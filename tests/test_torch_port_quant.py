"""The PyTorch port's int8 (w8a8) path against the JAX package's.

- ``ops/quant.py``: the spec parser's cases and errors; per-channel and
  per-token quantization of the same seeded matrices give equal int8
  values and bit-equal scales (both round half to even after a true
  division); the int8 x int8 -> int32 product is exact; ``int8_dense`` is
  within 1e-6 of the output's scale in fp32 (one fp32 rounding order).
- The DiT: a 2-block fp32 model on the tiny trained model's weights with
  ``quant="int8"`` and ``"int8:1"`` against the JAX model's ``apply``:
  image and code within 1e-3 of their scale (a rounding tie that flips one
  int8 step moves an output by about s_x * s_w * |w|); the parameter names
  do not change with ``quant``; the weights are quantized once per
  parameter version (counted), from the fp32 parameters also when the
  solve computes in bf16.
- The int8 solve on the tiny trained model (fast, fp32, 32 puzzles of the
  regime it was trained on, the JAX solver's noise template): puzzle and
  patch accuracy >= 0.95 / 0.97 (``tests/test_quant.py``'s gate) and the
  permutations of the JAX int8 solve on at least 31 of 32.
- ``run_eval`` with ``model.quant=int8`` against the JAX ``run_eval``'s
  journal on 16 puzzles: at least 15 agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from jpdvt_mt_ntnu_tpu.data import SyntheticPuzzles as JaxSyntheticPuzzles
from jpdvt_mt_ntnu_tpu.eval import run_eval as jax_run_eval
from jpdvt_mt_ntnu_tpu.eval.solver import PuzzleSolver as JaxPuzzleSolver
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.ops import quant as jax_quant
from jpdvt_mt_ntnu_tpu.tools.torch_convert import load_npz_params
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.eval import run_eval
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.models import create_model, dit
from jpdvt_mt_ntnu_tpu_torch.ops import quant
from jpdvt_mt_ntnu_tpu_torch.tools.weights import load_artifact

from test_torch_port_eval import FIXTURE, _journal, jax_eval_draws, jax_noise
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(depth=2, hidden_size=64, num_heads=4)
# Matrices (d_in, d_out) of the JAX kernel layout; the port's weight is the transpose.
SHAPES = [(40, 24), (64, 192), (256, 64), (768, 2304)]


@pytest.mark.parametrize("mod", [jax_quant, quant], ids=["jax", "port"])
def test_parse_quant_spec(mod):
    assert mod.parse_quant_spec("") == (None, None)
    assert mod.parse_quant_spec(None) == (None, None)
    assert mod.parse_quant_spec("int8") == ("int8", None)
    assert mod.parse_quant_spec("int8:8") == ("int8", 8)
    assert mod.parse_quant_spec("int8:0") == ("int8", 0)
    with pytest.raises(ValueError, match="unknown quant mode"):
        mod.parse_quant_spec("int4")
    with pytest.raises(ValueError, match="bad quant spec"):
        mod.parse_quant_spec("int8:x")


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_equals_jax(shape):
    """Equal int8 values, bit-equal scales; a rounding tie would be the
    only way to differ, so at most 1 in 10^4 entries may (none does)."""
    rng = np.random.default_rng(shape[1])
    k = (rng.standard_normal(shape) / 8).astype(np.float32)
    jw, js = jax_quant.quantize_channelwise(jnp.asarray(k))
    w_q, s_w = quant.quantize_channelwise(torch.from_numpy(k.T.copy()))
    assert w_q.dtype == torch.int8 and s_w.dtype == torch.float32
    assert (w_q.numpy().T != np.asarray(jw)).sum() <= k.size // 10_000
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(js))
    x = rng.standard_normal((3, 17, shape[0])).astype(np.float32) * 3
    jx, jsx = jax_quant.quantize_rowwise(jnp.asarray(x))
    x_q, s_x = quant.quantize_rowwise(torch.from_numpy(x))
    assert (x_q.numpy() != np.asarray(jx)).sum() <= x.size // 10_000
    np.testing.assert_array_equal(s_x.numpy(), np.asarray(jsx))
    acc = quant.int8_matmul(x_q, w_q)
    assert acc.dtype == torch.int32 and acc.shape == (3, 17, shape[1])
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jax_quant.int8_matmul(jx, jw)))


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_int8_dense_matches_jax(shape):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 9, shape[0])).astype(np.float32)
    k = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape[1]).astype(np.float32)
    want = np.asarray(jax_quant.int8_dense(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                           out_dtype=jnp.float32))
    got = quant.int8_dense(torch.from_numpy(x),
                           *quant.quantize_channelwise(torch.from_numpy(k.T.copy())),
                           torch.from_numpy(b)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    bf = quant.int8_dense(torch.from_numpy(x).bfloat16(),
                          *quant.quantize_channelwise(torch.from_numpy(k.T.copy())),
                          torch.from_numpy(b))
    assert bf.dtype == torch.bfloat16


def test_zero_rows_quantize_to_zero():
    x_q, s_x = quant.quantize_rowwise(torch.zeros(3, 16))
    assert not x_q.any() and torch.all(s_x == 1e-30 / 127.0)
    w_q, s_w = quant.quantize_channelwise(torch.eye(16))
    out = quant.int8_dense(torch.zeros(3, 16), w_q, s_w, torch.ones(16))
    assert torch.equal(out, torch.ones(3, 16))


@pytest.fixture(scope="module")
def tiny_weights():
    params = jax.tree.map(jnp.asarray, load_npz_params(FIXTURE))
    with pytest.warns(UserWarning, match="step 0"):
        sd, _ = load_artifact(FIXTURE, device="cpu")
    return params, sd


def port_model(sd, **overrides):
    model, cfg = create_model("JPDVT", 48, device="cpu", **TINY, **overrides)
    model.load_state_dict(sd, strict=True)
    return model, cfg


@pytest.mark.parametrize("spec", ["int8", "int8:1"])
def test_dit_int8_matches_jax(tiny_weights, spec):
    params, sd = tiny_weights
    jmodel, jcfg = jax_create_model("JPDVT", 48, quant=spec, **TINY)
    model, cfg = port_model(sd, quant=spec)
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (3, 48, 48, 3)).astype(np.float32)
    t = np.array([0, 17, 999])
    code = rng.standard_normal((3, cfg.num_tokens, 8)).astype(np.float32)
    jimg, jcode = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(code))
    with torch.inference_mode():
        img, out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(code))
    for mine, theirs in ((img, jimg), (out, jcode)):
        theirs = np.asarray(theirs)
        assert np.abs(mine.numpy() - theirs).max() <= 1e-3 * np.abs(theirs).max()
    quantized = [i for i, blk in enumerate(model.blocks) if blk.mlp.fc1.quant]
    assert quantized == ([0, 1] if spec == "int8" else [0])
    with torch.inference_mode():
        plain = port_model(sd)[0](torch.from_numpy(x), torch.from_numpy(t),
                                  torch.from_numpy(code))[1]
    assert not torch.equal(plain, out)


def test_param_names_unchanged_with_quant(tiny_weights):
    _, sd = tiny_weights
    names = {k: v.shape for k, v in port_model(sd)[0].state_dict().items()}
    for spec in ("int8", "int8:1"):
        assert {k: v.shape for k, v in port_model(sd, quant=spec)[0].state_dict().items()} == names


def test_weights_quantized_once_per_parameter_version(tiny_weights, monkeypatch):
    _, sd = tiny_weights
    calls = []
    real = dit.quantize_channelwise
    monkeypatch.setattr(dit, "quantize_channelwise", lambda w: calls.append(1) or real(w))
    model, cfg = port_model(sd, quant="int8")
    args = (torch.zeros(2, 48, 48, 3), torch.tensor([0, 5]), torch.zeros(2, cfg.num_tokens, 8))
    with torch.inference_mode():
        for _ in range(3):
            model(*args)
    assert len(calls) == 8  # qkv, proj, fc1, fc2 of two blocks, once
    with torch.no_grad():
        model.blocks[1].mlp.fc2.weight.mul_(1.0)  # a new version of one parameter
    with torch.inference_mode():
        model(*args)
    assert len(calls) == 9
    # A bf16 solve quantizes the fp32 parameters before its cast copy, once.
    model, cfg = port_model(sd, quant="int8", dtype=torch.bfloat16)
    calls.clear()
    solver = PuzzleSolver(model, cfg, create_diffusion("10", device="cpu"), grid_size=3,
                          mode="faithful", device="cpu")
    x = np.random.default_rng(0).uniform(-1, 1, (2, 48, 48, 3)).astype(np.float32)
    solver.solve(x)
    solver.solve(x)
    assert len(calls) == 8
    copy_fc1 = solver._cast_params().blocks[0].mlp.fc1
    assert copy_fc1.weight.dtype == torch.bfloat16
    w_q, s_w = real(model.blocks[0].mlp.fc1.weight)
    assert torch.equal(copy_fc1.int8_weights()[0], w_q)
    assert torch.equal(copy_fc1.int8_weights()[1], s_w)


def test_int8_solve_on_the_tiny_model_matches_jax(tiny_weights):
    params, sd = tiny_weights
    jmodel, jcfg = jax_create_model("JPDVT", 48, quant="int8", **TINY)
    ds = JaxSyntheticPuzzles(48, n=32, seed=123)
    x = np.stack([ds[i] for i in range(32)])
    rng = np.random.default_rng(0)
    perms = np.stack([rng.permutation(9) for _ in range(32)])
    jsolver = JaxPuzzleSolver(jmodel, jcfg, jax_create_diffusion("50"), grid_size=3,
                              mode="fast")
    jpred = np.asarray(jsolver._solve_and_score(params, jnp.asarray(x),
                                                jnp.asarray(perms))[0])
    model, cfg = port_model(sd, quant="int8")
    res = PuzzleSolver(model, cfg, create_diffusion("50", device="cpu"), grid_size=3,
                       mode="fast", device="cpu",
                       noise_template=np.asarray(jsolver.noise_template)).evaluate(x, perms)
    assert res.puzzle_accuracy >= 0.95 and res.patch_accuracy >= 0.97
    same = int((res.pred == jpred).all(axis=1).sum())
    print(f"int8 solve: {same}/32 permutations equal the JAX int8 solve's")
    assert same >= 31


def test_run_eval_int8_agrees_with_jax_journal(tmp_path, monkeypatch):
    from test_torch_port_eval import TINY_ARGS

    monkeypatch.chdir(tmp_path)
    np.savez(tmp_path / "draws.npz", **jax_eval_draws(11, 16, 8, 9))
    np.save(tmp_path / "noise.npy", jax_noise(11, 9))
    args = TINY_ARGS + ["model.quant=int8"]
    assert jax_run_eval.main(args + [f"eval.logs_dir={tmp_path}/jax"]) == 0
    assert run_eval.main(args + ["device=cpu", f"eval.jax_draws={tmp_path}/draws.npz",
                                 f"eval.jax_noise={tmp_path}/noise.npy",
                                 f"eval.logs_dir={tmp_path}/port"]) == 0
    theirs, mine = _journal(tmp_path / "jax"), _journal(tmp_path / "port")
    assert [r[0] for r in mine] == [r[0] for r in theirs] and len(mine) == 16
    agree = sum(a == b for a, b in zip(mine, theirs))
    print(f"run_eval int8: {agree}/16 journal rows equal the JAX run_eval's")
    assert agree >= 15
