"""The grid-20 geometry (320 px, N = 400 tokens) in the PyTorch port, on the CPU.

- The attention route table (``ops.attention.attention_route``) as the
  card applies it, and ``run_train.check_supported``'s refusals, both
  without a card.
- A 2-block, full-width DiT at 320 px against the JAX package's
  ``DiT.apply`` in fp32, ``attn_impl`` None on both sides: XLA's softmax in
  JAX, the flash route's plain version in the port (K1 takes no fp32
  N = 400). Tolerance 1e-4 of the output's largest magnitude (fp32 through
  two 768-wide blocks of 400 tokens; summation order only).
- The committed ``waves20_hard_step32700`` artifact, reassembled once for
  this module: it converts with nothing missing and nothing unused, and
  the port's fp32 fast solve of 4 grid-20 wave puzzles (the seed-0 noise
  template, ``tests/golden/jax_noise_seed0_1x400x8.npy``) predicts the same
  permutations as the JAX package's fp32 fast solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from jpdvt_mt_ntnu_tpu.eval.solver import PuzzleSolver as JaxPuzzleSolver
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.tools.torch_convert import _unflatten
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.data import SyntheticPuzzles
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.models import DiT, DiTConfig, create_model, dit
from jpdvt_mt_ntnu_tpu_torch.ops import jigsaw
from jpdvt_mt_ntnu_tpu_torch.ops.attention import attention_route
from jpdvt_mt_ntnu_tpu_torch.tools import weights
from jpdvt_mt_ntnu_tpu_torch.train import run_train
from jpdvt_mt_ntnu_tpu_torch.utils.config import Config, apply_overrides

ARTIFACT = "artifacts/waves20_hard_step32700.manifest.json"
NOISE_TEMPLATE = "tests/golden/jax_noise_seed0_1x400x8.npy"
BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("n,dtype,grad,route", [
    (144, BF16, True, "whole_row"), (205, BF16, True, "whole_row"),
    (206, BF16, True, "flash"), (400, BF16, True, "flash"),
    (400, BF16, False, "whole_row"), (571, BF16, False, "whole_row"),
    (572, BF16, False, "flash"), (164, FP32, True, "whole_row"),
    (165, FP32, True, "flash"), (341, FP32, False, "whole_row"),
    (400, FP32, False, "flash")])
def test_auto_route_takes_the_whole_row_kernels_where_they_fit(n, dtype, grad, route):
    assert attention_route(n, dtype, grad) == route
    assert attention_route(n, dtype, grad, "flash") == "flash"


def test_route_refusals():
    with pytest.raises(ValueError, match="shared memory"):
        attention_route(400, BF16, True, "pallas")
    assert attention_route(400, BF16, False, "pallas") == "whole_row"
    with pytest.raises(ValueError, match="head dim 16"):
        attention_route(9, FP32, True, head_dim=16)
    assert attention_route(9, FP32, True, head_dim=16, on_card=False) == "whole_row"
    with pytest.raises(ValueError, match="float16"):
        attention_route(144, torch.float16, False)
    for impl in ("xla", "block_interpret", "ring"):
        with pytest.raises(ValueError, match="not ported"):
            attention_route(144, BF16, False, impl)
    assert attention_route(144, BF16, False, "block") == "block"  # K3, asked for


def _cfg(*overrides):
    return apply_overrides(Config(), ["data.synthetic_cues=waves", *overrides])


@pytest.mark.parametrize("impl", ["xla", "xla2", "xla_split", "interpret", "block",
                                  "block_interpret", "ring"])
def test_check_supported_refuses_attention_routes_by_name(impl):
    with pytest.raises(NotImplementedError, match=f"model.attn_impl='{impl}'"):
        run_train.check_supported(_cfg(f"model.attn_impl={impl}"))


def test_check_supported_refuses_geometries_no_kernel_takes():
    for ok in ([], ["model.image_size=320"], ["model.image_size=320", "model.attn_impl=flash"],
               ["model.attn_impl=pallas"], ["model.compute_dtype=float32",
                                           "model.image_size=320"]):
        run_train.check_supported(_cfg(*ok))
    with pytest.raises(NotImplementedError, match="image_size=320.*pallas"):
        run_train.check_supported(_cfg("model.image_size=320", "model.attn_impl=pallas"))
    tiny = ("model.hidden_size=64", "model.num_heads=4")  # Dh 16
    with pytest.raises(NotImplementedError, match="head dim 16"):
        run_train.check_supported(_cfg(*tiny))
    run_train.check_supported(_cfg(*tiny), on_card=False)


def test_run_train_refuses_before_any_weights_load(tmp_path):
    exp = tmp_path / "exp"
    with pytest.raises(NotImplementedError, match="block"):
        run_train.main(["device=cpu", "data.synthetic_cues=waves", "model.attn_impl=block",
                        f"train.exp_dir={exp}", f"train.warm_start={ARTIFACT}"])
    assert not exp.exists()


@pytest.fixture(scope="module")
def two_blocks():
    size = dict(depth=2)
    jmodel, jcfg = jax_create_model("JPDVT", 320, **size)
    shapes = jmodel.init(jax.random.key(0), jnp.zeros((1, 320, 320, 3)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1, 400, 8)))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (0.02 * rng.standard_normal(a.shape)).astype(np.float32), shapes)
    model, cfg = create_model("JPDVT", 320, device="cpu", **size)
    sd, unused = weights.params_to_state_dict(params)
    assert unused == []
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    return jmodel, params, model, cfg


def test_two_block_dit_at_grid20_matches_jax(two_blocks, monkeypatch):
    jmodel, params, model, cfg = two_blocks
    assert cfg.num_tokens == 400 and cfg.attn_impl is None
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 320, 320, 3)).astype(np.float32)
    t = np.array([3, 900])
    code = rng.standard_normal((2, 400, 8)).astype(np.float32)
    j_img, j_code = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(code))
    calls = []
    flash_route = dit.fused_qkv_flash_attention
    monkeypatch.setattr(dit, "fused_qkv_flash_attention",
                        lambda *a: calls.append(1) or flash_route(*a))
    with torch.no_grad():
        img, code_out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(code))
    assert len(calls) == cfg.depth  # fp32 at N = 400: the flash route
    for mine, theirs in ((code_out, j_code), (img, j_img)):
        theirs = np.asarray(theirs)
        scale = np.abs(theirs).max()
        assert scale > 0.1
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0, atol=1e-4 * scale)


@pytest.fixture(scope="module")
def artifact():
    return weights.read_artifact(ARTIFACT)


def test_grid20_artifact_converts_every_parameter(artifact):
    flat, step = artifact
    assert step == 32700
    sd, unused = weights.params_to_state_dict(flat)
    assert unused == []
    with torch.device("meta"):
        expected = DiT(DiTConfig(input_size=320)).state_dict()
    assert sorted(sd) == sorted(expected)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(expected[k].shape), k


def test_grid20_fast_solve_predicts_jax_permutations(artifact):
    flat, _ = artifact
    sd, _ = weights.params_to_state_dict(flat)
    model, cfg = create_model("JPDVT", 320, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    x = SyntheticPuzzles(320, n=4, seed=5).batch()
    rng = np.random.default_rng(5)
    perms = np.stack([rng.permutation(400) for _ in range(4)])
    x_scr = jigsaw.scramble(torch.from_numpy(x), torch.from_numpy(perms), 20)
    template = np.load(NOISE_TEMPLATE)
    mine = PuzzleSolver(model, cfg, create_diffusion("250", device="cpu"), grid_size=20,
                        mode="fast", device="cpu", noise_template=template).solve(x_scr)
    del model
    jmodel, jcfg = jax_create_model("JPDVT", 320, dtype=jnp.float32)
    jsolver = JaxPuzzleSolver(jmodel, jcfg, jax_create_diffusion("250"), grid_size=20,
                              mode="fast")
    np.testing.assert_array_equal(np.asarray(jsolver.noise_template), template)
    theirs = jsolver.solve(_unflatten(flat), jnp.asarray(x_scr.numpy()))
    assert (np.sort(mine, axis=1) == np.arange(400)).all()
    np.testing.assert_array_equal(mine, theirs)
    assert (mine == perms).mean() > 0.9  # the trained model places most pieces
