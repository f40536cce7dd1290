"""The grid-20 geometry (320 px, N = 400 tokens) in the PyTorch port, on the CPU.

- The attention route table (``ops.attention.attention_route``) as the
  card applies it, and ``run_train.check_supported``'s refusals, both
  without a card; at DiT-XL's head dim, 72, too (the default route with
  grad is flash at every N, by measurement; ``"pallas"`` takes K1 + K2
  with grad, ``"block"`` is taken at every N: K3 where the JAX rule runs
  its kernel, DiT-XL/8 at 96 px, the XLA composition at 192 px), and
  ``check_supported`` of ``run_train`` and
  ``run_eval`` taking DiT-XL/2, /4 and /8 on the card.
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
from jpdvt_mt_ntnu_tpu_torch.eval import run_eval
from jpdvt_mt_ntnu_tpu_torch.ops.attention import (HOPPER_MAX_SMEM, attention_route,
                                                  block_takes_k3, k1_smem_bytes,
                                                  k2_smem_bytes)
from jpdvt_mt_ntnu_tpu_torch.tools import weights
from jpdvt_mt_ntnu_tpu_torch.train import run_train
from jpdvt_mt_ntnu_tpu_torch.utils.config import Config, apply_overrides
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

ARTIFACT = "artifacts/waves20_hard_step32700.manifest.json"
NOISE_TEMPLATE = "tests/golden/jax_noise_seed0_1x400x8.npy"
BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("n,dtype,grad,route", [
    (144, BF16, True, "whole_row"), (205, BF16, True, "whole_row"),
    (206, BF16, True, "flash"), (400, BF16, True, "flash"),
    (400, BF16, False, "whole_row"), (571, BF16, False, "whole_row"),
    (572, BF16, False, "whole_row"), (1024, BF16, False, "whole_row"),
    (164, FP32, True, "whole_row"), (165, FP32, True, "flash"),
    (341, FP32, False, "whole_row"), (400, FP32, False, "flash"),
    (324, BF16, True, "flash"), (576, BF16, True, "flash")])
def test_auto_route_takes_the_whole_row_kernels_where_they_fit(n, dtype, grad, route):
    """bf16 K1 and K2 stream their operands through fixed rings, so they fit
    at every N; with grad the default route keeps bf16 on them up to
    ``WHOLE_ROW_GRAD_MAX_N`` (205) and on flash beyond. fp32 stops where
    the scalar kernels' shared memory does."""
    assert attention_route(n, dtype, grad) == route
    assert attention_route(n, dtype, grad, "flash") == "flash"


@pytest.mark.parametrize("n,d", [(9, 64), (144, 64), (400, 64), (1024, 64), (9, 72),
                                 (309, 72), (310, 72), (576, 72)],
                         ids=["9", "144", "400", "1024", "9-d72", "309-d72", "310-d72",
                              "576-d72"])
def test_k1_smem_bytes_is_the_kernels_design(n, d):
    """bf16: two stages of 64-key K and V chunks, rows of Dh + 8 (144 B) at
    Dh 64 and Dh + 16 (176 B, an odd count of 16-byte units) at 72, the
    same at every N; fp32: the scalar kernel's K and V whole (rows of Dh +
    2), a 32-row fp32 query tile and its fp32 score rows."""
    row = {64: 72, 72: 88}[d]
    assert k1_smem_bytes(n, 2, d) == 2 * 2 * 64 * row * 2 == {64: 36864, 72: 45056}[d]
    assert k1_smem_bytes(n, 4, d) == (2 * n * (d + 2) * 4 + 32 * (d + 2) * 4
                                      + 32 * (n + 1) * 4)
    assert (k1_smem_bytes(n, 4, d) <= HOPPER_MAX_SMEM) == (n <= {64: 341, 72: 309}[d])


@pytest.mark.parametrize("n,d", [(9, 64), (144, 64), (205, 64), (206, 64), (400, 64),
                                 (1024, 64), (9, 72), (148, 72), (149, 72), (576, 72)],
                         ids=["9", "144", "205", "206", "400", "1024", "9-d72", "148-d72",
                              "149-d72", "576-d72"])
def test_k2_smem_bytes_is_the_kernels_design(n, d):
    """bf16: the larger of the row kernel's ring (two stages of 64-key K and
    V chunks, rows of Dh + 8 at Dh 64, Dh + 16 at 72) and the column
    kernel's (two stages of 64-row q and dO chunks and each row's three
    fp32 statistics), the same at every N; fp32: the scalar kernel's K, V,
    fp32 dK/dV accumulators, 32-row q and dO tiles and fp32 P/dP rows, rows
    of Dh + 2."""
    row = {64: 72, 72: 88}[d]
    assert k2_smem_bytes(n, 2, d) == max(2 * 2 * 64 * row * 2,
                                         2 * (2 * 64 * row * 2 + 3 * 64 * 4))
    assert k2_smem_bytes(n, 2, d) == {64: 38400, 72: 46592}[d]
    assert k2_smem_bytes(n, 4, d) == (2 * n * (d + 2) * 4 + 2 * n * (d + 2) * 4
                                      + 2 * 32 * (d + 2) * 4 + 2 * 32 * (n + 1) * 4)
    assert (k2_smem_bytes(n, 4, d) <= HOPPER_MAX_SMEM) == (n <= {64: 164, 72: 148}[d])


def test_route_refusals():
    """``pallas`` in fp32 takes K1 and K2 at every N (past their whole-row
    instances' shared memory, on their streaming instances); the JAX names
    ``xla``, ``block_interpret`` are routes; ``ring`` is refused by its
    mesh axis."""
    assert attention_route(165, FP32, True, "pallas") == "whole_row"
    assert attention_route(164, FP32, True, "pallas") == "whole_row"
    assert attention_route(400, BF16, True, "pallas") == "whole_row"
    assert attention_route(400, BF16, False, "pallas") == "whole_row"
    with pytest.raises(ValueError, match="head dim 16"):
        attention_route(9, FP32, True, head_dim=16)
    assert attention_route(9, FP32, True, head_dim=16, on_card=False) == "whole_row"
    with pytest.raises(ValueError, match="float16"):
        attention_route(144, torch.float16, False)
    assert attention_route(144, BF16, False, "xla") == "xla"
    assert attention_route(144, BF16, False, "block_interpret") == "block"
    with pytest.raises(ValueError, match="ring.*mesh.seq.*not ported"):
        attention_route(144, BF16, False, "ring")
    assert attention_route(144, BF16, False, "block") == "block"  # K3, asked for


@pytest.mark.parametrize("n", [16, 144, 205, 206, 400, 576, 1024, 9216])
def test_auto_route_at_head_dim_72(n):
    """At 72 the default route with grad is flash at every N
    (``WHOLE_ROW_GRAD_MAX_N[72]`` is 0: on an H100 K4 + K5 + K6 measured
    faster than K1 + K2 at batch 32 and 96 for N from 144 to 576, within 1%
    at N = 144 and batch 32); without grad bf16 takes K1 at every N and fp32
    up to N = 309, where its shared memory ends."""
    assert attention_route(n, BF16, True, head_dim=72) == "flash"
    assert attention_route(n, FP32, True, head_dim=72) == "flash"
    assert attention_route(n, BF16, False, head_dim=72) == "whole_row"
    assert attention_route(n, BF16, False, "pallas", head_dim=72) == "whole_row"
    assert attention_route(n, FP32, False, head_dim=72) == ("whole_row" if n <= 309 else "flash")
    for grad in (False, True):
        assert attention_route(n, BF16, grad, "flash", head_dim=72) == "flash"


def test_route_refusals_at_head_dim_72():
    """K2 and K3 take Dh 72: ``"pallas"`` with grad is K1 + K2 at every N
    (fp32 past K2's N = 148 on the streaming instances), and ``"block"`` is
    taken at every N: K3
    at DiT-XL/8's 96 px (N = 144, where the JAX rule runs its kernel), the
    XLA composition at 192 px (N = 576, where it does not). Head dims other
    than 64 and 72 stay refused by name on the card."""
    for n in (144, 576, 9216):
        assert attention_route(n, BF16, True, "pallas", head_dim=72) == "whole_row"
    assert attention_route(148, FP32, True, "pallas", head_dim=72) == "whole_row"
    assert attention_route(149, FP32, True, "pallas", head_dim=72) == "whole_row"
    for grad in (False, True):
        assert attention_route(144, BF16, grad, "block", head_dim=72) == "block"
        assert attention_route(144, FP32, grad, "block", head_dim=72) == "block"
        assert attention_route(576, BF16, grad, "block", head_dim=72) == "block"
    w = torch.empty((48, 1152, 72), dtype=BF16)
    assert block_takes_k3(torch.empty((32, 144, 1152), dtype=BF16), w, 16)
    assert not block_takes_k3(torch.empty((32, 576, 1152), dtype=BF16), w, 16)
    for d in (16, 128):
        with pytest.raises(ValueError, match=f"head dim {d} .*Dh 64 or 72"):
            attention_route(144, BF16, False, head_dim=d)
        with pytest.raises(ValueError, match=f"head dim {d} .*Dh 64 or 72"):
            attention_route(144, BF16, True, "pallas", head_dim=d)
        with pytest.raises(ValueError, match=f"head dim {d} .*Dh 64 or 72"):
            attention_route(144, BF16, False, "block", head_dim=d)
    # The CPU's plain versions take every head dim and these impls.
    assert attention_route(576, BF16, True, "pallas", head_dim=72, on_card=False) == "whole_row"
    assert attention_route(576, BF16, True, "block", head_dim=72, on_card=False) == "block"
    assert attention_route(144, BF16, True, head_dim=128, on_card=False) == "whole_row"


def _cfg(*overrides):
    return apply_overrides(Config(), ["data.synthetic_cues=waves", *overrides])


@pytest.mark.parametrize("name", ["DiT-XL/2", "DiT-XL/4", "DiT-XL/8"])
def test_check_supported_takes_dit_xl_on_the_card(name):
    """DiT-XL (16 heads of 72) at 192 px trains and solves on the card,
    bf16 and fp32: 9,216, 2,304 or 576 tokens; with ``attn_impl=pallas``
    in bf16 too (K1 + K2). ``attn_impl=block`` trains and solves every
    DiT-XL at 192 px and at 96 px (144, 576, 2,304 tokens): K3 where the
    JAX rule runs its kernel (/8 at 96 px), else the XLA composition."""
    for dtype in ("bfloat16", "float32"):
        cfg = _cfg(f"model.name={name}", f"model.compute_dtype={dtype}")
        run_train.check_supported(cfg, on_card=True)
        run_eval.check_supported(cfg, on_card=True)
    for check in (run_train.check_supported, run_eval.check_supported):
        check(_cfg(f"model.name={name}", "model.attn_impl=pallas"))
        check(_cfg(f"model.name={name}", "model.attn_impl=block"))
        check(_cfg(f"model.name={name}", "model.attn_impl=block", "model.image_size=96"))
    # fp32 on pallas: K1's and K2's streaming instances at every N
    run_train.check_supported(_cfg(f"model.name={name}", "model.attn_impl=pallas",
                                   "model.compute_dtype=float32"), on_card=True)


@pytest.mark.parametrize("impl", ["xla", "xla2", "xla_split", "interpret", "block",
                                  "block_interpret", "ring"])
def test_check_supported_refuses_attention_routes_by_name(impl):
    """Every setting the JAX DiT runs at Dh 64 and 72 is ported (``block``:
    K3 or the XLA composition; ``xla*``: the XLA attention; the
    ``interpret`` names: the same functions as ``pallas`` and ``block``),
    at grid 3 and grid 20 in both types; ``ring`` is refused by name, as a
    setting of ``mesh.seq``."""
    if impl == "ring":
        with pytest.raises(NotImplementedError, match="model.attn_impl='ring'.*mesh.seq"):
            run_train.check_supported(_cfg(f"model.attn_impl={impl}"))
        return
    run_train.check_supported(_cfg(f"model.attn_impl={impl}"))
    run_train.check_supported(_cfg(f"model.attn_impl={impl}", "model.image_size=320",
                                   "model.compute_dtype=float32"))


def test_check_supported_refuses_geometries_no_kernel_takes():
    for ok in ([], ["model.image_size=320"], ["model.image_size=320", "model.attn_impl=flash"],
               ["model.attn_impl=pallas"], ["model.compute_dtype=float32",
                                           "model.image_size=320"],
               ["model.image_size=320", "model.attn_impl=pallas"]):
        run_train.check_supported(_cfg(*ok))
    # fp32 pallas at grid 20 takes K1's and K2's streaming instances
    run_train.check_supported(_cfg("model.compute_dtype=float32", "model.image_size=320",
                                   "model.attn_impl=pallas"))
    tiny = ("model.hidden_size=64", "model.num_heads=4")  # Dh 16
    with pytest.raises(NotImplementedError, match="head dim 16"):
        run_train.check_supported(_cfg(*tiny))
    run_train.check_supported(_cfg(*tiny), on_card=False)


def test_run_train_refuses_before_any_weights_load(tmp_path):
    exp = tmp_path / "exp"
    # mesh.pipe is ported; with mesh.seq it is refused by name.
    with pytest.raises(NotImplementedError, match=r"mesh\.pipe with mesh\.seq"):
        run_train.main(["device=cpu", "data.synthetic_cues=waves", "mesh.pipe=2",
                        "mesh.seq=2", f"train.exp_dir={exp}", f"train.warm_start={ARTIFACT}"])
    # mesh.model is ported; one process has no ranks for it.
    with pytest.raises(ValueError, match=r"mesh\.model=2 .*world size"):
        run_train.main(["device=cpu", "data.synthetic_cues=waves", "mesh.model=2",
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
