"""Kernels K4, K5 and K6 of the PyTorch port against the JAX package's flash
attention, on the CPU.

The port's plain versions (``flash_attention_fwd_reference``,
``flash_attention_bwd_reference``: the path the wrappers take for CPU
tensors) are held against the Pallas kernels run in interpret mode
(``_flash_fwd`` / ``_flash_bwd`` with ``interpret=True``) on the same numpy
inputs, with small tiles (block_q 64, block_k 128) so that several blocks
and a ragged tail run, and the forward also at the CUDA kernel's own key
tile (``BLOCK_K``, 64). The CUDA kernels themselves run only on a card:
``tests/test_torch_port_cuda.py``.

Tolerances:
- the forward at the Pallas call's own key tiling: fp32 1e-5 absolute at
  |o| <= 3 (summation order and exp rounding); bf16 2e-2 (both round
  exp(S - m) to bf16 per tile at the same points; a different exp or sum
  order can flip one rounding by one bf16 ulp, 2^-8 relative). The LSE,
  fp32 in both, 1e-5 absolute;
- the plain forward over the whole row against the Pallas forward over
  several tiles: fp32 1e-5 (the tiling only reorders sums); bf16 2e-2 (the
  tiles round exp(S - m) against the running max instead of the row's);
- the backward relative to each gradient's largest magnitude: fp32 1e-5,
  bf16 2^-6 (the two round dS and the outputs at the same points; a
  summation order that flips one rounding moves a value by one bf16 ulp,
  2^-8 of its scale), as K2's;
- the ``autograd.Function`` (K4 forward, K5 + K6 backward, dq/dk/dv
  written into one fused-qkv gradient) against torch autograd of the
  plain forward, fp32, 1e-5 of scale.

The forward and backward cases run at Dh 64, at DiT-XL's 72 and at 32 under
the same tolerances: where Dh^-1/2 is not a power of two both packages
round the scale to the input type before q is scaled, and dQ takes the
fp32 scale. In bf16 at most 1% of O, dQ and dV may differ at all
(``FLIP_SHARE``, summation order; a q scaled by the fp32 scale moves
23-74% of them at Dh 32 and 72). dK is left out of that count: on the CPU
XLA takes the bf16 scale out of the interpreted kernel's dS^T (q * scale)
and applies it to the fp32 product, one ulp on ~41% of dK there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.ops.flash_attention import (_flash_bwd, _flash_fwd, _pick_block,
                                                   fused_qkv_flash_attention)
from jpdvt_mt_ntnu_tpu_torch.ops import attention as port_attention
from jpdvt_mt_ntnu_tpu_torch.ops import flash_attention as port

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_TOL = {"float32": 1e-5, "bfloat16": 2 ** -6}
FLIP_SHARE = 0.01  # bf16: the largest share of O, dQ, dV that may differ at all
BLOCK_Q, BLOCK_K = 64, 128


def _inputs(n, seed, count=4, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 2, n, d)).astype(np.float32) for _ in range(count)]


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _pallas_fwd(q, k, v, block_q=BLOCK_Q, block_k=BLOCK_K):
    n = q.shape[2]
    bq, bk = _pick_block(n, block_q, q.dtype), _pick_block(n, block_k, k.dtype)
    o, lse = _flash_fwd(q, k, v, bq, bk, True, True)
    return o, lse[..., 0], bk


# The forward at the small Pallas tiles, and at the CUDA kernel's own key
# tile (``port.BLOCK_K``): the tiling sets where exp(S - m) is rounded, so
# this ties the Pallas kernel, at the tiling the card runs, to the plain
# version that the card holds K4 against.
_FWD_CASES = ([(n, dtype, BLOCK_K, 64) for n in (9, 77, 144, 400)
               for dtype in ("float32", "bfloat16")]
              + [(n, dtype, port.BLOCK_K, 64) for n in (77, 400)
                 for dtype in ("float32", "bfloat16")]
              + [(n, dtype, block_k, d) for n, block_k, d in
                 ((144, BLOCK_K, 72), (77, port.BLOCK_K, 72), (77, BLOCK_K, 32))
                 for dtype in ("float32", "bfloat16")])


def _case_id(n, dtype, tiles, default_tiles, d):
    tile = "" if tiles == default_tiles else (
        f"-bk{tiles}" if isinstance(tiles, int) else f"-{tiles[0]}x{tiles[1]}")
    return f"{n}-{dtype}{tile}" + ("" if d == 64 else f"-d{d}")


@pytest.mark.parametrize("n,dtype,block_k,d", _FWD_CASES, ids=[
    _case_id(n, dtype, block_k, BLOCK_K, d) for n, dtype, block_k, d in _FWD_CASES])
def test_k4_plain_matches_pallas_interpret(n, dtype, block_k, d):
    q, k, v = _inputs(n, seed=n, count=3, d=d)
    o, lse, bk = _pallas_fwd(*(_jax(a, dtype) for a in (q, k, v)), block_k=block_k)
    assert bk == block_k or n <= block_k  # one tile when N fits in it
    mine_o, mine_lse = port.flash_attention_fwd_reference(
        *(_torch(a, dtype) for a in (q, k, v)), block_k=bk)
    assert mine_o.dtype == getattr(torch, dtype) and mine_lse.dtype == torch.float32
    np.testing.assert_allclose(_np(mine_o), _np(o), atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(mine_lse.numpy(), np.asarray(lse), atol=1e-5, rtol=0)
    if dtype == "bfloat16":
        assert (_np(mine_o) != _np(o)).mean() <= FLIP_SHARE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_plain_over_the_whole_row_matches_tiled_pallas(dtype):
    """At N = 400 the JAX default is one block; small tiles change only
    the bf16 rounding of exp(S - m)."""
    q, k, v = _inputs(400, seed=4, count=3)
    o, lse, bk = _pallas_fwd(*(_jax(a, dtype) for a in (q, k, v)))
    assert bk < 400
    mine_o, mine_lse = port.flash_attention_fwd_reference(*(_torch(a, dtype) for a in (q, k, v)))
    np.testing.assert_allclose(_np(mine_o), _np(o), atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(mine_lse.numpy(), np.asarray(lse), atol=1e-5, rtol=0)


# The backward at the Pallas tiles (block_q, block_k) of the forward, and at
# 16 x 16: its result does not depend on the tiling (P comes from the saved
# row LSE, so nothing rounded does), which lets the CUDA kernels pick
# their own tiles.
_BWD_CASES = ([(n, dtype, (BLOCK_Q, BLOCK_K), 64) for n in (9, 77, 144, 400)
               for dtype in ("float32", "bfloat16")]
              + [(n, dtype, (16, 16), 64) for n in (77, 400) for dtype in ("float32", "bfloat16")]
              + [(n, dtype, tiles, d) for n, tiles, d in
                 ((144, (BLOCK_Q, BLOCK_K), 72), (77, (16, 16), 32))
                 for dtype in ("float32", "bfloat16")])


@pytest.mark.parametrize("n,dtype,tiles,d", _BWD_CASES, ids=[
    _case_id(n, dtype, tiles, (BLOCK_Q, BLOCK_K), d) for n, dtype, tiles, d in _BWD_CASES])
def test_k5_k6_plain_match_pallas_interpret(n, dtype, tiles, d):
    q, k, v, do = _inputs(n, seed=n + 1, d=d)
    jq, jk, jv, jdo = (_jax(a, dtype) for a in (q, k, v, do))
    o, lse, _ = _pallas_fwd(jq, jk, jv)
    bq, bk = (_pick_block(n, t, jq.dtype) for t in tiles)
    want = _flash_bwd(jq, jk, jv, o, lse[..., None], jdo, bq, bk, True)
    mine = port.flash_attention_bwd_reference(
        *(_torch(a, dtype) for a in (q, k, v)), _torch(_np(o), dtype),
        torch.from_numpy(np.asarray(lse)), _torch(do, dtype))
    for name, m, w in zip(("dq", "dk", "dv"), mine, want):
        assert m.dtype == getattr(torch, dtype)
        w = _np(w)
        np.testing.assert_allclose(_np(m), w, rtol=0,
                                   atol=BWD_TOL[dtype] * np.abs(w).max(), err_msg=name)
        if dtype == "bfloat16" and name != "dk":
            assert (_np(m) != w).mean() <= FLIP_SHARE, name


def test_flash_autograd_matches_torch_autograd_of_the_plain_forward():
    """The fused-qkv Function's gradient (K5 + K6 on the card, their plain
    versions here) written into one (B, N, 3*H*Dh) buffer, in fp32."""
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((2, 77, 3 * 2 * 64)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 77, 2 * 64)).astype(np.float32))
    mine_in = qkv.clone().requires_grad_(True)
    mine = port.fused_qkv_flash_attention(mine_in, 2)
    (mine * g).sum().backward()
    ref_in = qkv.clone().requires_grad_(True)
    q, k, v = port_attention._heads(ref_in, 2)
    o, _ = port.flash_attention_fwd_reference(q, k, v)
    ref = o.transpose(1, 2).reshape(2, 77, -1)
    (ref * g).sum().backward()
    np.testing.assert_allclose(mine.detach().numpy(), ref.detach().numpy(), atol=1e-6, rtol=0)
    scale = ref_in.grad.abs().max().item()
    np.testing.assert_allclose(mine_in.grad.numpy(), ref_in.grad.numpy(), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_qkv_flash_attention_matches_jax(dtype):
    """timm's [q|k|v][head][dim] split and the (B, N, H*Dh) merge against the
    JAX function (interpret mode reaches K4)."""
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((2, 144, 3 * 2 * 64)).astype(np.float32)
    with torch.no_grad():
        mine = port.fused_qkv_flash_attention(_torch(qkv, dtype), 2)
    assert mine.shape == (2, 144, 128) and mine.dtype == getattr(torch, dtype)
    want = fused_qkv_flash_attention(_jax(qkv, dtype), 2, interpret=True)
    np.testing.assert_allclose(_np(mine), _np(want), atol=TOL[dtype], rtol=0)


def test_cpu_wrappers_take_plain_versions_and_count_no_launch():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(77, seed=1))
    before = (port.flash_attention_fwd.launches, port.flash_dq.launches,
              port.flash_dkv.launches)
    o, lse = port.flash_attention_fwd(q, k, v)
    ref_o, ref_lse = port.flash_attention_fwd_reference(q, k, v, port.BLOCK_K)
    np.testing.assert_array_equal(o.numpy(), ref_o.numpy())
    np.testing.assert_array_equal(lse.numpy(), ref_lse.numpy())
    out = [torch.empty_like(q) for _ in range(3)]
    port.flash_attention_bwd(q, k, v, o, lse, do, out=out)
    for got, want in zip(out, port.flash_attention_bwd_reference(q, k, v, o, lse, do)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    dq = port.flash_dq(q, k, v, o, lse, do, torch.empty_like(q))
    np.testing.assert_array_equal(dq.numpy(), out[0].numpy())
    assert (port.flash_attention_fwd.launches, port.flash_dq.launches,
            port.flash_dkv.launches) == before


def test_wrappers_refuse_a_device_without_a_kernel():
    q = torch.empty((1, 2, 9, 64), device="meta")
    lse = torch.empty((1, 2, 9), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        port.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        port.flash_attention_bwd(q, q, q, q, lse, q, out=(q, q, q))


@pytest.mark.parametrize("name,group", [
    ("(anonymous namespace)::tc::flash_dq_mma_kernel(__nv_bfloat16 const*, __nv_bfloat16 "
     "const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, float "
     "const*, __nv_bfloat16*, (anonymous namespace)::Strides, int, int, float, int)",
     "k5_flash_dq"),
    ("void (anonymous namespace)::flash_dq_kernel<float>(float const*, float const*, float "
     "const*, float const*, float const*, float const*, float*, (anonymous "
     "namespace)::Strides, int, int, float)", "k5_flash_dq"),
    ("(anonymous namespace)::tc::flash_dkv_mma_kernel(__nv_bfloat16 const*, __nv_bfloat16 "
     "const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, float "
     "const*, __nv_bfloat16*, __nv_bfloat16*, (anonymous namespace)::Strides, int, int, "
     "float, int)", "k6_flash_dkv"),
    ("void (anonymous namespace)::flash_dkv_kernel<float>(float const*, float const*, "
     "float const*, float const*, float const*, float const*, float*, float*, (anonymous "
     "namespace)::Strides, int, int, float)", "k6_flash_dkv"),
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16>(__nv_bfloat16 const*)",
     "k4_flash_fwd"),
    ("(anonymous namespace)::tc::flash_fwd_mma_kernel(__nv_bfloat16 const*, __nv_bfloat16 "
     "const*, __nv_bfloat16 const*, __nv_bfloat16*, float*, long long, long long, long "
     "long, long long, long long, long long, int, int, float, int)", "k4_flash_fwd"),
    ("void (anonymous namespace)::flash_fwd_kernel<float>(float const*, float const*, "
     "float const*, float*, float*, long long, long long, long long, long long, long "
     "long, long long, int, int, float)", "k4_flash_fwd"),
    ("(anonymous namespace)::tc::attention_bwd_dq_mma_kernel(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, "
     "float*, (anonymous namespace)::tc::Strides, int, int, float, int)", "k2_attention_bwd"),
    ("(anonymous namespace)::tc::attention_bwd_dkv_mma_kernel(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
     "__nv_bfloat16*, __nv_bfloat16*, (anonymous namespace)::tc::Strides, int, int, float, "
     "int)", "k2_attention_bwd"),
    ("void (anonymous namespace)::attention_bwd_kernel<float>(float const*, float const*, "
     "float const*, float const*, float*, float*, float*, long long, long long, long long, "
     "long long, long long, long long, long long, long long, long long, int, float)",
     "k2_attention_bwd"),
    ("(anonymous namespace)::tc::attention_fwd_mma_kernel(__nv_bfloat16 const*)",
     "k1_attention"),
])
def test_profile_train_groups_the_flash_backward_kernels(name, group):
    """The train steps' breakdowns file K2 (grid 3), K4, K5 and K6 (grid
    20) by their kernels' names (bf16 on the tensor cores, fp32 scalar),
    not under "other", and K1's forward apart from K2."""
    from jpdvt_mt_ntnu_tpu_torch.tools.profile_train import _group
    assert _group(name) == group


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4", "k5", "k6"])
def test_kernel_variants_ablations_apply_to_their_sources(kernel):
    """Each built-in ablation and design variant of
    ``tools/kernel_variants.py`` finds its text in the kernel's source (the
    tool raises on the card otherwise)."""
    from jpdvt_mt_ntnu_tpu_torch.ops import _build
    from jpdvt_mt_ntnu_tpu_torch.tools import kernel_variants as kv
    src = (_build.CSRC / kv.SOURCES[kernel]).read_text()
    for subs in (*kv.ABLATIONS[kernel].values(), *kv.VARIANTS.get(kernel, {}).values()):
        assert kv._substitute(src, subs) != src
