"""Kernels K1 and K2 of the PyTorch port against the JAX package's attention.

The port's plain version (``attention_reference``, the path its wrapper
takes for CPU tensors) is held against the Pallas kernel run in interpret
mode (``_attention_pallas_fwd_only(..., interpret=True)``) and against the
XLA oracle ``_attention_xla``, on the same numpy inputs. The CUDA kernel
itself runs only on a card: ``tests/test_torch_port_cuda.py``.

Tolerances: fp32 differs only by summation order and exp rounding, 1e-5
absolute at |o| <= 3. bf16 rounds P and O to bf16 in both; a different
exp or sum order can flip one rounding by one bf16 ulp (2^-8 relative),
so 2e-2 absolute at |o| <= 3. The same tolerances hold at every head dim:
Dh 72 (DiT-XL's) and 32, where Dh^-1/2 is not a power of two, take the
scale as JAX does, rounded to the input type before q is scaled
(``scaled_q``, held bit for bit to JAX's ``q * d ** -0.5``). In bf16 at
most 1% of the outputs may differ at all (``FLIP_SHARE``): summation order
flips a few roundings (0.05% at most here), while a q scaled by the fp32
scale moves 18-61% of them at Dh 32 and 72.

K2's plain version (``attention_bwd_reference``) is held against the
Pallas backward kernel in interpret mode (``_attention_pallas_bwd``),
relative to each gradient's largest magnitude: fp32 1e-5 (summation
order), bf16 2^-6 (the two round dS and the outputs at the same points; a
summation order that flips one rounding moves a value by one bf16 ulp,
2^-8 of its scale). The autograd wiring (K1 forward, K2 backward, dq/dk/dv
written into one fused-qkv gradient) is held against torch autograd of the
plain forward in fp32, 1e-5 of scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.ops.attention import (
    _attention_pallas_bwd, _attention_pallas_fwd_only, _attention_xla,
    fused_qkv_attention, fused_qkv_attention_xla)
from jpdvt_mt_ntnu_tpu_torch.ops import attention as port

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_TOL = {"float32": 1e-5, "bfloat16": 2 ** -6}
FLIP_SHARE = 0.01  # bf16: the largest share of outputs that may differ at all
SHAPES = [(2, 4, 16, 16), (1, 2, 144, 64), (2, 3, 37, 64), (2, 3, 144, 72), (1, 2, 40, 32)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["2x4x16x16", "1x2x144x64", "ragged37",
                                               "2x3x144x72", "1x2x40x32"])
def test_k1_plain_matches_pallas_interpret_and_xla(shape, dtype):
    q, k, v = _inputs(shape, seed=sum(shape))
    mine = _np(port.attention(*(_torch(a, dtype) for a in (q, k, v))))
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    pallas = _np(_attention_pallas_fwd_only(jq, jk, jv, interpret=True))
    xla = _np(_attention_xla(jq, jk, jv))
    np.testing.assert_allclose(mine, pallas, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(mine, xla, atol=TOL[dtype], rtol=0)
    if dtype == "bfloat16":
        assert (mine != pallas).mean() <= FLIP_SHARE and (mine != xla).mean() <= FLIP_SHARE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_qkv_attention_matches_jax(dtype):
    """The head split of timm's fused qkv ([q|k|v][head][dim]) and the
    (B, N, H*Dh) merge, against both JAX routes (interpret mode reaches K1)."""
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((2, 144, 3 * 2 * 64)).astype(np.float32)
    mine = port.fused_qkv_attention(_torch(qkv, dtype), num_heads=2)
    assert mine.shape == (2, 144, 128) and mine.dtype == getattr(torch, dtype)
    jqkv = _jax(qkv, dtype)
    np.testing.assert_allclose(_np(mine), _np(fused_qkv_attention_xla(jqkv, 2)),
                               atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(_np(mine), _np(fused_qkv_attention(jqkv, 2, True)),
                               atol=TOL[dtype], rtol=0)
    np.testing.assert_array_equal(
        _np(mine), _np(port.fused_qkv_attention_reference(_torch(qkv, dtype), 2)))


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 2, 9, 64), seed=1))
    before = port.attention.launches
    np.testing.assert_array_equal(port.attention(q, k, v),
                                  port.attention_reference(q, k, v))
    assert port.attention.launches == before


def test_wrapper_refuses_a_device_without_a_kernel():
    q = torch.empty((1, 2, 9, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        port.attention(q, q, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(9, 64), (77, 64), (144, 64), (144, 72), (40, 32)],
                         ids=["9", "77", "144", "144-d72", "40-d32"])
def test_k2_plain_matches_pallas_interpret(n, d, dtype):
    rng = np.random.default_rng(n)
    arrays = [rng.standard_normal((2, 2, n, d)).astype(np.float32) for _ in range(4)]
    mine = port.attention_bwd_reference(*(_torch(a, dtype) for a in arrays))
    want = _attention_pallas_bwd(*(_jax(a, dtype) for a in arrays), interpret=True)
    for name, m, w in zip(("dq", "dk", "dv"), mine, want):
        assert m.dtype == getattr(torch, dtype)
        w = _np(w)
        np.testing.assert_allclose(_np(m), w, rtol=0,
                                   atol=BWD_TOL[dtype] * np.abs(w).max(), err_msg=name)
        # dK is left out: on the CPU, XLA takes the bf16 scale out of the
        # interpreted kernel's dS^T (q * scale) and applies it to the fp32
        # product, which moves ~41% of dK by one ulp where Dh^-1/2 is not a
        # power of two; the port keeps the kernel's dS^T qs.
        if dtype == "bfloat16" and name != "dk":
            assert (_np(m) != w).mean() <= FLIP_SHARE, name


def test_k2_plain_is_not_autograd_of_the_plain_forward_in_bf16():
    """The rounding points differ from torch autograd of attention_reference
    (which is why K2 has its own plain version)."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 2, 77, 64)).astype(
        np.float32)).bfloat16() for _ in range(4))
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    port.attention_reference(qa, ka, va).backward(do)
    mine = port.attention_bwd_reference(q, k, v, do)
    assert any(not torch.equal(m, a.grad) for m, a in zip(mine, (qa, ka, va)))


def test_fused_qkv_autograd_wiring_matches_plain_autograd():
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((2, 37, 3 * 3 * 64)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 37, 3 * 64)).astype(np.float32))
    a = qkv.clone().requires_grad_(True)
    out = port.fused_qkv_attention(a, 3)
    assert out.grad_fn is not None and "FusedQKVAttention" in type(out.grad_fn).__name__
    out.backward(g)
    b = qkv.clone().requires_grad_(True)
    port.fused_qkv_attention_reference(b, 3).backward(g)
    assert a.grad.shape == qkv.shape and a.grad.is_contiguous()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=0,
                               atol=1e-5 * b.grad.abs().max().item())


def test_no_grad_path_skips_the_autograd_function():
    qkv = torch.zeros((1, 9, 3 * 2 * 64), requires_grad=True)
    with torch.no_grad():
        assert port.fused_qkv_attention(qkv, 2).grad_fn is None
    with torch.inference_mode():
        assert port.fused_qkv_attention(qkv.detach(), 2).grad_fn is None


def test_cpu_backward_counts_no_launch():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs((1, 2, 9, 64), seed=2) + _inputs((1, 2, 9, 64), seed=3)[:1])
    before = port.attention_bwd.launches
    out = tuple(torch.empty_like(q) for _ in range(3))
    got = port.attention_bwd(q, k, v, do, out=out)
    assert got is out and port.attention_bwd.launches == before
    for m, w in zip(out, port.attention_bwd_reference(q, k, v, do)):
        assert torch.equal(m, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 72, 96, 128])
def test_scaled_q_is_jax_q_times_scale(d, dtype):
    """q * Dh^-1/2 as the JAX package writes it, bit for bit: the weakly
    typed scale is rounded to q's type first (bf16 at Dh 72: 0.11767578)."""
    q = np.random.default_rng(d).standard_normal((2, 3, 64, d)).astype(np.float32)
    jq = _jax(q, dtype)
    want = _np((jq * (d ** -0.5)).astype(jq.dtype))
    mine = port.scaled_q(_torch(q, dtype))
    assert mine.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(mine), want)
    assert port.q_scale(d, getattr(torch, dtype)) == float(jnp.asarray(d ** -0.5, dtype))


def test_ring_scales_q_through_the_shared_helper(monkeypatch):
    """The ring's forward and backward take q scaled by ``scaled_q``: at Dh
    72 in bf16 its scaled q is JAX's ``(q * scale).astype(q.dtype)``
    (``parallel/sequence.py:57``), bit for bit. One rank, which exchanges
    with itself."""
    from types import SimpleNamespace

    from jpdvt_mt_ntnu_tpu_torch.parallel import sequence

    rng = np.random.default_rng(8)
    q, k, v, g = (_torch(rng.standard_normal((1, 2, 24, 72)).astype(np.float32), "bfloat16")
                  for _ in range(4))
    seen = []
    monkeypatch.setattr(sequence, "scaled_q", lambda t: seen.append(port.scaled_q(t)) or seen[-1])
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    # One rank sends to itself: the exchange is a copy.
    mesh = SimpleNamespace(exchange=lambda sends, recvs, group: [
        r.copy_(t) for (t, _), (r, _) in zip(sends, recvs)])
    out = sequence._Ring.apply(qa, ka, va, mesh, SimpleNamespace(size=1, index=0))
    out.backward(g)
    assert len(seen) == 2  # the forward's and the backward's
    jq = _jax(_np(q), "bfloat16")
    want = _np((jq * (72 ** -0.5)).astype(jq.dtype))
    for qs in seen:
        np.testing.assert_array_equal(_np(qs), want)
    np.testing.assert_allclose(_np(out.detach()), _np(port.attention_reference(q, k, v)),
                               atol=TOL["bfloat16"], rtol=0)
