"""Kernel K1 of the PyTorch port against the JAX package's attention.

The port's plain version (``attention_reference``, the path its wrapper
takes for CPU tensors) is held against the Pallas kernel run in interpret
mode (``_attention_pallas_fwd_only(..., interpret=True)``) and against the
XLA oracle ``_attention_xla``, on the same numpy inputs. The CUDA kernel
itself runs only on a card: ``tests/test_torch_port_cuda.py``.

Tolerances: fp32 differs only by summation order and exp rounding, 1e-5
absolute at |o| <= 3. bf16 rounds P and O to bf16 in both; a different
exp or sum order can flip one rounding by one bf16 ulp (2^-8 relative),
so 2e-2 absolute at |o| <= 3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.ops.attention import (
    _attention_pallas_fwd_only, _attention_xla, fused_qkv_attention,
    fused_qkv_attention_xla)
from jpdvt_mt_ntnu_tpu_torch.ops import attention as port

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SHAPES = [(2, 4, 16, 16), (1, 2, 144, 64), (2, 3, 37, 64)]


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
@pytest.mark.parametrize("shape", SHAPES, ids=["2x4x16x16", "1x2x144x64", "ragged37"])
def test_k1_plain_matches_pallas_interpret_and_xla(shape, dtype):
    q, k, v = _inputs(shape, seed=sum(shape))
    mine = _np(port.attention(*(_torch(a, dtype) for a in (q, k, v))))
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    pallas = _np(_attention_pallas_fwd_only(jq, jk, jv, interpret=True))
    xla = _np(_attention_xla(jq, jk, jv))
    np.testing.assert_allclose(mine, pallas, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(mine, xla, atol=TOL[dtype], rtol=0)


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
