"""Whole-row multi-head attention for the DiT (kernel K1).

Counterpart of ``jpdvt_mt_ntnu_tpu/ops/attention.py``: :func:`attention` is
the wrapper of the CUDA kernel in ``csrc/attention.cu``, which replaces the
Pallas kernel ``_attn_kernel`` (reached there through
``_attention_pallas_fwd_only`` and ``fused_qkv_attention``);
:func:`attention_reference` is its plain version, mirroring
``_attention_xla``. Semantics as timm's: scale Dh^-1/2 applied to q, no
mask, no dropout; scores and softmax in fp32, probabilities cast to the V
type, the product accumulated in fp32, the output in the input type.

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain version only for tensors on the CPU. The DiT's attention on the card
always goes through the kernel: the TPU package's routing by sequence
length (``default_impl``) was a TPU measurement and is not carried over.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1. q, k, v: (B, H, N, Dh) -> (B, H, N, Dh)."""
    d = q.shape[-1]
    s = torch.matmul((q * d ** -0.5).float(), k.float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


@functools.cache
def _kernel():
    lib = _build.load("attention")
    fn = lib.k1_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.k1_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.k1_attention_smem_bytes.restype = ctypes.c_size_t
    lib.k1_attention_max_smem.argtypes = [ctypes.c_int]
    lib.k1_attention_max_smem.restype = ctypes.c_int
    return lib


@functools.cache
def _max_smem(device_index: int) -> int:
    return _kernel().k1_attention_max_smem(device_index)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"attention kernel needs q, k, v on one CUDA device; "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention kernel takes float32 or bfloat16 q, k, v "
                         f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, N, Dh) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != HEAD_DIM or q.shape[2] < 1:
        raise ValueError(f"attention kernel needs Dh == {HEAD_DIM} and N >= 1; "
                         f"got shape {tuple(q.shape)}")
    if k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError("q, k and v must share strides")
    elem = q.element_size()
    if q.stride(-1) != 1 or any(s % 2 for s in q.stride()[:3]) or any(
            t.data_ptr() % (2 * elem) for t in (q, k, v)):
        raise ValueError("the head dim must be contiguous, with even strides "
                         "and pair-aligned pointers")
    need = _kernel().k1_attention_smem_bytes(q.shape[2], elem)
    have = _max_smem(q.device.index if q.device.index is not None
                     else torch.cuda.current_device())
    if need > have:
        raise ValueError(f"N={q.shape[2]} needs {need} B of shared memory per "
                         f"block; this device allows {have} B")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K1. q, k, v: (B, H, N, 64), any batch/head/token strides -> (B, H, N, 64).

    On the card the output is a (B, H, N, Dh) view of a (B, N, H, Dh)
    buffer, so ``.transpose(1, 2).reshape(B, N, H * Dh)`` is free. Each
    launch adds one to ``attention.launches``."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_reference(q, k, v)
    _check(q, k, v)
    b, h, n, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    err = _kernel().k1_attention_fwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), *q.stride()[:3], *out.stride()[:3], b, h, n,
        d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    attention.launches += 1
    return out


attention.launches = 0


def _heads(qkv: torch.Tensor, num_heads: int):
    b, n, f = qkv.shape
    d = f // (3 * num_heads)
    return qkv.reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention from the fused qkv projection (``ops/attention.py:226``).

    qkv: (B, N, 3*H*Dh) in timm's [q|k|v][head][dim] feature order ->
    (B, N, H*Dh). q, k and v are strided views of ``qkv``; on the card the
    kernel reads them in place and writes the (B, N, H*Dh) layout."""
    b, n, _ = qkv.shape
    return attention(*_heads(qkv, num_heads)).transpose(1, 2).reshape(b, n, -1)


def fused_qkv_attention_reference(qkv: torch.Tensor,
                                  num_heads: int) -> torch.Tensor:
    """Plain version of :func:`fused_qkv_attention` (``fused_qkv_attention_xla``)."""
    b, n, _ = qkv.shape
    return attention_reference(*_heads(qkv, num_heads)).transpose(1, 2).reshape(b, n, -1)
