"""Flash (KV-streaming) multi-head attention for the DiT (kernels K4, K5, K6).

Counterpart of ``jpdvt_mt_ntnu_tpu/ops/flash_attention.py``, the
FlashAttention-2 scheme: the forward streams K/V tiles through an online
softmax (running max m, normaliser l, fp32 accumulator) and saves only the
row log-sum-exp (LSE); the backward recomputes the probabilities tile by
tile, dQ in a pass that streams K/V, dK/dV in a pass that streams Q.

- :func:`flash_attention_fwd` wraps K4 (``csrc/flash_fwd.cu``), which
  replaces the Pallas kernel ``_fwd_kernel`` (``:58``);
- :func:`flash_attention_bwd` wraps K5 then K6 (``csrc/flash_bwd.cu``),
  which replace ``_dq_kernel`` (``:162``) and ``_dkv_kernel`` (``:194``);
  :func:`flash_dq` and :func:`flash_dkv` are the two launches;
- :func:`flash_attention_fwd_reference` and
  :func:`flash_attention_bwd_reference` are their plain versions, with the
  Pallas kernels' rounding points: q * Dh^-1/2 rounded to the input type
  (``scaled_q``: the scale itself rounded to that type first, as JAX
  rounds its weakly typed Python float; dQ takes the fp32 scale);
  S in fp32; the forward's product takes exp(S - m) rounded to the V type
  and divides by l at the end (K1 normalises before it rounds);
  delta = rowsum(dO * O) from the saved output in the input type (K2 takes
  rowsum(dP * P)); dS rounded to the k/q type before both products;
- :func:`fused_qkv_flash_attention` (``:341``) reads q/k/v as strided views
  of the fused projection; with grad on, an ``autograd.Function`` saves
  q, k, v (as the fused qkv), O and the LSE, as ``_flash_vjp_fwd``
  (``:357``) does, and its backward writes dq/dk/dv into the
  ``[q|k|v][head][dim]`` slots of one gradient buffer.

On a CUDA tensor a wrapper launches its kernel or raises; it takes the
plain version only for tensors on the CPU. K4 tiles the keys by
:data:`BLOCK_K`; in bf16 the rounding of exp(S - m) per tile depends on
the tiling, so the CPU path takes the plain forward at the kernel's tile.
The plain forward's default (``block_k=None``) is one tile over the whole
row, what a single-block Pallas call computes (``_pick_block`` gives one
block up to 512 tokens).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .attention import HEAD_DIM, _DTYPE_CODES, _check, _check_like, _heads, q_scale, scaled_q

BLOCK_K = 64  # key rows per tile of K4 (``kBK`` in csrc/flash_fwd.cu)


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  block_k: int | None = None):
    """Plain PyTorch version of K4: q, k, v (B, H, N, Dh) -> (o (B, H, N, Dh)
    in the input type, lse (B, H, N) fp32), the online softmax over key
    tiles of ``block_k`` (None: one tile over the whole row)."""
    b, h, n, d = q.shape
    block = k.shape[2] if block_k is None else block_k
    qs = scaled_q(q).float()
    m = torch.full((b, h, n, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, h, n, 1), device=q.device)
    acc = torch.zeros((b, h, n, d), device=q.device)
    for k0 in range(0, k.shape[2], block):
        s = torch.matmul(qs, k[:, :, k0:k0 + block].float().transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        l = l * alpha + e.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(e.to(v.dtype).float(),
                                         v[:, :, k0:k0 + block].float())
        m = m_new
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor):
    """Plain PyTorch version of K5 and K6: (dq, dk, dv), all (B, H, N, Dh)
    in the input type, from the forward's output ``o`` and ``lse`` (B, H, N)
    and the output gradient ``do``. P = exp(S - LSE) in fp32; dV =
    round(P)^T dO; dP = dO V^T; dS = P (dP - rowsum(dO O)), rounded to the
    input type; dQ = dS K * scale with the fp32 scale; dK = dS^T qs, qs =
    :func:`scaled_q` (q * scale rounded to the input type). Products in
    fp32; no rounding between tiles, so one pass over the whole row."""
    scale = q.shape[-1] ** -0.5
    qs = scaled_q(q).float()
    p = torch.exp(torch.matmul(qs, k.float().transpose(-1, -2)) - lse[..., None])
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _fwd_kernel(head_dim: int = HEAD_DIM):
    lib = _build.load(_build.unit("flash_fwd", head_dim))
    if lib.k4_flash_fwd_head_dim() != head_dim:
        raise RuntimeError(f"the K4 library for Dh {head_dim} was built for Dh "
                           f"{lib.k4_flash_fwd_head_dim()}")
    fn = lib.k4_flash_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.k4_flash_fwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.k4_flash_fwd_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.cache
def _bwd_kernel(head_dim: int = HEAD_DIM):
    lib = _build.load(_build.unit("flash_bwd", head_dim))
    if lib.k56_flash_bwd_head_dim() != head_dim:
        raise RuntimeError(f"the K5/K6 library for Dh {head_dim} was built for Dh "
                           f"{lib.k56_flash_bwd_head_dim()}")
    lib.k5_flash_dq.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                                + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.k6_flash_dkv.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                                 + [ctypes.c_float, ctypes.c_void_p])
    for fn in (lib.k5_flash_dq, lib.k6_flash_dkv):
        fn.restype = ctypes.c_int
    for fn in (lib.k5_flash_dq_smem_bytes, lib.k6_flash_dkv_smem_bytes):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_size_t
    return lib


def _check_lse(q: torch.Tensor, lse: torch.Tensor) -> None:
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != q.shape[:3] or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 (B, H, N) tensor on q's "
                         f"device; got {lse.dtype} {tuple(lse.shape)} on {lse.device}")


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K4. q, k, v: (B, H, N, Dh), Dh 64 or 72, sharing any batch/head/token
    strides -> (o (B, H, N, Dh), lse (B, H, N) fp32); q is scaled by
    ``q_scale``.

    On the card ``o`` is a (B, H, N, Dh) view of a (B, N, H, Dh) buffer, so
    ``.transpose(1, 2).reshape(B, N, H * Dh)`` is free. Each launch adds one
    to ``flash_attention_fwd.launches``."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_fwd_reference(q, k, v, BLOCK_K)
    b, h, n, d = q.shape
    _check(q, k, v, lambda n, elem: _fwd_kernel(d).k4_flash_fwd_smem_bytes(elem))
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    err = _fwd_kernel(d).k4_flash_fwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), *q.stride()[:3], *o.stride()[:3], b, h, n,
        q_scale(d, q.dtype), _stream(q))
    if err:
        raise RuntimeError(f"flash attention forward launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _check_bwd(q, k, v, o, lse, do, smem_fn: str) -> None:
    """Raise on operands the backward kernels cannot take; ``smem_fn`` names
    the library's shared-memory function of the kernel (the library is
    built only once the operands are known to lie on the card)."""
    _check(q, k, v, lambda n, elem: getattr(_bwd_kernel(q.shape[-1]), smem_fn)(elem))
    _check_like(q, o, do)
    _check_lse(q, lse)


def flash_dq(q, k, v, o, lse, do, dq: torch.Tensor) -> torch.Tensor:
    """K5: writes dq of :func:`flash_attention_fwd` into ``dq`` (a
    (B, H, N, Dh) view with its own strides). The kernel scales q by
    ``q_scale`` and dQ by the fp32 Dh^-1/2. Each launch adds one to
    ``flash_dq.launches``."""
    if all(t.device.type == "cpu" for t in (q, k, v, o, lse, do)):
        return dq.copy_(flash_attention_bwd_reference(q, k, v, o, lse, do)[0])
    _check_bwd(q, k, v, o, lse, do, "k5_flash_dq_smem_bytes")
    _check_like(q, dq)
    b, h, n, d = q.shape
    err = _bwd_kernel(d).k5_flash_dq(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), *q.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], *dq.stride()[:3], b, h, n, q_scale(d, q.dtype), d ** -0.5,
        _stream(q))
    if err:
        raise RuntimeError(f"flash attention dq launch failed: cudaError {err}")
    flash_dq.launches += 1
    return dq


flash_dq.launches = 0


def flash_dkv(q, k, v, o, lse, do, dk: torch.Tensor, dv: torch.Tensor):
    """K6: writes dk, dv of :func:`flash_attention_fwd` into ``dk`` and
    ``dv`` (two (B, H, N, Dh) views sharing strides). The kernel takes qs =
    q ``q_scale`` rounded to q's type for S and dK. Each launch adds one
    to ``flash_dkv.launches``."""
    if all(t.device.type == "cpu" for t in (q, k, v, o, lse, do)):
        _, gk, gv = flash_attention_bwd_reference(q, k, v, o, lse, do)
        return dk.copy_(gk), dv.copy_(gv)
    _check_bwd(q, k, v, o, lse, do, "k6_flash_dkv_smem_bytes")
    _check_like(q, dk, dv)
    if dv.stride() != dk.stride():
        raise ValueError("dk and dv must share strides")
    b, h, n, d = q.shape
    err = _bwd_kernel(d).k6_flash_dkv(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dk.data_ptr(), dv.data_ptr(), *q.stride()[:3],
        *o.stride()[:3], *do.stride()[:3], *dk.stride()[:3], b, h, n,
        q_scale(d, q.dtype), _stream(q))
    if err:
        raise RuntimeError(f"flash attention dk/dv launch failed: cudaError {err}")
    flash_dkv.launches += 1
    return dk, dv


flash_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, out) -> tuple:
    """K5 then K6: writes (dq, dk, dv) of :func:`flash_attention_fwd` for the
    output gradient ``do`` into ``out`` (three (B, H, N, Dh) views; in the
    train step, slots of the fused-qkv gradient buffer) and returns it."""
    dq, dk, dv = out
    if all(t.device.type == "cpu" for t in (q, k, v, o, lse, do)):
        for dst, src in zip(out, flash_attention_bwd_reference(q, k, v, o, lse, do)):
            dst.copy_(src)
        return out
    flash_dq(q, k, v, o, lse, do, dq)
    flash_dkv(q, k, v, o, lse, do, dk, dv)
    return out


class _FlashQKVAttention(torch.autograd.Function):
    """K4 forward, K5 + K6 backward; saves the fused qkv, O and the LSE."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        b, n, _ = qkv.shape
        o, lse = flash_attention_fwd(*_heads(qkv, num_heads))
        out = o.transpose(1, 2).reshape(b, n, -1)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        qkv, out, lse = ctx.saved_tensors
        h = ctx.num_heads
        b, n, f = qkv.shape
        d = f // (3 * h)
        grad = grad.to(qkv.dtype).contiguous()
        dqkv = torch.empty((b, n, f), dtype=qkv.dtype, device=qkv.device)
        flash_attention_bwd(*_heads(qkv, h), out.view(b, n, h, d).transpose(1, 2), lse,
                            grad.view(b, n, h, d).transpose(1, 2), out=_heads(dqkv, h))
        return dqkv, None


def fused_qkv_flash_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Flash attention from the fused qkv projection (``:341``).

    qkv: (B, N, 3*H*Dh) in timm's [q|k|v][head][dim] feature order ->
    (B, N, H*Dh). On the card the kernels read q, k, v in place through
    strides and write the (B, N, H*Dh) layout: unlike the JAX function, no
    head transposes. With grad on and ``qkv`` requiring it, the backward is
    K5 + K6; under ``no_grad``/``inference_mode`` K4 alone runs."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FlashQKVAttention.apply(qkv, num_heads)
    b, n, _ = qkv.shape
    o, _ = flash_attention_fwd(*_heads(qkv, num_heads))
    return o.transpose(1, 2).reshape(b, n, -1)
