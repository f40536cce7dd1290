"""Whole-row multi-head attention for the DiT (kernels K1 and K2).

Counterpart of ``jpdvt_mt_ntnu_tpu/ops/attention.py``: :func:`attention` is
the wrapper of the CUDA kernel in ``csrc/attention.cu``, which replaces the
Pallas kernel ``_attn_kernel`` (reached there through
``_attention_pallas_fwd_only`` and ``fused_qkv_attention``);
:func:`attention_reference` is its plain version, mirroring
``_attention_xla``. Semantics as timm's: scale Dh^-1/2 applied to q, no
mask, no dropout; scores and softmax in fp32, probabilities cast to the V
type, the product accumulated in fp32, the output in the input type.

:func:`attention_bwd` wraps K2 (``csrc/attention_bwd.cu``), which replaces
the backward kernel ``_attn_bwd_kernel``; :func:`attention_bwd_reference`
is its plain version. :func:`fused_qkv_attention` is differentiable: with
grad on, a ``torch.autograd.Function`` runs K1 forward and K2 backward,
saving only the fused qkv, as the JAX package's custom VJP saves only
q, k, v (``:120-136``).

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain version only for tensors on the CPU.

:func:`attention_route` picks the DiT's route, the counterpart of
``default_impl`` (``:168``), whose TPU thresholds do not carry over: the
whole-row kernels where their shared memory fits (K1; K1 + K2 with grad
on), the flash kernels K4-K6 (``ops/flash_attention.py``) beyond.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Dynamic shared memory one block may opt into on Hopper (H100, H200), the
# only target the kernels are built for (sm_90a).
HOPPER_MAX_SMEM = 232448
# model.attn_impl values the port runs: None (auto), "pallas" (the
# whole-row kernels K1/K2, as the JAX name), "flash" (K4-K6).
ATTN_IMPLS = (None, "pallas", "flash")


def k1_smem_bytes(n: int, elem: int) -> int:
    """K1's shared memory per block (``csrc/attention.cu`` ``smem_bytes``):
    K and V rows of Dh + 2, a 32-row fp32 query tile and its fp32 score rows."""
    return 2 * n * (HEAD_DIM + 2) * elem + 32 * (HEAD_DIM + 2) * 4 + 32 * (n + 1) * 4


def k2_smem_bytes(n: int, elem: int) -> int:
    """K2's shared memory per block (``csrc/attention_bwd.cu`` ``smem_bytes``):
    K, V, fp32 dK/dV accumulators, the q and dO tiles, fp32 P and dP rows."""
    row = HEAD_DIM + 2
    return 2 * n * row * elem + 2 * n * row * 4 + 2 * 32 * row * 4 + 2 * 32 * (n + 1) * 4


@functools.cache
def attention_route(n: int, dtype: torch.dtype, grad: bool, attn_impl=None, *,
                    head_dim: int = HEAD_DIM, on_card: bool = True) -> str:
    """The DiT attention's route for N tokens: ``"whole_row"`` (K1, and K2
    as its backward when ``grad``) or ``"flash"`` (K4, and K5 + K6).

    ``attn_impl`` None takes the whole-row kernels where their shared
    memory fits a Hopper block (bf16: N <= 571 without grad, <= 205 with
    it; fp32: 341 and 164) and flash beyond; ``"pallas"`` insists on the
    whole-row kernels and ``"flash"`` on the flash ones. The CPU takes the
    same route through the plain versions, which hold no limit of Dh or
    dtype; ``on_card`` adds the kernels' (Dh 64, fp32 or bf16). Raises
    ``ValueError`` naming the reason where no kernel takes the geometry."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r} is not ported; the port runs "
                         f"{ATTN_IMPLS}")
    if on_card and (head_dim != HEAD_DIM or dtype not in _DTYPE_CODES):
        raise ValueError(f"no attention kernel takes head dim {head_dim} in {dtype}; "
                         f"the kernels take Dh == {HEAD_DIM}, float32 or bfloat16")
    if attn_impl == "flash":
        return "flash"
    elem = torch.empty((), dtype=dtype).element_size()
    need = max(k1_smem_bytes(n, elem), k2_smem_bytes(n, elem) if grad else 0)
    if need <= HOPPER_MAX_SMEM:
        return "whole_row"
    if attn_impl == "pallas":
        raise ValueError(f"attn_impl='pallas' at N={n} in {dtype}"
                         f"{' with grad' if grad else ''}: the whole-row kernels "
                         f"need {need} B of shared memory per block, more than "
                         f"the {HOPPER_MAX_SMEM} B a Hopper block has")
    return "flash"


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1. q, k, v: (B, H, N, Dh) -> (B, H, N, Dh)."""
    d = q.shape[-1]
    s = torch.matmul((q * d ** -0.5).float(), k.float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor):
    """Plain PyTorch version of K2: (dq, dk, dv) of :func:`attention` for
    the output gradient ``do``, all (B, H, N, Dh).

    Mirrors ``_attn_bwd_kernel`` step by step, with its rounding points
    (not torch autograd of :func:`attention_reference`, which rounds
    elsewhere in bf16): q * scale rounded to the input type; P in fp32;
    dV = round(P)^T dO; dP = dO V^T; dS = P (dP - rowsum(dP P)) with the
    fp32 P, then rounded to the q type; dQ = dS K * scale; dK = dS^T
    (q * scale). Products in fp32, outputs in the input type."""
    scale = q.shape[-1] ** -0.5
    qs = (q * scale).float()
    p = torch.softmax(torch.matmul(qs, k.float().transpose(-1, -2)), dim=-1)
    dof = do.float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsc = ds.to(q.dtype).float()
    dq = torch.matmul(dsc, k.float()) * scale
    dk = torch.matmul(dsc.transpose(-1, -2), qs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
def _bwd_kernel():
    lib = _build.load("attention_bwd")
    fn = lib.k2_attention_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.k2_attention_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.k2_attention_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.cache
def _max_smem(device_index: int) -> int:
    return _kernel().k1_attention_max_smem(device_index)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           smem_bytes=None) -> None:
    """Raise on q, k, v that the kernels cannot take. ``smem_bytes(n,
    elem)`` is the kernel's shared memory per block (default: K1's)."""
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
    need = (smem_bytes or _kernel().k1_attention_smem_bytes)(q.shape[2], elem)
    have = _max_smem(q.device.index if q.device.index is not None
                     else torch.cuda.current_device())
    if need > have:
        raise ValueError(f"N={q.shape[2]} needs {need} B of shared memory per "
                         f"block; this device allows {have} B")


def _check_like(q: torch.Tensor, *tensors: torch.Tensor) -> None:
    """Raise unless each tensor (dO, O, the gradients) matches q's device,
    dtype and shape, with a contiguous head dim, even strides and
    pair-aligned pointers (its strides may differ from q's)."""
    for t in tensors:
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"dO, O and the outputs must match q's device, dtype "
                             f"and shape; got {t.device}, {t.dtype}, {tuple(t.shape)}")
        if t.stride(-1) != 1 or any(s % 2 for s in t.stride()[:3]) or (
                t.data_ptr() % (2 * t.element_size())):
            raise ValueError("the head dim must be contiguous, with even strides "
                             "and pair-aligned pointers")


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


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, out) -> tuple:
    """K2: writes (dq, dk, dv) of :func:`attention` for the output gradient
    ``do`` into ``out`` and returns it.

    q, k, v share (B, H, N, 64) strides; ``do`` has its own; ``out`` is
    three (B, H, N, 64) views sharing one set of strides (in the train step,
    slots of the fused-qkv gradient buffer). Each launch adds one to
    ``attention_bwd.launches``."""
    if all(t.device.type == "cpu" for t in (q, k, v, do)):
        for dst, src in zip(out, attention_bwd_reference(q, k, v, do)):
            dst.copy_(src)
        return out
    dq, dk, dv = out
    _check(q, k, v, _bwd_kernel().k2_attention_bwd_smem_bytes)
    _check_like(q, do, dq, dk, dv)
    if dk.stride() != dq.stride() or dv.stride() != dq.stride():
        raise ValueError("dq, dk and dv must share strides")
    b, h, n, d = q.shape
    err = _bwd_kernel().k2_attention_bwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *q.stride()[:3], *do.stride()[:3], *dq.stride()[:3], b, h, n,
        d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"attention backward kernel launch failed: cudaError {err}")
    attention_bwd.launches += 1
    return out


attention_bwd.launches = 0


def _heads(qkv: torch.Tensor, num_heads: int):
    b, n, f = qkv.shape
    d = f // (3 * num_heads)
    return qkv.reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)


class _FusedQKVAttention(torch.autograd.Function):
    """K1 forward, K2 backward; saves only ``qkv``."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        b, n, _ = qkv.shape
        return attention(*_heads(qkv, num_heads)).transpose(1, 2).reshape(b, n, -1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        h = ctx.num_heads
        b, n, f = qkv.shape
        d = f // (3 * h)
        grad = grad.to(qkv.dtype).contiguous()
        dqkv = torch.empty((b, n, f), dtype=qkv.dtype, device=qkv.device)
        # dq, dk, dv land in the [q|k|v][head][dim] slots of one buffer.
        attention_bwd(*_heads(qkv, h), grad.view(b, n, h, d).transpose(1, 2),
                      out=_heads(dqkv, h))
        return dqkv, None


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention from the fused qkv projection (``ops/attention.py:226``).

    qkv: (B, N, 3*H*Dh) in timm's [q|k|v][head][dim] feature order ->
    (B, N, H*Dh). q, k and v are strided views of ``qkv``; on the card the
    kernel reads them in place and writes the (B, N, H*Dh) layout. With
    grad on and ``qkv`` requiring it, the result's backward is K2; under
    ``no_grad``/``inference_mode`` K1 is called directly."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedQKVAttention.apply(qkv, num_heads)
    b, n, _ = qkv.shape
    return attention(*_heads(qkv, num_heads)).transpose(1, 2).reshape(b, n, -1)


def fused_qkv_attention_reference(qkv: torch.Tensor,
                                  num_heads: int) -> torch.Tensor:
    """Plain version of :func:`fused_qkv_attention` (``fused_qkv_attention_xla``),
    differentiated by torch autograd."""
    b, n, _ = qkv.shape
    return attention_reference(*_heads(qkv, num_heads)).transpose(1, 2).reshape(b, n, -1)
