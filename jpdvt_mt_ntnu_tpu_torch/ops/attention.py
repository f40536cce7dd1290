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

:func:`fused_attention_block` wraps K3 (``csrc/attention_block.cu``), the
whole attention sublayer (qkv projection, attention, output projection),
which replaces ``_attn_block_kernel`` (``:242``);
:func:`fused_attention_block_plain` is its plain version with the
kernel's rounding points, and :func:`dense_to_block_weights` lays the
port's ``Linear`` weights out for it. Its backward is torch autograd of
the plain version, as the JAX package's ``_fab_bwd`` (``:365-372``)
differentiates ``fused_attention_block_xla``.

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain version only for tensors on the CPU.

:func:`attention_route` picks the DiT's route, the counterpart of
``default_impl`` (``:168``), whose TPU thresholds do not carry over: the
whole-row kernels where their shared memory fits (K1; K1 + K2 with grad
on), the flash kernels K4-K6 (``ops/flash_attention.py``) beyond, and K3
only when ``attn_impl="block"`` asks for it (``default_impl`` never picks
it either).
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
# whole-row kernels K1/K2, as the JAX name), "flash" (K4-K6), "block" (K3,
# the whole sublayer; its backward is autograd of the plain version).
ATTN_IMPLS = (None, "pallas", "flash", "block")


def k1_smem_bytes(n: int, elem: int) -> int:
    """K1's shared memory per block (``csrc/attention.cu`` ``smem_bytes``):
    K and V rows of Dh + 2, a 32-row fp32 query tile and its fp32 score rows."""
    return 2 * n * (HEAD_DIM + 2) * elem + 32 * (HEAD_DIM + 2) * 4 + 32 * (n + 1) * 4


def k2_smem_bytes(n: int, elem: int) -> int:
    """K2's shared memory per block (``csrc/attention_bwd.cu`` ``smem_bytes``):
    K, V, fp32 dK/dV accumulators, the q and dO tiles, fp32 P and dP rows."""
    row = HEAD_DIM + 2
    return 2 * n * row * elem + 2 * n * row * 4 + 2 * 32 * row * 4 + 2 * 32 * (n + 1) * 4


def k3_smem_bytes(n: int, elem: int) -> int:
    """K3's shared memory per block of its first launch
    (``csrc/attention_block.cu`` ``smem_bytes``): q, k, v of one (item,
    head) with rows of Dh + 2, rounded up to 16 B, then the larger of the
    projection's staged chunks (48 x 33 and 32 x 192 fp32) and a 32-row
    query tile's fp32 score rows."""
    qkv = -(-3 * n * (HEAD_DIM + 2) * elem // 16) * 16
    return qkv + max((48 * 33 + 32 * 3 * HEAD_DIM) * 4, 32 * (n + 1) * 4)


@functools.cache
def attention_route(n: int, dtype: torch.dtype, grad: bool, attn_impl=None, *,
                    head_dim: int = HEAD_DIM, on_card: bool = True) -> str:
    """The DiT attention's route for N tokens: ``"whole_row"`` (K1, and K2
    as its backward when ``grad``), ``"flash"`` (K4, and K5 + K6) or
    ``"block"`` (K3, the whole sublayer, only when ``attn_impl`` is
    ``"block"``; bf16 N <= 443, fp32 N <= 252 on the card).

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
    if attn_impl == "block":
        if on_card and k3_smem_bytes(n, elem) > HOPPER_MAX_SMEM:
            raise ValueError(f"attn_impl='block' at N={n} in {dtype}: K3 keeps one "
                             f"(item, head)'s q, k, v in {k3_smem_bytes(n, elem)} B of "
                             f"shared memory per block, more than the "
                             f"{HOPPER_MAX_SMEM} B a Hopper block has")
        return "block"
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


def dense_to_block_weights(qkv_weight: torch.Tensor, qkv_bias: torch.Tensor,
                           proj_weight: torch.Tensor, proj_bias: torch.Tensor,
                           num_heads: int):
    """The port's ``Linear`` parameters (weight (out, in)) -> K3's layouts
    (``ops/attention.py:376``): w_qkv (3H, D, Dh) with q rows 0..H-1, k rows
    H..2H-1, v rows 2H..3H-1; b_qkv (3H, 1, Dh); w_proj (H, Dh, D); b_proj
    (1, D). Types are kept as given."""
    hidden = qkv_weight.shape[1]
    d = qkv_weight.shape[0] // (3 * num_heads)
    w_qkv = qkv_weight.t().reshape(hidden, 3 * num_heads, d).permute(1, 0, 2).contiguous()
    b_qkv = qkv_bias.reshape(3 * num_heads, 1, d)
    w_proj = proj_weight.t().reshape(num_heads, d, proj_weight.shape[0]).contiguous()
    b_proj = proj_bias.reshape(1, -1)
    return w_qkv, b_qkv, w_proj, b_proj


def fused_attention_block_plain(x: torch.Tensor, w_qkv: torch.Tensor,
                                b_qkv: torch.Tensor, w_proj: torch.Tensor,
                                b_proj: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of K3 with ``_attn_block_kernel``'s rounding
    points (T is ``x.dtype``): q = T(x Wq + bq) * Dh^-1/2 in T, k and v
    alike unscaled, products in fp32 and the biases added in fp32; S = q k^T
    and the softmax in fp32; o_h = T(T(P) v); out = T(sum_h o_h Wp_h + bp),
    summed over the heads in order in fp32. x: (B, N, D) -> (B, N, D).
    Differentiable by torch autograd."""
    dt, h = x.dtype, num_heads
    d = w_qkv.shape[-1]
    xf = x.float()

    def proj(i: int) -> torch.Tensor:  # (B, H, N, Dh)
        y = torch.einsum("bnk,hkd->bhnd", xf, w_qkv[i * h:(i + 1) * h].float())
        return (y + b_qkv[i * h:(i + 1) * h].float()[None]).to(dt)

    q = proj(0) * d ** -0.5
    k, v = proj(1), proj(2)
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)), dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float()).to(dt)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(h):
        acc = acc + torch.matmul(o[:, i].float(), w_proj[i].float())
    return (acc + b_proj.float()).to(dt)


@functools.cache
def _block_kernel():
    lib = _build.load("attention_block")
    fn = lib.k3_attention_block
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.k3_attention_block_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.k3_attention_block_smem_bytes.restype = ctypes.c_size_t
    lib.k3_attention_block_max_smem.argtypes = [ctypes.c_int]
    lib.k3_attention_block_max_smem.restype = ctypes.c_int
    return lib


def _check_block(x, w_qkv, b_qkv, w_proj, b_proj, num_heads: int) -> None:
    """Raise on operands that K3 cannot take."""
    tensors = (x, w_qkv, b_qkv, w_proj, b_proj)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("K3 needs x and the weights on one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPE_CODES or w_qkv.dtype != x.dtype or w_proj.dtype != x.dtype:
        raise ValueError(f"K3 takes float32 or bfloat16 x and weights of one dtype; got "
                         f"{x.dtype}, {w_qkv.dtype}, {w_proj.dtype}")
    if b_qkv.dtype != torch.float32 or b_proj.dtype != torch.float32:
        raise ValueError(f"K3 takes float32 biases; got {b_qkv.dtype}, {b_proj.dtype}")
    if x.dim() != 3 or x.shape[1] < 1:
        raise ValueError(f"K3 takes x of shape (B, N, D), N >= 1; got {tuple(x.shape)}")
    b, n, hidden = x.shape
    h, d = num_heads, HEAD_DIM
    want = {"w_qkv": (3 * h, hidden, d), "b_qkv": (3 * h, 1, d),
            "w_proj": (h, d, hidden), "b_proj": (1, hidden)}
    for name, t in zip(want, tensors[1:]):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"K3 needs Dh == {HEAD_DIM}: {name} of shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
    if hidden % 64:
        raise ValueError(f"K3 needs a hidden size that is a multiple of 64; got {hidden}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K3 takes contiguous x and weights")
    need = _block_kernel().k3_attention_block_smem_bytes(n, x.element_size())
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    have = _block_kernel().k3_attention_block_max_smem(dev)
    if need > have:
        raise ValueError(f"K3 at N={n} needs {need} B of shared memory per block; "
                         f"this device allows {have} B")


def _launch_block(x, w_qkv, b_qkv, w_proj, b_proj, num_heads: int) -> torch.Tensor:
    _check_block(x, w_qkv, b_qkv, w_proj, b_proj, num_heads)
    b, n, hidden = x.shape
    o = torch.empty((b, n, num_heads * HEAD_DIM), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    err = _block_kernel().k3_attention_block(
        _DTYPE_CODES[x.dtype], x.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(),
        w_proj.data_ptr(), b_proj.data_ptr(), o.data_ptr(), out.data_ptr(), b, n,
        num_heads, hidden, HEAD_DIM ** -0.5,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"attention block kernel launch failed: cudaError {err}")
    fused_attention_block.launches += 1
    return out


class _FusedAttentionBlock(torch.autograd.Function):
    """K3 forward; backward by torch autograd of the plain version (the
    JAX package's rule: its custom VJP differentiates the XLA reference)."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, w_proj, b_proj, num_heads: int):
        ctx.save_for_backward(x, w_qkv, b_qkv, w_proj, b_proj)
        ctx.num_heads = num_heads
        return _launch_block(x, w_qkv, b_qkv, w_proj, b_proj, num_heads)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = fused_attention_block_plain(*inputs, ctx.num_heads)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None)


def fused_attention_block(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                          w_proj: torch.Tensor, b_proj: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """K3: the whole attention sublayer. x (B, N, D) -> (B, N, D); weights in
    :func:`dense_to_block_weights`' layouts, in x's type, biases float32.

    On the card each call launches the pair of kernels once and adds one to
    ``fused_attention_block.launches``; with grad on, the result's backward
    is autograd of :func:`fused_attention_block_plain`. On the CPU it is
    the plain version."""
    tensors = (x, w_qkv, b_qkv, w_proj, b_proj)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_attention_block_plain(x, w_qkv, b_qkv, w_proj, b_proj, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _FusedAttentionBlock.apply(x, w_qkv, b_qkv, w_proj, b_proj, num_heads)
    return _launch_block(x, w_qkv, b_qkv, w_proj, b_proj, num_heads)


fused_attention_block.launches = 0
