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

The attention sublayer of ``model.attn_impl="block"`` (qkv projection,
attention, output projection) is :func:`fused_attention_block`, which
computes what the JAX package's ``fused_attention_block`` (``:299-327``)
computes: by the JAX rule :func:`_block_bb` (a copy of ``:272-296``), the
Pallas kernel ``_attn_block_kernel`` (``:242``) where one program fits a
TPU core's VMEM budget, else ``fused_attention_block_xla`` (``:330``),
which rounds elsewhere. The first is K3, wrapped by
:func:`fused_attention_block_k3` (``csrc/attention_block.cu``: a
short-row instance keeping q, k, v of one (item, head) in shared memory,
and a long-row one, for any N, its projection and attention on Hopper's
``wgmma`` through a global q, k, v scratch, which :func:`k3_instance`
takes at every N, the short-row one its bit-for-bit reference;
:func:`k3_long_stages` times its three launches apart);
:func:`fused_attention_block_plain` is its plain version with the
kernel's rounding points. The second is :func:`fused_attention_block_xla`
(on the card, cuBLAS projections around K1 or K4) with its plain version
:func:`fused_attention_block_xla_plain`. :func:`dense_to_block_weights`
views the port's ``Linear`` parameters in their shapes, with no copy. The
backward, at every geometry, is torch autograd of
:func:`fused_attention_block_xla_plain`, as the JAX package's ``_fab_bwd``
(``:365-372``) differentiates ``fused_attention_block_xla``.

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain version only for tensors on the CPU.

:func:`attention_route` picks the DiT's route, the counterpart of
``default_impl`` (``:168``), whose TPU thresholds do not carry over: the
whole-row kernels where their shared memory fits (K1; K1 + K2 with grad
on, up to ``WHOLE_ROW_GRAD_MAX_N`` of the head dim), the flash kernels K4-K6
(``ops/flash_attention.py``) beyond, and the sublayer of
:func:`fused_attention_block` only when ``attn_impl="block"`` asks for it
(``default_impl`` never picks it either).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# Head dims the kernels take: K1-K6 are each built once per head dim in
# HEAD_DIMS (``csrc/*.cu`` compiled with ``-DHEAD_DIM=<Dh>``,
# ``_build.unit``); HEAD_DIM is the sources' default, the JPDVT flagship's.
HEAD_DIM = 64
HEAD_DIMS = (64, 72)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Dynamic shared memory one block may opt into on Hopper (H100, H200), the
# only target the kernels are built for (sm_90a).
HOPPER_MAX_SMEM = 232448
# model.attn_impl values the port runs: None (auto), "pallas" (the
# whole-row kernels K1/K2, as the JAX name), "flash" (K4-K6), "block" (the
# whole sublayer: K3 or the XLA composition by the JAX rule, its backward
# autograd of the composition's plain version).
ATTN_IMPLS = (None, "pallas", "flash", "block")
# With grad, the default route takes the whole-row kernels (K1 + K2) up to
# this N, by head dim, and the flash kernels beyond. Dh 64: the route the
# train step ran while K2 kept fp32 dK and dV accumulators in shared
# memory, which fit a Hopper block only up to N = 205; K2's bf16 kernels
# now fit at every N, and ROADMAP §2 re-decides the route from
# measurements (tools/bench_attention_routes.py). Dh 72: 0, flash at every
# N: on an H100, K4 + K5 + K6 was faster than K1 + K2 at batch 32 and 96
# for every N measured (144, 196, 256, 324, 576), or within 1% (N = 144,
# batch 32); K1 + K2 was faster only at batch 8 and N <= 196 (PERF.md §6).
WHOLE_ROW_GRAD_MAX_N = {64: 205, 72: 0}


def smem_row(head_dim: int) -> int:
    """Elements of a bf16 K/V row in the tensor-core kernels' shared memory
    (``kRow``): Dh + 8 where that is an odd count of 16-byte units (64: 72,
    144 B), else Dh + 16 (72: 88, 176 B), so that the eight rows of an
    ``ldmatrix`` fall on distinct banks."""
    return head_dim + 8 if head_dim // 8 % 2 == 0 else head_dim + 16


def k1_smem_bytes(n: int, elem: int, head_dim: int = HEAD_DIM) -> int:
    """K1's shared memory per block (``csrc/attention.cu`` ``smem_bytes``).
    bf16: two stages of 64-key chunks of K and V with rows of
    :func:`smem_row`, the same at every N. fp32: K and V whole with rows of
    Dh + 2, a 32-row fp32 query tile and its fp32 score rows."""
    if elem == 2:
        return 2 * 2 * 64 * smem_row(head_dim) * elem
    return 2 * n * (head_dim + 2) * elem + 32 * (head_dim + 2) * 4 + 32 * (n + 1) * 4


def k2_smem_bytes(n: int, elem: int, head_dim: int = HEAD_DIM) -> int:
    """K2's shared memory per block (``csrc/attention_bwd.cu``
    ``k2_attention_bwd_smem_bytes``). bf16: the larger of its two kernels',
    the same at every N: the row kernel's two stages of 64-key K and V
    chunks with rows of :func:`smem_row` (36,864 B at Dh 64, 45,056 B at
    72), the column kernel's two stages of 64-row q and dO chunks with each
    row's three fp32 statistics (38,400 B, 46,592 B). fp32: the scalar
    kernel's K, V, fp32 dK/dV accumulators, the q and dO tiles, fp32 P and
    dP rows, all rows of Dh + 2 (N <= 164 at Dh 64, 148 at 72)."""
    if elem == 2:
        stage = 64 * smem_row(head_dim) * elem
        return max(2 * 2 * stage, 2 * (2 * stage + 3 * 64 * 4))
    row = head_dim + 2
    return 2 * n * row * elem + 2 * n * row * 4 + 2 * 32 * row * 4 + 2 * 32 * (n + 1) * 4


def k3_smem_bytes(n: int, elem: int, head_dim: int = HEAD_DIM) -> int:
    """Shared memory per block of K3's short-row instance, first launch
    (``csrc/attention_block.cu`` ``smem_bytes``). bf16: q, k, v of one
    (item, head), N padded to 16, with rows of :func:`smem_row`, then the
    staged chunks of x (144 rows) and of the head's q|k|v weights (3 Dh
    rows), 64 wide in rows of 72 (N <= 416 at Dh 64, 336 at 72). fp32: q,
    k, v with rows of Dh + 2, rounded up to 16 B, then the larger of the
    projection's staged chunks (48 x 33 and 32 x 3 Dh fp32) and a 32-row
    query tile's fp32 score rows (N <= 252 at Dh 64, 223 at 72). Past these
    ``instance="short"`` is refused."""
    if elem == 2:
        row = smem_row(head_dim) * elem
        return 3 * -(-n // 16) * 16 * row + (144 + 3 * head_dim) * 72 * elem
    qkv = -(-3 * n * (head_dim + 2) * elem // 16) * 16
    return qkv + max((48 * 33 + 32 * 3 * head_dim) * 4, 32 * (n + 1) * 4)


def k3_padded_dims(head_dim: int) -> int:
    """Dims of a q or k row in the bf16 long-row instance's scratch
    (``kDP``): the head dim rounded up to the 16 of a k16 step (72: 80, dims
    72-79 zero)."""
    return -(-head_dim // 16) * 16


# Rows of x a block of the long-row instance's projection (L.1) takes, by head
# dim (``kP1Rows``): 3 warpgroups of 64 at Dh 64, 2 at Dh 72, whose 108
# accumulators a thread need the registers of a smaller block.
K3_LONG_PROJECT_ROWS = {64: 192, 72: 128}


def k3_long_kv_whole(n: int, head_dim: int = HEAD_DIM) -> bool:
    """Whether the bf16 long-row instance's attention launch (L.2) takes one
    head's k and v whole into shared memory (``long_kv_whole``): 64-key
    chunks of k (rows of :func:`k3_padded_dims`) and of v, and two mbarriers
    a chunk, within a Hopper block's 232,448 B (N <= 896 at Dh 64, 704 at
    72); past that they stream through a ring of four chunks."""
    chunk = 64 * (k3_padded_dims(head_dim) + head_dim) * 2 + 16  # k, v and 2 mbarriers
    return -(-n // 64) * chunk <= HOPPER_MAX_SMEM


def k3_long_smem_bytes(n: int, elem: int, head_dim: int = HEAD_DIM) -> int:
    """The most shared memory one block of K3's long-row instance takes
    (``csrc/attention_block.cu`` ``long_smem_bytes``). bf16: the larger of
    L.1's (a ring of four 64-wide K-chunks of ``K3_LONG_PROJECT_ROWS`` rows
    of x and of the head's 3 Dh weight rows, two mbarriers a stage, 1,024 B
    of alignment) and L.2's (:func:`k3_long_kv_whole`: the head's k and v
    whole, else four 64-key chunks of each). fp32: a 32-row query tile and a 64-row chunk
    with rows of Dh + 2, and the tile's fp32 score rows (N <= 1,617 at Dh
    64, 1,593 at 72)."""
    if elem == 2:
        stage = 64 * (k3_padded_dims(head_dim) + head_dim) * 2 + 16
        attend = -(-n // 64) * stage if k3_long_kv_whole(n, head_dim) else 4 * stage
        rows = K3_LONG_PROJECT_ROWS[head_dim]
        project = 4 * (rows + 3 * head_dim) * 128 + 4 * 2 * 8 + 1024
        return max(project, attend)
    return (32 + 64) * (head_dim + 2) * 4 + 32 * (n + 1) * 4


def k3_long_scratch_elems(b: int, n: int, heads: int, elem: int,
                          head_dim: int = HEAD_DIM) -> int:
    """Elements of the long-row instance's q, k, v scratch: three (B, H)
    slots of N rounded up to 16 rows of Dh elements (fp32), or to 32 rows
    (a 32-key group) of :func:`k3_padded_dims` (bf16)."""
    if elem == 2:
        return 3 * b * heads * -(-n // 32) * 32 * k3_padded_dims(head_dim)
    return 3 * b * heads * -(-n // 16) * 16 * head_dim


def k3_instance(n: int, dtype: torch.dtype, head_dim: int = HEAD_DIM) -> str:
    """Which of K3's two instances :func:`fused_attention_block_k3` launches
    at (N, Dh, dtype): the long-row one (projected into a global scratch)
    at every one. With its projection and attention on ``wgmma`` it is the
    faster at 182 of the 192 rows of ``tools/bench_attention_routes --k3
    --batch 8 32 96`` on an H100 (the registry's four widths, bf16 and
    fp32, N up to the short-row instance's shared memory); the short-row
    one (q, k and v of one item and head whole in shared memory) only at
    batch 8 or DiT-S's width, where host time per call is most of a call,
    by up to 18%. Taking the long-row one everywhere is within 0.4% of the per-row
    best (PERF.md section 6). The short-row instance stays its bit-for-bit
    reference, behind ``instance="short"``."""
    return "long"


# The JAX package's rule for what its ``block`` computes, copied from
# jpdvt_mt_ntnu_tpu/ops/attention.py:272-296: the Pallas K3 where one
# program (``bb`` items) fits a 12 MiB budget of a TPU core's VMEM, else
# ``fused_attention_block_xla``. A TPU budget, kept because it decides which
# function ``block`` computes (they round at other points), so the port
# computes the same one.
_VMEM_BUDGET = 12 * 1024 * 1024  # leave headroom of the ~16 MB per core


def _block_vmem(bb, n, heads, d, hidden, itemsize) -> int:
    weights = (3 * heads * hidden * d + heads * d * hidden) * itemsize
    blocks = 2 * bb * n * hidden * itemsize        # x + out
    work = n * hidden * 4 + 3 * n * n * 4          # fp32 acc + score temps
    return weights + blocks + work


def _block_bb(b: int, n: int, heads: int, d: int, hidden: int,
              itemsize: int, bb: int | None = None) -> int | None:
    """Batch items per program: amortize launch overhead under a VMEM
    budget (weights are grid-invariant, fetched once)."""
    if bb is None:
        bb = 8 if n <= 160 else (4 if n <= 384 else 1)
    while b % bb:
        bb //= 2
    bb = max(bb, 1)
    while bb > 1 and _block_vmem(bb, n, heads, d, hidden, itemsize) > _VMEM_BUDGET:
        bb //= 2
    if _block_vmem(bb, n, heads, d, hidden, itemsize) > _VMEM_BUDGET:
        return None
    return bb


@functools.cache
def attention_route(n: int, dtype: torch.dtype, grad: bool, attn_impl=None, *,
                    head_dim: int = HEAD_DIM, on_card: bool = True) -> str:
    """The DiT attention's route for N tokens: ``"whole_row"`` (K1, and K2
    as its backward when ``grad``), ``"flash"`` (K4, and K5 + K6) or
    ``"block"`` (the whole sublayer, :func:`fused_attention_block`, only
    when ``attn_impl`` is ``"block"``, at every N: K3 where the JAX rule
    runs its kernel, else the XLA composition on K1 or K4).

    ``attn_impl`` None takes the whole-row kernels where their shared
    memory fits a Hopper block (bf16: every N; fp32 at Dh 64: 341 without
    grad and 164 with it, at Dh 72: 309 and 148), with grad up to
    ``WHOLE_ROW_GRAD_MAX_N`` of the head dim (205 at Dh 64, past fp32's
    164; 0 at 72, flash at every N, by measurement), and flash beyond;
    ``"pallas"`` insists on the whole-row kernels (bf16: every N, with grad
    too) and ``"flash"`` on the flash ones. The CPU takes the same route
    through the plain versions, which hold no limit of Dh or dtype (a Dh
    outside ``HEAD_DIMS`` routes by the Dh-64 table); ``on_card`` adds the
    kernels' limits (Dh 64 or 72, fp32 or bf16). Raises ``ValueError``
    naming the reason where no kernel takes the geometry."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r} is not ported; the port runs "
                         f"{ATTN_IMPLS}")
    if on_card and (head_dim not in HEAD_DIMS or dtype not in _DTYPE_CODES):
        raise ValueError(f"no attention kernel takes head dim {head_dim} in {dtype}; "
                         f"the kernels take Dh 64 or 72, float32 or bfloat16")
    if attn_impl in ("flash", "block"):
        return attn_impl
    d = head_dim if head_dim in HEAD_DIMS else HEAD_DIM
    elem = torch.empty((), dtype=dtype).element_size()
    need = max(k1_smem_bytes(n, elem, d), k2_smem_bytes(n, elem, d) if grad else 0)
    if need > HOPPER_MAX_SMEM:
        if attn_impl == "pallas":
            raise ValueError(f"attn_impl='pallas' at N={n}, Dh {d} in {dtype}"
                             f"{' with grad' if grad else ''}: the whole-row kernels "
                             f"need {need} B of shared memory per block, more than "
                             f"the {HOPPER_MAX_SMEM} B a Hopper block has")
        return "flash"
    if attn_impl is None and grad and n > WHOLE_ROW_GRAD_MAX_N[d]:
        return "flash"
    return "whole_row"


@functools.cache
def q_scale(head_dim: int, dtype: torch.dtype) -> float:
    """s_q = T(Dh^-1/2), the factor q is scaled by: the JAX package writes
    ``q * (d ** -0.5)``, and the weakly typed Python float is rounded to
    q's type T first. bf16 at Dh 72: 0.11767578, not 0.11785113; at a
    power of two (Dh 16, 64) nothing is rounded. dQ is scaled by the fp32
    Dh^-1/2 (``dq * scale`` on an fp32 product), not by this."""
    return torch.tensor(head_dim ** -0.5, dtype=dtype).item()


def scaled_q(q: torch.Tensor) -> torch.Tensor:
    """qs = T(q s_q) in q's type T, as the JAX package's ``q * (d ** -0.5)``:
    the product of two bf16 numbers is exact in fp32, so PyTorch's fp32
    product of q and the bf16-valued scale is rounded once, to the same
    number. Every plain version, the ring and the kernels (through the
    scale their wrappers pass) scale q so."""
    return q * q_scale(q.shape[-1], q.dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1. q, k, v: (B, H, N, Dh) -> (B, H, N, Dh)."""
    s = torch.matmul(scaled_q(q).float(), k.float().transpose(-1, -2))
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
    fp32 P, then rounded to the q type; dQ = dS K * scale with the fp32
    scale; dK = dS^T qs with qs = :func:`scaled_q` (q * scale rounded to the
    input type). Products in fp32, outputs in the input type."""
    scale = q.shape[-1] ** -0.5
    qs = scaled_q(q).float()
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
def _kernel(head_dim: int = HEAD_DIM):
    lib = _build.load(_build.unit("attention", head_dim))
    if lib.k1_attention_head_dim() != head_dim:
        raise RuntimeError(f"the K1 library for Dh {head_dim} was built for Dh "
                           f"{lib.k1_attention_head_dim()}")
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
def _bwd_kernel(head_dim: int = HEAD_DIM):
    lib = _build.load(_build.unit("attention_bwd", head_dim))
    if lib.k2_attention_bwd_head_dim() != head_dim:
        raise RuntimeError(f"the K2 library for Dh {head_dim} was built for Dh "
                           f"{lib.k2_attention_bwd_head_dim()}")
    fn = lib.k2_attention_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.k2_attention_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.k2_attention_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.cache
def _max_smem(device_index: int, head_dim: int) -> int:
    return _kernel(head_dim).k1_attention_max_smem(device_index)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, smem_bytes=None) -> None:
    """Raise on q, k, v that the kernels cannot take. ``smem_bytes(n,
    elem)`` is the kernel's shared memory per block at q's head dim
    (default: K1's), called once the head dim is known to be built."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"attention kernel needs q, k, v on one CUDA device; "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention kernel takes float32 or bfloat16 q, k, v "
                         f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, N, Dh) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] not in HEAD_DIMS or q.shape[2] < 1:
        raise ValueError(f"attention kernel needs Dh in {HEAD_DIMS} and N >= 1; "
                         f"got shape {tuple(q.shape)}")
    if k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError("q, k and v must share strides")
    elem = q.element_size()
    if q.stride(-1) != 1 or any(s % 2 for s in q.stride()[:3]) or any(
            t.data_ptr() % (2 * elem) for t in (q, k, v)):
        raise ValueError("the head dim must be contiguous, with even strides "
                         "and pair-aligned pointers")
    need = (smem_bytes or _kernel(q.shape[-1]).k1_attention_smem_bytes)(q.shape[2], elem)
    have = _max_smem(q.device.index if q.device.index is not None
                     else torch.cuda.current_device(), q.shape[-1])
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
    """K1. q, k, v: (B, H, N, Dh), Dh 64 or 72, any batch/head/token strides
    -> (B, H, N, Dh).

    On the card the output is a (B, H, N, Dh) view of a (B, N, H, Dh)
    buffer, so ``.transpose(1, 2).reshape(B, N, H * Dh)`` is free. The
    kernel scales q by :func:`q_scale`. Each launch adds one to
    ``attention.launches``."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_reference(q, k, v)
    _check(q, k, v)
    b, h, n, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    err = _kernel(d).k1_attention_fwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), *q.stride()[:3], *out.stride()[:3], b, h, n,
        q_scale(d, q.dtype), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    attention.launches += 1
    return out


attention.launches = 0


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, out) -> tuple:
    """K2: writes (dq, dk, dv) of :func:`attention` for the output gradient
    ``do`` into ``out`` and returns it.

    q, k, v share (B, H, N, Dh) strides, Dh 64 or 72; ``do`` has its own;
    ``out`` is three (B, H, N, Dh) views sharing one set of strides (in the
    train step, slots of the fused-qkv gradient buffer). The kernels scale
    q by :func:`q_scale` and dQ by the fp32 Dh^-1/2. In bf16 the call is
    two kernels joined by a float32 (3, B, H, N) workspace of the rows'
    softmax statistics, allocated here on q's device. Each call adds one to
    ``attention_bwd.launches``."""
    if all(t.device.type == "cpu" for t in (q, k, v, do)):
        for dst, src in zip(out, attention_bwd_reference(q, k, v, do)):
            dst.copy_(src)
        return out
    dq, dk, dv = out
    _check(q, k, v, lambda n, elem: _bwd_kernel(q.shape[-1]).k2_attention_bwd_smem_bytes(
        n, elem))
    _check_like(q, do, dq, dk, dv)
    if dk.stride() != dq.stride() or dv.stride() != dq.stride():
        raise ValueError("dq, dk and dv must share strides")
    b, h, n, d = q.shape
    # The bf16 kernels' row statistics, alive until the launches are queued;
    # the fp32 kernel takes none.
    ws = (torch.empty((3, b, h, n), dtype=torch.float32, device=q.device)
          if q.dtype == torch.bfloat16 else None)
    err = _bwd_kernel(d).k2_attention_bwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ws if ws is None else ws.data_ptr(), *q.stride()[:3], *do.stride()[:3],
        *dq.stride()[:3], b, h, n, q_scale(d, q.dtype), d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
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
    """The port's ``Linear`` parameters (weight (out, in)) -> K3's shapes
    (``ops/attention.py:376``): w_qkv (3H, D, Dh) with q rows 0..H-1, k rows
    H..2H-1, v rows 2H..3H-1; b_qkv (3H, 1, Dh); w_proj (H, Dh, D); b_proj
    (1, D). All four are views of the parameters (nothing is copied): the
    weights keep the ``Linear`` layout, the one K3's bf16 kernels read.
    Types are kept as given."""
    hidden = qkv_weight.shape[1]
    d = qkv_weight.shape[0] // (3 * num_heads)
    w_qkv = qkv_weight.view(3 * num_heads, d, hidden).transpose(1, 2)
    b_qkv = qkv_bias.reshape(3 * num_heads, 1, d)
    w_proj = proj_weight.t().view(num_heads, d, proj_weight.shape[0])
    b_proj = proj_bias.reshape(1, -1)
    return w_qkv, b_qkv, w_proj, b_proj


def fused_attention_block_plain(x: torch.Tensor, w_qkv: torch.Tensor,
                                b_qkv: torch.Tensor, w_proj: torch.Tensor,
                                b_proj: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of K3 with ``_attn_block_kernel``'s rounding
    points (T is ``x.dtype``): q = T(x Wq + bq) * Dh^-1/2 in T
    (:func:`scaled_q`), k and v alike unscaled, products in fp32 and the
    biases added in fp32; S = q k^T and the softmax in fp32; o_h = T(T(P)
    v); out = T(sum_h o_h Wp_h + bp), summed over the heads in order in
    fp32. x: (B, N, D) -> (B, N, D)."""
    dt, h = x.dtype, num_heads
    xf = x.float()

    def proj(i: int) -> torch.Tensor:  # (B, H, N, Dh)
        y = torch.einsum("bnk,hkd->bhnd", xf, w_qkv[i * h:(i + 1) * h].float())
        return (y + b_qkv[i * h:(i + 1) * h].float()[None]).to(dt)

    q = scaled_q(proj(0))
    k, v = proj(1), proj(2)
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)), dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float()).to(dt)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(h):
        acc = acc + torch.matmul(o[:, i].float(), w_proj[i].float())
    return (acc + b_proj.float()).to(dt)


def fused_attention_block_xla_plain(x: torch.Tensor, w_qkv: torch.Tensor,
                                    b_qkv: torch.Tensor, w_proj: torch.Tensor,
                                    b_proj: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of ``fused_attention_block_xla`` (``:330``),
    with its rounding points (T is ``x.dtype``): q, k, v = T(T(x W_h) +
    b_h), the product in T with a T result, then the fp32 bias; the
    attention :func:`attention_reference` (``_attention_xla``'s function: q
    scaled in T, S and the softmax in fp32, P rounded to T, o in T); out =
    T(T(sum_h o_h Wp_h) + bp), one product over the heads and their dims.
    Operands as :func:`fused_attention_block`'s. Differentiable by torch
    autograd: it is the backward of every ``block`` call."""
    h = num_heads
    q, k, v = ((torch.einsum("bnk,hkd->bhnd", x, w_qkv[i * h:(i + 1) * h])
                + b_qkv[i * h:(i + 1) * h][None]).to(x.dtype) for i in range(3))
    o = attention_reference(q, k, v)
    return (torch.einsum("bhnk,hkd->bnd", o, w_proj) + b_proj).to(x.dtype)


def fused_attention_block_xla(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                              w_proj: torch.Tensor, b_proj: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """``fused_attention_block_xla``'s function, computed as the JAX package
    computes it outside any Pallas kernel: on the card the projections are
    ``torch.matmul`` (cuBLAS) with :func:`fused_attention_block_xla_plain`'s
    rounding points, and the attention core is the kernel that the default
    route takes without grad for ``_attention_xla``'s function (K1 where
    its shared memory fits, else K4), reading q, k, v as strided views of
    the fused projection. On the CPU, the plain version. Not
    differentiable on the card (:func:`fused_attention_block` is)."""
    tensors = (x, w_qkv, b_qkv, w_proj, b_proj)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_attention_block_xla_plain(*tensors, num_heads)
    b, n, hidden = x.shape
    h, d, dt = num_heads, w_qkv.shape[-1], x.dtype
    # (3H Dh, D) in [q|k|v][head][dim] rows: the Linear weight, viewed back.
    w = w_qkv.transpose(1, 2).reshape(3 * h * d, hidden)
    qkv = (torch.matmul(x, w.t()) + b_qkv.reshape(-1)).to(dt)
    if attention_route(n, dt, False, head_dim=d) == "whole_row":
        o = attention(*_heads(qkv, h))
    else:
        from .flash_attention import flash_attention_fwd
        o, _ = flash_attention_fwd(*_heads(qkv, h))
    o = o.transpose(1, 2).reshape(b, n, h * d)
    return (torch.matmul(o, w_proj.reshape(h * d, hidden)) + b_proj).to(dt)


@functools.cache
def _block_kernel(head_dim: int = HEAD_DIM):
    lib = _build.load(_build.unit("attention_block", head_dim))
    if lib.k3_attention_block_head_dim() != head_dim:
        raise RuntimeError(f"the K3 library for Dh {head_dim} was built for Dh "
                           f"{lib.k3_attention_block_head_dim()}")
    fn = lib.k3_attention_block
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.k3_attention_block_long
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.k3_attention_block_long_stage
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.k3_attention_block_long_kv_whole.argtypes = [ctypes.c_int]
    lib.k3_attention_block_long_kv_whole.restype = ctypes.c_int
    lib.k3_attention_block_long_scratch_elems.argtypes = [ctypes.c_int] * 4
    lib.k3_attention_block_long_scratch_elems.restype = ctypes.c_size_t
    for fn in (lib.k3_attention_block_smem_bytes, lib.k3_attention_block_long_smem_bytes):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_size_t
    lib.k3_attention_block_max_smem.argtypes = [ctypes.c_int]
    lib.k3_attention_block_max_smem.restype = ctypes.c_int
    return lib


def _check_block(x, w_qkv, b_qkv, w_proj, b_proj, num_heads: int) -> bool:
    """Raise on operands that K3 cannot take; return whether the
    short-row instance's shared memory takes N."""
    tensors = (x, w_qkv, b_qkv, w_proj, b_proj)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("K3 needs x and the weights on one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPE_CODES or w_qkv.dtype != x.dtype or w_proj.dtype != x.dtype:
        raise ValueError(f"K3 takes float32 or bfloat16 x and weights of one dtype; got "
                         f"{x.dtype}, {w_qkv.dtype}, {w_proj.dtype}")
    if b_qkv.dtype != torch.float32 or b_proj.dtype != torch.float32:
        raise ValueError(f"K3 takes float32 biases; got {b_qkv.dtype}, {b_proj.dtype}")
    if x.dim() != 3 or x.shape[1] < 1 or w_qkv.dim() != 3:
        raise ValueError(f"K3 takes x of shape (B, N, D), N >= 1, and w_qkv of shape "
                         f"(3H, D, Dh); got {tuple(x.shape)}, {tuple(w_qkv.shape)}")
    b, n, hidden = x.shape
    h, d = num_heads, w_qkv.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"K3 needs Dh in {HEAD_DIMS}; got w_qkv of shape "
                         f"{tuple(w_qkv.shape)}")
    want = {"w_qkv": (3 * h, hidden, d), "b_qkv": (3 * h, 1, d),
            "w_proj": (h, d, hidden), "b_proj": (1, hidden)}
    for name, t in zip(want, tensors[1:]):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"K3 at Dh {d}, {h} heads: {name} of shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
    if hidden % 64:
        raise ValueError(f"K3 needs a hidden size that is a multiple of 64; got {hidden}")
    if not all(t.is_contiguous() for t in (x, b_qkv, b_proj)):
        raise ValueError("K3 takes contiguous x and biases")
    if x.data_ptr() % 16:
        raise ValueError("K3 takes x at a 16-byte aligned address")
    elem = x.element_size()
    have = _max_smem(x.device.index if x.device.index is not None
                     else torch.cuda.current_device(), d)
    need = k3_long_smem_bytes(n, elem, d)
    if need > have:
        raise ValueError(f"K3's long-row instance at N={n} needs {need} B of shared memory "
                         f"per block; this device allows {have} B")
    return k3_smem_bytes(n, elem, d) <= have


@functools.cache
def _max_smem(device: int, head_dim: int) -> int:
    """The dynamic shared memory one block may opt into on ``device``."""
    return _block_kernel(head_dim).k3_attention_block_max_smem(device)


def _weight_strides(w_qkv: torch.Tensor, w_proj: torch.Tensor) -> tuple:
    """The weights' strides as K3 reads them: in bf16 the ``Linear``
    layout (:func:`dense_to_block_weights`' views), in fp32 contiguous."""
    n3, hidden, d = w_qkv.shape
    if w_qkv.dtype == torch.bfloat16:
        return (d * hidden, 1, hidden), (d, 1, n3 // 3 * d)
    return (hidden * d, d, 1), (d * hidden, hidden, 1)


def _as_laid_out(t: torch.Tensor, strides: tuple) -> torch.Tensor:
    """``t`` if it has ``strides`` and a 16-byte aligned address, else a copy
    laid out so (the DiT's bf16 views pass through as they are)."""
    if t.stride() == strides and t.data_ptr() % 16 == 0:
        return t
    return torch.empty_strided(t.shape, strides, dtype=t.dtype, device=t.device).copy_(t)


def _block_launch_args(x, w_qkv, b_qkv, w_proj, b_proj, num_heads: int) -> tuple:
    """Weights in K3's layout, the outputs (o, out) and the pointers K3's C
    functions take, in order, before the scratch."""
    qkv_strides, proj_strides = _weight_strides(w_qkv, w_proj)
    w_qkv, w_proj = _as_laid_out(w_qkv, qkv_strides), _as_laid_out(w_proj, proj_strides)
    b, n, _ = x.shape
    o = torch.empty((b, n, num_heads * w_qkv.shape[-1]), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    ptrs = (x.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
            b_proj.data_ptr())
    return (w_qkv, w_proj), o, out, ptrs


def _long_scratch(x, d: int, num_heads: int) -> torch.Tensor:
    """The long-row instance's q, k, v scratch for x, alive until queued."""
    b, n, _ = x.shape
    return torch.empty(k3_long_scratch_elems(b, n, num_heads, x.element_size(), d),
                       dtype=x.dtype, device=x.device)


def _launch_block(x, w_qkv, b_qkv, w_proj, b_proj, num_heads: int,
                  instance: str | None = None) -> torch.Tensor:
    fits = _check_block(x, w_qkv, b_qkv, w_proj, b_proj, num_heads)
    if instance is None:
        instance = k3_instance(x.shape[1], x.dtype, w_qkv.shape[-1])
    if instance not in ("short", "long") or (instance == "short" and not fits):
        raise ValueError(f"K3's {instance!r} instance at N={x.shape[1]}: expected 'long', "
                         f"or 'short' where its shared memory takes N")
    _, o, out, ptrs = _block_launch_args(x, w_qkv, b_qkv, w_proj, b_proj, num_heads)
    b, n, hidden = x.shape
    d = w_qkv.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if instance == "short":
        err = _block_kernel(d).k3_attention_block(
            _DTYPE_CODES[x.dtype], *ptrs, o.data_ptr(), out.data_ptr(), b, n, num_heads,
            hidden, q_scale(d, x.dtype), stream)
    else:
        scratch = _long_scratch(x, d, num_heads)
        err = _block_kernel(d).k3_attention_block_long(
            _DTYPE_CODES[x.dtype], *ptrs, scratch.data_ptr(), o.data_ptr(), out.data_ptr(),
            b, n, num_heads, hidden, q_scale(d, x.dtype), stream)
    if err:
        raise RuntimeError(f"attention block kernel launch failed: cudaError {err}")
    fused_attention_block_k3.launches += 1
    return out


def k3_long_stages(x, w_qkv, b_qkv, w_proj, b_proj, num_heads: int):
    """The bf16 long-row instance's three launches apart, to time each:
    ``run(stage)`` launches L.1 (0: x to the scratch), L.2 (1: the scratch
    to o) or A.2 (2: o to the output) on buffers made here, and returns the
    output. Launch L.1 before L.2 and L.2 before A.2 once; then any stage
    again. Not counted in ``fused_attention_block_k3.launches``."""
    _check_block(x, w_qkv, b_qkv, w_proj, b_proj, num_heads)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"k3_long_stages times the bf16 instance; got {x.dtype}")
    weights, o, out, ptrs = _block_launch_args(x, w_qkv, b_qkv, w_proj, b_proj, num_heads)
    b, n, hidden = x.shape
    d = w_qkv.shape[-1]
    scratch = _long_scratch(x, d, num_heads)
    lib = _block_kernel(d)

    def run(stage: int) -> torch.Tensor:
        err = lib.k3_attention_block_long_stage(
            stage, _DTYPE_CODES[x.dtype], *ptrs, scratch.data_ptr(), o.data_ptr(),
            out.data_ptr(), b, n, num_heads, hidden, q_scale(d, x.dtype),
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K3 long-row stage {stage} launch failed: cudaError {err}")
        return out

    run.buffers = (weights, scratch, o, out)  # alive as long as run
    return run


def fused_attention_block_k3(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                             w_proj: torch.Tensor, b_proj: torch.Tensor, num_heads: int,
                             instance: str | None = None) -> torch.Tensor:
    """K3, at any N: x (B, N, D) -> (B, N, D); weights of
    :func:`dense_to_block_weights`' shapes (Dh 64 or 72, from ``w_qkv``), in
    x's type, any strides (the kernel reads its own layout,
    :func:`_weight_strides`; others are copied into it first), biases
    float32. The kernel scales q by :func:`q_scale`.

    On the card each call launches the instance :func:`k3_instance` names
    (``instance="short"`` or ``"long"`` takes that one where it runs, to
    hold the two to each other and to time them), and adds one to
    ``fused_attention_block_k3.launches``. On the CPU it is
    the plain version. Not differentiable (:func:`fused_attention_block`
    is)."""
    tensors = (x, w_qkv, b_qkv, w_proj, b_proj)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_attention_block_plain(*tensors, num_heads)
    return _launch_block(*tensors, num_heads, instance)


fused_attention_block_k3.launches = 0


def block_takes_k3(x: torch.Tensor, w_qkv: torch.Tensor, num_heads: int) -> bool:
    """Whether the JAX package's ``block`` runs its Pallas K3 on these
    operands (:func:`_block_bb` is not None), not
    ``fused_attention_block_xla``."""
    b, n, hidden = x.shape
    return _block_bb(b, n, num_heads, w_qkv.shape[-1], hidden, x.element_size()) is not None


class _FusedAttentionBlock(torch.autograd.Function):
    """``forward`` (K3 or the XLA composition) forward; backward by torch
    autograd of :func:`fused_attention_block_xla_plain`, as the JAX
    package's custom VJP differentiates ``fused_attention_block_xla`` at
    every geometry."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, w_proj, b_proj, num_heads: int, forward):
        ctx.save_for_backward(x, w_qkv, b_qkv, w_proj, b_proj)
        ctx.num_heads = num_heads
        return forward(x, w_qkv, b_qkv, w_proj, b_proj, num_heads)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = fused_attention_block_xla_plain(*inputs, ctx.num_heads)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None)


def _with_xla_backward(forward, tensors: tuple, num_heads: int) -> torch.Tensor:
    """``forward(*tensors, num_heads)``; with grad on, through
    :class:`_FusedAttentionBlock`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _FusedAttentionBlock.apply(*tensors, num_heads, forward)
    return forward(*tensors, num_heads)


def fused_attention_block(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                          w_proj: torch.Tensor, b_proj: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """The whole attention sublayer of ``attn_impl="block"``, the JAX
    package's ``fused_attention_block``: where the JAX rule runs its Pallas
    kernel (:func:`block_takes_k3`), K3 (:func:`fused_attention_block_k3`),
    else :func:`fused_attention_block_xla`; on the CPU their plain versions.
    Operands as :func:`fused_attention_block_k3`'s. With grad on, the
    result's backward is autograd of :func:`fused_attention_block_xla_plain`
    at every geometry."""
    forward = (fused_attention_block_k3 if block_takes_k3(x, w_qkv, num_heads)
               else fused_attention_block_xla)
    return _with_xla_backward(forward, (x, w_qkv, b_qkv, w_proj, b_proj), num_heads)


def fused_attention_block_reference(x: torch.Tensor, w_qkv: torch.Tensor,
                                    b_qkv: torch.Tensor, w_proj: torch.Tensor,
                                    b_proj: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of :func:`fused_attention_block` on any device: the
    function the JAX rule picks, through plain torch ops, with the same
    backward."""
    forward = (fused_attention_block_plain if block_takes_k3(x, w_qkv, num_heads)
               else fused_attention_block_xla_plain)
    return _with_xla_backward(forward, (x, w_qkv, b_qkv, w_proj, b_proj), num_heads)
