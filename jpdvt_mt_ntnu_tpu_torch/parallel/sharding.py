"""The train state's layout on the mesh: tensor parallelism (``mesh.model``),
fully-sharded data parallelism (``mesh.fsdp``) and expert parallelism
(``mesh.ep``), with the pipeline's stages (``parallel/pipeline.py``) and the
ring's token groups (``parallel/sequence.py``).

Counterpart of ``jpdvt_mt_ntnu_tpu/parallel/sharding.py``. There GSPMD
turns the partition specs into collectives; here each process is one rank
of the pipe x data x fsdp x ep x seq x model mesh (:class:`MeshRanks`, in
the JAX package's order) and the collectives are written out:

- **Tensor parallelism**, the JAX package's ``_TP_RULES`` (Megatron): the
  DiT block's qkv and fc1 keep their output features of this model rank,
  proj and fc2 their input features. qkv's [q|k|v] rows are cut by heads,
  so that each rank's attention kernels (K1/K2, K4-K6) run on its own heads
  whole. ``dit.Linear`` applies the conjugate pair around them (``tp_mode``
  "column": identity forward, all-reduce of the gradient; "row": all-reduce
  of the partial sums in fp32, the bias added once after it). adaLN, the
  embeddings, the heads and every other leaf stay replicated, and get
  identical gradients on the ranks of a model group.
- **Expert parallelism**, ``_EP_RULES``: the MoE's stacked ``wi``, ``bi``,
  ``wo`` and ``bo`` keep E/ep of the experts; the experts' hidden features
  are cut over model as fc1's and fc2's are. The MoE (``models/moe.py``)
  applies the same conjugate pair over the ep group; the router's gradient,
  partial on each ep rank, is summed over the group.
- **Fully-sharded data parallelism**, ``_with_fsdp`` (ZeRO-3): every leaf of
  two or more dimensions keeps 1/fsdp of its largest dimension that no TP
  or expert rule takes and that fsdp divides (in the JAX package's Flax
  order: a Linear's (in, out)), in the params, the EMA and the AdamW
  moments; 1-D leaves stay replicated. A ``dit.Linear`` weight is gathered,
  cast and applied in one autograd function (:class:`_GatheredLinear`), an
  expert leaf in its einsum (:class:`_GatheredEinsum`), each saving only
  the shard: the backward gathers the weight again, and reduce-scatters its
  gradient. A full weight lives only while its product runs. A step's
  backwards (the pipeline's microbatches, ``train.grad_accum``'s) sum each
  leaf's whole gradient and reduce-scatter it once
  (:meth:`Mesh.deferred_scatter`).
- The batch is cut over data x fsdp (``batch_index``, ``batch_size``); the
  ranks of a pipe, ep, seq or model group take the same rows. The partial
  gradients are summed first (the stem's and head's over pipe, the
  router's over ep, every leaf's over seq), then the gradients of sharded
  leaves are reduced over the data group after the fsdp reduce-scatter,
  those of the other leaves over data x fsdp; the global norm sums each
  leaf once.
- Checkpoints hold the one-process layout: :meth:`Layout.full_state_dict`
  gathers the state on every rank, and a restore into the full state before
  :meth:`Layout.shard_` re-shards it.

The gathers and reduce-scatters are the backends' own
(``all_gather_into_tensor``, ``reduce_scatter_tensor``), which gloo takes
on the CPU and on a card's tensors, and nccl across cards; the
point-to-point transfers go through :meth:`Mesh.exchange`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.dit import DiT, DiTBlock, Linear
from ..models.moe import ExpertChoiceMoE
from ..ops.attention import ATTN_ALIASES
from .mesh import AXES, BUCKET_ELEMS, DataParallel, MeshSpec
from . import sequence
from .pipeline import Pipeline

log = logging.getLogger(__name__)

# What the point-to-point transfers (Mesh.exchange: the pipeline's sends, the
# ring's rotations) took in all: wall seconds, bytes sent, calls. A reader
# sets it to 0 and reads it; the card's queue is drained before each timing.
TRANSPORT = {"seconds": 0.0, "bytes": 0, "calls": 0}

# torch >= 2.13 names the single-tensor collectives so; older ones as below.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


# ------------------------------------------------------------------- placement

# Each axis's letter in MeshRanks.groups, in the JAX order.
LETTERS = dict(zip(AXES, "pdfesm"))


@dataclasses.dataclass(frozen=True)
class MeshRanks:
    """Where each rank sits on the pipe x data x fsdp x ep x seq x model
    mesh, in the JAX order: ``pipe`` outermost, ``model`` innermost."""

    data: int = 1
    fsdp: int = 1
    model: int = 1
    pipe: int = 1
    ep: int = 1
    seq: int = 1

    @classmethod
    def from_spec(cls, spec: MeshSpec, world: int) -> "MeshRanks":
        return cls(**{k: v for k, v in spec.axis_sizes(world).items()})

    @property
    def world(self) -> int:
        return int(np.prod([getattr(self, a) for a in AXES]))

    @property
    def names(self) -> tuple[str, ...]:
        """The JAX mesh's axes for these sizes: data, fsdp and model always
        (so (d, f, m) as before), pipe, ep and seq where above 1."""
        return tuple(a for a in AXES if a in ("data", "fsdp", "model") or getattr(self, a) > 1)

    def coord(self, rank: int, axis: str) -> int:
        inner = int(np.prod([getattr(self, a) for a in AXES[AXES.index(axis) + 1:]]))
        return rank // inner % getattr(self, axis)

    def coords(self, rank: int) -> tuple[int, ...]:
        """This rank's coordinates along :attr:`names`."""
        return tuple(self.coord(rank, a) for a in self.names)

    def groups(self, axes: str) -> list[list[int]]:
        """Every group of ranks that differ only along ``axes`` (letters of
        "pdfesm": "m" the model groups, "df" the batch's data x fsdp), each
        in rank order, which is its order along those axes."""
        out: dict = {}
        for r in range(self.world):
            key = tuple(self.coord(r, a) for a in AXES if LETTERS[a] not in axes)
            out.setdefault(key, []).append(r)
        return [out[k] for k in sorted(out)]

    def batch_index(self, rank: int) -> int:
        """This rank's shard of the batch: its (d, f) in data x fsdp (the
        ranks of a pipe, ep, seq or model group take the same rows)."""
        return self.coord(rank, "data") * self.fsdp + self.coord(rank, "fsdp")

    @property
    def batch_size(self) -> int:
        return self.data * self.fsdp


@dataclasses.dataclass
class Group:
    """One process group of this rank: its ranks, and this rank's index."""

    ranks: list[int]
    index: int
    pg: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """This process's groups on the mesh (model, fsdp, data, the batch's
    data x fsdp, ep, seq and pipe) and the collectives over them (see the
    module docstring)."""

    GROUPS = (("model", "m"), ("fsdp", "f"), ("data", "d"), ("batch", "df"), ("ep", "e"),
              ("seq", "s"), ("pipe", "p"))

    def __init__(self, ranks: MeshRanks, dp: DataParallel):
        if ranks.world != dp.world:
            raise ValueError(f"a mesh of {ranks.world} ranks on a world of {dp.world}")
        self.ranks = ranks
        self.rank = dp.rank
        self.backend = dp.backend
        self._deferred: dict | None = None  # deferred_scatter's sums, by leaf
        self.reduce_scatters = 0  # scatter_sum's calls, for a reader to count
        found = {}
        # Every rank creates every group, in one order, as new_group requires.
        for name, axes in self.GROUPS:
            for members in ranks.groups(axes):
                pg = dist.new_group(members) if dp.in_group and len(members) > 1 else None
                if self.rank in members:
                    found[name] = Group(members, members.index(self.rank), pg)
        for name, _ in self.GROUPS:
            setattr(self, name, found[name])

    def __deepcopy__(self, memo):  # modules that hold it are copied, it is not
        return self

    @contextlib.contextmanager
    def deferred_scatter(self):
        """Within it, the gathered leaves' gradients are summed whole on this
        rank and reduce-scattered over fsdp once each, at its end, into
        their ``.grad``: a step's backwards (the pipeline's microbatches,
        ``train.grad_accum``'s) then reduce-scatter each leaf once."""
        self._deferred = {}
        try:
            yield
            for shard, dim, full in self._deferred.values():
                g = self.scatter_sum(full, self.fsdp, dim)
                shard.grad = g if shard.grad is None else shard.grad + g
        finally:
            self._deferred = None

    def scatter_grad(self, shard: torch.Tensor, full: torch.Tensor, dim: int):
        """The gradient of a gathered leaf (``shard``, the parameter itself)
        from its whole gradient ``full``: reduce-scattered over fsdp now, or
        within :meth:`deferred_scatter` added to the leaf's running sum
        (None: nothing for autograd)."""
        full = full.to(shard.dtype)
        if self._deferred is None:
            return self.scatter_sum(full, self.fsdp, dim)
        key = id(shard)
        if key in self._deferred:
            self._deferred[key][2].add_(full)
        else:
            self._deferred[key] = (shard, dim, full)
        return None

    @property
    def describe(self) -> dict:
        return {**{a: getattr(self.ranks, a) for a in AXES},
                "coords": dict(zip(self.ranks.names, self.ranks.coords(self.rank)))}

    def all_reduce_(self, tensors: Sequence[torch.Tensor], group: Group,
                    bucket_elems: int = BUCKET_ELEMS) -> None:
        """Sum each tensor (one dtype, one device) over ``group``, in buckets."""
        if group.size == 1:
            return
        bucket: list = []
        size = 0
        for t in [*tensors, None]:
            if bucket and (t is None or size + t.numel() > bucket_elems):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                dist.all_reduce(flat, group=group.pg)
                torch._foreach_copy_(bucket, [v.view_as(b) for v, b in
                                              zip(flat.split([b.numel() for b in bucket]), bucket)])
                bucket, size = [], 0
            if t is not None:
                bucket.append(t)
                size += t.numel()

    def broadcast_(self, t: torch.Tensor, group: Group, index: int) -> None:
        """``t`` of the group's rank ``index`` on every rank of ``group``."""
        if group.size > 1:
            dist.broadcast(t, src=group.ranks[index], group=group.pg)

    def stack(self, t: torch.Tensor, group: Group) -> torch.Tensor:
        """(n, *t.shape): every rank's ``t`` of ``group``, bit for bit, in
        group order."""
        if group.size == 1:
            return t.detach()[None]
        t = t.detach().contiguous()
        out = torch.empty(group.size * t.numel(), dtype=t.dtype, device=t.device)
        _all_gather(out, t.view(-1), group=group.pg)
        return out.view(group.size, *t.shape)

    def gather(self, t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
        """The concatenation along ``dim`` of the group's tensors."""
        if group.size == 1:
            return t
        s = self.stack(t, group)
        return s.movedim(0, dim).reshape(*t.shape[:dim], -1, *t.shape[dim + 1:])

    def scatter_sum(self, full: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` of the group's sum of ``full``."""
        if group.size == 1:
            return full
        self.reduce_scatters += 1
        n = group.size
        parts = full.unflatten(dim, (n, full.shape[dim] // n)).movedim(dim, 0).contiguous()
        out = torch.empty_like(parts[0])
        _reduce_scatter(out.view(-1), parts.view(-1), group=group.pg)
        return out

    def exchange(self, sends: Sequence[tuple[torch.Tensor, int]],
                 recvs: Sequence[tuple[torch.Tensor, int]], group: Group) -> None:
        """Point-to-point: each ``(tensor, index)`` of ``sends`` to the
        group's rank ``index``, each of ``recvs`` filled from its rank, all
        posted at once (``batch_isend_irecv``, so two ranks that send to each
        other do not wait on each other) and waited for. Ranks sharing a card
        over gloo pass card tensors through :func:`host_exchange`."""
        on_card = any(t.is_cuda for t, _ in [*sends, *recvs])
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if self.backend == "gloo" and on_card:
            host_exchange(sends, recvs, group)
        else:
            ops = [dist.P2POp(dist.isend, t.contiguous(), group.ranks[i], group.pg)
                   for t, i in sends]
            ops += [dist.P2POp(dist.irecv, t, group.ranks[i], group.pg) for t, i in recvs]
            for work in dist.batch_isend_irecv(ops) if ops else []:
                work.wait()
            if on_card:
                torch.cuda.synchronize()
        TRANSPORT["seconds"] += time.perf_counter() - t0
        TRANSPORT["bytes"] += sum(t.numel() * t.element_size() for t, _ in sends)
        TRANSPORT["calls"] += 1

    # Megatron's conjugate pair over a group (dit.Linear's tp_mode over the
    # model group, the MoE's over the ep group).
    def copy_to(self, x: torch.Tensor, group: Group) -> torch.Tensor:
        """Identity forward; the gradient summed over ``group``."""
        return _CopyTo.apply(x, self, group) if group.size > 1 else x

    def reduce_from(self, y: torch.Tensor, group: Group) -> torch.Tensor:
        """The fp32 sum over ``group`` of the partial results ``y``."""
        return _ReduceFrom.apply(y, self, group) if group.size > 1 else y.float()

    def gathered_linear(self, x: torch.Tensor, shard: torch.Tensor, bias: torch.Tensor | None,
                        dim: int) -> torch.Tensor:
        """``F.linear(x, w, bias)`` with ``w`` this fsdp group's weight,
        gathered from ``shard`` (cut along ``dim``) and cast to x's type."""
        return _GatheredLinear.apply(x, shard, bias, self, dim)

    def gathered_einsum(self, eq: str, x: torch.Tensor, shard: torch.Tensor,
                        dim: int) -> torch.Tensor:
        """``einsum(eq, x, w)``, ``w`` gathered over fsdp as in
        :meth:`gathered_linear` (the MoE's stacked experts)."""
        return _GatheredEinsum.apply(eq, x, shard, self, dim)

    def gathered(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """The fsdp group's leaf whole from ``shard``; its gradient
        reduce-scattered back (the MoE's expert biases)."""
        return _Gathered.apply(shard, self, dim)

    # Sequence parallelism over the seq group (parallel/sequence.py).
    def ring_attention(self, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        return sequence.ring_attention(self, qkv, num_heads, self.seq)

    def local_tokens(self, x: torch.Tensor) -> torch.Tensor:
        return sequence.local_tokens(x, self.seq)

    def gather_tokens(self, x: torch.Tensor) -> torch.Tensor:
        return sequence.gather_tokens(self, x, self.seq)

    def gather_tokens_summed(self, x: torch.Tensor) -> torch.Tensor:
        return sequence.gather_tokens_summed(self, x, self.seq)

    def sum_fp32(self, t: torch.Tensor, group: Group) -> torch.Tensor:
        out = t.to(torch.float32, copy=True)
        dist.all_reduce(out, group=group.pg)
        return out


def host_exchange(sends, recvs, group: Group) -> None:
    """:meth:`Mesh.exchange` for card tensors over gloo, which reads and
    writes host memory only: each tensor is staged through a pinned host
    buffer. The compute stays on the card; only the bytes in flight pass
    the host."""
    staged = [(torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t), i)
              for t, i in sends]
    landing = [(torch.empty(t.shape, dtype=t.dtype, pin_memory=True), i) for t, i in recvs]
    ops = [dist.P2POp(dist.isend, h, group.ranks[i], group.pg) for h, i in staged]
    ops += [dist.P2POp(dist.irecv, h, group.ranks[i], group.pg) for h, i in landing]
    for work in dist.batch_isend_irecv(ops) if ops else []:
        work.wait()
    for (t, _), (h, _) in zip(recvs, landing):
        t.copy_(h)


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient summed over a group (in fp32)."""

    @staticmethod
    def forward(ctx, x, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.sum_fp32(g, ctx.group).to(g.dtype), None, None


class _ReduceFrom(torch.autograd.Function):
    """The partial results added over a group in fp32; identity backward."""

    @staticmethod
    def forward(ctx, y, mesh, group):
        ctx.dtype = y.dtype
        return mesh.sum_fp32(y, group)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


class _GatheredLinear(torch.autograd.Function):
    """A Linear on a weight gathered over the fsdp group. It saves the
    input and the shard, gathers the weight again in the backward where
    the input needs a gradient, and reduce-scatters the weight's gradient
    (computed in the compute type, summed in the shard's;
    :meth:`Mesh.scatter_grad`)."""

    @staticmethod
    def forward(ctx, x, shard, bias, mesh, dim):
        w = mesh.gather(shard.detach(), mesh.fsdp, dim).to(x.dtype)
        ctx.save_for_backward(x, shard)
        ctx.mesh, ctx.dim, ctx.leaf = mesh, dim, shard
        return F.linear(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, shard = ctx.saved_tensors
        mesh = ctx.mesh
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = g @ mesh.gather(shard.detach(), mesh.fsdp, ctx.dim).to(g.dtype)
        g2 = g.reshape(-1, g.shape[-1])
        if ctx.needs_input_grad[1]:
            gw = mesh.scatter_grad(ctx.leaf, g2.T @ x.reshape(-1, x.shape[-1]), ctx.dim)
        if ctx.needs_input_grad[2]:
            gb = g2.sum(0)
        return gx, gw, gb, None, None


class _GatheredEinsum(torch.autograd.Function):
    """``einsum("A,B->C", x, w)`` on a ``w`` gathered over the fsdp group,
    saving the input and the shard as :class:`_GatheredLinear` does. Every
    index of the two equations it serves (the experts' fc1 and fc2) stands
    in two of the three operands, so the gradients are
    ``einsum("C,B->A")`` and ``einsum("A,C->B")``."""

    @staticmethod
    def forward(ctx, eq, x, shard, mesh, dim):
        w = mesh.gather(shard.detach(), mesh.fsdp, dim).to(x.dtype)
        ctx.save_for_backward(x, shard)
        ctx.mesh, ctx.dim, ctx.leaf = mesh, dim, shard
        ctx.terms = eq.replace("->", ",").split(",")
        return torch.einsum(eq, x, w)

    @staticmethod
    def backward(ctx, g):
        x, shard = ctx.saved_tensors
        a, b, c = ctx.terms
        mesh = ctx.mesh
        gx = gw = None
        if ctx.needs_input_grad[1]:
            w = mesh.gather(shard.detach(), mesh.fsdp, ctx.dim).to(g.dtype)
            gx = torch.einsum(f"{c},{b}->{a}", g, w)
        if ctx.needs_input_grad[2]:
            gw = mesh.scatter_grad(ctx.leaf, torch.einsum(f"{a},{c}->{b}", x, g), ctx.dim)
        return None, gx, gw, None, None


class _Gathered(torch.autograd.Function):
    """A leaf gathered over the fsdp group; its gradient reduce-scattered."""

    @staticmethod
    def forward(ctx, shard, mesh, dim):
        ctx.mesh, ctx.dim, ctx.leaf = mesh, dim, shard
        return mesh.gather(shard.detach(), mesh.fsdp, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.scatter_grad(ctx.leaf, g.contiguous(), ctx.dim), None, None


# ----------------------------------------------------------------------- rules

@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """How one leaf is cut: ``tp_dim`` over the model group (in ``tp_parts``
    runs cut alike: qkv's q, k and v), ``fsdp_dim`` over fsdp and
    ``ep_dim`` (a stacked expert leaf's E) over ep."""

    tp_dim: int | None = None
    tp_parts: int = 1
    fsdp_dim: int | None = None
    ep_dim: int | None = None


# (module names, torch dim of the weight, of the bias, runs): _TP_RULES in the
# torch layout, where a Linear's weight is (out, in).
TP_RULES = ((("attn", "qkv"), 0, 0, 3), (("attn", "proj"), 1, None, 1),
            (("mlp", "fc1"), 0, 0, 1), (("mlp", "fc2"), 1, None, 1))
# The expert-choice MoE's stacked leaves (_EP_RULES): E (dim 0) over ep, and
# the expert hidden dims, torch dim of each, over model.
EP_MODEL_DIMS = {"wi": 2, "bi": 1, "wo": 1}
EXPERT_LEAVES = ("wi", "bi", "wo", "bo")


def is_expert_leaf(name: str) -> bool:
    parts = name.split(".")
    return "mlp" in parts and parts[-1] in EXPERT_LEAVES


def is_router_leaf(name: str) -> bool:
    parts = name.split(".")
    return "mlp" in parts and "router" in parts


def block_index(name: str) -> int | None:
    """i of a leaf of ``blocks.{i}``, else None (the stem and the head)."""
    parts = name.split(".")
    return int(parts[1]) if parts[0] == "blocks" else None


def tp_rule(name: str, ndim: int) -> tuple[int | None, int]:
    """(torch dim cut over the model group, runs) of a leaf by its name."""
    parts = name.split(".")
    if is_expert_leaf(name):
        return EP_MODEL_DIMS.get(parts[-1]), 1
    for keys, wdim, bdim, runs in TP_RULES:
        if all(k in parts for k in keys):
            if parts[-1] == "weight" and ndim == 2:
                return wdim, runs
            if parts[-1] == "bias" and ndim == 1:
                return bdim, runs
    return None, 1


def fsdp_dim(name: str, shape: Sequence[int], taken: int | None, fsdp: int,
             ep: int = 1) -> int | None:
    """``_with_fsdp``: the largest dim that no TP or expert rule takes and
    that fsdp divides, ties to the first in the JAX package's order (a
    Linear weight's Flax kernel is (in, out), the torch weight's
    transpose); None for 1-D leaves and where no dim divides. The rules
    take their dims whatever the size of their axis, as JAX's specs name
    them; an expert leaf's E only where the mesh has an ep axis."""
    if fsdp <= 1 or len(shape) < 2:
        return None
    flax = name.endswith(".weight") and len(shape) == 2
    order = [1, 0] if flax else list(range(len(shape)))
    taken_dims = {taken} | ({0} if ep > 1 and is_expert_leaf(name) else set())
    free = [d for d in order if d not in taken_dims and shape[d] % fsdp == 0]
    return max(free, key=lambda d: shape[d]) if free else None


def leaf_specs(shapes: dict[str, Sequence[int]], model: int, fsdp: int,
               ep: int = 1) -> dict[str, LeafSpec]:
    """The spec of every named leaf of a DiT for a mesh of ``model`` x
    ``fsdp`` x ``ep``."""
    out = {}
    for name, shape in shapes.items():
        dim, runs = tp_rule(name, len(shape))
        out[name] = LeafSpec(dim if model > 1 else None, runs,
                             fsdp_dim(name, shape, dim, fsdp, ep),
                             0 if ep > 1 and is_expert_leaf(name) else None)
    return out


def tp_slice(t: torch.Tensor, spec: LeafSpec, m: int, model: int) -> torch.Tensor:
    """Model rank ``m``'s part of a full leaf: of each run along ``tp_dim``,
    its 1/model (qkv: its heads' rows of q, of k and of v)."""
    if spec.tp_dim is None or model == 1:
        return t
    d, runs = spec.tp_dim, spec.tp_parts
    k = t.shape[d] // (runs * model)
    return t.unflatten(d, (runs, model, k)).select(d + 1, m).flatten(d, d + 1)


def tp_join(stacked: torch.Tensor, spec: LeafSpec) -> torch.Tensor:
    """The full leaf from the model ranks' parts, stacked (model, *part)."""
    d, runs = spec.tp_dim + 1, spec.tp_parts
    x = stacked.unflatten(d, (runs, stacked.shape[d] // runs))  # (M, .., runs, k, ..)
    return x.movedim(0, d).flatten(d - 1, d + 1)  # (.., runs, M, k, ..) -> (.., runs M k, ..)


def fsdp_slice(t: torch.Tensor, spec: LeafSpec, f: int, fsdp: int) -> torch.Tensor:
    if spec.fsdp_dim is None or fsdp == 1:
        return t
    return t.chunk(fsdp, dim=spec.fsdp_dim)[f]


# ---------------------------------------------------------------------- layout

# The axes that may cut a leaf, in the order the global norm sums over them.
CUT_AXES = ("model", "fsdp", "ep", "pipe")


class Layout:
    """The train state's layout on a mesh: shards it, runs its forward and
    backward with the collectives, reduces its gradients, measures their
    global norm and gathers it whole for a checkpoint."""

    def __init__(self, mesh: Mesh, shapes: dict[str, Sequence[int]], microbatches: int = 0):
        self.mesh = mesh
        r = mesh.ranks
        self.names = list(shapes)  # the one-process order
        self.specs = leaf_specs(shapes, r.model, r.fsdp, r.ep)
        self.m, self.f, self.e = mesh.model.index, mesh.fsdp.index, mesh.ep.index
        depth = 1 + max((i for i in map(block_index, shapes) if i is not None), default=-1)
        self.pipeline = Pipeline(mesh, depth, microbatches) if r.pipe > 1 else None

    @property
    def batch_index(self) -> int:
        return self.mesh.ranks.batch_index(self.mesh.rank)

    @property
    def batch_size(self) -> int:
        return self.mesh.ranks.batch_size

    def cut_axes(self, name: str) -> tuple[bool, ...]:
        """For each of :data:`CUT_AXES`, whether it cuts this leaf."""
        spec = self.specs[name]
        staged = self.pipeline is not None and block_index(name) is not None
        return (spec.tp_dim is not None, spec.fsdp_dim is not None, spec.ep_dim is not None,
                staged)

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a full leaf (a new contiguous tensor)."""
        spec, ranks = self.specs[name], self.mesh.ranks
        t = tp_slice(full, spec, self.m, ranks.model)
        t = fsdp_slice(t, spec, self.f, ranks.fsdp)
        if spec.ep_dim is not None:
            t = t.chunk(ranks.ep, dim=spec.ep_dim)[self.e]
        return t.contiguous().clone()

    def full(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """A leaf of this stage whole from every rank's shard (collective)."""
        spec, mesh = self.specs[name], self.mesh
        t = shard.detach()
        if spec.fsdp_dim is not None:
            t = mesh.gather(t, mesh.fsdp, spec.fsdp_dim)
        if spec.tp_dim is not None:
            t = tp_join(mesh.stack(t, mesh.model), spec)
        if spec.ep_dim is not None:
            t = mesh.gather(t, mesh.ep, spec.ep_dim)
        return t.contiguous()

    # -- sharding the state ------------------------------------------------

    def shard_(self, state) -> None:
        """Cut ``state`` (a whole ``TrainState``, the same on every rank) to
        this rank's shards in place: the model, the EMA and the moments;
        the model and EMA run their forward through the layout."""
        for module in (state.model, state.ema):
            self._shard_module(module)
        kept = {n for n, _ in state.model.named_parameters()}
        for moments in (state.opt.mu, state.opt.nu):
            for name in list(moments):
                if name in kept:
                    moments[name] = self.local(name, moments[name])
                else:  # another stage's block
                    del moments[name]
        state.layout = self

    def _shard_module(self, model: nn.Module) -> None:
        ranks, mesh = self.mesh.ranks, self.mesh
        if self.pipeline is not None:
            for i in range(len(model.blocks)):
                if i not in self.pipeline.blocks:
                    model.blocks[i] = nn.Identity()  # keeps the others' names
        blocks = [b for b in model.blocks if isinstance(b, DiTBlock)]
        for block in blocks:
            attn = block.attn
            if (ATTN_ALIASES.get(attn.attn_impl, attn.attn_impl) == "block"
                    and (ranks.model > 1 or ranks.fsdp > 1 or ranks.seq > 1)):
                # K3 reads qkv's and proj's weights whole, under TP would need
                # proj's bias after the reduce, and attends to every token.
                log.warning("mesh.model=%d, mesh.fsdp=%d, mesh.seq=%d: model.attn_impl=block "
                            "takes the default route", ranks.model, ranks.fsdp, ranks.seq)
                attn.attn_impl = None
        moes = [b.mlp for b in blocks if isinstance(b.mlp, ExpertChoiceMoE)]
        if ranks.seq > 1:
            use_ring(model, mesh)
        if ranks.model > 1:
            for block in blocks:
                attn = block.attn
                if attn.num_heads % ranks.model:
                    raise ValueError(f"mesh.model={ranks.model} does not divide "
                                     f"{attn.num_heads} heads")
                attn.num_heads //= ranks.model
                pairs = [(attn.qkv, "column"), (attn.proj, "row")]
                if not isinstance(block.mlp, ExpertChoiceMoE):
                    pairs += [(block.mlp.fc1, "column"), (block.mlp.fc2, "row")]
                for lin, mode in pairs:
                    lin.tp_mode, lin.tp = mode, mesh
        for moe in moes:
            if moe.num_experts % ranks.ep:
                raise ValueError(f"mesh.ep={ranks.ep} does not divide {moe.num_experts} "
                                 "experts")
            if ranks.ep > 1 or ranks.model > 1:
                moe.mesh = mesh
            moe.first_expert = self.e * (moe.num_experts // ranks.ep)
        for name, p in list(model.named_parameters()):
            owner, leaf = _owner(model, name)
            dim = self.specs[name].fsdp_dim
            if dim is not None:
                if isinstance(owner, Linear) and leaf == "weight":
                    owner.fsdp = (mesh, dim)
                elif isinstance(owner, ExpertChoiceMoE) and leaf in EXPERT_LEAVES:
                    owner.mesh = mesh
                    owner.fsdp_dims[leaf] = dim
                else:
                    raise NotImplementedError(f"mesh.fsdp={ranks.fsdp}: {name} is neither a "
                                              "Linear weight nor an expert leaf")
            owner._parameters[leaf] = nn.Parameter(self.local(name, p.detach()),
                                                   requires_grad=p.requires_grad)

    # -- the step --------------------------------------------------------------

    def reduce_grads_(self, named: Sequence[tuple[str, torch.Tensor]]) -> None:
        """Every rank's gradients to their mean over the batch's shards.
        First the sums of partial gradients: the stem's and the head's over
        the pipe group (a stage that did not use a leaf holds zeros), the
        router's over the ep group (each rank's forward gates only its
        experts), every leaf's over the seq group (each rank's tokens).
        Then the mean: fsdp-cut leaves (already summed over fsdp) over the
        data group, the others over data x fsdp."""
        mesh = self.mesh
        if self.pipeline is not None:
            mesh.all_reduce_([g for n, g in named if block_index(n) is None], mesh.pipe)
        mesh.all_reduce_([g for n, g in named if is_router_leaf(n)], mesh.ep)
        mesh.all_reduce_([g for _, g in named], mesh.seq)
        cut = [g for n, g in named if self.specs[n].fsdp_dim is not None]
        whole = [g for n, g in named if self.specs[n].fsdp_dim is None]
        mesh.all_reduce_(cut, mesh.data)
        mesh.all_reduce_(whole, mesh.batch)
        if self.batch_size > 1:
            torch._foreach_div_([g for _, g in named], self.batch_size)

    def mean_over_batch_(self, t: torch.Tensor) -> None:
        """The metrics' mean over the batch's shards; under the pipeline the
        last stage's (the only one that computes them) first."""
        if self.pipeline is not None:
            self.mesh.broadcast_(t, self.mesh.pipe, self.mesh.pipe.size - 1)
        self.mesh.all_reduce_([t], self.mesh.batch)
        t.div_(self.batch_size)

    def global_norm(self, named: Sequence[tuple[str, torch.Tensor]]) -> torch.Tensor:
        """The norm of the whole gradient, each leaf counted once: the
        squares of cut leaves summed over the groups that cut them."""
        keys = list(itertools.product((False, True), repeat=len(CUT_AXES)))
        by_key: dict = {}
        for n, g in named:
            by_key.setdefault(self.cut_axes(n), []).append(g)
        dev = named[0][1].device
        zero = torch.zeros((), device=dev)
        sq = torch.stack([torch.linalg.vector_norm(torch.stack(torch._foreach_norm(by_key[k])))
                          ** 2 if k in by_key else zero for k in keys])
        for a, axis in enumerate(CUT_AXES):
            rows = [i for i, k in enumerate(keys) if k[a]]
            part = sq[rows].contiguous()
            self.mesh.all_reduce_([part], getattr(self.mesh, axis))
            sq[rows] = part
        return torch.sqrt(sq.sum())

    # -- checkpoints -----------------------------------------------------------

    def whole_params(self, named) -> dict:
        """``{name: tensor}`` of a module's (or moments') leaves whole, in
        the one-process names and order (collective: every rank gathers,
        every rank gets it)."""
        out = {}
        for n, t in named:
            t = self.full(n, t)
            i = block_index(n)
            if self.pipeline is None or i is None:
                out[n] = t
                continue
            # Stage s holds blocks [s L, (s+1) L); this rank's block i sits at
            # the same place in its stage as block s L + j in stage s.
            per, j = len(self.pipeline.blocks), i - self.pipeline.blocks.start
            rest = n.split(".", 2)[2]
            for s, each in enumerate(self.mesh.stack(t, self.mesh.pipe)):
                out[f"blocks.{s * per + j}.{rest}"] = each
        return {n: out[n] for n in self.names if n in out}

    def full_state_dict(self, state) -> dict:
        """``TrainState.state_dict()`` of the whole state, in the one-process
        layout (collective: every rank gathers, every rank gets it)."""
        return {"step": state.step, "model": self.whole_params(state.model.named_parameters()),
                "ema": self.whole_params(state.ema.named_parameters()),
                "opt": {"count": state.opt.count, "mu": self.whole_params(state.opt.mu.items()),
                        "nu": self.whole_params(state.opt.nu.items())}}

    def whole(self, module: nn.Module) -> nn.Module:
        """Under the pipeline, a one-process DiT of ``module``'s weights
        gathered from every stage (the validation's solves need every
        block); otherwise ``module``, whose forward runs the layout's
        collectives itself."""
        if self.pipeline is None:
            return module
        sd = self.whole_params(module.named_parameters())
        dev = next(iter(sd.values())).device
        with torch.device(dev):
            out = DiT(module.config)
        out.load_state_dict(sd)
        return out.requires_grad_(False)


def use_ring(model: nn.Module, mesh: Mesh) -> None:
    """Run ``model`` on this rank's tokens of the seq group, its attention
    as the ring and its MoE on the gathered sequence (``parallel/sequence.py``)."""
    n = model.config.num_tokens
    if n % mesh.seq.size:
        raise ValueError(f"mesh.seq={mesh.seq.size} does not divide {n} tokens")
    model.seq = mesh
    for block in model.blocks:
        if isinstance(block, DiTBlock):
            block.attn.ring = mesh
            if isinstance(block.mlp, ExpertChoiceMoE):
                block.mlp.mesh = mesh


def _owner(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    path, _, leaf = name.rpartition(".")
    return (model.get_submodule(path) if path else model), leaf


def make_layout(spec: MeshSpec, dp: DataParallel, model: nn.Module,
                microbatches: int = 0) -> Layout | None:
    """The layout of ``model``'s state on ``spec``'s mesh over ``dp``'s
    ranks, or None where the mesh is data-parallel only. ``microbatches``:
    the pipeline's (``mesh.pipe_microbatches``; 0 is twice the stages)."""
    ranks = MeshRanks.from_spec(spec, dp.world)
    if ranks.world == ranks.data:
        return None
    return Layout(Mesh(ranks, dp), {n: tuple(p.shape) for n, p in model.named_parameters()},
                  microbatches)
