"""Tensor parallelism (``mesh.model``) and fully-sharded data parallelism (``mesh.fsdp``).

Counterpart of ``jpdvt_mt_ntnu_tpu/parallel/sharding.py``. There GSPMD
turns the partition specs into collectives; here each process is one rank
of the data x fsdp x model mesh (:class:`MeshRanks`, ``model`` innermost as
in the JAX package) and the collectives are written out:

- **Tensor parallelism**, the JAX package's ``_TP_RULES`` (Megatron): the
  DiT block's qkv and fc1 keep their output features of this model rank,
  proj and fc2 their input features. qkv's [q|k|v] rows are cut by heads,
  so that each rank's attention kernels (K1/K2, K4-K6) run on its own heads
  whole. ``dit.Linear`` applies the conjugate pair around them (``tp_mode``
  "column": identity forward, all-reduce of the gradient; "row": all-reduce
  of the partial sums in fp32, the bias added once after it). adaLN, the
  embeddings, the heads and every other leaf stay replicated, and get
  identical gradients on the ranks of a model group.
- **Fully-sharded data parallelism**, ``_with_fsdp`` (ZeRO-3): every leaf of
  two or more dimensions keeps 1/fsdp of its largest dimension that no TP
  rule takes and that fsdp divides (in the JAX package's Flax order: a
  Linear's (in, out)), in the params, the EMA and the AdamW moments; 1-D
  leaves stay replicated. Every such leaf is a ``dit.Linear`` weight, whose
  forward gathers it, casts it and applies it in one autograd function
  (:class:`_GatheredLinear`) that saves only the shard: the backward
  gathers the weight again, and reduce-scatters its gradient. A full
  weight lives only while its product runs.
- The batch is cut over data x fsdp (``batch_index``, ``batch_size``); a
  model group's ranks take the same rows. The gradients of sharded leaves
  are reduced over the data group after the fsdp reduce-scatter, those of
  the other leaves over data x fsdp; the global norm sums each leaf once.
- Checkpoints hold the one-process layout: :meth:`Layout.full_state_dict`
  gathers the state on every rank, and a restore into the full state before
  :meth:`Layout.shard_` re-shards it.

The gathers and reduce-scatters are the backends' own
(``all_gather_into_tensor``, ``reduce_scatter_tensor``), which gloo takes
on the CPU and on a card's tensors, and nccl across cards.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.dit import Linear
from .mesh import BUCKET_ELEMS, DataParallel, MeshSpec

log = logging.getLogger(__name__)

# torch >= 2.13 names the single-tensor collectives so; older ones as below.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


# ------------------------------------------------------------------- placement

@dataclasses.dataclass(frozen=True)
class MeshRanks:
    """Where each rank sits on the data x fsdp x model mesh, ``model``
    innermost: rank r is (r // (F M), r // M % F, r % M)."""

    data: int = 1
    fsdp: int = 1
    model: int = 1

    @classmethod
    def from_spec(cls, spec: MeshSpec, world: int) -> "MeshRanks":
        sizes = spec.axis_sizes(world)
        return cls(sizes["data"], sizes.get("fsdp", 1), sizes.get("model", 1))

    @property
    def world(self) -> int:
        return self.data * self.fsdp * self.model

    def coords(self, rank: int) -> tuple[int, int, int]:
        return rank // (self.fsdp * self.model), rank // self.model % self.fsdp, rank % self.model

    def groups(self, axes: str) -> list[list[int]]:
        """Every group of ranks that differ only along ``axes`` (letters of
        "dfm": "m" the model groups, "df" the batch's data x fsdp), each in
        rank order, which is its order along those axes."""
        out: dict = {}
        for r in range(self.world):
            key = tuple(c for a, c in zip("dfm", self.coords(r)) if a not in axes)
            out.setdefault(key, []).append(r)
        return [out[k] for k in sorted(out)]

    def batch_index(self, rank: int) -> int:
        """This rank's shard of the batch: its (d, f) in data x fsdp."""
        d, f, _ = self.coords(rank)
        return d * self.fsdp + f

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
    """This process's groups on the mesh (model, fsdp, data and the batch's
    data x fsdp) and the collectives over them (see the module docstring)."""

    def __init__(self, ranks: MeshRanks, dp: DataParallel):
        if ranks.world != dp.world:
            raise ValueError(f"a mesh of {ranks.world} ranks on a world of {dp.world}")
        self.ranks = ranks
        self.rank = dp.rank
        found = {}
        # Every rank creates every group, in one order, as new_group requires.
        for name, axes in (("model", "m"), ("fsdp", "f"), ("data", "d"), ("batch", "df")):
            for members in ranks.groups(axes):
                pg = dist.new_group(members) if dp.in_group and len(members) > 1 else None
                if self.rank in members:
                    found[name] = Group(members, members.index(self.rank), pg)
        self.model, self.fsdp, self.data, self.batch = (
            found[k] for k in ("model", "fsdp", "data", "batch"))

    def __deepcopy__(self, memo):  # modules that hold it are copied, it is not
        return self

    @property
    def describe(self) -> dict:
        return {"data": self.ranks.data, "fsdp": self.ranks.fsdp, "model": self.ranks.model,
                "coords": self.ranks.coords(self.rank)}

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
        n = group.size
        parts = full.unflatten(dim, (n, full.shape[dim] // n)).movedim(dim, 0).contiguous()
        out = torch.empty_like(parts[0])
        _reduce_scatter(out.view(-1), parts.view(-1), group=group.pg)
        return out

    # Megatron's conjugate pair over the model group (dit.Linear's tp_mode).
    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self) if self.model.size > 1 else x

    def reduce_from_model(self, y: torch.Tensor) -> torch.Tensor:
        """The fp32 sum over the model group of the partial products ``y``."""
        return _ReduceFromModel.apply(y, self) if self.model.size > 1 else y.float()

    def gathered_linear(self, x: torch.Tensor, shard: torch.Tensor, bias: torch.Tensor | None,
                        dim: int) -> torch.Tensor:
        """``F.linear(x, w, bias)`` with ``w`` this fsdp group's weight,
        gathered from ``shard`` (cut along ``dim``) and cast to x's type."""
        return _GatheredLinear.apply(x, shard, bias, self, dim)

    def sum_fp32(self, t: torch.Tensor) -> torch.Tensor:
        out = t.to(torch.float32, copy=True)
        dist.all_reduce(out, group=self.model.pg)
        return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group (in fp32)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.sum_fp32(g).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial sums added over the model group in fp32; identity backward."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.dtype = y.dtype
        return mesh.sum_fp32(y)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _GatheredLinear(torch.autograd.Function):
    """A Linear on a weight gathered over the fsdp group. It saves the
    input and the shard, gathers the weight again in the backward where
    the input needs a gradient, and reduce-scatters the weight's gradient
    (computed in the compute type, summed in the shard's)."""

    @staticmethod
    def forward(ctx, x, shard, bias, mesh, dim):
        w = mesh.gather(shard.detach(), mesh.fsdp, dim).to(x.dtype)
        ctx.save_for_backward(x, shard)
        ctx.mesh, ctx.dim = mesh, dim
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
            full = g2.T @ x.reshape(-1, x.shape[-1])
            gw = mesh.scatter_sum(full.to(shard.dtype), mesh.fsdp, ctx.dim)
        if ctx.needs_input_grad[2]:
            gb = g2.sum(0)
        return gx, gw, gb, None, None


# ----------------------------------------------------------------------- rules

@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """How one leaf is cut: ``tp_dim`` over the model group (in ``tp_parts``
    runs cut alike: qkv's q, k and v), then ``fsdp_dim`` over fsdp."""

    tp_dim: int | None = None
    tp_parts: int = 1
    fsdp_dim: int | None = None


# (module names, torch dim of the weight, of the bias, runs): _TP_RULES in the
# torch layout, where a Linear's weight is (out, in).
TP_RULES = ((("attn", "qkv"), 0, 0, 3), (("attn", "proj"), 1, None, 1),
            (("mlp", "fc1"), 0, 0, 1), (("mlp", "fc2"), 1, None, 1))
# The expert-choice MoE's leaves, whose expert hidden dims JAX's _EP_RULES
# give the model axis (so never fsdp's): torch dim of each.
EP_MODEL_DIMS = {"wi": 2, "bi": 1, "wo": 1}


def tp_rule(name: str, ndim: int) -> tuple[int | None, int]:
    """(torch dim cut over the model group, runs) of a leaf by its name."""
    parts = name.split(".")
    for keys, wdim, bdim, runs in TP_RULES:
        if all(k in parts for k in keys):
            if parts[-1] == "weight" and ndim == 2:
                return wdim, runs
            if parts[-1] == "bias" and ndim == 1:
                return bdim, runs
    return None, 1


def fsdp_dim(name: str, shape: Sequence[int], taken: int | None, fsdp: int) -> int | None:
    """``_with_fsdp``: the largest dim that no TP rule takes and that fsdp
    divides, ties to the first in the JAX package's order (a Linear weight's
    Flax kernel is (in, out), the torch weight's transpose); None for 1-D
    leaves and where no dim divides."""
    if fsdp <= 1 or len(shape) < 2:
        return None
    flax = name.endswith(".weight") and len(shape) == 2
    order = [1, 0] if flax else list(range(len(shape)))
    parts = name.split(".")
    if "mlp" in parts and parts[-1] in EP_MODEL_DIMS:
        taken = EP_MODEL_DIMS[parts[-1]]
    free = [d for d in order if d != taken and shape[d] % fsdp == 0]
    return max(free, key=lambda d: shape[d]) if free else None


def leaf_specs(shapes: dict[str, Sequence[int]], model: int, fsdp: int) -> dict[str, LeafSpec]:
    """The spec of every named leaf of a DiT for a mesh of ``model`` x ``fsdp``."""
    out = {}
    for name, shape in shapes.items():
        dim, runs = tp_rule(name, len(shape))
        out[name] = LeafSpec(dim if model > 1 else None, runs,
                             fsdp_dim(name, shape, dim, fsdp))
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

class Layout:
    """The train state's layout on a mesh: shards it, runs its forward and
    backward with the collectives, reduces its gradients, measures their
    global norm and gathers it whole for a checkpoint."""

    def __init__(self, mesh: Mesh, shapes: dict[str, Sequence[int]]):
        self.mesh = mesh
        r = mesh.ranks
        self.specs = leaf_specs(shapes, r.model, r.fsdp)
        self.m = mesh.model.index
        self.f = mesh.fsdp.index

    @property
    def batch_index(self) -> int:
        return self.mesh.ranks.batch_index(self.mesh.rank)

    @property
    def batch_size(self) -> int:
        return self.mesh.ranks.batch_size

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a full leaf (a new contiguous tensor)."""
        spec = self.specs[name]
        t = tp_slice(full, spec, self.m, self.mesh.ranks.model)
        return fsdp_slice(t, spec, self.f, self.mesh.ranks.fsdp).contiguous().clone()

    def full(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """A leaf whole from every rank's shard (collective)."""
        spec, mesh = self.specs[name], self.mesh
        t = shard.detach()
        if spec.fsdp_dim is not None:
            t = mesh.gather(t, mesh.fsdp, spec.fsdp_dim)
        if spec.tp_dim is not None:
            t = tp_join(mesh.stack(t, mesh.model), spec)
        return t.contiguous()

    # -- sharding the state ------------------------------------------------

    def shard_(self, state) -> None:
        """Cut ``state`` (a whole ``TrainState``, the same on every rank) to
        this rank's shards in place: the model, the EMA and the moments;
        the model and EMA run their forward through the layout."""
        for module in (state.model, state.ema):
            self._shard_module(module)
        for moments in (state.opt.mu, state.opt.nu):
            for name in list(moments):
                moments[name] = self.local(name, moments[name])
        state.layout = self

    def _shard_module(self, model: nn.Module) -> None:
        ranks = self.mesh.ranks
        for block in model.blocks:
            attn = block.attn
            if attn.attn_impl == "block":
                # K3 reads qkv's and proj's weights whole, and under TP would
                # need proj's bias after the reduce.
                log.warning("mesh.model=%d, mesh.fsdp=%d: model.attn_impl=block takes the "
                            "default route", ranks.model, ranks.fsdp)
                attn.attn_impl = None
        if ranks.model > 1:
            for block in model.blocks:
                attn = block.attn
                if attn.num_heads % ranks.model:
                    raise ValueError(f"mesh.model={ranks.model} does not divide "
                                     f"{attn.num_heads} heads")
                attn.num_heads //= ranks.model
                for lin, mode in ((attn.qkv, "column"), (attn.proj, "row"),
                                  (block.mlp.fc1, "column"), (block.mlp.fc2, "row")):
                    lin.tp_mode, lin.tp = mode, self.mesh
        for name, p in list(model.named_parameters()):
            owner, leaf = _owner(model, name)
            dim = self.specs[name].fsdp_dim
            if dim is not None:
                if not (isinstance(owner, Linear) and leaf == "weight"):
                    raise NotImplementedError(
                        f"mesh.fsdp={ranks.fsdp}: {name} is not a Linear weight (the port "
                        "shards Linear weights; the expert-choice MoE's experts wait for "
                        "the expert rules)")
                owner.fsdp = (self.mesh, dim)
            owner._parameters[leaf] = nn.Parameter(self.local(name, p.detach()),
                                                   requires_grad=p.requires_grad)

    # -- the step --------------------------------------------------------------

    def reduce_grads_(self, named: Sequence[tuple[str, torch.Tensor]]) -> None:
        """Every rank's gradients to their mean over the batch's shards:
        fsdp-cut leaves (already summed over fsdp) over the data group, the
        others over data x fsdp."""
        mesh = self.mesh
        cut = [g for n, g in named if self.specs[n].fsdp_dim is not None]
        whole = [g for n, g in named if self.specs[n].fsdp_dim is None]
        mesh.all_reduce_(cut, mesh.data)
        mesh.all_reduce_(whole, mesh.batch)
        if self.batch_size > 1:
            torch._foreach_div_([g for _, g in named], self.batch_size)

    def mean_over_batch_(self, t: torch.Tensor) -> None:
        self.mesh.all_reduce_([t], self.mesh.batch)
        t.div_(self.batch_size)

    def global_norm(self, named: Sequence[tuple[str, torch.Tensor]]) -> torch.Tensor:
        """The norm of the whole gradient, each leaf counted once: the
        squares of cut leaves summed over the groups that cut them."""
        sq = {}
        for n, g in named:
            spec = self.specs[n]
            key = (spec.tp_dim is not None, spec.fsdp_dim is not None)
            sq.setdefault(key, []).append(g)
        dev = named[0][1].device
        parts = {k: torch.linalg.vector_norm(torch.stack(torch._foreach_norm(v))) ** 2
                 for k, v in sq.items()}
        tp = torch.stack([parts.get((True, False), torch.zeros((), device=dev)),
                          parts.get((True, True), torch.zeros((), device=dev))])
        self.mesh.all_reduce_([tp], self.mesh.model)
        fs = torch.stack([parts.get((False, True), torch.zeros((), device=dev)), tp[1]])
        self.mesh.all_reduce_([fs], self.mesh.fsdp)
        return torch.sqrt(parts.get((False, False), torch.zeros((), device=dev))
                          + tp[0] + fs[0] + fs[1])

    # -- checkpoints -----------------------------------------------------------

    def full_state_dict(self, state) -> dict:
        """``TrainState.state_dict()`` of the whole state, in the one-process
        layout (collective: every rank gathers, every rank gets it)."""
        def whole(named):
            return {n: self.full(n, t) for n, t in named}

        return {"step": state.step, "model": whole(state.model.named_parameters()),
                "ema": whole(state.ema.named_parameters()),
                "opt": {"count": state.opt.count, "mu": whole(state.opt.mu.items()),
                        "nu": whole(state.opt.nu.items())}}


def _owner(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    path, _, leaf = name.rpartition(".")
    return (model.get_submodule(path) if path else model), leaf


def make_layout(spec: MeshSpec, dp: DataParallel, model: nn.Module) -> Layout | None:
    """The layout of ``model``'s state on ``spec``'s mesh over ``dp``'s
    ranks, or None where the mesh is data-parallel only."""
    ranks = MeshRanks.from_spec(spec, dp.world)
    if ranks.model == 1 and ranks.fsdp == 1:
        return None
    return Layout(Mesh(ranks, dp), {n: tuple(p.shape) for n, p in model.named_parameters()})
