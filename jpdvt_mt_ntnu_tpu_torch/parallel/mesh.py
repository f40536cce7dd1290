"""Processes on a mesh: start-up, the backend rule, the ranks' collectives.

Counterpart of ``jpdvt_mt_ntnu_tpu/parallel/mesh.py``. There one process
drives a mesh of devices and XLA inserts the collectives. Here, as in the
reference's torchrun trainers (train_JPDVT.py:111, :296-311) and its DDP
eval (inference_ddp.py:77-87, :325), each process is one rank that drives
one card, and the port's train step reduces its own gradients
(``train/steps.py``). Every axis of the JAX mesh is ported: the world is
pipe x data x fsdp x ep x seq x model ranks, placed in the JAX order
(:class:`MeshSpec`: ``pipe`` outermost, ``model`` innermost); the batch is
cut over data x fsdp, the layout of the weights over fsdp, ep, model and
pipe (``parallel/sharding.py``, ``parallel/pipeline.py``) and the tokens
over seq (``parallel/sequence.py``). ``mesh.data`` is -1 (the ranks that
the other axes leave) or that count.

Start-up (:func:`maybe_initialize_distributed`, the counterpart of the JAX
function of that name) reads, in this order:

- ``mesh.coordinator`` (``host:port`` or ``tcp://host:port``) with
  ``mesh.num_processes`` and ``mesh.process_id``;
- torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
  ``MASTER_ADDR`` and ``MASTER_PORT``;
- Slurm with more than one task (``SLURM_NTASKS``, ``SLURM_PROCID``,
  ``SLURM_LOCALID``, and this node's entry, ``SLURM_NODEID``, of
  ``SLURM_TASKS_PER_NODE``, which Slurm always sets, in its ``8(x2)`` and
  ``8,4`` forms), with ``MASTER_ADDR`` and ``MASTER_PORT``;
- Open MPI (``OMPI_COMM_WORLD_SIZE``, ``OMPI_COMM_WORLD_RANK``,
  ``OMPI_COMM_WORLD_LOCAL_RANK``, ``OMPI_COMM_WORLD_LOCAL_SIZE``), likewise.

``mesh.distributed=auto`` starts a process group where one of these names
more than one process, ``force`` also for a world of one, ``never`` never.
A ``mesh.coordinator`` launch without ``LOCAL_WORLD_SIZE`` counts the
ranks on each host after the rendezvous (each rank posts its host name to
the rendezvous store), so that the backend rule sees the ranks that share
this host's cards and not the whole world.

The backend rule (:func:`backend_and_device`): ``gloo`` on the CPU; on the
cards ``nccl`` with rank r on ``cuda:LOCAL_RANK`` where the host has a card
for each of its ranks, else ``gloo`` with the ranks sharing
``cuda:LOCAL_RANK % device_count`` (NCCL refuses two ranks on one device).
Tensors stay on the card either way. The collectives that steer the run
(barriers, the exp dir, the agreed stop flag) go over a ``gloo`` group on
the host, so a rank that dies breaks its peers' next step instead of
leaving them waiting on the card.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import default_device, rank_device

# Longest wait of any collective or of the start-up rendezvous.
TIMEOUT = datetime.timedelta(minutes=10)
# Gradients are reduced in buckets of this many elements (400 MB in fp32).
BUCKET_ELEMS = 1 << 27
# The JAX mesh's axes, outermost first (its MeshSpec.axis_sizes order).
AXES = ("pipe", "data", "fsdp", "ep", "seq", "model")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The JAX mesh's axes; ``data`` is -1 for the ranks the others leave."""

    data: int = -1
    model: int = 1
    fsdp: int = 1
    pipe: int = 1
    ep: int = 1
    seq: int = 1

    @classmethod
    def from_config(cls, mesh_cfg) -> "MeshSpec":
        return cls(**{f.name: getattr(mesh_cfg, f.name) for f in dataclasses.fields(cls)})

    def axis_sizes(self, world: int) -> dict[str, int]:
        """The axes' sizes in the JAX order (``pipe`` outermost, ``model``
        innermost): ``data`` always, the others where they are above 1.
        Raises where they do not multiply to the world size."""
        sizes = {k: max(1, getattr(self, k)) for k in AXES if k != "data"}
        rest = int(np.prod(list(sizes.values())))
        data = self.data if self.data > 0 else world // rest
        if data < 1 or data * rest != world:
            named = " x ".join([f"mesh.data={self.data}"]
                               + [f"mesh.{k}={v}" for k, v in sizes.items() if v > 1])
            raise ValueError(f"{named} must cover the world size, {world} processes (one "
                             "rank per shard)")
        return {k: (data if k == "data" else sizes[k]) for k in AXES
                if k == "data" or sizes[k] > 1}


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_shard(items: Sequence, process_index_: int | None = None,
                  process_count_: int | None = None) -> list:
    """``items[rank::world]``, the reference's ``paths[rank::world_size]``
    (inference_ddp.py:325)."""
    i = process_index() if process_index_ is None else process_index_
    n = process_count() if process_count_ is None else process_count_
    return list(items)[i::n]


def local_batch_size(global_batch: int, world: int) -> int:
    """One rank's share of the global batch (train_JPDVT.py:311)."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by {world} data shards")
    return global_batch // world


def rank_rows(global_batch: int, rank: int, world: int, grad_accum: int = 1) -> np.ndarray:
    """The rows of the global batch that ``rank`` takes, in the order its
    train step reads them: the batch is cut into ``grad_accum``
    microbatches and each microbatch across the ranks, so with one
    microbatch rank r takes rows [r B/N, (r+1) B/N)."""
    if global_batch % (grad_accum * world):
        raise ValueError(f"global batch {global_batch} not divisible by grad_accum="
                         f"{grad_accum} x {world} ranks")
    micro = global_batch // grad_accum
    part = micro // world
    return np.concatenate([np.arange(i * micro + rank * part, i * micro + (rank + 1) * part)
                           for i in range(grad_accum)])


@dataclasses.dataclass(frozen=True)
class Launch:
    """Where this process sits in a multi-process run. ``local_rank`` and
    ``local_world`` are None where the launcher does not say them; the
    rendezvous then counts them (:func:`local_ranks`)."""

    rank: int
    world: int
    local_rank: int | None
    local_world: int | None
    init_method: str
    source: str


def _int(env: Mapping[str, str], key: str, default: int) -> int:
    value = env.get(key, "")
    digits = value.split("(")[0].split(",")[0]  # Slurm's "2(x3)" and "2,1"
    return int(digits) if digits.strip() else default


def slurm_tasks_on_node(tasks_per_node: str, node: int) -> int:
    """Node ``node``'s entry of ``SLURM_TASKS_PER_NODE``: ``8(x2),4`` is
    8, 8 and 4 tasks on nodes 0, 1 and 2."""
    counts: list[int] = []
    for part in tasks_per_node.split(","):
        n, _, rep = part.partition("(x")
        counts += [int(n)] * (int(rep.rstrip(")")) if rep else 1)
    if not 0 <= node < len(counts):
        raise ValueError(f"SLURM_TASKS_PER_NODE={tasks_per_node!r} has no node {node}")
    return counts[node]


def local_ranks(hosts: Sequence[str], rank: int) -> tuple[int, int]:
    """(local rank, local world) of ``rank`` from every rank's host name:
    its place among the ranks on its host, and their count."""
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return mine.index(rank), len(mine)


def _master(env: Mapping[str, str], source: str) -> str:
    addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
    if not addr or not port:
        raise ValueError(f"a {source} launch needs MASTER_ADDR and MASTER_PORT (or "
                         "mesh.coordinator=host:port) for the process group's rendezvous")
    return f"tcp://{addr}:{port}"


def detect_launch(mesh_cfg=None, env: Mapping[str, str] | None = None) -> Launch | None:
    """The launch this process belongs to, or None for a run of one
    process (``mesh.distributed``: auto, never, force)."""
    env = os.environ if env is None else env
    mode = getattr(mesh_cfg, "distributed", "auto") if mesh_cfg is not None else "auto"
    if mode not in ("auto", "never", "force"):
        raise ValueError(f"mesh.distributed={mode!r}: auto, never or force")
    if mode == "never":
        return None
    coordinator = getattr(mesh_cfg, "coordinator", "") if mesh_cfg is not None else ""
    if coordinator:
        world = getattr(mesh_cfg, "num_processes", 0) or _int(env, "WORLD_SIZE", 0)
        rank = getattr(mesh_cfg, "process_id", -1)
        rank = rank if rank >= 0 else _int(env, "RANK", -1)
        if world < 1 or not 0 <= rank < world:
            raise ValueError(f"mesh.coordinator={coordinator!r} needs mesh.num_processes "
                             f"and mesh.process_id (got {world}, {rank})")
        method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        if "LOCAL_WORLD_SIZE" not in env:  # counted at the rendezvous
            return Launch(rank, world, None, None, method, "mesh.coordinator")
        return Launch(rank, world, _int(env, "LOCAL_RANK", rank),
                      _int(env, "LOCAL_WORLD_SIZE", world), method, "mesh.coordinator")
    found = None
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = _int(env, "RANK", 0), _int(env, "WORLD_SIZE", 1)
        found = ("torchrun", rank, world, _int(env, "LOCAL_RANK", rank),
                 _int(env, "LOCAL_WORLD_SIZE", world))
    elif _int(env, "SLURM_NTASKS", 1) > 1:
        world, rank = _int(env, "SLURM_NTASKS", 1), _int(env, "SLURM_PROCID", 0)
        per_node = (_int(env, "SLURM_NTASKS_PER_NODE", world) if "SLURM_NTASKS_PER_NODE" in env
                    else slurm_tasks_on_node(env.get("SLURM_TASKS_PER_NODE", str(world)),
                                             _int(env, "SLURM_NODEID", 0)))
        found = ("Slurm", rank, world, _int(env, "SLURM_LOCALID", rank), per_node)
    elif _int(env, "OMPI_COMM_WORLD_SIZE", 1) > 1:
        world, rank = _int(env, "OMPI_COMM_WORLD_SIZE", 1), _int(env, "OMPI_COMM_WORLD_RANK", 0)
        found = ("Open MPI", rank, world, _int(env, "OMPI_COMM_WORLD_LOCAL_RANK", rank),
                 _int(env, "OMPI_COMM_WORLD_LOCAL_SIZE", world))
    if found is None:
        if mode == "force":
            raise ValueError("mesh.distributed=force, but neither mesh.coordinator nor a "
                             "torchrun, Slurm or Open MPI environment names the processes")
        return None
    source, rank, world, local, local_world = found
    if world == 1 and mode != "force":
        return None
    if not 0 <= rank < world:
        raise ValueError(f"{source}: rank {rank} outside a world of {world}")
    return Launch(rank, world, local, local_world, _master(env, source), source)


def backend_and_device(device_type: str, local_rank: int, local_world: int,
                       device_count: int) -> tuple[str, torch.device]:
    """``gloo`` on the CPU; on the cards ``nccl`` where the host has a card
    per rank, else ``gloo`` with ranks sharing cards; the device is
    :func:`rank_device`'s."""
    if device_type == "cpu":
        return "gloo", torch.device("cpu")
    return ("nccl" if device_count >= local_world else "gloo",
            rank_device(local_rank, device_count))


class DataParallel:
    """This process's rank in its data-parallel group, with the group's
    collectives. A world of one (no process group) makes each a no-op."""

    def __init__(self, rank: int = 0, world: int = 1, device: torch.device | None = None,
                 backend: str | None = None, source: str = "one process",
                 control=None, owns_group: bool = False):
        self.rank, self.world = rank, world
        self.device = device if device is not None else torch.device("cpu")
        self.backend, self.source = backend, source
        self._control = control
        self._owns_group = owns_group

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def in_group(self) -> bool:
        """Whether a process group of this object's is running."""
        return self._owns_group

    def describe(self) -> dict:
        return {"world_size": self.world, "rank": self.rank, "backend": self.backend or "none",
                "device": str(self.device), "launch": self.source}

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor],
                         bucket_elems: int = BUCKET_ELEMS) -> None:
        """Replace each tensor (float32, one device) by its mean over the
        ranks, in buckets of at most ``bucket_elems`` elements (a process
        group of one rank reduces too, so that its backend is exercised)."""
        if not self.in_group:
            return
        buckets, bucket, size = [], [], 0
        for t in tensors:
            if bucket and size + t.numel() > bucket_elems:
                buckets.append(bucket)
                bucket, size = [], 0
            bucket.append(t)
            size += t.numel()
        for bucket in buckets + [bucket]:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat)
            flat.div_(self.world)
            torch._foreach_copy_(bucket, [v.view_as(t) for v, t in
                                          zip(flat.split([t.numel() for t in bucket]), bucket)])

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (every rank gets the answer)."""
        if self.world == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._control)
        return bool(t.item())

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self._control)

    def broadcast(self, obj, src: int = 0):
        """Rank ``src``'s ``obj`` on every rank."""
        if self.world == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self._control)
        return box[0]

    def all_gather(self, obj) -> list:
        if self.world == 1:
            return [obj]
        out: list = [None] * self.world
        dist.all_gather_object(out, obj, group=self._control)
        return out

    def check_replicas(self, tensors: Sequence[torch.Tensor], what: str) -> None:
        """Raise unless every rank holds the same bits in ``tensors`` (a sum
        of each tensor's 32-bit words, gathered)."""
        if self.world == 1:
            return
        sums = [int(t.detach().contiguous().view(torch.int32).to(torch.int64).sum())
                if t.element_size() == 4 else int(t.detach().to(torch.int64).sum())
                for t in tensors]
        gathered = self.all_gather(sums)
        if any(g != gathered[0] for g in gathered):
            bad = [r for r, g in enumerate(gathered) if g != gathered[0]]
            raise RuntimeError(f"{what} differs across ranks: ranks {bad} against rank 0")

    def close(self) -> None:
        """Leave the process group this object started."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self._owns_group = False


def initialize_distributed(launch: Launch, device: str | torch.device | None = None
                           ) -> DataParallel:
    """Start the process group of ``launch`` on the backend and device of
    :func:`backend_and_device` (``device``: None or ``cuda`` for the
    cards, ``cpu`` for the CPU)."""
    device_type = torch.device(device or "cuda").type
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    store, rank, world = next(dist.rendezvous(launch.init_method, launch.rank, launch.world,
                                              timeout=TIMEOUT))
    local_rank, local_world = launch.local_rank, launch.local_world
    if local_world is None:
        store.set(f"jpdvt_host/{rank}", socket.gethostname())
        hosts = [store.get(f"jpdvt_host/{r}").decode() for r in range(world)]
        local_rank, local_world = local_ranks(hosts, rank)
    backend, dev = backend_and_device(device_type, local_rank, local_world, count)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # device_id: NCCL sets up its communicator here, not in the first step.
    dist.init_process_group(backend, store=store, world_size=world, rank=rank,
                            timeout=TIMEOUT, device_id=dev if backend == "nccl" else None)
    control = dist.new_group(backend="gloo", timeout=TIMEOUT) if backend != "gloo" else None
    return DataParallel(launch.rank, launch.world, dev, backend, launch.source, control,
                        owns_group=True)


def maybe_initialize_distributed(mesh_cfg=None, device: str | torch.device | None = None,
                                 env: Mapping[str, str] | None = None) -> DataParallel:
    """The process group of this run where one was asked for or a
    launcher's environment names one (see the module's docstring), else
    a world of one on ``default_device(device)``. Checks ``mesh.data``
    against the world size."""
    launch = detect_launch(mesh_cfg, env)
    if launch is None:
        dp = DataParallel(device=default_device(device))
    else:
        dp = initialize_distributed(launch, device)
    if mesh_cfg is not None:
        try:
            MeshSpec.from_config(mesh_cfg).axis_sizes(dp.world)
        except ValueError:
            dp.close()
            raise
    return dp
