"""One rank of a gloo group on the CPU running the expert, pipeline and sequence axes.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_axes_worker.py <out.npz> <weights dir> <suite>

joins the group as torchrun's ranks do and runs every mesh of
``SUITES[suite]`` on it: 3 train steps of a tiny DiT in fp32 (48 px,
hidden 64, 4 heads; :data:`MODELS`) with injected draws, on the same
global batches as ``tests/torch_parallel_worker.py``, cut by
``parallel/sharding.py``'s layout, writing to ``out.npz`` per mesh the
per-step metrics, the whole state gathered after the last step, the
first step's reduced gradients, and its reduce-scatters beside the
fsdp-cut leaves its backward reached. The 4-rank suites also run the
compositions (pipe x model, pipe x fsdp, seq x model, seq x ep). The sequence suites also run the ring
(``parallel/sequence.py``) on fixed inputs, forward and backward, and the
seq=2 suite the solver with the ring. Every mesh holds the replicated
leaves' gradients equal on all ranks (``DataParallel.check_replicas``).
The tests run :func:`run_case` with no mesh in their own process as the
one-process reference. It imports torch, numpy and the port only.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

import torch_parallel_worker as dpw
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.parallel import MeshSpec, maybe_initialize_distributed, rank_rows
from jpdvt_mt_ntnu_tpu_torch.parallel.sharding import (Mesh, MeshRanks, is_router_leaf,
                                                       make_layout, use_ring)
from jpdvt_mt_ntnu_tpu_torch.train import (CheckpointManager, TrainTask, create_train_state,
                                           make_optimizer, make_train_step)
from jpdvt_mt_ntnu_tpu_torch.utils.pos_embed import grid_code

# name -> (registry name, overrides): the MoE of 4 experts (9 tokens), the
# dense DiT of depth 4 (2 blocks a stage at pipe=2), and the 36-token DiT of
# patch 8 (18 tokens a rank at seq=2), dense and with 4 experts.
MODELS = {
    "moe": ("JPDVT-MoE", dict(depth=2, hidden_size=64, num_heads=4, moe_experts=4)),
    "deep": ("JPDVT", dict(depth=4, hidden_size=64, num_heads=4)),
    "p8": ("JPDVT", dict(depth=2, hidden_size=64, num_heads=4, patch_size=8)),
    "p8moe": ("JPDVT-MoE", dict(depth=2, hidden_size=64, num_heads=4, patch_size=8,
                                moe_experts=4)),
}
# mesh name -> (model, MeshSpec fields, pipe microbatches)
MESHES = {
    "ep2": ("moe", dict(ep=2), 0),
    "moe_tp2": ("moe", dict(model=2), 0),
    "moe_fsdp2": ("moe", dict(fsdp=2), 0),
    "ep2_data2": ("moe", dict(ep=2, data=2), 0),
    "ep2_tp2": ("moe", dict(ep=2, model=2), 0),
    "ep2_fsdp2": ("moe", dict(ep=2, fsdp=2), 0),
    "pipe2": ("deep", dict(pipe=2), 4),
    "pipe2_data2": ("deep", dict(pipe=2, data=2), 2),
    "pipe2_tp2": ("deep", dict(pipe=2, model=2), 4),
    "pipe2_fsdp2": ("deep", dict(pipe=2, fsdp=2), 2),
    "seq2": ("p8", dict(seq=2), 0),
    "seq2_moe": ("p8moe", dict(seq=2), 0),
    "seq2_data2": ("p8", dict(seq=2, data=2), 0),
    "seq2_fsdp2": ("p8", dict(seq=2, fsdp=2), 0),
    "seq2_tp2": ("p8", dict(seq=2, model=2), 0),
    "seq2_ep2": ("p8moe", dict(seq=2, ep=2), 0),
}
# suite -> (world, meshes, ring sizes, solve)
SUITES = {
    "ep-2": (2, ("ep2", "moe_tp2", "moe_fsdp2"), (), False),
    "ep-4": (4, ("ep2_data2", "ep2_tp2", "ep2_fsdp2"), (), False),
    "pipe-2": (2, ("pipe2",), (), False),
    "pipe-4": (4, ("pipe2_data2", "pipe2_tp2", "pipe2_fsdp2"), (), False),
    "seq-2": (2, ("seq2", "seq2_moe"), (2,), True),
    "seq-4": (4, ("seq2_data2", "seq2_fsdp2", "seq2_tp2", "seq2_ep2"), (4,), False),
}
RING = dict(b=2, n=24, heads=4, dim=8)


def draws(step: int, n_tokens: int) -> dict:
    """The injected draws of ``step`` for the whole global batch (one
    microbatch): timesteps, permutations and both noises."""
    rng = np.random.default_rng(300 + step)
    return {"t": rng.integers(0, 1000, dpw.B),
            "indices": np.stack([rng.permutation(dpw.GRID ** 2) for _ in range(dpw.B)]),
            "noise_x": rng.standard_normal((dpw.B, dpw.SIZE, dpw.SIZE, 3)).astype(np.float32),
            "noise_c": rng.standard_normal((dpw.B, n_tokens, 8)).astype(np.float32)}


class Injected:
    """A ``Diffusion`` whose training loss takes :func:`draws`."""

    def __init__(self, diffusion, n_tokens: int):
        self.diffusion, self.n_tokens, self.calls = diffusion, n_tokens, 0

    def __getattr__(self, name):
        return getattr(self.diffusion, name)

    def training_losses(self, model_fn, x, t, code, *, rows=None, **kw):
        d = draws(self.calls, self.n_tokens)
        self.calls += 1
        t = torch.as_tensor(d["t"])
        return self.diffusion.training_losses(
            model_fn, x, t if rows is None else t[rows], code, rows=rows,
            _inject={k: v for k, v in d.items() if k != "t"}, **kw)


def build(model: str, weights_dir: str):
    name, kw = MODELS[model]
    net, cfg = create_model(name, dpw.SIZE, device="cpu", **kw)
    with np.load(os.path.join(weights_dir, f"{model}.npz")) as z:
        net.load_state_dict({k: torch.from_numpy(v) for k, v in z.items()})
    return net, cfg


def run_case(mesh_name: str, weights_dir: str, dp=None, ckpt: str | None = None) -> dict:
    """3 steps of ``mesh_name``'s model, on its mesh over ``dp`` (None: one
    process): the per-step metrics, the final state whole and the first
    step's reduced gradients."""
    model_name, axes, micro = MESHES[mesh_name]
    net, cfg = build(model_name, weights_dir)
    state = create_train_state(net)
    layout = make_layout(MeshSpec(**axes), dp, net, micro) if dp is not None else None
    if layout is not None:
        layout.shard_(state)
    task = TrainTask(grid_size=dpw.GRID, block_size=dpw.SIZE // dpw.GRID,
                     patch_size=cfg.patch_size, ema_warmup=True)
    diffusion = Injected(create_diffusion("", device="cpu"), cfg.num_tokens)
    step = make_train_step(diffusion, make_optimizer(dpw.LR), task,
                           torch.as_tensor(grid_code(8, dpw.GRID)), dp=dp, layout=layout)
    parts, index = (layout.batch_size, layout.batch_index) if layout else (1, 0)
    rows = rank_rows(dpw.B, index, parts)
    partial = {}  # the router's gradients of the first step before the reduction
    used = []  # the fsdp-cut leaves the first step's backward reached (the others hold zeros)
    if layout is not None:
        reduce = layout.reduce_grads_

        def recording(named):
            if not used:
                partial.update({n: g.clone() for n, g in named if is_router_leaf(n)})
                used.append(sum(1 for n, g in named
                                if layout.specs[n].fsdp_dim is not None and g.any()))
            reduce(named)

        layout.reduce_grads_ = recording
    out: dict = {k: [] for k in ("loss", "code_mse", "img_mse", "grad_norm")}
    grads = {}
    for s in range(dpw.STEPS):
        state, metrics = step(state, torch.from_numpy(dpw.images(s)[rows]))
        for k in out:
            out[k].append(float(metrics[k]))
        if s == 0:
            named = list(state.model.named_parameters())
            scatters = layout.mesh.reduce_scatters if layout is not None else 0
            if dp is not None:  # the replicated leaves' gradients, bit-equal on every rank
                dp.check_replicas([p.grad for n, p in named if not any(layout.cut_axes(n))],
                                  f"{mesh_name}: the replicated leaves' gradients")
            grads = {n: p.grad.detach().clone() for n, p in named if not any(
                layout.cut_axes(n))} if layout is not None else {
                n: p.grad.detach().clone() for n, p in named}
    res = {k: np.asarray(v) for k, v in out.items()}
    sd = state.state_dict()
    for part in ("model", "ema"):
        res.update({f"{part}.{k}": v.detach().numpy().copy() for k, v in sd[part].items()})
    for part in ("mu", "nu"):
        res.update({f"{part}.{k}": v.detach().numpy().copy() for k, v in sd["opt"][part].items()})
    res.update({f"grad.{k}": v.numpy() for k, v in grads.items()})
    res.update({f"partial.{k}": v.numpy() for k, v in partial.items()})
    if layout is not None:  # the first step's reduce-scatters, and the leaves they serve
        res["fsdp_leaves_used"] = np.asarray(used[0])
        res["reduce_scatters"] = np.asarray(scatters)
    if ckpt is not None:
        CheckpointManager(ckpt, dp=dp).save(state)
    return res


def ring_inputs() -> tuple[torch.Tensor, torch.Tensor]:
    """(qkv (B, N, 3 H D), dO (B, N, H D)) of the ring's check."""
    rng = np.random.default_rng(5)
    b, n, h, d = (RING[k] for k in ("b", "n", "heads", "dim"))
    return (torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((b, n, h * d)).astype(np.float32)))


def run_ring(dp, seq: int) -> dict:
    """The ring on a (data, seq) mesh of the world: this seq group's whole
    output and qkv gradient, gathered over the group."""
    mesh = Mesh(MeshRanks(data=dp.world // seq, seq=seq), dp)
    qkv, g = ring_inputs()
    mine = mesh.local_tokens(qkv).clone().requires_grad_()
    out = mesh.ring_attention(mine, RING["heads"])
    out.backward(mesh.local_tokens(g))
    return {f"ring{seq}/out": mesh.gather(out.detach(), mesh.seq, 1).numpy(),
            f"ring{seq}/grad": mesh.gather(mine.grad, mesh.seq, 1).numpy()}


def solve(weights_dir: str, dp=None) -> np.ndarray:
    """The faithful 5-step solve of 4 puzzles by the seq=2 model, with the
    ring where ``dp`` is given (the JAX package's test_sequence_eval)."""
    net, cfg = build("p8", weights_dir)
    if dp is not None:
        use_ring(net, Mesh(MeshRanks(seq=2), dp))
    rng = np.random.default_rng(9)
    x = (0.5 * rng.standard_normal((4, dpw.SIZE, dpw.SIZE, 3))).astype(np.float32)
    perms = np.stack([rng.permutation(dpw.GRID ** 2) for _ in range(4)])
    res = PuzzleSolver(net, cfg, create_diffusion("5", device="cpu"), grid_size=dpw.GRID,
                       mode="faithful", device="cpu").evaluate(x, perms)
    return np.asarray(res.pred)


def main(argv) -> None:
    out_path, weights_dir, suite = argv[:3]
    torch.set_num_threads(1)  # up to 4 ranks beside the test's own process
    dp = maybe_initialize_distributed(device="cpu")
    world, meshes, rings, with_solve = SUITES[suite]
    assert dp.world == world, (dp.world, world)
    res = {}
    for i, name in enumerate(meshes):
        ckpt = os.path.join(os.path.dirname(out_path), f"{name}_ckpt")
        res.update({f"{name}/{k}": v for k, v in run_case(name, weights_dir, dp, ckpt).items()})
    for seq in rings:
        res.update(run_ring(dp, seq))
    if with_solve:
        res["solve/pred"] = solve(weights_dir, dp)
    np.savez(out_path, **res)
    dp.close()


if __name__ == "__main__":
    main(sys.argv[1:])
