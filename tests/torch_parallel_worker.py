"""One rank of a two-process gloo group on the CPU, for tests/test_torch_parallel.py.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel_worker.py <out.npz> <weights.npz>

joins the group as torchrun's ranks do and runs every case of :data:`CASES` (3 train steps of a 48 px, depth-2 DiT in
fp32, the rank's rows of each global batch) and one bucketed all-reduce,
and writes what each case ends with to ``out.npz``. The test runs the same
:func:`run_case` in its own process as the one-process reference. It
imports torch, numpy and the port only. :func:`launch` starts the ranks
of a command for the tests.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.parallel import (DataParallel, maybe_initialize_distributed,
                                              rank_rows)
from jpdvt_mt_ntnu_tpu_torch.train import TrainTask, create_train_state, make_optimizer
from jpdvt_mt_ntnu_tpu_torch.train import make_train_step
from jpdvt_mt_ntnu_tpu_torch.utils.pos_embed import grid_code

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, GRID, TOKENS, B, STEPS, LR = 48, 3, 9, 8, 3, 2e-3
MODEL = dict(depth=2, hidden_size=128, num_heads=2)
# name -> (grad_accum, task options, injected draws)
CASES = {
    "plain": (1, {}, False),
    "accum2": (2, {}, False),
    "mask_tbias_per_sample": (2, dict(add_mask=True, t_bias=2.0, shared_perm=False), False),
    "injected": (1, {}, True),
    "injected_accum2": (2, {}, True),
}


def images(step: int) -> np.ndarray:
    """The global batch of ``step``."""
    rng = np.random.default_rng(100 + step)
    return (0.5 * rng.standard_normal((B, SIZE, SIZE, 3))).astype(np.float32)


def draws(step: int, accum: int) -> list[dict]:
    """Injected draws of each microbatch of ``step``, for its whole global
    microbatch: timesteps, permutations and both noises."""
    rng = np.random.default_rng(200 + step)
    m = B // accum
    return [{"t": rng.integers(0, 1000, m),
             "indices": np.stack([rng.permutation(GRID * GRID) for _ in range(m)]),
             "noise_x": rng.standard_normal((m, SIZE, SIZE, 3)).astype(np.float32),
             "noise_c": rng.standard_normal((m, TOKENS, 8)).astype(np.float32)}
            for _ in range(accum)]


class Injected:
    """A ``Diffusion`` whose training loss takes the draws of
    :func:`draws`, one microbatch per call, instead of its generator's."""

    def __init__(self, diffusion, accum: int):
        self.diffusion, self.accum, self.calls = diffusion, accum, 0

    def __getattr__(self, name):
        return getattr(self.diffusion, name)

    def training_losses(self, model_fn, x, t, code, *, rows=None, **kw):
        step, micro = divmod(self.calls, self.accum)
        self.calls += 1
        d = draws(step, self.accum)[micro]
        t = torch.as_tensor(d["t"])
        return self.diffusion.training_losses(
            model_fn, x, t if rows is None else t[rows], code, rows=rows,
            _inject={k: v for k, v in d.items() if k != "t"}, **kw)


def run_case(name: str, dp: DataParallel, weights: dict) -> dict:
    """Three steps of case ``name`` on ``dp``'s rank, from ``weights``;
    the per-step metrics, the final params, EMA and moments, and the first
    step's (mean) gradients."""
    accum, opts, inject = CASES[name]
    model, _ = create_model("JPDVT", SIZE, device="cpu", **MODEL)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    state = create_train_state(model)
    task = TrainTask(grid_size=GRID, block_size=SIZE // GRID, patch_size=16,
                     ema_warmup=True, **opts)
    diffusion = create_diffusion("", device="cpu")
    if inject:
        diffusion = Injected(diffusion, accum)
    step = make_train_step(diffusion, make_optimizer(LR), task,
                           torch.as_tensor(grid_code(8, GRID)), grad_accum=accum, dp=dp)
    rows = rank_rows(B, dp.rank, dp.world, accum)
    out: dict = {k: [] for k in ("loss", "code_mse", "img_mse", "grad_norm")}
    for s in range(STEPS):
        state, metrics = step(state, torch.from_numpy(images(s)[rows]))
        for k in out:
            out[k].append(float(metrics[k]))
        if s == 0:
            grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
    res = {k: np.asarray(v) for k, v in out.items()}
    for part, sd in (("model", state.model.state_dict()), ("ema", state.ema.state_dict()),
                     ("mu", state.opt.mu), ("nu", state.opt.nu), ("grad", grads)):
        res.update({f"{part}.{k}": v.detach().numpy().copy() for k, v in sd.items()})
    return res


def bucketed(dp: DataParallel) -> dict:
    """Rank-dependent tensors averaged in buckets of at most 5 elements."""
    ts = [torch.full((n,), float(dp.rank + 1) * (i + 1)) for i, n in enumerate((3, 4, 1, 7))]
    dp.all_reduce_mean_(ts, bucket_elems=5)
    return {f"bucket{i}": t.numpy() for i, t in enumerate(ts)}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", **extra)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        if k not in extra:
            env.pop(k, None)
    return env


def torchrun_env(rank: int, world: int, port: int) -> dict:
    return child_env(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                     LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port))


def launch(cmd_of_rank, tmp_path, name: str, world: int = 2) -> list:
    """Start ``world`` ranks, output to files; returns (process, log path)."""
    port = free_port()
    procs = []
    for r in range(world):
        log = tmp_path / f"{name}_rank{r}.log"
        with open(log, "w") as f:
            procs.append((subprocess.Popen(cmd_of_rank(r), env=torchrun_env(r, world, port),
                                           cwd=str(tmp_path), stdout=f,
                                           stderr=subprocess.STDOUT,
                                           stdin=subprocess.DEVNULL), log))
    return procs


def wait_all(procs, timeout: float = 240) -> list[int]:
    codes = []
    try:
        for p, _ in procs:
            codes.append(p.wait(timeout=timeout))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
    return codes


def logs(procs) -> str:
    return "\n".join(log.read_text() for _, log in procs)


def main(argv) -> None:
    out_path, weights_path = argv
    torch.set_num_threads(2)
    dp = maybe_initialize_distributed(device="cpu")
    with np.load(weights_path) as z:
        weights = dict(z)
    res = bucketed(dp)
    for name in CASES:
        res.update({f"{name}/{k}": v for k, v in run_case(name, dp, weights).items()})
    np.savez(out_path, backend=dp.backend, device=str(dp.device), **res)
    dp.close()


if __name__ == "__main__":
    main(sys.argv[1:])
