"""Checkpoint diagnostic: x0-code accuracy against the timestep, then every sampler.

Counterpart of ``jpdvt_mt_ntnu_tpu/tools/probe_checkpoint.py``. A run that
reads "chance" may not have learned, may have an EMA that has not caught
up, or may have a sampler chain that destroys a signal the one-step
prediction carries. This probe tells them apart:

1. for each timestep t of :data:`PROBE_TIMESTEPS`, one model call on the
   fixed noise template at t, its x0 code prediction assigned greedily
   with no sampler chain: accuracy above chance at any t means the model
   has the signal;
2. the faithful, iterative and DDIM solvers on the same puzzles;
3. ``eval.use_ema=false`` probes the raw weights of a checkpoint
   directory instead of its EMA.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.probe_checkpoint \\
        eval.checkpoint=results/run/checkpoints data.synthetic_cues=waves \\
        [eval.use_ema=false] [task.grid_size=4] [eval.batch_size=32] [device=cpu]

The probe is a plain function under ``torch.no_grad()`` (the JAX tool
jits one). The scrambles are drawn from ``eval.seed + 5`` and the noise
template from ``eval.seed`` by torch, or given to :func:`probe_rows`. Runs
on the card unless ``device=cpu``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.diffusion import create_diffusion
from ..data import SyntheticPuzzles
from ..eval.run_eval import build_dataset, build_model
from ..eval.solver import PuzzleSolver
from ..ops import assignment, jigsaw
from ..utils.config import Config, apply_overrides, split_device
from ..utils.device import apply_matmul_precision, default_device

PROBE_TIMESTEPS = (999, 900, 700, 400, 100, 10, 0)
MODES = ("faithful", "iterative", "ddim")


@torch.no_grad()
def x0_probe(solver: PuzzleSolver, x_scrambled: torch.Tensor, t: int) -> np.ndarray:
    """Greedy permutations of one model call at timestep ``t`` on the
    solver's noise template (no sampler chain). -> (B, P)."""
    b = x_scrambled.shape[0]
    noise = solver.noise_template.expand(b, -1, -1)
    _, code = solver.model(x_scrambled, torch.full((b,), t, dtype=torch.long,
                                                   device=solver.device), noise)
    pieces = jigsaw.tokens_to_piece_code(code, solver.grid, solver.sub)
    dist = assignment.manhattan_distances(pieces, solver.canon)
    return assignment.greedy_permutation(dist).cpu().numpy()


def probe_rows(model, model_cfg, x, *, grid: int = 3, steps: str = "250", seed: int = 0,
               indices=None, noise_template=None, device=None) -> list[tuple]:
    """(what, puzzle acc, patch acc): one row per probe timestep, then one
    per sampler of :data:`MODES`, all on the clean images ``x`` scrambled by
    ``indices`` (drawn from ``seed + 5`` when None)."""
    device = default_device(device)
    x = torch.as_tensor(x, device=device)
    b, p = x.shape[0], grid * grid
    if indices is None:
        indices = jigsaw.random_permutations(
            b, p, generator=torch.Generator().manual_seed(seed + 5))
    idx = torch.as_tensor(indices).cpu().numpy()
    x_scr = jigsaw.scramble(x, torch.as_tensor(idx, device=device), grid)

    def solver(mode: str) -> PuzzleSolver:
        return PuzzleSolver(model, model_cfg, create_diffusion(steps, device=device),
                            grid_size=grid, mode=mode, seed=seed,
                            noise_template=noise_template, device=device)

    rows = []
    probe = solver("faithful")
    for t in PROBE_TIMESTEPS:
        eq = x0_probe(probe, x_scr, t) == idx
        rows.append((f"t={t}", eq.all(-1).mean(), eq.mean()))
        print(f"t={t:4d} noise-code x0-pred: puzzle={rows[-1][1]:.3f} "
              f"patch={rows[-1][2]:.3f}", flush=True)
    for mode in MODES:
        eq = solver(mode).solve(x_scr) == idx
        rows.append((f"mode={mode}", eq.all(-1).mean(), eq.mean()))
        print(f"solver mode={mode}: puzzle={rows[-1][1]:.3f} patch={rows[-1][2]:.3f}",
              flush=True)
    return rows


def main(argv=None) -> int:
    argv, device = split_device(sys.argv[1:] if argv is None else argv)
    cfg = apply_overrides(Config(), argv)
    device = default_device(device)
    apply_matmul_precision(cfg.model.matmul_precision)
    model, model_cfg = build_model(cfg, device)
    ds = build_dataset(cfg)
    b = cfg.eval.batch_size
    if isinstance(ds, SyntheticPuzzles) and ds.cues == "waves":
        x = ds.device_batch(range(b), device).float()
    else:
        x = torch.from_numpy(np.stack([ds[i] for i in range(min(b, len(ds)))])).to(device)
    print(f"probe: {'ema' if cfg.eval.use_ema else 'raw'} weights, {x.shape[0]} images, "
          f"grid {cfg.task.grid_size}, cues={cfg.data.synthetic_cues or cfg.data.dataset}")
    probe_rows(model, model_cfg, x, grid=cfg.task.grid_size,
               steps=str(cfg.diffusion.sampling_steps), seed=cfg.eval.seed, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
