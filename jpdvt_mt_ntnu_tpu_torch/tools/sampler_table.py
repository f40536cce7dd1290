"""Sampler trade-off table: accuracy AND throughput per sampler mode.

Counterpart of ``jpdvt_mt_ntnu_tpu/tools/sampler_table.py``. The reference
has one working sampler, the 250-step faithful loop (reference
image_model/inference.py:281-290; its DDIM path is dead code,
gaussian_diffusion.py:546-553). The port carries four (``core/diffusion.py``):
the parity-faithful loop, the corrected iterative chain, a working DDIM and
the one-step fast path. This tool puts them side by side on one checkpoint
and one set of unseen images: puzzle and patch accuracy, and puzzles/s of
back-to-back solves at batch ``min(128, n)`` closed by one
``torch.cuda.synchronize()``.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.sampler_table \\
        eval.checkpoint=artifacts/waves3_r5_step10000.manifest.json \\
        data.synthetic_cues=waves [task.grid_size=4] [eval.limit=512] [device=cpu]

Writes ``<eval.logs_dir>/sampler_table_grid<G>.{md,csv}``, the files of
``logs/sampler_r3/``. The images are ``SyntheticPuzzles`` at
``eval.seed + 1100``; the scrambles and the noise template are the port's
draws (torch cannot replay ``jax.random``), or given to
:func:`sampler_rows`. Runs on the card unless ``device=cpu``.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from ..core.diffusion import create_diffusion
from ..data import SyntheticPuzzles
from ..eval.run_eval import build_model
from ..eval.solver import PuzzleSolver
from ..utils.config import Config, apply_overrides, split_device
from ..utils.device import default_device, synchronize
from .bench import pipelined

# (label, sampler_mode, respacing). "fast" ignores the step count (one t=0
# step, output-equal to faithful); it is listed with the faithful respacing.
SWEEP = (
    ("faithful-250 (reference protocol)", "faithful", "250"),
    ("iterative-250 (corrected chain)", "iterative", "250"),
    ("ddim-50", "ddim", "ddim50"),
    ("ddim-25", "ddim", "ddim25"),
    ("ddim-10", "ddim", "ddim10"),
    ("fast (1-step equivalent)", "fast", "250"),
)

# Seconds of back-to-back solves per throughput measurement.
BENCH_TARGET_S = 8.0


def measure_throughput(solver: PuzzleSolver, x_bench: torch.Tensor, min_iters: int = 3,
                       target_s: float | None = None) -> float:
    """Puzzles/s of back-to-back solves closed by one synchronise, their
    count calibrated on one timed solve so that every mode (fast ..
    faithful-250) runs ~``target_s``. The caller has run these shapes once
    (:func:`sampler_rows`' ``evaluate``), so the calibrating solve is warm."""
    target_s = BENCH_TARGET_S if target_s is None else target_s
    synchronize(solver.device)
    t0 = time.perf_counter()
    solver.solve_codes(x_bench)
    synchronize(solver.device)
    return pipelined(solver, x_bench,
                     max(min_iters, int(target_s / max(time.perf_counter() - t0, 1e-4))))


def synthetic_images(cfg: Config, n: int, seed: int, device: torch.device) -> torch.Tensor:
    """``n`` float32 images of ``SyntheticPuzzles`` at ``seed`` in
    ``data.synthetic_cues`` on ``device``: waves made on the device (bf16,
    as the JAX tools' ``device_generate_all``), other regimes on the host."""
    ds = SyntheticPuzzles(cfg.model.image_size, n=n, seed=seed,
                          cues=cfg.data.synthetic_cues or None)
    if ds.cues == "waves":
        return ds.device_generate_all(device).float()[:n]
    return torch.from_numpy(ds.batch()).to(device)


def sampler_rows(model, model_cfg, x, *, grid: int = 3, seed: int = 0, indices=None,
                 noise_template=None, device=None, target_s: float | None = None,
                 min_iters: int = 3) -> list[tuple]:
    """(label, mode, respacing, puzzle acc, patch acc, puzzles/s) per
    sampler of :data:`SWEEP` on clean images ``x``, each scrambled by
    ``indices`` (drawn per solver when None) and solved with
    ``noise_template`` (the solver's own when None); ``target_s`` and
    ``min_iters`` bound each throughput window."""
    device = default_device(device)
    bench_b = min(128, x.shape[0])
    rows = []
    for label, mode, respacing in SWEEP:
        solver = PuzzleSolver(model, model_cfg, create_diffusion(respacing, device=device),
                              grid_size=grid, mode=mode, seed=seed,
                              noise_template=noise_template, device=device)
        res = solver.evaluate(x, indices)
        x_bench = solver.scramble(x[:bench_b], res.indices[:bench_b])
        tp = measure_throughput(solver, x_bench, min_iters, target_s)
        rows.append((label, mode, respacing, res.puzzle_accuracy, res.patch_accuracy, tp))
        print(f"{label}: puzzle={res.puzzle_accuracy:.4f} patch={res.patch_accuracy:.4f} "
              f"{tp:.1f} puzzles/s", flush=True)
    return rows


def write_table(rows, logs_dir: str, grid: int, n: int, checkpoint: str,
                use_ema: bool) -> tuple[str, str]:
    """The ``.md`` and ``.csv`` of the JAX tool, in ``logs_dir``."""
    os.makedirs(logs_dir, exist_ok=True)
    md_path = os.path.join(logs_dir, f"sampler_table_grid{grid}.md")
    csv_path = os.path.join(logs_dir, f"sampler_table_grid{grid}.csv")
    with open(md_path, "w") as f:
        f.write(f"# Sampler trade-off — grid {grid}x{grid}, {n} unseen images, "
                f"batch {min(128, n)}, ckpt={checkpoint} (ema={use_ema})\n\n")
        f.write("| sampler | puzzle acc | patch acc | puzzles/s (pipelined) |\n")
        f.write("|---|---|---|---|\n")
        for label, mode, respacing, pa, ta, tp in rows:
            f.write(f"| {label} | {pa:.4f} | {ta:.4f} | {tp:.1f} |\n")
    with open(csv_path, "w") as f:
        f.write("label,mode,respacing,puzzle_acc,patch_acc,puzzles_per_s,n\n")
        for label, mode, respacing, pa, ta, tp in rows:
            f.write(f"{label},{mode},{respacing},{pa:.6f},{ta:.6f},{tp:.2f},{n}\n")
    return md_path, csv_path


def main(argv=None) -> int:
    argv, device = split_device(sys.argv[1:] if argv is None else argv)
    cfg = apply_overrides(Config(), argv)
    device = default_device(device)
    model, model_cfg = build_model(cfg, device)
    n = cfg.eval.limit or 512
    x = synthetic_images(cfg, n, cfg.eval.seed + 1100, device)
    rows = sampler_rows(model, model_cfg, x, grid=cfg.task.grid_size, seed=cfg.eval.seed,
                        device=device)
    md_path, csv_path = write_table(rows, cfg.eval.logs_dir, cfg.task.grid_size, n,
                                    cfg.eval.checkpoint, cfg.eval.use_ema)
    print(f"wrote {md_path} and {csv_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
