"""Masked-puzzle table: accuracy against the number of hidden pieces.

Counterpart of ``jpdvt_mt_ntnu_tpu/tools/masked_eval_table.py``, the
reference's texrec-mask axis (reference image_model/inference_texrec.py:
12-15; inference_visualize_missing_patches.ipynb zeroes pieces before the
solve) as one sweep: for k = 0 .. grid - 1 hidden pieces and both fills
(``noise``, the masked training distribution, gaussian_diffusion.py:800;
``zero``, the notebook's), solve one batch of unseen images with
``PuzzleSolver.evaluate_masked`` and report puzzle and patch accuracy.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.masked_eval_table \\
        eval.checkpoint=artifacts/waves3_r5_step10000.manifest.json \\
        data.synthetic_cues=waves [task.grid_size=4] [eval.limit=256] [device=cpu]

Writes ``<eval.logs_dir>/masked_table_grid<G>.{md,csv}``, the files of
``logs/masked_r3/``. The images are ``SyntheticPuzzles`` at ``eval.seed +
900``; the scrambles, masks and fills are the solver's draws, or given to
:func:`masked_rows`. Runs on the card unless ``device=cpu``.
"""

from __future__ import annotations

import os
import sys
from typing import Callable

from ..core.diffusion import create_diffusion
from ..eval.run_eval import build_model
from ..eval.solver import PuzzleSolver
from ..utils.config import Config, apply_overrides, split_device
from ..utils.device import default_device
from .sampler_table import synthetic_images

FILLS = ("noise", "zero")


def masked_rows(solver: PuzzleSolver, x, *, ks=None,
                draws: Callable[[str, int], dict] | None = None) -> list[tuple]:
    """(fill, hidden, puzzle acc, patch acc) for each fill and each k of
    ``ks`` (default 0 .. grid - 1). ``draws(fill, k)`` may give
    ``evaluate_masked``'s ``indices``, ``piece_mask`` and ``fill``."""
    rows = []
    for fill in FILLS:
        for k in (range(solver.grid) if ks is None else ks):
            res = solver.evaluate_masked(x, k, mask_fill=fill,
                                         **(draws(fill, k) if draws else {}))
            rows.append((fill, k, res.puzzle_accuracy, res.patch_accuracy))
            print(f"fill={fill} hidden={k}: puzzle={res.puzzle_accuracy:.4f} "
                  f"patch={res.patch_accuracy:.4f} (n={len(res.pred)})", flush=True)
    return rows


def write_table(rows, logs_dir: str, grid: int, n: int, sampler: str,
                checkpoint: str) -> tuple[str, str]:
    os.makedirs(logs_dir, exist_ok=True)
    md_path = os.path.join(logs_dir, f"masked_table_grid{grid}.md")
    csv_path = os.path.join(logs_dir, f"masked_table_grid{grid}.csv")
    with open(md_path, "w") as f:
        f.write(f"# Masked-puzzle sweep — grid {grid}x{grid}, {sampler}, "
                f"{n} unseen images, ckpt={checkpoint}\n\n")
        f.write("| fill | hidden pieces | puzzle acc | patch acc |\n")
        f.write("|---|---|---|---|\n")
        for fill, k, pa, ta in rows:
            f.write(f"| {fill} | {k} | {pa:.4f} | {ta:.4f} |\n")
    with open(csv_path, "w") as f:
        f.write("fill,hidden,puzzle_acc,patch_acc,n\n")
        for fill, k, pa, ta in rows:
            f.write(f"{fill},{k},{pa:.6f},{ta:.6f},{n}\n")
    return md_path, csv_path


def main(argv=None) -> int:
    argv, device = split_device(sys.argv[1:] if argv is None else argv)
    cfg = apply_overrides(Config(), argv)
    device = default_device(device)
    model, model_cfg = build_model(cfg, device)
    g = cfg.task.grid_size
    solver = PuzzleSolver(model, model_cfg,
                          create_diffusion(str(cfg.diffusion.sampling_steps), device=device),
                          grid_size=g, mode=cfg.diffusion.sampler_mode, seed=cfg.eval.seed,
                          device=device)
    n = cfg.eval.limit or 256
    rows = masked_rows(solver, synthetic_images(cfg, n, cfg.eval.seed + 900, device))
    md_path, csv_path = write_table(
        rows, cfg.eval.logs_dir, g, n,
        f"{cfg.diffusion.sampler_mode}-{cfg.diffusion.sampling_steps}", cfg.eval.checkpoint)
    print(f"wrote {md_path} and {csv_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
