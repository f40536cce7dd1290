"""Streaming quick-accuracy loop (the reference's image_model/sample.py).

Counterpart of ``jpdvt_mt_ntnu_tpu/eval/run_sample.py``: solves the dataset
batch by batch, prints the running accuracy and stops at ``eval.limit``
(default 2,000 puzzles, the reference's MET count). ``sample.crop=1``
evaluates the crop-gap augmentation (sample.py:123-136): items are made at
288 px and each piece is centre-cropped to ``image_size / grid`` pixels
(``jigsaw.inner_crop_pieces``).

    python -m jpdvt_mt_ntnu_tpu_torch.eval.run_sample data.synthetic_cues=waves \\
        eval.limit=2000 model.image_size=192 eval.checkpoint=<manifest>

The scrambles come from the solver's generator (``eval.seed``). The run is
on the card; ``device=cpu`` runs it on the CPU. What ``run_eval`` refuses,
this refuses too.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from ..core.diffusion import create_diffusion
from ..models import create_model
from ..ops import jigsaw
from ..utils.config import Config, apply_overrides
from ..utils.device import default_device
from .run_eval import build_dataset, check_supported, load_params
from .solver import PuzzleSolver

_DEFAULT_LIMITS = {"met": 2000, "imagenet": 50000}


def main(argv=None, device: str | torch.device | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    crop = any(a.lstrip("-").startswith("sample.crop") for a in argv)
    cli_device = [a.split("=", 1)[1] for a in argv if a.lstrip("-").startswith("device=")]
    argv = [a for a in argv if not a.lstrip("-").startswith(("sample.crop", "device="))]
    cfg = apply_overrides(Config(), argv)
    device = device if device is not None else (cli_device[-1] if cli_device else None)
    check_supported(cfg, on_card=torch.device(device or "cuda").type == "cuda")
    device = default_device(device)
    limit = cfg.eval.limit or _DEFAULT_LIMITS.get(cfg.data.dataset, 2000)

    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    model, model_cfg = create_model(cfg.model.name, cfg.model.image_size, device=device,
                                    dtype=dtype, attn_impl=cfg.model.attn_impl,
                                    **cfg.model.overrides())
    load_params(cfg, model, device)
    solver = PuzzleSolver(model, model_cfg,
                          create_diffusion(str(cfg.diffusion.sampling_steps), device=device),
                          grid_size=cfg.task.grid_size, mode=cfg.diffusion.sampler_mode,
                          seed=cfg.eval.seed, device=device)
    # Crop mode needs the larger source image (288 px, inner-cropped to
    # image_size), as training loads it; at image_size the crop is a no-op.
    data_cfg = (dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, image_size=288))
                if crop else cfg)
    dataset = build_dataset(data_cfg)
    grid = cfg.task.grid_size
    p = grid * grid
    bs = cfg.eval.batch_size
    stop = min(limit, len(dataset))
    puzzle = patch = count = 0
    t0 = time.time()
    for start in range(0, stop, bs):
        items = range(start, min(start + bs, stop))
        batch = dataset.device_batch(items, device).float()
        if crop:
            batch = jigsaw.inner_crop_pieces(batch, grid, cfg.model.image_size // grid)
        res = solver.evaluate(batch)
        puzzle += int(res.puzzle_correct.sum())
        patch += int(res.patch_matches.sum())
        count += len(items)
        print(f"{count}/{limit}: running puzzleAcc={puzzle / count:.4f} "
              f"patchAcc={patch / (count * p):.4f} "
              f"({count / (time.time() - t0):.2f} puzzles/s)")
    print(f"FINAL: n={count} puzzle={puzzle / max(1, count):.4f} "
          f"patch={patch / max(1, count * p):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
