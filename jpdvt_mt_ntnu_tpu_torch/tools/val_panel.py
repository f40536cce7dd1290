"""Perfect-against-failed panel: one solved and one failed case, side by side.

Counterpart of ``jpdvt_mt_ntnu_tpu/tools/val_panel.py`` (the reference's
image_model/valwhiletrain.py:213-258): picks one perfectly solved and one
failed file from an eval journal, solves both again and writes a 2 x 3
panel, original | scrambled | reconstructed per row, as a PNG. The JAX tool
draws it with matplotlib; here the panel is composed in numpy (8 px white
gaps) and written through ``serve/png.py``, and the titles matplotlib drew
(the column names, each row's file and whether it was solved) are printed
as one JSON line instead.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.val_panel --csv logs/inference_progress.csv \\
        --data-dir /data/imagenet/test --checkpoint artifacts/<run>.manifest.json \\
        --out panel.png [--device cpu]

Each file is picked as pandas' ``sample(1, random_state=seed)`` picks it
(``RandomState(seed).choice``), and decoded and centre-cropped by the
native decoder (PNG and JPEG). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np
import torch

from ..core.diffusion import create_diffusion
from ..data import transforms as T
from ..eval.run_eval import load_params
from ..eval.solver import PuzzleSolver
from ..models import create_model
from ..ops import native
from ..serve.png import encode_png
from ..utils.config import Config
from ..utils.device import default_device

COLUMNS = ("original", "scrambled", "reconstructed")
GAP = 8


def find_file(data_dir: str, filename: str) -> str | None:
    for dirpath, _, files in os.walk(data_dir):
        if filename in files:
            return os.path.join(dirpath, filename)
    return None


def pick(rows: list[dict], seed: int) -> list[tuple[str, str]]:
    """(label, filename) of one perfect and one failed row, each drawn as
    pandas' ``df[mask].sample(1, random_state=seed)`` draws it."""
    picks = []
    for label, want in (("perfect", 1), ("failed", 0)):
        sub = [r["filename"] for r in rows if int(r["puzzle_correct"]) == want]
        if sub:
            picks.append((label, sub[int(np.random.RandomState(seed).choice(
                len(sub), size=1, replace=False)[0])]))
    return picks


def render_panel(rows: list[dict]) -> np.ndarray:
    """rows: [{"original", "scrambled", "reconstructed"}] of HWC [-1, 1]
    arrays -> one uint8 RGB image, a row of three per entry."""
    tiles = [[(T.denormalize(np.asarray(r[k], np.float32)) * 255).astype(np.uint8)
              for k in COLUMNS] for r in rows]
    h, w = tiles[0][0].shape[:2]
    out = np.full((len(rows) * h + (len(rows) - 1) * GAP, 3 * w + 2 * GAP, 3), 255, np.uint8)
    for i, row in enumerate(tiles):
        for j, tile in enumerate(row):
            out[i * (h + GAP):i * (h + GAP) + h, j * (w + GAP):j * (w + GAP) + w] = tile
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csv", required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--model", default="JPDVT")
    ap.add_argument("--image-size", type=int, default=192)
    ap.add_argument("--grid", type=int, default=3)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--mode", default="faithful")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="val_panel.png")
    ap.add_argument("--device", default=None, help="default: the card")
    a = ap.parse_args(argv)
    with open(a.csv, newline="") as f:
        picks = pick(list(csv.DictReader(f)), a.seed)
    if not picks:
        print("CSV has no rows")
        return 1
    device = default_device(a.device)
    cfg = Config()
    cfg.eval.checkpoint = a.checkpoint
    model, model_cfg = create_model(a.model, a.image_size, device=device)
    load_params(cfg, model, device)
    solver = PuzzleSolver(model, model_cfg, create_diffusion(str(a.steps), device=device),
                          grid_size=a.grid, mode=a.mode, seed=a.seed, device=device)
    rng = np.random.default_rng(a.seed)
    rows, titles = [], []
    for label, fname in picks:
        path = find_file(a.data_dir, fname)
        if path is None:
            print(f"warning: {fname} not under {a.data_dir}")
            continue
        with open(path, "rb") as f:
            img = native.decode_center_crop(f.read(), a.image_size)
        indices = rng.permutation(a.grid * a.grid)[None]
        scrambled = solver.scramble(img[None], indices)
        pred = solver.solve(scrambled)
        recon = solver.reconstruct(scrambled, pred)
        titles.append(f"{label} ({fname}) solved={bool((pred[0] == indices[0]).all())}")
        rows.append({"original": img, "scrambled": scrambled[0].cpu().numpy(),
                     "reconstructed": recon[0].cpu().numpy()})
    if not rows:
        print("none of the picked files is under the data dir")
        return 1
    with open(a.out, "wb") as f:
        f.write(encode_png(render_panel(rows)))
    print(json.dumps({"panel": a.out, "columns": list(COLUMNS), "rows": titles}))
    print(f"wrote {a.out} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
