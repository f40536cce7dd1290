"""Step-by-step single-image walk-through (notebook replacement).

Counterpart of ``examples/demo_walkthrough.py`` (the reference's
``ak_sample_visualize.ipynb``): load an image, scramble it, run the
reverse diffusion, recover the permutation, and draw every stage into one
panel, original | scrambled | reconstructed, written as a PNG.

    python -m jpdvt_mt_ntnu_tpu_torch.examples.demo_walkthrough [--image path] \\
        [--checkpoint ckpt] [--out walkthrough.png] [--steps 250] [--mode faithful] \\
        [--device cpu]

The image is read by the port's decoder (PNG or JPEG) and ADM-cropped;
without ``--image`` a synthetic texture (the ``coords`` regime, as the JAX
example's) is used; without ``--checkpoint`` the model keeps its random
init (the pipeline still runs end to end: expect a wrong permutation).
The scramble is ``default_rng(seed).permutation``. The panel is composed in
numpy and written through ``serve/png.py`` (no matplotlib, no PIL), as
``tools/val_panel`` does. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.diffusion import create_diffusion
from ..data import SyntheticPuzzles
from ..eval.run_eval import load_params
from ..eval.solver import PuzzleSolver
from ..models import create_model
from ..ops import native
from ..serve.png import encode_png
from ..tools.val_panel import render_panel
from ..utils.config import Config
from ..utils.device import default_device


def parser(description: str, out: str) -> argparse.ArgumentParser:
    """The JAX examples' flags, and ``--device``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--image", default="")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--model", default="JPDVT")
    ap.add_argument("--image-size", type=int, default=192)
    ap.add_argument("--grid", type=int, default=3)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--mode", default="faithful")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=out)
    ap.add_argument("--depth", type=int, default=0, help="scaled-down overrides")
    ap.add_argument("--hidden-size", type=int, default=0)
    ap.add_argument("--num-heads", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card")
    return ap


def load_image(path: str, size: int, seed: int) -> np.ndarray:
    """(size, size, 3) float32 in [-1, 1]: the file's ADM crop, else the
    synthetic texture of ``seed``."""
    if path:
        with open(path, "rb") as f:
            return native.decode_center_crop(f.read(), size)
    return SyntheticPuzzles(size, n=1, seed=seed, cues="coords")[0]


def build_solver(a) -> PuzzleSolver:
    """The model (its checkpoint loaded) and its solver, on ``--device``."""
    device = default_device(a.device)
    overrides = {k: v for k, v in dict(depth=a.depth, hidden_size=a.hidden_size,
                                       num_heads=a.num_heads).items() if v}
    model, cfg = create_model(a.model, a.image_size, device=device, **overrides)
    c = Config()
    c.eval.checkpoint = a.checkpoint
    load_params(c, model, device)
    return PuzzleSolver(model, cfg, create_diffusion(str(a.steps), device=device),
                        grid_size=a.grid, mode=a.mode, seed=a.seed, device=device)


def scramble_indices(seed: int, grid: int) -> np.ndarray:
    """(1, grid^2): the scramble of the walk-through."""
    return np.random.default_rng(seed).permutation(grid * grid)[None]


def write_panel(path: str, original, shown, recon) -> None:
    panel = render_panel([{"original": original, "scrambled": np.asarray(shown),
                           "reconstructed": np.asarray(recon)}])
    with open(path, "wb") as f:
        f.write(encode_png(panel))


def main(argv=None) -> int:
    a = parser(__doc__.split("\n\n")[0], "walkthrough.png").parse_args(argv)
    # 1) The clean image.
    img = load_image(a.image, a.image_size, a.seed)
    print(f"image: {img.shape}, range [{img.min():.2f}, {img.max():.2f}]")
    # 2) Model and solver.
    solver = build_solver(a)
    # 3) Scramble with a random permutation.
    indices = scramble_indices(a.seed, a.grid)
    scrambled = solver.scramble(img[None], indices)
    print(f"scramble permutation: {indices[0].tolist()}")
    # 4) Reverse diffusion -> per-token codes -> greedy assignment.
    pred = solver.solve(scrambled)
    print(f"predicted slots:      {pred[0].tolist()}")
    # 5) Re-place the pieces, score, draw.
    recon = solver.reconstruct(scrambled, pred)
    correct = pred[0] == indices[0]
    print(f"puzzle solved: {bool(correct.all())} ({int(correct.sum())}/{a.grid ** 2} pieces)")
    write_panel(a.out, img, scrambled[0].cpu(), recon[0].cpu())
    print(f"wrote {a.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
