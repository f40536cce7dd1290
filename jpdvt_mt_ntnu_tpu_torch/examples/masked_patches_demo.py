"""Masked-puzzle demo: zero out pieces before solving.

Counterpart of ``examples/masked_patches_demo.py`` (the reference's
``inference_visualize_missing_patches.ipynb``): scramble an image, black
out selected pieces of the scrambled input (the notebook's
``SKIPPED_PATCHES``), solve, and draw the panel (the masked input in the
middle, the original pieces re-placed on the right). Models trained with
``task.add_mask=true`` learn to place pieces with missing evidence.

    python -m jpdvt_mt_ntnu_tpu_torch.examples.masked_patches_demo --skip 0 4 \\
        [--image path] [--checkpoint ckpt] [--device cpu] ...

The flags are ``demo_walkthrough``'s and ``--skip``; so are the image, the
scramble and the panel. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import torch

from ..ops import jigsaw
from .demo_walkthrough import (build_solver, load_image, parser, scramble_indices,
                               write_panel)


def main(argv=None) -> int:
    ap = parser(__doc__.split("\n\n")[0], "masked_demo.png")
    ap.add_argument("--skip", type=int, nargs="*", default=[0, 4],
                    help="scrambled-slot indices to zero out")
    a = ap.parse_args(argv)
    img = load_image(a.image, a.image_size, a.seed)
    solver = build_solver(a)
    indices = scramble_indices(a.seed, a.grid)
    scrambled = solver.scramble(img[None], indices)
    p = a.grid ** 2
    piece_mask = torch.ones((1, p), device=scrambled.device)
    piece_mask[0, a.skip] = 0.0
    masked = scrambled * jigsaw.piece_mask_to_image(piece_mask, a.grid, a.image_size // a.grid)
    print(f"zeroed scrambled slots: {sorted(a.skip)}")
    pred = solver.solve(masked)
    recon = solver.reconstruct(scrambled, pred)  # re-place the ORIGINAL pieces
    correct = pred[0] == indices[0]
    print(f"permutation: {indices[0].tolist()}")
    print(f"predicted:   {pred[0].tolist()}")
    print(f"solved: {bool(correct.all())} ({int(correct.sum())}/{p})")
    write_panel(a.out, img, masked[0].cpu(), recon[0].cpu())
    print(f"wrote {a.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
