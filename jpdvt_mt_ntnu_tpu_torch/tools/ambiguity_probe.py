"""Placement-equivalence ambiguity behind puzzle-accuracy failures.

Counterpart of ``tools/ambiguity_probe.py``. In the ``waves`` regime (2-3
plane waves an image) draws near the sampler's floor (frequencies down to
0.25 cycles an image, orientations barely over 0.5 rad apart) can make some
pieces interchangeable: swapping them changes the image less than training
noise. A model can place every piece consistently with the field and still
lose the all-pieces-right metric on such draws.

This probe solves N unseen puzzles (``SyntheticPuzzles`` at ``--seed``, as
``run_eval``'s synthetic set), reconstructs each from its predicted
permutation, and scores each misplaced slot by the MSE between the piece
placed there and the piece that belongs there over that piece's variance.
A misplacement under a tolerance is placement-equivalent: evidence of
ambiguity in the task, not of a model failure. It reports raw puzzle and
patch accuracy, the accuracies that count equivalent slots as right, and
the relative MSE's quantiles over misplaced slots, as one JSON line.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.ambiguity_probe --image-size 320 --grid 20 \\
        --checkpoint artifacts/waves20_hard_step32700.manifest.json --seed 11 --n 512 \\
        [--device cpu]

The scrambles are drawn with numpy from ``--seed`` (the JAX tool draws
them with ``jax.random``). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.diffusion import create_diffusion
from ..data import SyntheticPuzzles
from ..eval.run_eval import load_params
from ..eval.solver import PuzzleSolver
from ..models import create_model
from ..ops import jigsaw
from ..utils.config import Config
from ..utils.device import default_device

QUANTILES = (0.1, 0.5, 0.9, 0.99)


@torch.no_grad()
def slot_rel_mse(x: torch.Tensor, indices: torch.Tensor, pred: torch.Tensor,
                 grid: int) -> torch.Tensor:
    """(B, P) relative MSE per slot between the reconstruction from
    ``pred`` and the clean images ``x``."""
    recon = jigsaw.unscramble(jigsaw.scramble(x, indices, grid), pred, grid)
    xp = jigsaw.to_pieces(x.float(), grid)  # (B, P, h, w, C)
    rp = jigsaw.to_pieces(recon.float(), grid)
    err = ((xp - rp) ** 2).mean(dim=(-1, -2, -3))
    var = xp.var(dim=(-1, -2, -3), unbiased=False) + 1e-8
    return err / var


class Tally:
    """The probe's running counts over solved batches."""

    def __init__(self, grid: int, tols):
        self.p = grid * grid
        self.tols = list(tols)
        self.mis_rel: list[float] = []
        self.count = self.puzzles = self.patches = 0
        self.eq_puzzles = [0] * len(self.tols)
        self.eq_patches = [0] * len(self.tols)

    def add(self, rel: np.ndarray, pred: np.ndarray, indices: np.ndarray) -> None:
        """One batch: ``rel`` (B, P) of :func:`slot_rel_mse`."""
        wrong = pred != indices
        for b in range(rel.shape[0]):
            self.count += 1
            nm = int(wrong[b].sum())
            self.puzzles += int(nm == 0)
            self.patches += self.p - nm
            if nm == 0:
                continue
            # ``wrong`` marks scrambled pieces; their target slots come from pred.
            r = rel[b][pred[b][wrong[b]]]
            self.mis_rel.extend(r.tolist())
            for ti, tol in enumerate(self.tols):
                neq = int((r < tol).sum())
                self.eq_patches[ti] += neq
                self.eq_puzzles[ti] += int(neq == nm)

    def report(self, grid: int) -> dict:
        mis = np.asarray(self.mis_rel) if self.mis_rel else np.zeros(0)
        out = {
            "n": self.count, "grid": grid,
            "puzzle_acc": self.puzzles / self.count,
            "patch_acc": self.patches / (self.count * self.p),
            "misplaced_slots": int(mis.size),
            "rel_mse_quantiles": ({q: float(np.quantile(mis, q)) for q in QUANTILES}
                                  if mis.size else {}),
        }
        for ti, tol in enumerate(self.tols):
            out[f"equiv_frac@{tol}"] = float((mis < tol).mean()) if mis.size else 1.0
            out[f"puzzle_acc_equiv@{tol}"] = (self.puzzles + self.eq_puzzles[ti]) / self.count
            out[f"patch_acc_equiv@{tol}"] = ((self.patches + self.eq_patches[ti])
                                             / (self.count * self.p))
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image-size", type=int, default=320)
    ap.add_argument("--grid", type=int, default=20)
    ap.add_argument("--model", default="JPDVT")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--cues", default="waves")
    ap.add_argument("--sampling-steps", default="250")
    ap.add_argument("--mode", default="faithful")
    ap.add_argument("--tols", default="0.001,0.01,0.05")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    device = default_device(args.device)

    model, cfg = create_model(args.model, args.image_size, device=device,
                              dtype=torch.bfloat16)
    full = Config()
    full.model.name = args.model
    full.model.image_size = args.image_size
    full.task.grid_size = args.grid
    full.eval.checkpoint = args.checkpoint
    load_params(full, model, device)
    solver = PuzzleSolver(model, cfg, create_diffusion(args.sampling_steps, device=device),
                          grid_size=args.grid, mode=args.mode, device=device)
    ds = SyntheticPuzzles(args.image_size, n=args.n, seed=args.seed, cues=args.cues)
    tally = Tally(args.grid, [float(t) for t in args.tols.split(",")])
    rng = np.random.default_rng(args.seed)
    for i in range(0, len(ds), args.batch):
        x = torch.from_numpy(np.stack([ds[j] for j in range(i, min(i + args.batch, len(ds)))]))
        perms = np.stack([rng.permutation(args.grid ** 2) for _ in range(x.shape[0])])
        res = solver.evaluate(x, perms)
        rel = slot_rel_mse(x.to(device), torch.as_tensor(res.indices, device=device),
                           torch.as_tensor(res.pred, device=device), args.grid)
        tally.add(rel.cpu().numpy(), res.pred, res.indices)
        print(f"{tally.count} solved | raw puzzleAcc={tally.puzzles / tally.count:.4f}",
              flush=True)
    print(json.dumps(tally.report(args.grid)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
