"""In-training validation: solve held-out puzzles with the current weights.

Counterpart of ``jpdvt_mt_ntnu_tpu/train/validate.py`` (the reference's
``validate_model``, train_JPDVT.py:503-642): pick images of the validation
set, scramble them with random permutations, solve with the port's
``PuzzleSolver`` and report puzzle and patch accuracy. The run loop calls
it on the EMA model and on the raw one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.diffusion import create_diffusion
from ..eval.solver import PuzzleSolver
from ..ops import jigsaw


class Validator:
    def __init__(self, model_cfg, *, grid_size: int = 3, sampling_steps="250",
                 num_images: int = 100, batch_size: int = 50, seed: int = 42,
                 sampler_mode: str = "faithful", crop_pieces: int | None = None,
                 device: str | torch.device | None = None):
        self.cfg = model_cfg
        self.grid = grid_size
        self.diffusion = create_diffusion(str(sampling_steps), device=device)
        self.device = self.diffusion.device
        self.num_images = num_images
        self.batch_size = batch_size
        self.seed = seed
        self.mode = sampler_mode
        # task.crop trains on gap-augmented pieces cut from larger images;
        # validation applies the same transform.
        self.crop_pieces = crop_pieces

    def __call__(self, model, dataset) -> dict:
        """Evaluate ``model`` on up to ``num_images`` items of ``dataset``.
        Returns {"val_puzzle_acc", "val_patch_acc", "val_n"}."""
        solver = PuzzleSolver(model, self.cfg, self.diffusion, grid_size=self.grid,
                              mode=self.mode, seed=self.seed, device=self.device)
        rng = np.random.default_rng(self.seed)
        n = min(self.num_images, len(dataset))
        picks = rng.choice(len(dataset), size=n, replace=False)
        p = self.grid ** 2
        puzzle = patch = 0
        for i in range(0, n, self.batch_size):
            batch = np.stack([dataset[int(j)] for j in picks[i:i + self.batch_size]])
            if self.crop_pieces is not None:
                batch = jigsaw.inner_crop_pieces(torch.from_numpy(batch), self.grid,
                                                 self.crop_pieces).numpy()
            perm_rng = np.random.default_rng(self.seed + i)
            perms = np.stack([perm_rng.permutation(p) for _ in range(len(batch))])
            res = solver.evaluate(batch, perms)
            puzzle += int(res.puzzle_correct.sum())
            patch += int(res.patch_matches.sum())
        return {"val_puzzle_acc": puzzle / n, "val_patch_acc": patch / (n * p),
                "val_n": n}
