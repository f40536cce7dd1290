"""In-training validation: solve held-out puzzles with the current weights.

Counterpart of ``jpdvt_mt_ntnu_tpu/train/validate.py`` (the reference's
``validate_model``, train_JPDVT.py:503-642): pick images of the validation
set, scramble them with random permutations, solve with the port's
``PuzzleSolver`` and report puzzle and patch accuracy. The run loop calls
it on the EMA model and on the raw one.

The draws can be injected: ``noise_template`` (1, N, code_dim) and
``permutations`` (num_images, P), the latter taken ``batch_size`` rows per
batch in pick order. :func:`jax_draws` reads the JAX validator's own draws
at its defaults (seed 42, 100 images, batches of 50), committed for the
geometries in :data:`JAX_DRAWS`: the template of ``jax.random.key(42)`` and the
permutations ``jigsaw.random_permutations(key(42 + i), 50, P)`` of the
batch at offset i (JAX ``eval/solver.py:240``). Torch cannot replay
``jax.random``; with them the port validates on the JAX package's puzzles.
Without them it draws its own: numpy permutations, a torch-generated
template.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.diffusion import create_diffusion
from ..eval.solver import PuzzleSolver
from ..ops import jigsaw

# (grid, tokens) -> the committed draws of the JAX validator at its defaults:
# the grid-3 flagship at 192 px and the grid-20 geometry at 320 px.
JAX_DRAWS = {(g, n): os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_draws",
                                  f"validator_seed42_grid{g}.npz")
             for g, n in ((3, 144), (20, 400))}


def jax_draws(grid_size: int, num_tokens: int, seed: int = 42, num_images: int = 100,
              batch_size: int = 50) -> dict:
    """``{"noise_template", "permutations"}`` of the JAX validator for this
    grid and token count at its defaults, or {} where none is committed
    (another geometry, seed, count or batch size)."""
    key = (grid_size, num_tokens)
    if key not in JAX_DRAWS or (seed, num_images, batch_size) != (42, 100, 50):
        return {}
    with np.load(JAX_DRAWS[key]) as z:
        return {"noise_template": z["noise_template"],
                "permutations": z["permutations"].astype(np.int64)}


class Validator:
    def __init__(self, model_cfg, *, grid_size: int = 3, sampling_steps="250",
                 num_images: int = 100, batch_size: int = 50, seed: int = 42,
                 sampler_mode: str = "faithful", crop_pieces: int | None = None,
                 noise_template: np.ndarray | None = None,
                 permutations: np.ndarray | None = None,
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
        self.noise_template = noise_template
        if permutations is not None and len(permutations) < num_images:
            raise ValueError(f"{len(permutations)} permutations for {num_images} images")
        self.permutations = permutations

    def __call__(self, model, dataset) -> dict:
        """Evaluate ``model`` on up to ``num_images`` items of ``dataset``.
        Returns {"val_puzzle_acc", "val_patch_acc", "val_n"}."""
        solver = PuzzleSolver(model, self.cfg, self.diffusion, grid_size=self.grid,
                              mode=self.mode, seed=self.seed, device=self.device,
                              noise_template=self.noise_template)
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
            if self.permutations is not None:
                perms = self.permutations[i:i + len(batch)]
            else:
                perm_rng = np.random.default_rng(self.seed + i)
                perms = np.stack([perm_rng.permutation(p) for _ in range(len(batch))])
            res = solver.evaluate(batch, perms)
            puzzle += int(res.puzzle_correct.sum())
            patch += int(res.patch_matches.sum())
        return {"val_puzzle_acc": puzzle / n, "val_patch_acc": patch / (n * p),
                "val_n": n}
