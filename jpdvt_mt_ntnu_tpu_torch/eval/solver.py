"""Batched jigsaw solver: scramble -> diffuse -> recover -> metrics.

Counterpart of ``jpdvt_mt_ntnu_tpu/eval/solver.py``. The chain of one
microbatch (``_solve_codes_chunk``, JAX ``solver.py:164-189``) is: the
condition's patch embedding once (``DiT.embed_condition``), the sampler's
DiT calls with ``x_is_tokens``, per-piece code pooling, Manhattan distances
to the canonical grid code, greedy assignment.

The noise template is made once per solver and reused for every puzzle
(reference inference.py:221-222). The JAX package draws it with
``jax.random.normal(key(seed))``, which torch cannot reproduce: pass that
array as ``noise_template`` to solve exactly as the JAX solver does, or
leave it out to draw one from a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..core.diffusion import Diffusion
from ..ops import assignment, jigsaw
from ..utils.device import default_device
from ..utils.pos_embed import grid_code


@dataclasses.dataclass
class SolveResult:
    pred: np.ndarray            # (B, P) predicted slot per scrambled piece
    indices: np.ndarray         # (B, P) ground-truth scramble
    puzzle_correct: np.ndarray  # (B,) int
    patch_matches: np.ndarray   # (B,) int

    @property
    def puzzle_accuracy(self) -> float:
        return float(self.puzzle_correct.mean())

    @property
    def patch_accuracy(self) -> float:
        return float(self.patch_matches.mean() / self.pred.shape[-1])


class PuzzleSolver:
    """Solves puzzles with one (model, diffusion, grid, mode) configuration,
    assigning pieces greedily (Hungarian is not ported yet).

    ``device`` defaults to the card and must hold the model's parameters.
    ``microbatch`` None means 32; 0 never splits a batch."""

    def __init__(self, model, model_config, diffusion: Diffusion, *,
                 grid_size: int = 3, mode: str = "faithful", seed: int = 0,
                 microbatch: int | None = None,
                 noise_template: np.ndarray | torch.Tensor | None = None,
                 device: torch.device | str | None = None):
        if mode not in ("faithful", "fast", "iterative"):
            raise ValueError(f"unknown sampler mode {mode!r}")
        cfg = model_config
        self.device = default_device(device)
        param_device = next(model.parameters()).device
        if param_device != self.device:
            raise ValueError(f"model lives on {param_device}, solver on {self.device}")
        self.model = model
        self.cfg = cfg
        self.diffusion = diffusion
        self.grid = grid_size
        self.mode = mode
        self.microbatch = microbatch
        self.sub = cfg.input_size // (cfg.patch_size * grid_size)
        if self.sub < 1:
            raise ValueError("grid finer than model tokens")
        self.canon = torch.from_numpy(grid_code(cfg.code_dim, grid_size)).to(self.device)
        shape = (1, cfg.num_tokens, cfg.code_dim)
        if noise_template is None:
            noise_template = torch.randn(
                shape, generator=torch.Generator().manual_seed(seed))
        if not isinstance(noise_template, torch.Tensor):
            noise_template = torch.from_numpy(np.array(noise_template, np.float32))
        noise_template = noise_template.to(torch.float32)
        if tuple(noise_template.shape) != shape:
            raise ValueError(f"noise template of shape {tuple(noise_template.shape)}, "
                             f"expected {shape}")
        self.noise_template = noise_template.to(self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)

    def _resolve_microbatch(self, b: int) -> int:
        """Microbatch for a batch of ``b`` (0 = don't split)."""
        mb = 32 if self.microbatch is None else self.microbatch
        if not mb or b <= mb or b % mb:
            return 0
        return mb

    def _cast_params(self):
        """The model with parameters in the compute type, cast once per
        solve (not once per sampler step); the model itself as it is when
        that type is float32."""
        if self.cfg.dtype == torch.float32:
            return self.model
        return copy.deepcopy(self.model).to(self.cfg.dtype)

    def _solve_codes_chunk(self, model, x_scrambled: torch.Tensor):
        b = x_scrambled.shape[0]
        noise = self.noise_template.expand(b, -1, -1)
        condition = model.embed_condition(x_scrambled)

        def model_fn(cond, t_orig, code):
            return model(cond, t_orig, code, x_is_tokens=True)

        final = self.diffusion.p_sample_loop(
            model_fn, condition, noise, mode=self.mode, clip_denoised=False,
            generator=self.generator)
        pieces = jigsaw.tokens_to_piece_code(final, self.grid, self.sub)
        dist = assignment.manhattan_distances(pieces, self.canon)
        return assignment.greedy_permutation(dist), dist

    @torch.inference_mode()
    def solve_codes(self, x_scrambled) -> tuple[torch.Tensor, torch.Tensor]:
        """Scrambled images (B, H, W, C) -> (pred (B, P), dist (B, P, P))."""
        x = torch.as_tensor(x_scrambled, device=self.device)
        model = self._cast_params()
        b = x.shape[0]
        mb = self._resolve_microbatch(b) or b
        outs = [self._solve_codes_chunk(model, x[i:i + mb]) for i in range(0, b, mb)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    def solve(self, x_scrambled) -> np.ndarray:
        """Predict the slot of each scrambled piece. -> (B, P) int64."""
        return self.solve_codes(x_scrambled)[0].cpu().numpy()

    @torch.inference_mode()
    def evaluate(self, x, indices=None) -> SolveResult:
        """Scramble clean images (B, H, W, C) by ``indices`` (B, P) (drawn
        from the solver's generator when None), solve, score."""
        x = torch.as_tensor(x, device=self.device)
        p = self.grid * self.grid
        if indices is None:
            indices = jigsaw.random_permutations(
                x.shape[0], p, generator=self.generator, device=self.device)
        indices = torch.as_tensor(indices, device=self.device, dtype=torch.long)
        pred, _ = self.solve_codes(jigsaw.scramble(x, indices, self.grid))
        puzzle, patch = assignment.permutation_metrics(pred, indices)
        return SolveResult(pred.cpu().numpy(), indices.cpu().numpy(),
                           puzzle.cpu().numpy(), patch.cpu().numpy())

    def reconstruct(self, x_scrambled, pred) -> torch.Tensor:
        """Re-place pieces by the predicted permutation (inference.py:321-327)."""
        x = torch.as_tensor(x_scrambled, device=self.device)
        return jigsaw.unscramble(x, torch.as_tensor(pred, device=self.device),
                                 self.grid)
