"""Batched jigsaw solver: scramble -> diffuse -> recover -> metrics.

Counterpart of ``jpdvt_mt_ntnu_tpu/eval/solver.py``. The chain of one
microbatch (``_solve_codes_chunk``, JAX ``solver.py:164-189``) is: the
condition's patch embedding once (``DiT.embed_condition``), the sampler's
DiT calls with ``x_is_tokens``, per-piece code pooling, Manhattan distances
to the canonical grid code, greedy assignment. ``assignment_method=
"hungarian"`` assigns on the host instead (``ops/native.py``); ``votes`` > 1
solves each puzzle under ``votes - 1`` further arrangements and assigns
once on the averaged distances (``_solve_and_score_votes_impl``,
``solver.py:200-226``); ``mode="ddim"`` runs the DDIM sampler with eta 0.

The noise template is made once per solver and reused for every puzzle
(reference inference.py:221-222). The JAX package draws it with
``jax.random.normal(key(seed))``, which torch cannot reproduce: pass that
array as ``noise_template`` to solve exactly as the JAX solver does, or
leave it out to draw one from a ``torch.Generator`` seeded with ``seed``.
For the same reason the scrambles (``indices``), the votes' arrangements
(``sigmas``) and the masked puzzles' masks and fills may be given by the
caller; what is not given is drawn from the solver's generator.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.diffusion import Diffusion
from ..ops import assignment, jigsaw
from ..utils.device import default_device
from ..utils.pos_embed import grid_code

MODES = ("faithful", "fast", "iterative", "ddim")
ASSIGNMENTS = ("greedy", "hungarian")


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


def _score(pred: np.ndarray, indices: np.ndarray) -> SolveResult:
    eq = pred == indices
    return SolveResult(pred, indices, eq.all(-1).astype(np.int32),
                       eq.sum(-1).astype(np.int32))


class PuzzleSolver:
    """Solves puzzles with one (model, diffusion, grid, mode) configuration.

    ``device`` defaults to the card and must hold the model's parameters.
    ``microbatch`` None means 32; 0 never splits a batch."""

    def __init__(self, model, model_config, diffusion: Diffusion, *,
                 grid_size: int = 3, mode: str = "faithful",
                 assignment_method: str = "greedy", votes: int = 1, seed: int = 0,
                 microbatch: int | None = None,
                 noise_template: np.ndarray | torch.Tensor | None = None,
                 device: torch.device | str | None = None):
        if mode not in MODES:
            raise ValueError(f"unknown sampler mode {mode!r}; choose from {MODES}")
        if assignment_method not in ASSIGNMENTS:
            raise ValueError(f"unknown assignment {assignment_method!r}; "
                             f"choose from {ASSIGNMENTS}")
        if int(votes) < 1:
            raise ValueError(f"votes must be >= 1; got {votes}")
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
        self.assignment_method = assignment_method
        self.votes = int(votes)
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
        self._cast: tuple = (None, None)

    @property
    def pieces(self) -> int:
        return self.grid * self.grid

    def _resolve_microbatch(self, b: int) -> int:
        """Microbatch for a batch of ``b`` (0 = don't split)."""
        mb = 32 if self.microbatch is None else self.microbatch
        if not mb or b <= mb or b % mb:
            return 0
        return mb

    def _cast_params(self):
        """The model with parameters in the compute type; the model itself
        when that type is float32. The cast copy is kept and made anew only
        when a parameter of the model changed (its version counter), so a
        run of solves pays the cast once."""
        if self.cfg.dtype == torch.float32:
            return self.model
        key = tuple((id(p), p._version) for p in self.model.parameters())
        if self._cast[0] != key:
            self._cast = (key, copy.deepcopy(self.model).to(self.cfg.dtype))
        return self._cast[1]

    def _solve_codes_chunk(self, model, x_scrambled: torch.Tensor):
        b = x_scrambled.shape[0]
        noise = self.noise_template.expand(b, -1, -1)
        condition = model.embed_condition(x_scrambled)

        def model_fn(cond, t_orig, code):
            return model(cond, t_orig, code, x_is_tokens=True)

        if self.mode == "ddim":
            final = self.diffusion.ddim_sample_loop(model_fn, condition, noise, eta=0.0,
                                                    clip_denoised=False)
        else:
            final = self.diffusion.p_sample_loop(
                model_fn, condition, noise, mode=self.mode, clip_denoised=False,
                generator=self.generator)
        pieces = jigsaw.tokens_to_piece_code(final, self.grid, self.sub)
        dist = assignment.manhattan_distances(pieces, self.canon)
        return assignment.greedy_permutation(dist), dist

    def _solve_codes(self, model, x: torch.Tensor):
        b = x.shape[0]
        mb = self._resolve_microbatch(b) or b
        outs = [self._solve_codes_chunk(model, x[i:i + mb]) for i in range(0, b, mb)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    @torch.inference_mode()
    def solve_codes(self, x_scrambled) -> tuple[torch.Tensor, torch.Tensor]:
        """Scrambled images (B, H, W, C) -> (greedy pred (B, P), dist (B, P, P))."""
        return self._solve_codes(self._cast_params(),
                                 torch.as_tensor(x_scrambled, device=self.device))

    def solve(self, x_scrambled) -> np.ndarray:
        """Predict the slot of each scrambled piece by ``assignment_method``.
        -> (B, P) int64."""
        pred, dist = self.solve_codes(x_scrambled)
        if self.assignment_method == "hungarian":
            return assignment.hungarian_permutation(dist)
        return pred.cpu().numpy()

    def _draw(self, b: int, count: int | None = None) -> torch.Tensor:
        shape = b if count is None else count * b
        perms = jigsaw.random_permutations(shape, self.pieces, generator=self.generator,
                                           device=self.device)
        return perms if count is None else perms.reshape(count, b, self.pieces)

    def _to_device(self, a) -> torch.Tensor:
        """A tensor or array on the solver's device. From the host through
        pinned memory without blocking, so that queueing a batch does not
        wait for the card to finish the one before."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        if t.device == self.device:
            return t
        if t.device.type == "cpu" and self.device.type == "cuda" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _as_perms(self, a, shape: tuple) -> torch.Tensor:
        t = self._to_device(a).to(torch.long)
        if tuple(t.shape) != shape:
            raise ValueError(f"permutations of shape {tuple(t.shape)}, expected {shape}")
        return t

    def evaluate_async(self, x, indices=None, sigmas=None) -> Callable[[], SolveResult]:
        """Queue one scramble + solve + score on the card and return a thunk.

        ``indices`` (B, P) scramble the clean images ``x`` (B, H, W, C);
        with ``votes`` > 1, ``sigmas`` (votes - 1, B, P) are the further
        arrangements, applied on top of the scramble. Either is drawn from
        the solver's generator when None. The kernels run asynchronously;
        the results needed on the host (with Hungarian, the distances) come
        back in one non-blocking copy behind an event, and the thunk waits
        for that event and builds the :class:`SolveResult`, so that a
        caller can queue the next batch first (``solver.py:253-300``)."""
        with torch.inference_mode():
            x = self._to_device(x)
            b, p = x.shape[0], self.pieces
            indices = self._draw(b) if indices is None else self._as_perms(indices, (b, p))
            model = self._cast_params()
            x_scr = jigsaw.scramble(x, indices, self.grid)
            pred, dist = self._solve_codes(model, x_scr)
            if self.votes > 1:
                v = self.votes - 1
                sigmas = (self._draw(b, v) if sigmas is None
                          else self._as_perms(sigmas, (v, b, p)))
                total = dist.to(torch.float32)
                for sv in sigmas:
                    _, dv = self._solve_codes(model, jigsaw.scramble(x_scr, sv, self.grid))
                    inv = torch.argsort(sv, dim=-1)
                    total = total + torch.take_along_dim(
                        dv.to(torch.float32), inv[..., None], dim=1)
                dist = total / (1 + v)
                pred = assignment.greedy_permutation(dist)
            wanted = (dist if self.assignment_method == "hungarian" else pred, indices)
            host = [t.to("cpu", non_blocking=True) for t in wanted]
            done = torch.cuda.Event() if self.device.type == "cuda" else None
            if done is not None:
                done.record()

        def result() -> SolveResult:
            if done is not None:
                done.synchronize()
            out, idx = (t.numpy() for t in host)
            if self.assignment_method == "hungarian":
                out = assignment.hungarian_permutation(out)
            return _score(out.astype(np.int64), idx.astype(np.int64))

        return result

    def evaluate(self, x, indices=None, sigmas=None) -> SolveResult:
        """Scramble clean images (B, H, W, C) by ``indices`` (B, P) (drawn
        from the solver's generator when None), solve, score."""
        return self.evaluate_async(x, indices, sigmas)()

    @torch.inference_mode()
    def evaluate_masked(self, x, num_masked: int, mask_fill: str = "noise", *,
                        indices=None, piece_mask=None, fill=None) -> SolveResult:
        """Masked puzzles (``solver.py:306-340``): scramble, hide
        ``num_masked`` random scrambled slots per image, solve, score
        against the whole permutation. Holes are filled with Gaussian noise
        (``"noise"``, the masked training distribution) or zeros
        (``"zero"``, the reference notebook's protocol). ``indices`` (B, P),
        ``piece_mask`` (B, P; 1 = visible) and ``fill`` (B, H, W, C) may be
        given; otherwise they are drawn from the solver's generator."""
        if mask_fill not in ("noise", "zero"):
            raise ValueError(f"unknown mask_fill {mask_fill!r}")
        x = torch.as_tensor(x, device=self.device)
        b, p = x.shape[0], self.pieces
        indices = self._draw(b) if indices is None else self._as_perms(indices, (b, p))
        x_scr = jigsaw.scramble(x, indices, self.grid)
        if piece_mask is None:
            scores = torch.rand((b, p), generator=self.generator, device=self.device)
            ranks = torch.argsort(torch.argsort(scores, dim=-1), dim=-1)
            piece_mask = ranks >= num_masked
        piece_mask = torch.as_tensor(piece_mask, device=self.device).to(x.dtype)
        mask_img = jigsaw.piece_mask_to_image(piece_mask, self.grid, x.shape[1] // self.grid,
                                              x.shape[-1])
        if mask_fill == "zero":
            fill = torch.zeros_like(x_scr)
        elif fill is None:
            fill = torch.randn(x_scr.shape, generator=self.generator, device=self.device,
                               dtype=x_scr.dtype)
        fill = torch.as_tensor(fill, device=self.device, dtype=x_scr.dtype)
        pred = self.solve(x_scr * mask_img + fill * (1 - mask_img))
        return _score(pred, indices.cpu().numpy())

    def scramble(self, x, indices) -> torch.Tensor:
        """Scramble clean images (B, H, W, C) by ``indices`` (B, P)."""
        return jigsaw.scramble(torch.as_tensor(x, device=self.device),
                               torch.as_tensor(indices, device=self.device,
                                               dtype=torch.long), self.grid)

    def reconstruct(self, x_scrambled, pred) -> torch.Tensor:
        """Re-place pieces by the predicted permutation (inference.py:321-327)."""
        x = torch.as_tensor(x_scrambled, device=self.device)
        return jigsaw.unscramble(x, torch.as_tensor(pred, device=self.device),
                                 self.grid)
