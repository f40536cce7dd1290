"""Permutation recovery: Manhattan distances, greedy and Hungarian assignment.

Counterpart of ``jpdvt_mt_ntnu_tpu/ops/assignment.py`` (the reference's
``inference.py:113-125,304-314``): distances and the greedy scan batched
over puzzles on the device; the Hungarian method on the host, through the
port's C++ solver (``ops/native.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import native

_KNOCKOUT = 1e9


def manhattan_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., P, d), (P, d) -> (..., P, P): dist[i, j] = ||a_i - b_j||_1."""
    return (a[..., :, None, :] - b[None, :, :]).abs().sum(-1)


def greedy_assignment(dist: torch.Tensor) -> torch.Tensor:
    """(B, P, P) -> order (B, P): for slot j = 0, 1, ... take the remaining
    piece of least distance (first index on ties, as ``np.argmin``) and
    knock its row out with 1e9 (``assignment.py:25-54``)."""
    d = dist.to(torch.float32).clone()
    b, p, _ = d.shape
    rows = torch.arange(b, device=d.device)
    order = torch.empty((b, p), dtype=torch.long, device=d.device)
    for j in range(p):
        pick = torch.argmin(d[:, :, j], dim=1)
        order[:, j] = pick
        d[rows, pick] = _KNOCKOUT
    return order


def greedy_permutation(dist: torch.Tensor) -> torch.Tensor:
    """dist (B, P, P) -> pred (B, P), the slot of each piece:
    ``argsort(order)`` as in inference.py:306."""
    return torch.argsort(greedy_assignment(dist), dim=-1)


def hungarian_permutation(dist) -> np.ndarray:
    """Optimal assignment on the host (``assignment.py:57-73``): dist
    (..., P, P), a tensor on any device or an array -> pred (..., P) int64."""
    if isinstance(dist, torch.Tensor):
        dist = dist.detach().to("cpu", torch.float32).numpy()
    return native.hungarian_permutation(dist).astype(np.int64)


def permutation_metrics(pred: torch.Tensor, indices: torch.Tensor):
    """(puzzle_correct (B,) int32, patch_matches (B,) int32)."""
    eq = pred == indices
    return eq.all(-1).to(torch.int32), eq.sum(-1).to(torch.int32)
