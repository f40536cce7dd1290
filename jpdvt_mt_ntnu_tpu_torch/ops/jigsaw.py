"""Jigsaw tensor ops: pieces, scrambles and code pooling.

Counterpart of ``jpdvt_mt_ntnu_tpu/ops/jigsaw.py``. Images are NHWC, pieces
``(B, P, h, w, C)`` with ``P = grid**2`` row-major over the grid, as there.
"""

from __future__ import annotations

import torch


def to_pieces(x: torch.Tensor, grid: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, P, h, w, C), pieces row-major."""
    b, hh, ww, c = x.shape
    h, w = hh // grid, ww // grid
    x = x.reshape(b, grid, h, grid, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, grid * grid, h, w, c)


def from_pieces(p: torch.Tensor, grid: int) -> torch.Tensor:
    """(B, P, h, w, C) -> (B, H, W, C)."""
    b, _, h, w, c = p.shape
    p = p.reshape(b, grid, grid, h, w, c).permute(0, 1, 3, 2, 4, 5)
    return p.reshape(b, grid * h, grid * w, c)


def permute_pieces(p: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``out[:, k] = p[:, indices[k]]``; indices (P,) shared or (B, P)."""
    if indices.dim() == 1:
        return p[:, indices]
    return p[torch.arange(p.shape[0], device=p.device)[:, None], indices]


def scramble(x: torch.Tensor, indices: torch.Tensor, grid: int) -> torch.Tensor:
    """Permute the grid pieces of an image batch. (B,H,W,C) -> (B,H,W,C)."""
    return from_pieces(permute_pieces(to_pieces(x, grid), indices), grid)


def unscramble(x: torch.Tensor, pred: torch.Tensor, grid: int) -> torch.Tensor:
    """Piece at slot i goes to slot pred[i] (reference inference.py:322-326)."""
    return scramble(x, torch.argsort(pred, dim=-1), grid)


def tokens_to_piece_code(tokens: torch.Tensor, grid: int, sub: int) -> torch.Tensor:
    """(..., N, d) raster-order token codes -> (..., P, d) per-piece means
    over each piece's ``sub*sub`` tokens (reference inference.py:296-301)."""
    *lead, n, d = tokens.shape
    if n != (grid * sub) ** 2:
        raise ValueError(f"{n} tokens do not tile a {grid}x{grid} grid of "
                         f"{sub}x{sub} pieces")
    t = tokens.reshape(*lead, grid, sub, grid, sub, d)
    t = t.movedim(-3, -4)  # (..., grid, grid, sub, sub, d)
    return t.reshape(*lead, grid * grid, sub * sub, d).mean(dim=-2)


def random_permutations(batch: int, n: int, *, generator: torch.Generator | None = None,
                        device: torch.device | str = "cpu") -> torch.Tensor:
    """(B, P) independent random permutations."""
    keys = torch.rand((batch, n), generator=generator, device=device)
    return torch.argsort(keys, dim=-1)
