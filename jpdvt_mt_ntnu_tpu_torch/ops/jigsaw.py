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


def piece_code_to_tokens(code: torch.Tensor, grid: int, sub: int) -> torch.Tensor:
    """(..., P, d) per-piece codes -> (..., N, d) per-token codes in the
    token raster order (p1 h1 p2 w1), each piece covering ``sub*sub``
    tokens (reference gaussian_diffusion.py:783-790)."""
    *lead, p, d = code.shape
    if p != grid * grid:
        raise ValueError(f"{p} piece codes for a {grid}x{grid} grid")
    c = code.reshape(*lead, grid, grid, 1, 1, d).expand(
        *lead, grid, grid, sub, sub, d)
    c = c.movedim(-3, -4)  # (..., p1, h1, p2, w1, d)
    return c.reshape(*lead, (grid * sub) ** 2, d)


def random_permutations(batch: int, n: int, *, shared: bool = False,
                        generator: torch.Generator | None = None,
                        device: torch.device | str = "cpu") -> torch.Tensor:
    """(B, P) random permutations: independent per sample, or one shared by
    the batch (``shared``, the reference's training draw,
    gaussian_diffusion.py:756)."""
    if shared:
        perm = torch.argsort(torch.rand((n,), generator=generator, device=device))
        return perm.expand(batch, n)
    keys = torch.rand((batch, n), generator=generator, device=device)
    return torch.argsort(keys, dim=-1)


def random_piece_masks(batch: int, grid: int, *,
                       generator: torch.Generator | None = None,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """(B, P) float piece visibility, 1 = visible: each sample hides
    ``r ~ Uniform{0..grid-1}`` distinct pieces chosen uniformly
    (reference gaussian_diffusion.py:763-767)."""
    p = grid * grid
    r = torch.randint(0, grid, (batch,), generator=generator, device=device)
    scores = torch.rand((batch, p), generator=generator, device=device)
    ranks = torch.argsort(torch.argsort(scores, dim=-1), dim=-1)
    return (ranks >= r[:, None]).float()


def piece_mask_to_image(mask: torch.Tensor, grid: int, piece_px: int,
                        channels: int = 3) -> torch.Tensor:
    """(B, P) piece mask -> (B, H, W, C) pixel mask."""
    b, p = mask.shape
    m = mask.reshape(b, p, 1, 1, 1).expand(b, p, piece_px, piece_px, channels)
    return from_pieces(m, grid)


def inner_crop_pieces(x: torch.Tensor, grid: int, crop: int) -> torch.Tensor:
    """Centre-crop each grid piece to ``crop`` px and reassemble (the
    ImageNet ``--crop`` gap augmentation, train_JPDVT.py:345-349)."""
    p = to_pieces(x, grid)
    off = (p.shape[2] - crop) // 2
    return from_pieces(p[:, :, off:off + crop, off:off + crop, :], grid)
