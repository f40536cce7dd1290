"""Sinusoidal positional and timestep embeddings.

Counterpart of ``jpdvt_mt_ntnu_tpu/utils/pos_embed.py``. The 2-D tables are
built in float64 numpy exactly as there (and as the reference's
``image_model/models.py:319-366``), including its ``meshgrid(w, h)`` order:
the first half of each code encodes the column (w) coordinate. The timestep
embedding is cos-first (``models.py:40-59``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """1-D sin-cos table: (M,) positions -> (M, embed_dim), sin half first."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid_size**2, embed_dim) float64 table, row-major over the grid."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    coords = np.arange(grid_size, dtype=np.float64)
    w = np.tile(coords, grid_size)      # w varies fastest
    h = np.repeat(coords, grid_size)
    return np.concatenate([_sincos_1d(embed_dim // 2, w),
                           _sincos_1d(embed_dim // 2, h)], axis=1)


def grid_code(code_dim: int, grid_size: int, dtype=np.float32) -> np.ndarray:
    """Canonical per-piece positional code, shape (grid_size**2, code_dim)."""
    return get_2d_sincos_pos_embed(code_dim, grid_size).astype(dtype)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """(N,) timesteps -> (N, dim) float32, cos first (GLIDE convention)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
