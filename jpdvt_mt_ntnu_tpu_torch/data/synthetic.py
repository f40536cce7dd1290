"""Synthetic ``waves`` puzzles, numpy only.

Counterpart of ``SyntheticPuzzles`` in ``jpdvt_mt_ntnu_tpu/data/datasets.py``
(lines 190-323), ``"waves"`` regime only: 2-3 low-frequency plane waves per
image with random orientation, frequency and phase. A single piece carries
no absolute-position signal; the placement is recoverable only from the
pieces together. Item ``i`` of ``seed`` draws its parameters from
``default_rng(seed * 1000003 + i)``, so items equal the JAX package's.
:meth:`SyntheticPuzzles.device_batch` builds the fields on the card from
those host-drawn parameters, for any index (the never-repeating training
stream of ``data.device_stream``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import default_device

_TWO_PI = float(2 * np.float32(np.pi))


@functools.lru_cache(maxsize=4)
def _unit_grid(s: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(yy, xx) of ``np.mgrid[0:s, 0:s].astype(np.float32) / s`` on ``device``."""
    a = torch.arange(s, dtype=torch.float32, device=device) / s
    return a[:, None].expand(s, s), a[None, :].expand(s, s)


class SyntheticPuzzles:
    """Deterministic wave-field images, (s, s, 3) float32 in [-1, 1]."""

    _WAVES_MAX_K = 3

    def __init__(self, image_size: int = 192, n: int = 1024, seed: int = 0,
                 cues: str = "waves", hard_frac: float = 0.0):
        if cues != "waves":
            raise NotImplementedError(f"cue regime {cues!r} is not ported; "
                                      "only 'waves' is")
        self.image_size = image_size
        self.n = n
        self.seed = seed
        self.cues = cues
        self.hard_frac = float(hard_frac)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> np.ndarray:
        if not 0 <= i < self.n:
            raise IndexError(i)
        s = self.image_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        return self._waves_field(*self._wave_params(i), xx, yy).astype(np.float32)

    def batch(self, count: int | None = None) -> np.ndarray:
        """The first ``count`` items (all by default), stacked (B, s, s, 3)."""
        return np.stack([self[i] for i in range(self.n if count is None else count)])

    def device_batch(self, indices, device: str | torch.device | None = None
                     ) -> torch.Tensor:
        """Items ``indices`` (any non-negative ints, not bounded by ``n``) as
        a (B, s, s, 3) bfloat16 batch built on ``device`` (default: the
        card): the counterpart of the JAX package's ``device_batcher``
        (``data/datasets.py:324-354``). Only the per-item parameter draws
        run on the host; the fields equal :meth:`__getitem__`'s to fp32
        rounding before the cast."""
        device = default_device(device)
        params = [self._wave_params(int(i)) for i in indices]
        th, f, ph, amp = (torch.from_numpy(np.stack([p[j] for p in params])).to(device)
                          for j in range(4))
        yy, xx = _unit_grid(self.image_size, device)
        u = (torch.cos(th)[:, :, None, None] * xx
             + torch.sin(th)[:, :, None, None] * yy)            # (B, K, s, s)
        base = torch.sin(_TWO_PI * f[:, :, None, None] * u + ph[:, :, None, None])
        img = (base[..., None] * amp[:, :, None, None, :]).sum(dim=1)  # (B, s, s, 3)
        peak = img.abs().amax(dim=(1, 2, 3), keepdim=True)
        return (img / (peak + 1e-6) * 0.9).clamp(-1.0, 1.0).to(torch.bfloat16)

    def _wave_params(self, i: int):
        """Per-image (theta, freq, phase, amp), padded to 3 components.

        ``hard_frac``: probability of drawing from the hard region of the
        20x20 capability cliff (k=2, pairwise angle > 1.2 rad, max
        frequency > 0.85)."""
        rng = np.random.default_rng(self.seed * 1000003 + i)
        if self.hard_frac and rng.random() < self.hard_frac:
            th = rng.uniform(0, np.pi)
            th2 = th + rng.choice([-1, 1]) * rng.uniform(1.2, np.pi / 2)
            th = np.mod([th, th2], np.pi)
            f = np.array([rng.uniform(0.85, 1.0), rng.uniform(0.25, 1.0)])
            rng.shuffle(f)
            pad = self._WAVES_MAX_K - 2
            return (np.pad(th, (0, pad)).astype(np.float32),
                    np.pad(f, (0, pad)).astype(np.float32),
                    np.pad(rng.uniform(0, 2 * np.pi, 2), (0, pad)).astype(np.float32),
                    np.pad(rng.uniform(0.3, 1.0, (2, 3)),
                           ((0, pad), (0, 0))).astype(np.float32))
        k = 2 + int(rng.random() < 0.3)
        # Orientations pairwise >= 0.5 rad apart (mod pi), so that no two
        # pieces along a shared wavefront look alike.
        while True:
            th = rng.uniform(0, np.pi, k)
            d = np.abs(th[:, None] - th[None, :])
            d = np.minimum(d, np.pi - d)
            if np.all(d[np.triu_indices(k, 1)] >= 0.5):
                break
        pad = self._WAVES_MAX_K - k
        th = np.pad(th, (0, pad)).astype(np.float32)
        f = np.pad(rng.uniform(0.25, 1.0, k), (0, pad)).astype(np.float32)
        ph = np.pad(rng.uniform(0, 2 * np.pi, k), (0, pad)).astype(np.float32)
        amp = np.pad(rng.uniform(0.3, 1.0, (k, 3)),
                     ((0, pad), (0, 0))).astype(np.float32)
        return th, f, ph, amp

    @staticmethod
    def _waves_field(th, f, ph, amp, xx, yy):
        """th/f/ph: (K,), amp: (K, 3), xx/yy: (s, s) in [0, 1) -> (s, s, 3)."""
        u = (np.cos(th)[:, None, None] * xx[None]
             + np.sin(th)[:, None, None] * yy[None])
        base = np.sin(2 * np.float32(np.pi) * f[:, None, None] * u
                      + ph[:, None, None])
        img = np.sum(base[..., None] * amp[:, None, None, :], axis=0)
        img = img / (np.max(np.abs(img)) + 1e-6)
        return np.clip(img * 0.9, -1.0, 1.0)
