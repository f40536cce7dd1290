"""Timestep samplers, with a loss-aware importance resampler.

Counterpart of ``jpdvt_mt_ntnu_tpu/core/timestep_sampler.py`` (the
reference's ``diffusion/timestep_sampler.py``, which nothing of it
imports; its training draws ``torch.randint``). A sampler draws
timesteps with probabilities ``weights() / sum`` from a
``torch.Generator`` and returns importance weights ``1 / (T p_t)`` that
keep ``E[w f(t)]`` unbiased. The history of
:class:`LossSecondMomentResampler` lives on the host;
:meth:`~LossSecondMomentResampler.update_with_all_losses_multihost`
gathers every rank's (t, loss) pairs over ``parallel.DataParallel`` first,
as the reference's padded ``all_gather`` does (timestep_sampler.py:82-98).
"""

from __future__ import annotations

import numpy as np
import torch


class ScheduleSampler:
    """Importance-sampled timesteps with importance weights."""

    def weights(self) -> np.ndarray:
        raise NotImplementedError

    def sample(self, batch: int, generator: torch.Generator | None = None,
               device: str | torch.device = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
        """-> (t (B,) int64, weights (B,) float32), drawn on the CPU from
        ``generator`` and moved to ``device``."""
        w = np.asarray(self.weights(), dtype=np.float64)
        p = w / w.sum()
        t = torch.multinomial(torch.as_tensor(p), batch, replacement=True, generator=generator)
        inv = torch.as_tensor(1.0 / (len(p) * p), dtype=torch.float32)
        return t.to(device), inv[t].to(device)


class UniformSampler(ScheduleSampler):
    def __init__(self, num_timesteps: int):
        self._w = np.ones(num_timesteps)

    def weights(self) -> np.ndarray:
        return self._w


class LossSecondMomentResampler(ScheduleSampler):
    """Timesteps in proportion to sqrt(E[loss^2]) over the last
    ``history_per_term`` losses of each, mixed with ``uniform_prob`` of the
    uniform; uniform until every timestep has a full history
    (timestep_sampler.py:120-150)."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._history = np.zeros((num_timesteps, history_per_term))
        self._counts = np.zeros(num_timesteps, dtype=np.int64)

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones(self.num_timesteps)
        w = np.sqrt((self._history ** 2).mean(axis=-1))
        w /= w.sum()
        w *= 1 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def update_with_losses(self, ts, losses) -> None:
        for t, loss in zip(np.asarray(ts).tolist(), np.asarray(losses).tolist()):
            c = self._counts[t]
            if c == self.history_per_term:
                self._history[t, :-1] = self._history[t, 1:]
                self._history[t, -1] = loss
            else:
                self._history[t, c] = loss
                self._counts[t] += 1

    def update_with_all_losses_multihost(self, ts, losses, dp=None) -> None:
        """Every rank's (t, loss) pairs, in rank order, gathered over ``dp``
        (a ``parallel.DataParallel``; None or a world of one: this rank's)."""
        ts = np.asarray(torch.as_tensor(ts).cpu()).reshape(-1)
        losses = np.asarray(torch.as_tensor(losses).detach().float().cpu()).reshape(-1)
        if dp is not None and dp.world > 1:
            pairs = dp.all_gather((ts, losses))
            ts = np.concatenate([p[0] for p in pairs])
            losses = np.concatenate([p[1] for p in pairs])
        self.update_with_losses(ts, losses)

    def _warmed_up(self) -> bool:
        return bool((self._counts == self.history_per_term).all())
