"""DDPM over per-token positional codes, conditioned on scrambled images.

Counterpart of ``jpdvt_mt_ntnu_tpu/core/diffusion.py`` (the reference's
``image_model/diffusion/gaussian_diffusion.py``), sampling side. The model
protocol is the same: ``model_fn(condition, t_original, code) ->
(image_out, code_out)``, with the respacing remap to original-chain
timesteps done here.

Sampler modes of :meth:`Diffusion.p_sample_loop`:

- ``"faithful"``: the reference quirk (``gaussian_diffusion.py:522``,
  JAX ``core/diffusion.py:160``): every step feeds the ORIGINAL noise to the
  model, not the running sample. Only the t=0 step survives, so the output
  is the model's x0-prediction at t=0 from the noise.
- ``"fast"``: that t=0 step alone (:meth:`Diffusion.solve_t0`), the same
  computation in one model call.
- ``"iterative"``: the corrected ancestral chain (feeds the sample back).

The per-step noise is drawn from a ``torch.Generator``, or passed in as
``step_noise`` (one (B, N, d) tensor per step), which is how the tests hold
the iterative chain to the JAX package's: torch cannot reproduce JAX's
random stream. Faithful and fast outputs do not depend on it (the t=0 mask
zeroes it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from ..utils.device import default_device
from .schedules import DiffusionSchedule, make_schedule

ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                   tuple[torch.Tensor, torch.Tensor]]

_TABLES = ("posterior_mean_coef1", "posterior_mean_coef2", "posterior_variance",
           "posterior_log_variance_clipped")


@dataclasses.dataclass
class Diffusion:
    """A (possibly respaced) Gaussian diffusion over positional codes, with
    the reference's sampling choices: the model predicts x0 (START_X) and
    the variance is FIXED_SMALL. The float32 tables of ``schedule`` are
    copied to ``device`` once."""

    schedule: DiffusionSchedule
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = default_device(self.device)
        s = self.schedule
        self.tables = {name: torch.as_tensor(getattr(s, name), device=self.device)
                       for name in _TABLES}
        self.timestep_map = torch.as_tensor(s.timestep_map, device=self.device)

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    def _extract(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        return self.tables[name][t].reshape(t.shape + (1,) * (ndim - 1))

    def to_original_t(self, t: torch.Tensor) -> torch.Tensor:
        """Spaced index -> original-chain index for the model's embedding."""
        return self.timestep_map[t]

    def q_posterior_mean_variance(self, x_start, x_t, t):
        """q(x_{t-1} | x_t, x_0) (gaussian_diffusion.py:234-254)."""
        nd = x_t.ndim
        mean = (self._extract("posterior_mean_coef1", t, nd) * x_start
                + self._extract("posterior_mean_coef2", t, nd) * x_t)
        return (mean, self._extract("posterior_variance", t, nd),
                self._extract("posterior_log_variance_clipped", t, nd))

    def p_mean_variance(self, model_fn: ModelFn, condition, x, t,
                        clip_denoised: bool = True):
        """p(x_{t-1} | x_t) for the code stream: the model's CODE output is
        the x0-prediction (gaussian_diffusion.py:281); the variance is
        FIXED_SMALL, as the reference forces it (:288)."""
        _, code_out = model_fn(condition, self.to_original_t(t), x)
        pred_xstart = code_out.clamp(-1.0, 1.0) if clip_denoised else code_out
        mean, variance, log_variance = self.q_posterior_mean_variance(
            pred_xstart, x, t)
        return mean, variance, log_variance, pred_xstart

    def p_sample(self, model_fn: ModelFn, condition, x, t, noise,
                 clip_denoised: bool = True):
        """One ancestral step (gaussian_diffusion.py:388-431) with the given
        standard-normal ``noise``."""
        mean, _, log_variance, pred_xstart = self.p_mean_variance(
            model_fn, condition, x, t, clip_denoised)
        nonzero = (t != 0).to(x.dtype).reshape(t.shape + (1,) * (x.ndim - 1))
        return mean + nonzero * torch.exp(0.5 * log_variance) * noise, pred_xstart

    def p_sample_loop(self, model_fn: ModelFn, condition, noise, *,
                      mode: str = "faithful", clip_denoised: bool = False,
                      generator: torch.Generator | None = None,
                      step_noise: Sequence[torch.Tensor] | None = None):
        """The reverse process. noise: (B, N, d) initial code noise. Returns
        the final code sample (B, N, d)."""
        if mode == "fast":
            return self.solve_t0(model_fn, condition, noise, clip_denoised)
        if mode not in ("faithful", "iterative"):
            raise ValueError(f"unknown sampler mode {mode!r}")
        b = noise.shape[0]
        img = noise
        for i, t_scalar in enumerate(range(self.num_timesteps - 1, -1, -1)):
            x_in = noise if mode == "faithful" else img
            t = torch.full((b,), t_scalar, dtype=torch.long, device=noise.device)
            z = (step_noise[i] if step_noise is not None else torch.randn(
                noise.shape, generator=generator, device=noise.device,
                dtype=noise.dtype))
            img, _ = self.p_sample(model_fn, condition, x_in, t, z, clip_denoised)
        return img

    def solve_t0(self, model_fn: ModelFn, condition, noise,
                 clip_denoised: bool = False):
        """The faithful loop's only surviving step: the t=0 posterior mean of
        the model's x0-prediction from the original noise (one model call)."""
        t = torch.zeros((noise.shape[0],), dtype=torch.long, device=noise.device)
        _, code_out = model_fn(condition, self.to_original_t(t), noise)
        pred = code_out.clamp(-1.0, 1.0) if clip_denoised else code_out
        return self.q_posterior_mean_variance(pred, noise, t)[0]


def create_diffusion(timestep_respacing: str | None = "",
                     noise_schedule: str = "linear",
                     diffusion_steps: int = 1000, *,
                     device: torch.device | str | None = None) -> Diffusion:
    """The reference defaults (diffusion/__init__.py:10-46): linear betas,
    1000 base steps, START_X, FIXED_SMALL; tables on ``device`` (default:
    the card). The JAX package's epsilon and FIXED_LARGE variants serve
    training configurations and wait for the training port."""
    schedule = make_schedule(timestep_respacing, noise_schedule, diffusion_steps)
    return Diffusion(schedule=schedule, device=device)
