"""DDPM over per-token positional codes, conditioned on scrambled images.

Counterpart of ``jpdvt_mt_ntnu_tpu/core/diffusion.py`` (the reference's
``image_model/diffusion/gaussian_diffusion.py``): the samplers and the
jigsaw training loss (:meth:`Diffusion.training_losses`). The model
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

:meth:`Diffusion.ddim_sample_loop` is the JAX package's working DDIM
sampler (``core/diffusion.py:188-216``); the solver's ``mode="ddim"`` runs
it with eta 0, where it draws no noise.

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

from ..ops import jigsaw
from ..utils.device import default_device
from .schedules import DiffusionSchedule, make_schedule

ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                   tuple[torch.Tensor, torch.Tensor]]

_TABLES = ("posterior_mean_coef1", "posterior_mean_coef2", "posterior_variance",
           "posterior_log_variance_clipped", "large_variance", "large_log_variance",
           "alphas_cumprod", "alphas_cumprod_prev", "log_one_minus_alphas_cumprod",
           "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
           "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod")
MEAN_TYPES = ("start_x", "epsilon")
VAR_TYPES = ("fixed_small", "fixed_large")


@dataclasses.dataclass
class Diffusion:
    """A (possibly respaced) Gaussian diffusion over positional codes. The
    reference's choices are the defaults: the model predicts x0
    (``start_x``) and the variance is ``fixed_small``; ``epsilon`` and
    ``fixed_large`` are the JAX package's other options. The float32 tables
    of ``schedule`` are copied to ``device`` once."""

    schedule: DiffusionSchedule
    device: torch.device | str | None = None
    mean_type: str = "start_x"
    var_type: str = "fixed_small"

    def __post_init__(self):
        if self.mean_type not in MEAN_TYPES or self.var_type not in VAR_TYPES:
            raise ValueError(f"unknown mean/var type {self.mean_type!r}/{self.var_type!r}")
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

    def q_mean_variance(self, x_start, t):
        """Mean, variance and log variance of q(x_t | x_0) (JAX
        ``core/diffusion.py:56``)."""
        nd = x_start.ndim
        return (self._extract("sqrt_alphas_cumprod", t, nd) * x_start,
                1.0 - self._extract("alphas_cumprod", t, nd),
                self._extract("log_one_minus_alphas_cumprod", t, nd))

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        """The noise implied by an x0-prediction (JAX ``core/diffusion.py:88``)."""
        nd = x_t.ndim
        return ((self._extract("sqrt_recip_alphas_cumprod", t, nd) * x_t - pred_xstart)
                / self._extract("sqrt_recipm1_alphas_cumprod", t, nd))

    def q_sample(self, x_start, t, noise):
        """Sample q(x_t | x_0) (gaussian_diffusion.py:217-232)."""
        nd = x_start.ndim
        return (self._extract("sqrt_alphas_cumprod", t, nd) * x_start
                + self._extract("sqrt_one_minus_alphas_cumprod", t, nd) * noise)

    def _pred_xstart(self, model_out, x, t, clip_denoised: bool):
        if self.mean_type == "start_x":
            pred = model_out
        else:
            nd = x.ndim
            pred = (self._extract("sqrt_recip_alphas_cumprod", t, nd) * x
                    - self._extract("sqrt_recipm1_alphas_cumprod", t, nd) * model_out)
        return pred.clamp(-1.0, 1.0) if clip_denoised else pred

    def q_posterior_mean_variance(self, x_start, x_t, t):
        """q(x_{t-1} | x_t, x_0) (gaussian_diffusion.py:234-254)."""
        nd = x_t.ndim
        mean = (self._extract("posterior_mean_coef1", t, nd) * x_start
                + self._extract("posterior_mean_coef2", t, nd) * x_t)
        return (mean, self._extract("posterior_variance", t, nd),
                self._extract("posterior_log_variance_clipped", t, nd))

    def p_mean_variance(self, model_fn: ModelFn, condition, x, t,
                        clip_denoised: bool = True):
        """p(x_{t-1} | x_t) for the code stream: the model's CODE output
        (gaussian_diffusion.py:281) read by ``mean_type``; the variance by
        ``var_type``, as the JAX package's ``p_mean_variance``."""
        _, code_out = model_fn(condition, self.to_original_t(t), x)
        pred_xstart = self._pred_xstart(code_out, x, t, clip_denoised)
        mean, variance, log_variance = self.q_posterior_mean_variance(
            pred_xstart, x, t)
        if self.var_type == "fixed_large":
            variance = self._extract("large_variance", t, x.ndim)
            log_variance = self._extract("large_log_variance", t, x.ndim)
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
        pred = self._pred_xstart(code_out, noise, t, clip_denoised)
        return self.q_posterior_mean_variance(pred, noise, t)[0]

    def ddim_sample_loop(self, model_fn: ModelFn, condition, noise, *,
                         eta: float = 0.0, clip_denoised: bool = False,
                         generator: torch.Generator | None = None,
                         step_noise: Sequence[torch.Tensor] | None = None):
        """DDIM (Song et al., eq. 12; JAX ``core/diffusion.py:188-216``):
        every step feeds the running sample back. The step noise is scaled
        by sigma, which is 0 at ``eta`` 0; then none is drawn."""
        b = noise.shape[0]
        img = noise
        for i, t_scalar in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((b,), t_scalar, dtype=torch.long, device=noise.device)
            nd = img.ndim
            _, code_out = model_fn(condition, self.to_original_t(t), img)
            pred_xstart = self._pred_xstart(code_out, img, t, clip_denoised)
            eps = self._predict_eps_from_xstart(img, t, pred_xstart)
            a_bar = self._extract("alphas_cumprod", t, nd)
            a_prev = self._extract("alphas_cumprod_prev", t, nd)
            sigma = (eta * torch.sqrt((1 - a_prev) / (1 - a_bar))
                     * torch.sqrt(1 - a_bar / a_prev))
            mean = (pred_xstart * torch.sqrt(a_prev)
                    + torch.sqrt(torch.clamp(1 - a_prev - sigma ** 2, min=0.0)) * eps)
            if eta:
                z = (step_noise[i] if step_noise is not None else torch.randn(
                    img.shape, generator=generator, device=img.device, dtype=img.dtype))
                nonzero = (t != 0).to(img.dtype).reshape(t.shape + (1,) * (nd - 1))
                mean = mean + nonzero * sigma * z
            img = mean
        return img

    def training_losses(self, model_fn: ModelFn, x_start, t, piece_code, *,
                        block_size: int, patch_size: int, add_mask: bool = False,
                        grid_size: int = 3, shared_perm: bool = True,
                        generator: torch.Generator | None = None,
                        _inject: dict | None = None) -> dict:
        """Jigsaw diffusion training loss (gaussian_diffusion.py:736-843,
        JAX ``core/diffusion.py:218-295``).

        x_start: (B, H, W, C) clean images, NHWC, in [-1, 1]; t: (B,) spaced
        timestep indices; piece_code: (P, code_dim) canonical grid code.
        ``shared_perm`` draws one permutation for the batch, as the
        reference does. Parity quirks kept: masks are drawn on the
        UNPERMUTED piece layout and not permuted with the pieces; visible
        regions of the model input are CLEAN pixels, masked holes NOISED
        ones. Random draws (permutation, masks, image noise, code noise, in
        that order) come from ``generator``; ``_inject`` may supply any of
        ``indices``, ``piece_mask``, ``noise_x``, ``noise_c`` instead, which
        is how the tests feed this and the JAX package the same draws.

        Returns {"loss", "code_mse", "img_mse"} (each (B,)), "indices" and
        "piece_mask"."""
        b = x_start.shape[0]
        grid = grid_size
        p = grid * grid
        sub = block_size // patch_size
        dev = x_start.device
        inj = _inject or {}
        indices = inj.get("indices")
        if indices is None:
            indices = jigsaw.random_permutations(b, p, shared=shared_perm,
                                                 generator=generator, device=dev)
        indices = torch.as_tensor(indices, device=dev, dtype=torch.long)
        piece_mask = inj.get("piece_mask")
        if piece_mask is None:
            piece_mask = (jigsaw.random_piece_masks(b, grid, generator=generator,
                                                    device=dev)
                          if add_mask else torch.ones((b, p), device=dev))
        piece_mask = torch.as_tensor(piece_mask, device=dev, dtype=torch.float32)
        x_shuf = jigsaw.scramble(x_start, indices, grid)
        masks = jigsaw.piece_mask_to_image(piece_mask, grid, block_size,
                                           x_start.shape[-1]).to(x_start.dtype)
        code_tok = jigsaw.piece_code_to_tokens(piece_code[indices], grid, sub)

        def draw(name, like):
            z = inj.get(name)
            if z is None:
                return torch.randn(like.shape, generator=generator, device=dev,
                                   dtype=like.dtype)
            return torch.as_tensor(z, device=dev, dtype=like.dtype)

        noise_x = draw("noise_x", x_shuf)
        noise_c = draw("noise_c", code_tok)
        x_t = self.q_sample(x_shuf, t, noise_x)
        code_t = self.q_sample(code_tok, t, noise_c)
        x_t = x_t * (1 - masks) + masks * x_shuf

        img_out, code_out = model_fn(x_t, self.to_original_t(t), code_t)
        if self.mean_type == "start_x":
            target_c, target_x = code_tok, x_shuf
        else:
            target_c, target_x = noise_c, noise_x

        def mean_flat(v):
            return v.reshape(b, -1).mean(dim=-1)

        code_mse = mean_flat((target_c - code_out) ** 2)
        img_mse = mean_flat((target_x - img_out) ** 2 * (1 - masks))
        loss = code_mse + img_mse if add_mask else code_mse
        return {"loss": loss, "code_mse": code_mse, "img_mse": img_mse,
                "indices": indices, "piece_mask": piece_mask}


def create_diffusion(timestep_respacing: str | None = "",
                     noise_schedule: str = "linear",
                     predict_xstart: bool = True, sigma_small: bool = True,
                     diffusion_steps: int = 1000, *,
                     device: torch.device | str | None = None) -> Diffusion:
    """The reference defaults (diffusion/__init__.py:10-46): linear betas,
    1000 base steps, START_X (``predict_xstart``), FIXED_SMALL
    (``sigma_small``); tables on ``device`` (default: the card)."""
    schedule = make_schedule(timestep_respacing, noise_schedule, diffusion_steps)
    return Diffusion(schedule=schedule, device=device,
                     mean_type="start_x" if predict_xstart else "epsilon",
                     var_type="fixed_small" if sigma_small else "fixed_large")
