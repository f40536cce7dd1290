"""Likelihood utilities and the variational bound over the code stream.

Counterpart of ``jpdvt_mt_ntnu_tpu/core/likelihood.py`` (the reference's
``diffusion_utils.py``: ``normal_kl`` :10, the approximate CDF :39, the
continuous and discretized log-likelihoods :47, :62), over the port's
``core/diffusion``. The reference's own bound is dead code (its
``_vb_terms_bpd`` reads keys ``p_mean_variance`` never returns); this is
the JAX package's corrected one: :func:`vb_terms_bpd`, :func:`prior_bpd`
and :func:`calc_bpd_loop`, for diagnostics and model comparison. No entry
point calls them.
"""

from __future__ import annotations

import math

import torch

from .diffusion import Diffusion, ModelFn


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, e^logvar1) || N(mean2, e^logvar2)), elementwise in nats."""
    mean1, logvar1, mean2, logvar2 = (torch.as_tensor(v) for v in (mean1, logvar1, mean2,
                                                                  logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def continuous_gaussian_log_likelihood(x, *, means, log_scales):
    normalized = (x - means) * torch.exp(-log_scales)
    return -0.5 * normalized ** 2 - 0.5 * math.log(2 * math.pi) - log_scales


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a Gaussian discretized to 256 uint8 bins, x in
    [-1, 1] (diffusion_utils.py:62-88)."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp_min(1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp_min(1e-12))
    log_delta = torch.log((cdf_plus - cdf_min).clamp_min(1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_delta))


def vb_terms_bpd(diffusion: Diffusion, model_fn: ModelFn, condition, x_start, x_t, t,
                 clip_denoised: bool = False) -> dict:
    """KL(q(x_{t-1} | x_t, x_0) || p(x_{t-1} | x_t)) in bits over the code
    stream, and at t = 0 the decoder's NLL (continuous Gaussian)."""
    true_mean, _, true_logvar = diffusion.q_posterior_mean_variance(x_start, x_t, t)
    mean, _, logvar, pred_xstart = diffusion.p_mean_variance(
        model_fn, condition, x_t, t, clip_denoised)
    kl = mean_flat(normal_kl(true_mean, true_logvar, mean, logvar)) / math.log(2.0)
    decoder_nll = mean_flat(-continuous_gaussian_log_likelihood(
        x_start, means=mean, log_scales=0.5 * logvar)) / math.log(2.0)
    return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": pred_xstart}


def prior_bpd(diffusion: Diffusion, x_start: torch.Tensor) -> torch.Tensor:
    """KL(q(x_T | x_0) || N(0, I)) in bits per dim (gaussian_diffusion.py:845-859)."""
    t = torch.full((x_start.shape[0],), diffusion.schedule.T - 1, dtype=torch.long,
                   device=x_start.device)
    mean, _, logvar = diffusion.q_mean_variance(x_start, t)
    return mean_flat(normal_kl(mean, logvar, torch.zeros_like(mean),
                               torch.zeros_like(logvar))) / math.log(2.0)


@torch.no_grad()
def calc_bpd_loop(diffusion: Diffusion, model_fn: ModelFn, condition, x_start,
                  generator: torch.Generator | None = None, clip_denoised: bool = False,
                  noise: torch.Tensor | None = None) -> dict:
    """The whole variational bound over every timestep, T - 1 down to 0
    (the corrected ``calc_bpd_loop``, gaussian_diffusion.py:861-914).
    ``noise`` (T, *x_start.shape), row k for the k-th step taken, replaces
    the draws from ``generator``: the JAX package's ``jax.random`` stream
    cannot be replayed by torch."""
    b, T = x_start.shape[0], diffusion.schedule.T
    vb, xstart_mse, mse = [], [], []
    for k, t_scalar in enumerate(range(T - 1, -1, -1)):
        t = torch.full((b,), t_scalar, dtype=torch.long, device=x_start.device)
        eps = (noise[k] if noise is not None else
               torch.randn(x_start.shape, generator=generator, dtype=x_start.dtype,
                           device=x_start.device))
        x_t = diffusion.q_sample(x_start, t, eps)
        out = vb_terms_bpd(diffusion, model_fn, condition, x_start, x_t, t, clip_denoised)
        vb.append(out["output"])
        xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
        pred_eps = diffusion._predict_eps_from_xstart(x_t, t, out["pred_xstart"])
        mse.append(mean_flat((pred_eps - eps) ** 2))
    vb, xstart_mse, mse = (torch.stack(a, dim=1) for a in (vb, xstart_mse, mse))
    prior = prior_bpd(diffusion, x_start)
    return {"total_bpd": vb.sum(dim=1) + prior, "prior_bpd": prior, "vb": vb,
            "xstart_mse": xstart_mse, "mse": mse}
