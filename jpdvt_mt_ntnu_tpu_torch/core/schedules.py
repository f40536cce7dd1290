"""Noise schedules and timestep respacing for the DDPM chain.

Counterpart of ``jpdvt_mt_ntnu_tpu/core/schedules.py`` (the port's own copy,
numpy only). Tables are computed in float64 and stored as float32 numpy
arrays, rounded exactly as the JAX package rounds them; ``Diffusion`` moves
them to its device once. Respacing follows the reference's
``respace.py:12-87``: the kept steps get recomputed betas, and
``timestep_map`` sends a spaced index back to the original 0..999 index
that the model's timestep embedding sees.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


def betas_for_alpha_bar(num_steps: int, alpha_bar,
                        max_beta: float = 0.999) -> np.ndarray:
    betas = []
    for i in range(num_steps):
        t1 = i / num_steps
        t2 = (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def get_named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    """Named beta schedules (reference gaussian_diffusion.py:100-124)."""
    if name == "linear":
        scale = 1000.0 / num_steps
        return np.linspace(scale * 1e-4, scale * 0.02, num_steps,
                           dtype=np.float64)
    if name == "squaredcos_cap_v2":
        return betas_for_alpha_bar(
            num_steps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    raise NotImplementedError(f"unknown beta schedule: {name}")


def space_timesteps(num_timesteps: int, section_counts) -> set[int]:
    """Steps of the original chain to keep: per-section counts, a
    comma-separated string, or ``"ddimN"`` for a fixed stride."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(
                f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: list[int] = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """DDPM tables of a (possibly respaced) chain, indexed by spaced step."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    alphas_cumprod_next: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    large_variance: np.ndarray
    large_log_variance: np.ndarray
    timestep_map: np.ndarray  # int64, spaced index -> original index
    num_timesteps: int
    original_num_steps: int

    @property
    def T(self) -> int:  # noqa: N802
        return self.num_timesteps


def _tables_from_betas(betas: np.ndarray, timestep_map: np.ndarray,
                       original_num_steps: int) -> DiffusionSchedule:
    betas = np.asarray(betas, dtype=np.float64)
    if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be a 1-D array in (0, 1]")
    T = len(betas)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    acp_next = np.append(acp[1:], 0.0)
    posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
    posterior_log_variance_clipped = (
        np.log(np.append(posterior_variance[1], posterior_variance[1:]))
        if T > 1 else np.log(np.maximum(posterior_variance, 1e-20)))
    large_variance = (np.append(posterior_variance[1], betas[1:])
                      if T > 1 else betas.copy())

    def a(x):
        return np.asarray(x, dtype=np.float32)

    return DiffusionSchedule(
        betas=a(betas),
        alphas_cumprod=a(acp),
        alphas_cumprod_prev=a(acp_prev),
        alphas_cumprod_next=a(acp_next),
        sqrt_alphas_cumprod=a(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=a(np.sqrt(1.0 - acp)),
        log_one_minus_alphas_cumprod=a(np.log(1.0 - acp)),
        sqrt_recip_alphas_cumprod=a(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=a(np.sqrt(1.0 / acp - 1.0)),
        posterior_variance=a(posterior_variance),
        posterior_log_variance_clipped=a(posterior_log_variance_clipped),
        posterior_mean_coef1=a(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=a((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        large_variance=a(large_variance),
        large_log_variance=a(np.log(large_variance)),
        timestep_map=np.asarray(timestep_map, dtype=np.int64),
        num_timesteps=T,
        original_num_steps=original_num_steps,
    )


def make_schedule(timestep_respacing: str | Sequence[int] | None = None,
                  noise_schedule: str = "linear",
                  diffusion_steps: int = 1000) -> DiffusionSchedule:
    """A (respaced) schedule; ``""`` or None keeps the full chain. The
    spaced chain's betas come from the kept alphas_cumprod, so the
    marginals are preserved (reference respace.py:73-87)."""
    base_betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    use_timesteps = space_timesteps(diffusion_steps, timestep_respacing)
    base_acp = np.cumprod(1.0 - base_betas)
    last = 1.0
    new_betas, timestep_map = [], []
    for i, acp in enumerate(base_acp):
        if i in use_timesteps:
            new_betas.append(1 - acp / last)
            last = acp
            timestep_map.append(i)
    return _tables_from_betas(np.array(new_betas), np.array(timestep_map),
                              diffusion_steps)
