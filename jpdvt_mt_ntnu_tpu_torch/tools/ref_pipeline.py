"""The reference's metric pipeline, written out independently: the oracle of
the checkpoint rehearsal.

Counterpart of ``jpdvt_mt_ntnu_tpu/tools/ref_pipeline.py`` (numpy and
torch). ``tools/make_dit_goldens.py`` keeps the reference's *model*
semantics; this module keeps the *pipeline* that defines its metric, so
that the whole conversion loop (reference-format ``.pt`` ->
``tools/convert.py`` -> the port's ``run_eval`` faithful solve) can be held
to it image by image without the real ``2850000.pt`` (``tools/parity.py``).

It is written from the reference's formulas, not from the port's
``core/`` modules:

- the linear beta schedule scaled by 1000/T
  (reference image_model/diffusion/gaussian_diffusion.py:108-117);
- the section spacing of the respaced timesteps (diffusion/respace.py:12-62)
  and the respaced betas (respace.py:79-86);
- the faithful ``p_sample_loop`` with its noise-not-img quirk: every
  ``p_sample`` is given the ORIGINAL noise template, never the running
  sample (gaussian_diffusion.py:522), with START_X and the FIXED_SMALL
  posterior (gaussian_diffusion.py:281-288, 388-430);
- the per-piece mean pooling of the codes, Manhattan distances, the greedy
  ``find_permutation`` and its ``argsort`` (inference.py:294-306, 113-125).

The tables are float64 and the model's codes are taken to float64, so the
oracle adds no rounding of its own to the model's.
"""

from __future__ import annotations

import numpy as np


def linear_betas(num_steps: int = 1000) -> np.ndarray:
    """gaussian_diffusion.py:108-117: the linear schedule scaled by 1000/T."""
    scale = 1000.0 / num_steps
    return np.linspace(scale * 1e-4, scale * 2e-2, num_steps, dtype=np.float64)


def space_timesteps_sections(num_timesteps: int, counts: list[int]) -> list[int]:
    """respace.py:12-62, the section counts (no ``ddimN`` branch)."""
    size_per = num_timesteps // len(counts)
    extra = num_timesteps % len(counts)
    out, start = [], 0
    for i, count in enumerate(counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur, taken = 0.0, []
        for _ in range(count):
            taken.append(start + round(cur))
            cur += stride
        out += taken
        start += size
    return sorted(set(out))


class RefSpacedFaithfulSampler:
    """The reference's eval-time sampler, float64 tables."""

    def __init__(self, num_steps: int = 1000, respacing: int = 250):
        alphas_cumprod = np.cumprod(1.0 - linear_betas(num_steps))
        self.timestep_map = space_timesteps_sections(num_steps, [respacing])
        # The respaced betas (respace.py:79-86): 1 - acp[t] / acp[last kept].
        last, new_betas = 1.0, []
        for t in self.timestep_map:
            new_betas.append(1.0 - alphas_cumprod[t] / last)
            last = alphas_cumprod[t]
        nb = np.asarray(new_betas, dtype=np.float64)
        acp = np.cumprod(1.0 - nb)
        acp_prev = np.append(1.0, acp[:-1])
        # The posterior mean's coefficients (gaussian_diffusion.py:197-203).
        self.c1 = nb * np.sqrt(acp_prev) / (1.0 - acp)
        self.c2 = (1.0 - acp_prev) * np.sqrt(1.0 - nb) / (1.0 - acp)
        self.posterior_variance = nb * (1.0 - acp_prev) / (1.0 - acp)

    def p_sample_loop_faithful(self, model_fn, condition, noise, rng: np.random.Generator):
        """inference.py:281-290 through p_sample_loop_progressive
        (gaussian_diffusion.py:480-529), with the quirk: the model and the
        posterior always see the ORIGINAL ``noise``; the running sample is
        drawn (and discarded) at every step; the t = 0 output (z = 0,
        gaussian_diffusion.py:424-430) is returned."""
        final = None
        for i in reversed(range(len(self.timestep_map))):
            # _WrappedModel (respace.py:124-129) maps the spaced t to the original.
            x_start = model_fn(condition, self.timestep_map[i], noise)  # START_X: 2nd head
            mean = self.c1[i] * x_start + self.c2[i] * noise
            if i == 0:
                final = mean
            else:
                _ = mean + np.sqrt(self.posterior_variance[i]) * rng.standard_normal(noise.shape)
        return final


def find_permutation_greedy(dist: np.ndarray) -> list[int]:
    """inference.py:113-125: per column the argmin row, knocked out by 1e9."""
    d = dist.copy()
    order = []
    for col in range(d.shape[1]):
        row = int(np.argmin(d[:, col]))
        order.append(row)
        d[row, :] = 1e9
    return order


def recover_permutation(final_codes: np.ndarray, canon: np.ndarray, grid: int,
                        sub: int) -> np.ndarray:
    """inference.py:294-306: the tokens grouped '(p1 h1 p2 w1) d -> (p1 p2)
    (h1 w1) d', mean-pooled, Manhattan distances, greedy, argsort."""
    n_tokens, d = final_codes.shape
    if n_tokens != (grid * sub) ** 2:
        raise ValueError(f"{n_tokens} tokens for grid {grid} x {sub} tokens a piece side")
    g = final_codes.reshape(grid, sub, grid, sub, d)
    pooled = g.transpose(0, 2, 1, 3, 4).reshape(grid * grid, sub * sub, d).mean(1)
    dist = np.abs(pooled[:, None, :] - canon[None, :, :]).sum(-1)
    return np.argsort(np.asarray(find_permutation_greedy(dist)))


def reference_solve(model, x_scrambled_nchw: np.ndarray, noise: np.ndarray,
                    canon: np.ndarray, grid: int, sub: int, respacing: int = 250,
                    seed: int = 0) -> np.ndarray:
    """The whole metric pipeline for a batch of scrambled NCHW images on the
    CPU, ``model(x, t, code) -> (image, code)`` the reference's: (B, G*G)
    predicted slots."""
    import torch

    sampler = RefSpacedFaithfulSampler(respacing=respacing)

    def model_fn(cond, t_orig, x):
        with torch.no_grad():
            t = torch.full((cond.shape[0],), t_orig, dtype=torch.long)
            _, code = model(torch.from_numpy(cond).float(), t,
                            torch.from_numpy(x.astype(np.float32)))
        return code.numpy().astype(np.float64)

    final = sampler.p_sample_loop_faithful(model_fn, x_scrambled_nchw,
                                           noise.astype(np.float64),
                                           np.random.default_rng(seed))
    return np.stack([recover_permutation(final[b], canon, grid, sub)
                     for b in range(final.shape[0])])
