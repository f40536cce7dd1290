"""The port's ``tools/make_goldens`` against the JAX package's, on the CPU.

Both tools import the reference's ``diffusion`` package from
``<reference>/image_model``; the reference checkout is not here, so the
test writes a stand-in package with the calls the tools make, at the
reference's signatures (``create_diffusion``,
``gaussian_diffusion.get_named_beta_schedule``, ``q_sample``,
``q_posterior_mean_variance``, ``p_sample_loop``, ``training_losses``),
whose ``training_losses`` draws through every function the tools replace
(``np.random.permutation`` and ``randint``, ``random.sample``,
``torch.randn_like``) and whose ``p_sample_loop`` draws through
``torch.randn_like`` too. Each tool runs in its own process on it; the two
``reference_goldens.npz`` hold the same keys and bit-equal arrays (the
files' bytes differ only in the zip entries' timestamps).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GAUSSIAN_DIFFUSION = '''
    import math
    import random

    import numpy as np
    import torch


    def get_named_beta_schedule(name, n):
        if name == "linear":
            scale = 1000 / n
            return np.linspace(scale * 0.0001, scale * 0.02, n, dtype=np.float64)
        if name == "squaredcos_cap_v2":
            f = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
            return np.array([min(1 - f((i + 1) / n) / f(i / n), 0.999) for i in range(n)])
        raise NotImplementedError(name)


    class GaussianDiffusion:
        def __init__(self, betas, timestep_map):
            self.betas = np.asarray(betas, np.float64)
            self.num_timesteps = len(betas)
            self.timestep_map = timestep_map
            alphas = 1.0 - self.betas
            self.alphas_cumprod = np.cumprod(alphas)
            self.alphas_cumprod_prev = np.append(1.0, self.alphas_cumprod[:-1])
            self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
            self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)
            self.posterior_variance = (self.betas * (1.0 - self.alphas_cumprod_prev)
                                       / (1.0 - self.alphas_cumprod))
            self.posterior_log_variance_clipped = np.log(
                np.append(self.posterior_variance[1], self.posterior_variance[1:]))
            self.posterior_mean_coef1 = (self.betas * np.sqrt(self.alphas_cumprod_prev)
                                         / (1.0 - self.alphas_cumprod))
            self.posterior_mean_coef2 = ((1.0 - self.alphas_cumprod_prev) * np.sqrt(alphas)
                                         / (1.0 - self.alphas_cumprod))

        def _at(self, table, t, x):
            return torch.from_numpy(table)[t].float().view(-1, *[1] * (x.dim() - 1))

        def q_sample(self, x_start, t, noise=None):
            if noise is None:
                noise = torch.randn_like(x_start)
            return (self._at(self.sqrt_alphas_cumprod, t, x_start) * x_start
                    + self._at(self.sqrt_one_minus_alphas_cumprod, t, x_start) * noise)

        def q_posterior_mean_variance(self, x_start, x_t, t):
            mean = (self._at(self.posterior_mean_coef1, t, x_t) * x_start
                    + self._at(self.posterior_mean_coef2, t, x_t) * x_t)
            return (mean, self._at(self.posterior_variance, t, x_t).expand_as(x_t),
                    self._at(self.posterior_log_variance_clipped, t, x_t).expand_as(x_t))

        def p_sample_loop(self, model, cond, shape, noise=None, clip_denoised=True,
                          device=None):
            x = noise
            for i in reversed(range(self.num_timesteps)):
                t = torch.full((shape[0],), i, dtype=torch.long)
                _, out = model(cond, torch.as_tensor(self.timestep_map)[t], noise)
                if clip_denoised:
                    out = out.clamp(-1, 1)
                mean, _, log_var = self.q_posterior_mean_variance(out, noise, t)
                x = mean + float(i > 0) * torch.exp(0.5 * log_var) * torch.randn_like(noise)
            return x

        def training_losses(self, model, x_start, t, code, block_size=16, patch_size=8,
                            add_mask=False, grid_size=3):
            n, b = grid_size ** 2, x_start.shape[0]
            per_piece = (block_size // patch_size) ** 2
            perm = torch.as_tensor(np.random.permutation(n))
            masks = [random.sample(range(n), np.random.randint(1, 3)) for _ in range(b)]
            noise_x = torch.randn_like(x_start)
            tokens = torch.repeat_interleave(code[0][perm], per_piece, dim=0)
            tokens = tokens.unsqueeze(0).repeat(b, 1, 1)
            if add_mask:
                for i, m in enumerate(masks):
                    for p in m:
                        tokens[i, p * per_piece:(p + 1) * per_piece] = 0
            noise_c = torch.randn_like(tokens)
            img, pred = model(self.q_sample(x_start, t, noise_x), t,
                              self.q_sample(tokens, t, noise_c))
            loss = ((pred - tokens) ** 2).mean(dim=(1, 2)) + ((img - x_start) ** 2).mean(
                dim=(1, 2, 3))
            return {"loss": loss}
'''

INIT = '''
    import numpy as np

    from . import gaussian_diffusion


    def create_diffusion(timestep_respacing, noise_schedule="linear"):
        betas = gaussian_diffusion.get_named_beta_schedule(noise_schedule, 1000)
        if not timestep_respacing:
            use = list(range(1000))
        elif timestep_respacing.startswith("ddim"):
            use = list(range(0, 1000, 1000 // int(timestep_respacing[4:])))
        else:
            k = int(timestep_respacing)
            use = sorted({round(i * 999 / (k - 1)) for i in range(k)})
        cumprod, last, new = np.cumprod(1.0 - betas), 1.0, []
        for i in use:
            new.append(1.0 - cumprod[i] / last)
            last = cumprod[i]
        return gaussian_diffusion.GaussianDiffusion(np.array(new), use)
'''


def _stand_in(root) -> str:
    pkg = root / "reference" / "image_model" / "diffusion"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text(textwrap.dedent(INIT))
    (pkg / "gaussian_diffusion.py").write_text(textwrap.dedent(GAUSSIAN_DIFFUSION))
    return str(root / "reference")


def test_make_goldens_writes_the_jax_tools_arrays(tmp_path):
    reference = _stand_in(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    outs = {}
    for name, module in (("jax", "jpdvt_mt_ntnu_tpu.tools.make_goldens"),
                         ("port", "jpdvt_mt_ntnu_tpu_torch.tools.make_goldens")):
        out = tmp_path / name
        subprocess.run([sys.executable, "-m", module, "--reference", reference,
                        "--out", str(out)], check=True, env=env, cwd=str(tmp_path),
                       timeout=300, stdout=subprocess.DEVNULL)
        with np.load(out / "reference_goldens.npz") as z:
            outs[name] = dict(z)
    jax_rec, port_rec = outs["jax"], outs["port"]
    assert sorted(port_rec) == sorted(jax_rec)
    with np.load(os.path.join(REPO, "tests", "golden", "reference_goldens.npz")) as z:
        assert sorted(port_rec) == sorted(z.files)  # the keys of the committed goldens
    for k, want in jax_rec.items():
        got = port_rec[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k
    # The stand-in's draws reached the outputs: the two toy solves and the
    # losses are not trivial.
    assert not np.array_equal(port_rec["toy_solve"], port_rec["toy_solve_clip"])
    assert np.isfinite(port_rec["tl_loss"]).all() and port_rec["tl_loss"].shape == (2,)
