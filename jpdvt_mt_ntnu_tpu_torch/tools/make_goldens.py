"""Record golden tensors from the REFERENCE implementation for parity tests.

Counterpart of ``jpdvt_mt_ntnu_tpu/tools/make_goldens.py``, with the same
command line and the same arrays under the same keys. Run offline (needs
the reference checkout and torch):

    python -m jpdvt_mt_ntnu_tpu_torch.tools.make_goldens \\
        --reference /path/to/reference --out tests/golden

It imports the reference's ``diffusion`` package from
``<reference>/image_model`` (numpy and torch math; the model zoo is not
imported) and writes ``reference_goldens.npz`` with:

- the schedule tables of the full 1000-step linear chain, the "250"
  respacing and "ddim25", their timestep maps, and the squaredcos_cap_v2
  betas;
- ``q_sample`` and ``q_posterior_mean_variance`` on fixed inputs with
  injected noise;
- a whole deterministic ``p_sample_loop`` solve with a linear toy model,
  with and without ``clip_denoised`` (the reference's loop never feeds its
  samples back, so its randomness never reaches the output);
- a deterministic DDIM (eta = 0) chain over the reference's "ddim25"
  tables, by Song et al. eq. 12 in numpy (the reference's own DDIM path is
  dead code);
- ``training_losses`` on fixed inputs, with every draw it makes
  (``np.random.permutation`` and ``randint``, ``random.sample``,
  ``torch.randn_like``) replaced by a recorded value.

The npz is small and committed, so that no test needs the reference.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import tempfile

import numpy as np
import torch

SCHEDULE_KEYS = ("betas", "alphas_cumprod", "posterior_variance",
                 "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod")


def schedule_tables(create_diffusion, gd) -> dict:
    rec = {}
    for tag, respacing in (("full", ""), ("s250", "250"), ("ddim25", "ddim25")):
        d = create_diffusion(respacing)
        for key in SCHEDULE_KEYS:
            rec[f"{tag}_{key}"] = getattr(d, key)
        rec[f"{tag}_timestep_map"] = np.asarray(d.timestep_map, dtype=np.int64)
    rec["cosine_betas"] = gd.get_named_beta_schedule("squaredcos_cap_v2", 100)
    return rec


def toy_model_fn(a: np.ndarray, b: np.ndarray):
    """model(condition, t, x) -> (condition, x A (1 + t / 1000) + b), linear in x."""
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def model(condition, ts, x):
        f = 1.0 + ts.float().view(-1, 1, 1) / 1000.0
        return condition, torch.einsum("bnd,de->bne", x, ta) * f + tb

    return model


def sampling_tables(create_diffusion, rng: np.random.RandomState) -> dict:
    """q_sample, the posterior, the toy solves and the DDIM chain, drawing
    their inputs from ``rng`` in the JAX tool's order."""
    x0 = rng.randn(4, 9, 8).astype(np.float32)
    noise = rng.randn(4, 9, 8).astype(np.float32)
    xt = rng.randn(4, 9, 8).astype(np.float32)
    t = np.array([0, 1, 100, 249], dtype=np.int64)
    d250 = create_diffusion("250")
    rec = {"io_x0": x0, "io_noise": noise, "io_xt": xt, "io_t": t}
    rec["io_q_sample"] = d250.q_sample(torch.from_numpy(x0), torch.from_numpy(t),
                                       noise=torch.from_numpy(noise)).numpy()
    pm, pv, plv = d250.q_posterior_mean_variance(torch.from_numpy(x0), torch.from_numpy(xt),
                                                 torch.from_numpy(t))
    rec["io_post_mean"], rec["io_post_var"], rec["io_post_logvar"] = (
        pm.numpy(), pv.numpy(), plv.numpy())

    dim, ntok = 8, 16
    a = rng.randn(dim, dim).astype(np.float32) * 0.3
    bvec = rng.randn(dim).astype(np.float32) * 0.1
    cond = rng.randn(1, 3, 48, 48).astype(np.float32)
    template = rng.randn(1, ntok, dim).astype(np.float32)
    model = toy_model_fn(a, bvec)
    rec["toy_A"], rec["toy_b"], rec["toy_cond"], rec["toy_noise"] = a, bvec, cond, template
    for key, clip in (("toy_solve", False), ("toy_solve_clip", True)):
        rec[key] = d250.p_sample_loop(model, torch.from_numpy(cond), template.shape,
                                      torch.from_numpy(template), clip_denoised=clip,
                                      device=torch.device("cpu")).numpy()

    dd = create_diffusion("ddim25")
    x = template.copy()
    tmap = np.asarray(dd.timestep_map)
    for i in range(dd.num_timesteps - 1, -1, -1):
        ts = torch.full((1,), int(tmap[i]), dtype=torch.float32)
        pred = model(None, ts, torch.from_numpy(x))[1].numpy()
        a_bar, a_prev = dd.alphas_cumprod[i], dd.alphas_cumprod_prev[i]
        eps = (np.sqrt(1.0 / a_bar) * x - pred) / np.sqrt(1.0 / a_bar - 1.0)
        x = (pred * np.sqrt(a_prev) + np.sqrt(1 - a_prev) * eps).astype(np.float32)
    rec["toy_ddim25"] = x
    return rec


def sincos_code() -> np.ndarray:
    """The canonical 3 x 3 position code of 8 dims, the model side's table."""
    coords = np.arange(3, dtype=np.float64)

    def one(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], 1)

    return np.concatenate([one(4, np.tile(coords, 3)), one(4, np.repeat(coords, 3))], axis=1)


def training_loss_tables(create_diffusion) -> dict:
    """``training_losses`` of the full chain with every internal draw
    replaced by a recorded one, so that the jigsaw shuffle, the masks, the
    q-sampling and the loss replay bit for bit."""
    d_full = create_diffusion("")
    rng = np.random.RandomState(7)
    x_start = rng.randn(2, 3, 48, 48).astype(np.float32)
    code = sincos_code().astype(np.float32)  # (9, 8)
    t = np.array([7, 500], dtype=np.int64)
    perm = np.array([4, 2, 8, 0, 6, 1, 7, 3, 5])
    r_values = [1, 2]
    mask_lists = [[3], [0, 7]]
    noise_x = rng.randn(2, 3, 48, 48).astype(np.float32)
    noise_c = rng.randn(2, 36, 8).astype(np.float32)  # 9 pieces x 4 tokens

    saved = (np.random.permutation, np.random.randint, random.sample, torch.randn_like)
    randn = [torch.from_numpy(noise_x), torch.from_numpy(noise_c)]
    rs, masks = list(r_values), list(mask_lists)
    np.random.permutation = lambda n: perm.copy()
    np.random.randint = lambda lo, hi=None: rs.pop(0)
    random.sample = lambda population, k: masks.pop(0)
    torch.randn_like = lambda x: randn.pop(0)
    cwd = os.getcwd()
    try:
        os.chdir(tempfile.mkdtemp())  # training_losses saves a figure where it runs
        terms = d_full.training_losses(
            lambda x, ts, te: (0.5 * x, 0.25 * te), torch.from_numpy(x_start),
            torch.from_numpy(t), torch.from_numpy(code).unsqueeze(0), block_size=16,
            patch_size=8, add_mask=True, grid_size=3)
    finally:
        os.chdir(cwd)
        np.random.permutation, np.random.randint, random.sample, torch.randn_like = saved
    return {"tl_x_start": x_start, "tl_code": code, "tl_t": t, "tl_perm": perm,
            "tl_r": np.array(r_values),
            "tl_mask_lists": np.array([m + [-1] * (9 - len(m)) for m in mask_lists]),
            "tl_noise_x": noise_x, "tl_noise_c": noise_c, "tl_loss": terms["loss"].numpy()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", default="/root/reference",
                    help="the reference checkout (its image_model/diffusion package)")
    ap.add_argument("--out", default="tests/golden")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(args.reference, "image_model"))
    from diffusion import create_diffusion  # the reference's package
    from diffusion import gaussian_diffusion as gd

    os.makedirs(args.out, exist_ok=True)
    torch.manual_seed(0)
    rec = schedule_tables(create_diffusion, gd)
    rec.update(sampling_tables(create_diffusion, np.random.RandomState(42)))
    rec.update(training_loss_tables(create_diffusion))
    path = os.path.join(args.out, "reference_goldens.npz")
    np.savez_compressed(path, **rec)
    print(f"wrote {path} ({os.path.getsize(path)} bytes, {len(rec)} arrays)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
