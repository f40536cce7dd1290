"""The port's small library modules against the JAX package's, on the CPU.

- ``core/likelihood``: ``normal_kl``, the two log-likelihoods,
  ``vb_terms_bpd``, ``prior_bpd`` and ``calc_bpd_loop`` over a 10-step
  respaced diffusion and a fixed smooth model function written for both
  packages, the JAX loop's noise (its ``jax.random`` keys, split as its
  scan splits them) given to the port: 1e-5 relative, 1e-6 absolute
  (fp32, the same tables and formulas).
- ``core/timestep_sampler``: ``UniformSampler`` and
  ``LossSecondMomentResampler`` weights and histories equal to the JAX
  package's after the same updates (numpy on both sides: exact); the
  draws' importance weights are ``1 / (T p_t)``; the multi-host update
  over a two-rank gather equals one update on the gathered pairs.
- ``utils/profiling``: ``StepTimer``, ``measure`` and ``trace`` on the CPU.
- ``utils/device``: the ``matmul_precision`` table states what the card
  runs at ``default`` (TF32, as ``high``), and ``chip_smoke.py`` phase 16
  names the GEMM kernels at ``default`` too.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.core import likelihood as jax_lik
from jpdvt_mt_ntnu_tpu.core import timestep_sampler as jax_ts
from jpdvt_mt_ntnu_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from jpdvt_mt_ntnu_tpu_torch.core import likelihood, timestep_sampler
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.utils import device as device_utils
from jpdvt_mt_ntnu_tpu_torch.utils import profiling

W = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32) * 0.3


def _jax_model(cond, t, code):
    out = jnp.tanh(code @ W + 0.001 * t[:, None, None].astype(jnp.float32)) * cond
    return None, out


def _torch_model(cond, t, code):
    out = torch.tanh(code @ torch.from_numpy(W) + 0.001 * t[:, None, None].float()) * cond
    return None, out


def _codes(seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (3, 9, 8)).astype(np.float32)


def test_kl_and_log_likelihoods_match_jax():
    """The likelihoods at a decoder's operating point: means near x, scales
    0.08-0.6. Far in a tail, cdf_plus - cdf_min is a difference of two
    saturated tanh values, and one ulp of tanh moves its log by O(1) in
    either package."""
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((4, 9, 8)).astype(np.float32) for _ in range(2))
    x = np.clip(a, -1, 1)
    c = (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    d = rng.uniform(-2.5, -0.5, x.shape).astype(np.float32)
    pairs = [(likelihood.normal_kl(*map(torch.from_numpy, (a, b, c, d))),
              jax_lik.normal_kl(a, b, c, d)),
             (likelihood.continuous_gaussian_log_likelihood(
                 torch.from_numpy(x), means=torch.from_numpy(c), log_scales=torch.from_numpy(d)),
              jax_lik.continuous_gaussian_log_likelihood(x, means=c, log_scales=d)),
             (likelihood.discretized_gaussian_log_likelihood(
                 torch.from_numpy(np.round(x * 127.5) / 127.5), means=torch.from_numpy(c),
                 log_scales=torch.from_numpy(d)),
              jax_lik.discretized_gaussian_log_likelihood(
                  np.round(x * 127.5) / 127.5, means=c, log_scales=d))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_vb_terms_and_prior_bpd_match_jax():
    x0 = _codes()
    cond = np.float32(0.9)
    jdiff, diff = jax_create_diffusion("10"), create_diffusion("10", device="cpu")
    xt = np.random.default_rng(3).standard_normal(x0.shape).astype(np.float32)
    for t in ([0, 0, 0], [4, 9, 1]):
        want = jax_lik.vb_terms_bpd(jdiff, _jax_model, cond, jnp.asarray(x0), jnp.asarray(xt),
                                    jnp.asarray(t))
        got = likelihood.vb_terms_bpd(diff, _torch_model, torch.tensor(cond),
                                      torch.from_numpy(x0), torch.from_numpy(xt), torch.tensor(t))
        for k in ("output", "pred_xstart"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                       atol=1e-6)
    np.testing.assert_allclose(likelihood.prior_bpd(diff, torch.from_numpy(x0)).numpy(),
                               np.asarray(jax_lik.prior_bpd(jdiff, jnp.asarray(x0))),
                               rtol=1e-5, atol=1e-6)


def test_calc_bpd_loop_matches_jax_with_its_noise():
    x0 = _codes(4)
    cond = np.float32(1.1)
    jdiff, diff = jax_create_diffusion("10"), create_diffusion("10", device="cpu")
    key = jax.random.key(7)
    want = jax_lik.calc_bpd_loop(jdiff, _jax_model, cond, jnp.asarray(x0), key)
    noise, k = [], key
    for _ in range(10):  # the scan's key chain: key, sub = split(key) per step
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, x0.shape, jnp.float32)))
    got = likelihood.calc_bpd_loop(diff, _torch_model, torch.tensor(cond),
                                   torch.from_numpy(x0), noise=torch.from_numpy(np.stack(noise)))
    assert got["vb"].shape == (3, 10)
    for name in ("total_bpd", "prior_bpd", "vb", "xstart_mse", "mse"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    drawn = likelihood.calc_bpd_loop(diff, _torch_model, torch.tensor(cond),
                                     torch.from_numpy(x0),
                                     generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn["total_bpd"]).all()


def test_samplers_weights_and_updates_match_jax():
    assert (timestep_sampler.UniformSampler(7).weights() == jax_ts.UniformSampler(7).weights()
            ).all()
    mine = timestep_sampler.LossSecondMomentResampler(6, history_per_term=3)
    theirs = jax_ts.LossSecondMomentResampler(6, history_per_term=3)
    rng = np.random.default_rng(5)
    for step in range(8):
        ts = rng.integers(0, 6, 5)
        losses = rng.random(5) * (1 + ts)
        mine.update_with_losses(ts, losses)
        theirs.update_with_losses(ts, losses)
        np.testing.assert_array_equal(mine.weights(), theirs.weights())
        np.testing.assert_array_equal(mine._history, theirs._history)
    assert mine._warmed_up() and not np.allclose(mine.weights(), mine.weights()[0])


def test_sampler_draws_carry_importance_weights():
    s = timestep_sampler.LossSecondMomentResampler(4, history_per_term=1)
    s.update_with_losses([0, 1, 2, 3], [1.0, 2.0, 3.0, 4.0])
    p = s.weights() / s.weights().sum()
    t, w = s.sample(20000, generator=torch.Generator().manual_seed(0))
    assert t.dtype == torch.int64 and w.dtype == torch.float32 and t.shape == w.shape == (20000,)
    np.testing.assert_allclose(w.numpy(), 1.0 / (4 * p[t.numpy()]), rtol=1e-6)
    freq = np.bincount(t.numpy(), minlength=4) / 20000
    np.testing.assert_allclose(freq, p, atol=0.015)
    t_u, w_u = timestep_sampler.UniformSampler(5).sample(8, torch.Generator().manual_seed(1))
    assert (w_u == 1).all() and ((0 <= t_u) & (t_u < 5)).all()


def test_multihost_update_gathers_every_rank_first():
    class TwoRanks:
        world = 2

        def all_gather(self, obj):
            return [obj, (np.array([3, 3]), np.array([0.5, 0.25]))]

    a = timestep_sampler.LossSecondMomentResampler(4, history_per_term=2)
    b = timestep_sampler.LossSecondMomentResampler(4, history_per_term=2)
    a.update_with_all_losses_multihost(torch.tensor([1, 2]), torch.tensor([1.0, 2.0]), TwoRanks())
    b.update_with_losses([1, 2, 3, 3], [1.0, 2.0, 0.5, 0.25])
    np.testing.assert_array_equal(a._history, b._history)
    c = timestep_sampler.LossSecondMomentResampler(4, history_per_term=2)
    c.update_with_all_losses_multihost([1, 2], [1.0, 2.0])  # one process: its own pairs
    np.testing.assert_array_equal(c._counts, [0, 1, 1, 0])


def test_step_timer_measure_and_trace_on_the_cpu(tmp_path):
    timer = profiling.StepTimer()
    for _ in range(3):
        timer.step(torch.ones(2) * 2)
    assert timer.rate() > 0 and timer._steps == 0  # reset after the read
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x @ x, "n": 3}

    out = profiling.measure(fn, torch.eye(16), iters=4, warmup=2)
    assert len(calls) == 1 + 1 + 4
    assert set(out) == {"compile_s", "steady_s", "per_sec"}
    assert out["steady_s"] > 0 and out["per_sec"] == pytest.approx(1 / out["steady_s"])
    with profiling.trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_matmul_precision_table_states_what_the_card_runs():
    """``default``/``bfloat16`` map to torch's ``medium``, which runs TF32
    GEMMs on the card (no bf16 algorithm for an fp32 product): the table
    says so, and phase 16 names the kernels at ``default`` beside ``high``
    and ``highest``."""
    import chip_smoke

    try:
        assert device_utils.apply_matmul_precision("default") == "medium"
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        device_utils.apply_matmul_precision(None)
    doc = device_utils.apply_matmul_precision.__doc__
    row = next(line for line in doc.splitlines() if "``default``, ``bfloat16``" in line)
    assert "TF32" in row and "bf16" not in row
    assert "H100" in doc and "W)" in doc  # the card and its power limit
    assert chip_smoke.TF32_PRECISIONS == {"high": True, "default": True, "highest": False}
    assert os.path.basename(chip_smoke.__file__) == "chip_smoke.py"
