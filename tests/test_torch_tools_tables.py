"""The port's sampler, masked and probe tables against the JAX package.

The JAX tools draw their scrambles, masks, fills, noise template and the
iterative chain's step noise with ``jax.random`` inside ``main``; torch
cannot replay those. So both sides get the same injected inputs: on the
committed tiny trained model (``tests/fixtures/tiny_jpdvt_48px.npz``: 48 px,
depth 2, hidden 64, 4 heads, fp32), 16 images of the JAX package's
``SyntheticPuzzles(48, seed=123)``, numpy permutations, the JAX solver's
seed-0 noise template and its own step noise (drawn here as its scan draws
it). Each row of the port's tools is held to the JAX package's solver,
jigsaw and assignment functions on those inputs; JAX's attention is its
plain XLA reference. Accuracies must be equal. The CLIs run on the CPU and
write the JAX tools' files.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from jpdvt_mt_ntnu_tpu.data import SyntheticPuzzles as JaxSyntheticPuzzles
from jpdvt_mt_ntnu_tpu.eval.solver import PuzzleSolver as JaxPuzzleSolver
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.ops import assignment as jassign
from jpdvt_mt_ntnu_tpu.ops import jigsaw as jjig
from jpdvt_mt_ntnu_tpu.tools.probe_checkpoint import PROBE_TIMESTEPS as JAX_PROBE_TIMESTEPS
from jpdvt_mt_ntnu_tpu.tools.sampler_table import SWEEP as JAX_SWEEP
from jpdvt_mt_ntnu_tpu.tools.torch_convert import load_npz_params
from jpdvt_mt_ntnu_tpu.utils.pos_embed import grid_code
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.tools import masked_eval_table, probe_checkpoint, sampler_table
from jpdvt_mt_ntnu_tpu_torch.tools.weights import load_artifact
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

FIXTURE = "tests/fixtures/tiny_jpdvt_48px.npz"
TINY = dict(depth=2, hidden_size=64, num_heads=4)
TINY_ARGS = ["device=cpu", "model.image_size=48", "model.depth=2", "model.hidden_size=64",
             "model.num_heads=4", "model.compute_dtype=float32", f"eval.checkpoint={FIXTURE}"]
B = 16


@pytest.fixture(scope="module")
def tiny():
    jmodel, jcfg = jax_create_model("JPDVT", 48, attn_impl="xla", **TINY)
    params = jax.tree.map(jnp.asarray, load_npz_params(FIXTURE))
    model, cfg = create_model("JPDVT", 48, device="cpu", **TINY)
    with pytest.warns(UserWarning, match="step 0"):
        sd, _ = load_artifact(FIXTURE, device="cpu")
    model.load_state_dict(sd, strict=True)
    ds = JaxSyntheticPuzzles(48, n=B, seed=123)
    x = np.stack([ds[i] for i in range(B)])
    rng = np.random.default_rng(0)
    perms = np.stack([rng.permutation(9) for _ in range(B)])
    template = np.asarray(JaxPuzzleSolver(jmodel, jcfg, jax_create_diffusion("10"),
                                          grid_size=3).noise_template)
    return jmodel, jcfg, params, model, cfg, x, perms, template


def jax_step_noise(steps: int, shape, seed: int = 0) -> np.ndarray:
    """The iterative chain's per-step noise of the JAX solver of ``seed``:
    its scan splits ``key(seed + 1)`` once a step and draws from the half."""
    key, out = jax.random.key(seed + 1), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def inject_step_noise(monkeypatch, module, zs: np.ndarray) -> None:
    """Make ``module``'s diffusions run the iterative chain on ``zs``."""
    real = module.create_diffusion

    def make(*args, **kwargs):
        diffusion = real(*args, **kwargs)
        loop = diffusion.p_sample_loop

        def p_sample_loop(model_fn, condition, noise, *, mode="faithful", **kw):
            if mode == "iterative":
                assert len(zs) == diffusion.num_timesteps
                kw["step_noise"] = [torch.from_numpy(z[:noise.shape[0]]) for z in zs]
            return loop(model_fn, condition, noise, mode=mode, **kw)

        diffusion.p_sample_loop = p_sample_loop
        return diffusion

    monkeypatch.setattr(module, "create_diffusion", make)


def jax_accuracies(pred, perms) -> tuple[float, float]:
    eq = np.asarray(pred) == perms
    return float(eq.all(-1).mean()), float(eq.mean())


def test_sampler_rows_match_jax(tiny, monkeypatch):
    jmodel, jcfg, params, model, cfg, x, perms, template = tiny
    assert sampler_table.SWEEP == JAX_SWEEP
    inject_step_noise(monkeypatch, sampler_table, jax_step_noise(250, (B, 9, 8)))
    rows = sampler_table.sampler_rows(model, cfg, x, indices=perms, noise_template=template,
                                      device="cpu", target_s=0.0, min_iters=1)
    assert [r[:3] for r in rows] == [s for s in JAX_SWEEP]
    for (label, mode, respacing, puzzle, patch, tp) in rows:
        js = JaxPuzzleSolver(jmodel, jcfg, jax_create_diffusion(respacing), grid_size=3,
                             mode=mode)
        pred, *_ = js._solve_and_score(params, jnp.asarray(x), jnp.asarray(perms))
        assert (puzzle, patch) == jax_accuracies(pred, perms), label
        assert tp > 0
    assert rows[0][3] >= 0.9  # the fixture solves its puzzles


def test_masked_rows_match_jax(tiny):
    jmodel, jcfg, params, model, cfg, x, perms, template = tiny
    rng = np.random.default_rng(5)
    draws = {}
    for fill in masked_eval_table.FILLS:
        for k in range(3):
            ranks = np.argsort(np.argsort(rng.random((B, 9)), -1), -1)
            draws[fill, k] = {"indices": perms,
                              "piece_mask": (ranks >= k).astype(np.float32),
                              "fill": rng.standard_normal(x.shape).astype(np.float32)}
    solver = PuzzleSolver(model, cfg, create_diffusion("250", device="cpu"), mode="fast",
                          noise_template=template, device="cpu")
    rows = masked_eval_table.masked_rows(solver, x, draws=lambda f, k: draws[f, k])
    js = JaxPuzzleSolver(jmodel, jcfg, jax_create_diffusion("250"), grid_size=3, mode="fast")
    x_scr = jjig.scramble(jnp.asarray(x), jnp.asarray(perms), 3)
    assert [(f, k) for f, k, *_ in rows] == [(f, k) for f in ("noise", "zero")
                                            for k in range(3)]
    for fill, k, puzzle, patch in rows:
        d = draws[fill, k]
        mask_img = jjig.piece_mask_to_image(jnp.asarray(d["piece_mask"]), 3, 16, 3)
        fill_img = jnp.asarray(d["fill"]) if fill == "noise" else jnp.zeros_like(x_scr)
        pred = js.solve(params, x_scr * mask_img + fill_img * (1 - mask_img))
        assert (puzzle, patch) == jax_accuracies(pred, perms), (fill, k)
    unmasked = solver.evaluate(x, perms)
    assert rows[0][2:] == (unmasked.puzzle_accuracy, unmasked.patch_accuracy)
    assert rows[3][2:] == rows[0][2:]  # k = 0 hides nothing, whatever the fill


def test_probe_rows_match_jax(tiny, monkeypatch):
    jmodel, jcfg, params, model, cfg, x, perms, template = tiny
    assert probe_checkpoint.PROBE_TIMESTEPS == JAX_PROBE_TIMESTEPS
    steps = 50
    inject_step_noise(monkeypatch, probe_checkpoint, jax_step_noise(steps, (B, 9, 8)))
    rows = probe_checkpoint.probe_rows(model, cfg, x, steps=str(steps), indices=perms,
                                       noise_template=template, device="cpu")
    x_scr = jjig.scramble(jnp.asarray(x), jnp.asarray(perms), 3)
    canon = jnp.asarray(grid_code(8, 3))
    expected = []
    for t in JAX_PROBE_TIMESTEPS:
        noise = jnp.broadcast_to(jnp.asarray(template), (B, 9, 8))
        _, code = jmodel.apply(params, x_scr, jnp.full((B,), t, jnp.int32), noise)
        pieces = jjig.tokens_to_piece_code(code, 3, 1)
        pred = jassign.greedy_permutation(jassign.manhattan_distances(pieces, canon))
        expected.append((f"t={t}", *jax_accuracies(pred, perms)))
    for mode in probe_checkpoint.MODES:
        js = JaxPuzzleSolver(jmodel, jcfg, jax_create_diffusion(str(steps)), grid_size=3,
                             mode=mode)
        expected.append((f"mode={mode}", *jax_accuracies(js.solve(params, x_scr), perms)))
    assert [(w, float(p), float(q)) for w, p, q in rows] == expected
    assert expected[-3][1] >= 0.9


def read_csv(path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_table_clis_write_the_jax_files(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sampler_table, "BENCH_TARGET_S", 0.01)
    logs = f"eval.logs_dir={tmp_path}"
    assert sampler_table.main(TINY_ARGS + [logs, "eval.limit=8"]) == 0
    rows = read_csv(tmp_path / "sampler_table_grid3.csv")
    assert [r["label"] for r in rows] == [s[0] for s in JAX_SWEEP]
    assert all(r["n"] == "8" and float(r["puzzles_per_s"]) > 0 for r in rows)
    assert (tmp_path / "sampler_table_grid3.md").read_text().startswith(
        "# Sampler trade-off — grid 3x3, 8 unseen images")

    assert masked_eval_table.main(TINY_ARGS + [logs, "eval.limit=8",
                                               "diffusion.sampler_mode=fast"]) == 0
    rows = read_csv(tmp_path / "masked_table_grid3.csv")
    assert [(r["fill"], r["hidden"]) for r in rows] == [
        (f, str(k)) for f in ("noise", "zero") for k in range(3)]
    assert "fast-250" in (tmp_path / "masked_table_grid3.md").read_text()

    assert probe_checkpoint.main(TINY_ARGS + ["eval.batch_size=8",
                                              "diffusion.sampling_steps=10"]) == 0
    out = capsys.readouterr().out
    assert "probe: ema weights, 8 images, grid 3" in out
    assert out.count("noise-code x0-pred") == 7 and out.count("solver mode=") == 3
