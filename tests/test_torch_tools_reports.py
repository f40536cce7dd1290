"""The port's journal reports and image tools against the JAX package's.

``cliff_report`` must give the committed ``cliff.json`` of both grid-20
journals (``logs/waves20_hard_eval``, ``logs/waves20_r4_eval``: the one
``tests/test_cliff_report.py`` pins, 90 in region, 0.30 against 0.0375,
0.9395) and classify every seed-11 draw as the JAX tool does;
``metrics_report`` the JAX tool's report (pandas there, csv and numpy
here) on the committed journals, equal; ``val_panel`` picks the rows
pandas' ``sample`` picks and writes its panel through the port's PNG
writer; ``make_wave_pngdir`` writes the JAX tool's pixels;
``ambiguity_probe``'s per-slot relative MSE is the JAX tool's arithmetic
(``jigsaw`` in JAX) to fp32 rounding, 1e-6 relative.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from jpdvt_mt_ntnu_tpu.data import SyntheticPuzzles as JaxSyntheticPuzzles
from jpdvt_mt_ntnu_tpu.ops import jigsaw as jjig
from jpdvt_mt_ntnu_tpu.tools import metrics_report as jax_metrics
from jpdvt_mt_ntnu_tpu_torch.ops import native
from jpdvt_mt_ntnu_tpu_torch.serve.png import encode_png
from jpdvt_mt_ntnu_tpu_torch.tools import (ambiguity_probe, cliff_report, make_wave_pngdir,
                                           metrics_report, val_panel)
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import cliff_report as jax_cliff  # noqa: E402  (the root tool)

JOURNALS = ["waves20_hard_eval", "waves20_r4_eval"]


@pytest.mark.parametrize("run", JOURNALS)
def test_cliff_report_gives_the_committed_numbers(run, tmp_path, capsys):
    journal = f"logs/{run}/inference_progress.csv"
    out = tmp_path / "cliff.json"
    assert cliff_report.main([journal, "--seed", "11", "--grid", "20",
                              "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    with open(os.path.join(REPO, "logs", run, "cliff.json")) as f:
        assert rep == json.load(f)
    assert json.loads(capsys.readouterr().out) == rep
    if run == "waves20_r4_eval":
        assert (rep["n_in_region"], rep["fail_rate_in"], rep["fail_rate_out"],
                rep["puzzle_acc"]) == (90, 0.3, 0.0375, 0.9395)


def test_cliff_classification_equals_the_jax_tools():
    for i in range(1024):
        assert cliff_report.classify(i, 11, 1.2, 0.85) == jax_cliff.classify(i, 11, 1.2, 0.85)
    ds = JaxSyntheticPuzzles(64, n=16, seed=3, cues="waves", hard_frac=1.0)
    for i in range(16):
        th, f, _, amp = ds._wave_params(i)
        assert cliff_report.classify_params(th, f, amp, 1.2, 0.85)[0]


def test_cliff_report_refuses_rows_of_other_journals(tmp_path):
    journal = tmp_path / "p.csv"
    journal.write_text("filename,puzzle_correct,patch_matches,time_s\nimg_7.png,1,9,0.1\n")
    assert cliff_report.main([str(journal), "--grid", "3"]) == 1


@pytest.mark.parametrize("path", ["logs/waves20_r4_eval/inference_progress.csv",
                                  "logs/waves20_hard_eval", "logs/pngdir_r5_greedy"])
def test_metrics_report_equals_the_jax_tools(path):
    grid = 3 if "pngdir" in path else 20
    assert (metrics_report.report(metrics_report.load_journals(path), grid, 5000)
            == jax_metrics.report(jax_metrics.load_journals(path), grid, 5000))


def test_metrics_report_cli_and_histogram(tmp_path, capsys):
    hist = tmp_path / "hist.png"
    assert metrics_report.main(["logs/waves20_hard_eval", "--grid", "20",
                                "--hist", str(hist)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["images_processed"] == 1024 and rep["histogram"] == str(hist)
    assert rep["histogram_title"].startswith("solve-time distribution (n=1024, mean=")
    img = native.png_pixels(hist.read_bytes())
    assert img.shape == metrics_report.HIST_SIZE + (3,)
    assert (img == metrics_report.HIST_BAR).all(-1).any()


def test_val_panel_picks_as_pandas_samples(tmp_path):
    rows = [{"filename": f"f{i}.png", "puzzle_correct": str(int(i % 3 == 0))}
            for i in range(40)]
    df = pd.DataFrame({"filename": [r["filename"] for r in rows],
                       "puzzle_correct": [int(r["puzzle_correct"]) for r in rows]})
    for seed in (0, 1, 7, 123):
        want = [(label, df[mask].sample(1, random_state=seed)["filename"].iloc[0])
                for label, mask in (("perfect", df["puzzle_correct"] == 1),
                                    ("failed", df["puzzle_correct"] == 0))]
        assert val_panel.pick(rows, seed) == want


def test_val_panel_writes_the_panel_and_prints_the_titles(tmp_path, capsys):
    data = tmp_path / "data" / "sub"
    data.mkdir(parents=True)
    ds = JaxSyntheticPuzzles(48, n=2, seed=5, cues="waves")
    for i in range(2):
        (data / f"w{i}.png").write_bytes(encode_png(make_wave_pngdir.to_uint8(ds[i])))
    journal = tmp_path / "j.csv"
    journal.write_text("filename,puzzle_correct,patch_matches,time_s\n"
                       "w0.png,1,9,0.1\nw1.png,0,3,0.1\n")
    out = tmp_path / "panel.png"
    assert val_panel.main(["--csv", str(journal), "--data-dir", str(tmp_path / "data"),
                           "--image-size", "48", "--mode", "fast", "--steps", "10",
                           "--out", str(out), "--device", "cpu"]) == 0
    titles = json.loads(capsys.readouterr().out.splitlines()[0])
    assert titles["columns"] == ["original", "scrambled", "reconstructed"]
    assert [t.split(" (")[0] for t in titles["rows"]] == ["perfect", "failed"]
    panel = native.png_pixels(out.read_bytes())
    assert panel.shape == (2 * 48 + 8, 3 * 48 + 16, 3)
    original = native.decode_center_crop((data / "w0.png").read_bytes(), 48)
    np.testing.assert_array_equal(panel[:48, :48],
                                  ((original + 1) / 2 * 255).astype(np.uint8))


def test_make_wave_pngdir_writes_the_jax_tools_pixels(tmp_path, capsys):
    assert make_wave_pngdir.main([str(tmp_path), "--n", "3", "--size", "48",
                                  "--seed", "777"]) == 0
    assert "wrote 3 48px wave PNGs" in capsys.readouterr().out
    ds = JaxSyntheticPuzzles(48, n=3, seed=777, cache=False, cues="waves")
    for i in range(3):
        want = np.clip((ds[i] + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)
        got = native.png_pixels((tmp_path / f"wave_{i:05d}.png").read_bytes())
        np.testing.assert_array_equal(got, want)


def test_ambiguity_slot_mse_is_the_jax_tools_arithmetic():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (4, 48, 48, 3)).astype(np.float32)
    indices = np.stack([rng.permutation(9) for _ in range(4)])
    pred = indices.copy()
    pred[1, [0, 1]] = pred[1, [1, 0]]
    pred[3] = rng.permutation(9)
    mine = ambiguity_probe.slot_rel_mse(torch.from_numpy(x), torch.from_numpy(indices),
                                        torch.from_numpy(pred), 3).numpy()
    # The JAX tool's slot_rel_mse (tools/ambiguity_probe.py:86-95).
    xj = jnp.asarray(x)
    recon = jjig.unscramble(jjig.scramble(xj, jnp.asarray(indices), 3), jnp.asarray(pred), 3)
    xp, rp = jjig.to_pieces(xj, 3), jjig.to_pieces(recon, 3)
    ref = np.asarray(jnp.mean((xp - rp) ** 2, axis=(-1, -2, -3))
                     / (jnp.var(xp, axis=(-1, -2, -3)) + 1e-8))
    np.testing.assert_allclose(mine, ref, rtol=1e-6, atol=0)
    assert (mine[0] == 0).all() and (mine[1] > 0).sum() == 2


def test_ambiguity_tally_counts_equivalent_slots():
    tally = ambiguity_probe.Tally(3, [0.01, 1.0])
    indices = np.tile(np.arange(9), (3, 1))
    pred = indices.copy()
    pred[1, [0, 1]] = [1, 0]        # two slots misplaced, rel 0.5 each
    pred[2, [2, 3]] = [3, 2]        # two slots misplaced, rel 0.001 and 2.0
    rel = np.zeros((3, 9))
    rel[1, [0, 1]] = 0.5
    rel[2, [2, 3]] = [0.001, 2.0]
    tally.add(rel, pred, indices)
    rep = tally.report(3)
    assert rep["n"] == 3 and rep["puzzle_acc"] == 1 / 3 and rep["misplaced_slots"] == 4
    assert rep["patch_acc"] == 23 / 27
    assert rep["equiv_frac@0.01"] == 0.25 and rep["equiv_frac@1.0"] == 0.75
    assert rep["puzzle_acc_equiv@0.01"] == 1 / 3 and rep["puzzle_acc_equiv@1.0"] == 2 / 3
    assert rep["patch_acc_equiv@1.0"] == 26 / 27


def test_ambiguity_probe_cli_prints_the_committed_keys(capsys):
    assert ambiguity_probe.main(["--image-size", "48", "--grid", "3", "--n", "4",
                                 "--batch", "2", "--mode", "fast", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.splitlines()[-1])
    with open(os.path.join(REPO, "logs", "waves20_r4_eval", "ambiguity.json")) as f:
        committed = json.load(f)
    assert sorted(rep) == sorted(committed) and rep["n"] == 4
