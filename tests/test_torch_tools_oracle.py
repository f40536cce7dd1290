"""The port's reference-oracle tools against the JAX package's, and the parity rehearsal.

- ``tools.make_dit_goldens``: the golden of the port's copy equals the JAX
  tool's on the same seed bit for bit (weights, inputs and outputs), and
  the committed ``tests/golden/torch_dit_goldens.npz``: its weights and
  inputs bit for bit, its outputs within 2e-5 (absolute and relative, as
  ``tests/test_torch_parity.py`` holds the JAX forward to it: the file was
  written by another torch build).
- ``tools.ref_pipeline``: the sampler's float64 tables, the pooling and
  the greedy recovery, and ``reference_solve`` on a random reference DiT,
  equal to the JAX tool's bit for bit on the same inputs.
- ``tools.activation_compare``: a random reference ``.pt`` (depth 2)
  converted by ``tools.convert`` reports OK within 2e-4 (measured ~1e-6);
  the same ``.pt`` with block 0's qkv heads permuted (a conversion that
  reorders timm's heads) exits 1.
- ``tools.parity``: convert -> compare -> ``run_eval`` faithful-10 on a
  folder of 8 PNGs at the rehearsal's geometry (96 px, depth 2): the
  solver's permutations equal ``ref_pipeline``'s image by image, on the
  solver's own scrambles and noise template.
"""

import argparse
import os
import sys

import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.tools import make_dit_goldens as jax_goldens
from jpdvt_mt_ntnu_tpu.tools import ref_pipeline as jax_ref
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.serve.png import encode_png
from jpdvt_mt_ntnu_tpu_torch.tools import activation_compare, make_dit_goldens, parity
from jpdvt_mt_ntnu_tpu_torch.tools import ref_pipeline
from jpdvt_mt_ntnu_tpu_torch.utils.pos_embed import grid_code
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch_dit_goldens.npz")
# The rehearsal's geometry (tests/test_torch_tools_convert.py): 96 px, 6 x 6 tokens.
CFG = dict(input_size=96, patch_size=16, in_channels=3, hidden_size=64, depth=2,
           num_heads=4, mlp_ratio=4.0, code_dim=8, code_head_hidden=64)
ARCH = ["model.image_size=96", "model.depth=2", "model.hidden_size=64", "model.num_heads=4"]


def test_dit_golden_equals_the_jax_tools_and_the_committed_file(tmp_path, monkeypatch):
    mine = make_dit_goldens.golden()
    monkeypatch.setattr(sys, "argv", ["make_dit_goldens", "--out", str(tmp_path)])
    jax_goldens.main()
    with np.load(tmp_path / "torch_dit_goldens.npz") as z:
        theirs = dict(z)
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    with np.load(GOLDEN) as z:
        committed = dict(z)
    assert sorted(mine) == sorted(committed)
    for k, v in committed.items():
        if k.startswith("out_"):
            np.testing.assert_allclose(mine[k], v, atol=2e-5, rtol=2e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(mine[k], v, err_msg=k)
    assert make_dit_goldens.main(["--out", str(tmp_path / "port")]) == 0
    with np.load(tmp_path / "port" / "torch_dit_goldens.npz") as z:
        assert sorted(z.files) == sorted(mine)


def test_ref_pipeline_equals_the_jax_tools_bit_for_bit():
    for steps, respacing in ((1000, 250), (1000, 10), (100, 7)):
        a = ref_pipeline.RefSpacedFaithfulSampler(steps, respacing)
        b = jax_ref.RefSpacedFaithfulSampler(steps, respacing)
        assert a.timestep_map == b.timestep_map
        for k in ("c1", "c2", "posterior_variance"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    rng = np.random.default_rng(1)
    codes = rng.standard_normal((36, 8))
    canon = grid_code(8, 3)
    np.testing.assert_array_equal(ref_pipeline.recover_permutation(codes, canon, 3, 2),
                                  jax_ref.recover_permutation(codes, canon, 3, 2))
    dist = rng.random((9, 9))
    dist[2, 5] = dist[4, 5] = -1.0  # a tie: the first row wins in both
    assert ref_pipeline.find_permutation_greedy(dist) == jax_ref.find_permutation_greedy(dist)

    model = make_dit_goldens.build_torch_dit(CFG, seed=3)
    x = rng.standard_normal((3, 3, 96, 96)).astype(np.float32)
    noise = np.broadcast_to(rng.standard_normal((1, 36, 8)).astype(np.float32), (3, 36, 8))
    mine = ref_pipeline.reference_solve(model, x, noise, canon, 3, 2, respacing=10, seed=4)
    theirs = jax_ref.reference_solve(model, x, noise, canon, 3, 2, respacing=10, seed=4)
    np.testing.assert_array_equal(mine, theirs)
    assert mine.shape == (3, 9)


def _reference_pt(path, sd) -> None:
    """A reference training checkpoint of ``sd`` (numpy) as its ``ema``."""
    torch.save({"model": {k: torch.from_numpy(v + 0.01) for k, v in sd.items()},
                "ema": {k: torch.from_numpy(v) for k, v in sd.items()},
                "args": argparse.Namespace(model="JPDVT", image_size=96),
                "train_steps": 2850000}, path)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(oracle model, its reference-format .pt, the .pt converted to npz)."""
    from jpdvt_mt_ntnu_tpu_torch.tools import convert

    tmp = tmp_path_factory.mktemp("oracle")
    model = make_dit_goldens.build_torch_dit(CFG, seed=3)
    sd = make_dit_goldens.torch_state_dict_for_convert(model)
    pt, npz = str(tmp / "2850000.pt"), str(tmp / "converted.npz")
    _reference_pt(pt, sd)
    assert convert.main([pt, npz, "--depth", "2"]) == 0
    return model, sd, pt, npz, tmp


def test_activation_compare_passes_a_conversion_and_fails_permuted_heads(reference, capsys):
    _, sd, pt, npz, tmp = reference
    args = ["--model", "JPDVT", "--image-size", "96", "--depth", "2", "--hidden-size", "64",
            "--num-heads", "4", "--device", "cpu"]
    assert activation_compare.main([pt, npz, *args]) == 0
    out = capsys.readouterr().out
    assert "activation_compare: OK" in out
    r = activation_compare.compare(pt, npz, "JPDVT", 96, device="cpu", depth=2, hidden_size=64,
                                   num_heads=4)
    assert r["ok"] and max(r["img_max_abs"], r["code_max_abs"]) < 2e-5
    # Block 0's qkv rows (q|k|v, head, head_dim) with heads 0 and 1 swapped
    # in q, k and v alike: another function, which the npz does not compute.
    bad = dict(sd)
    for leaf in ("weight", "bias"):
        k = f"blocks.0.attn.qkv.{leaf}"
        w = sd[k].reshape(3, 4, 16, *sd[k].shape[1:])
        bad[k] = np.ascontiguousarray(w[:, [1, 0, 2, 3]].reshape(sd[k].shape))
    permuted = str(tmp / "permuted.pt")
    _reference_pt(permuted, bad)
    assert activation_compare.main([permuted, npz, *args]) == 1
    assert "activation_compare: MISMATCH" in capsys.readouterr().out


def test_parity_rehearses_to_the_oracles_permutations(reference, tmp_path, monkeypatch):
    model, _, pt, _, _ = reference
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(11)
    for i in range(8):  # smooth random images, so the puzzles are not all alike
        base = rng.integers(0, 256, (4, 4, 3)).astype(np.float64)
        img = np.kron(base, np.ones((24, 24, 1))) + rng.normal(0, 20, (96, 96, 3))
        (images / f"img{i}.png").write_bytes(encode_png(np.clip(img, 0, 255).astype(np.uint8)))
    seen = []
    evaluate_async = PuzzleSolver.evaluate_async

    def recording(self, x, indices=None, sigmas=None):
        thunk = evaluate_async(self, x, indices, sigmas)

        def result():
            res = thunk()
            seen.append((self, x.clone(), res))
            return res
        return result

    monkeypatch.setattr(PuzzleSolver, "evaluate_async", recording)
    out = tmp_path / "parity"
    assert parity.main([pt, str(images), "--out", str(out), "--device", "cpu", *ARCH,
                        "diffusion.sampling_steps=10", "eval.batch_size=4"]) == 0
    rows = (out / "logs" / "inference_progress.csv").read_text().splitlines()
    assert len(rows) == 9 and (out / "2850000_ema.npz").exists()
    assert sum(len(res.pred) for _, _, res in seen) == 8
    preds = []
    for solver, x, res in seen:
        assert solver.mode == "faithful" and solver.diffusion.num_timesteps == 10
        x_scr = solver.scramble(x, res.indices).numpy().transpose(0, 3, 1, 2)
        noise = np.broadcast_to(solver.noise_template.numpy(), (len(x), 36, 8))
        want = ref_pipeline.reference_solve(model, np.ascontiguousarray(x_scr), noise,
                                            grid_code(8, 3), 3, 2, respacing=10)
        np.testing.assert_array_equal(res.pred, want)
        preds.append(res.pred)
    assert len({tuple(p) for p in np.concatenate(preds)}) > 1  # not one answer for all
