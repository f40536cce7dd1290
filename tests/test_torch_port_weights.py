"""The PyTorch port's weight loader on the committed full-width artifact.

``artifacts/waves3_r5_step10000`` (the 131M JPDVT at 192 px on a 3x3 grid)
is reassembled once for this module. The converter must place every
parameter (nothing unused, nothing missing), its bf16 decode must equal
``ml_dtypes``' (which the port itself may not import), and the port's plain
path must fast-solve the artifact's export-smoke puzzles
(``tools/export_ckpt.py:213-222``: ``SyntheticPuzzles(192, n=16, seed=123,
cues="waves")``, permutations from ``default_rng(123)``, the seed-0 noise
template) at puzzle accuracy 1.00, the JAX package's recorded result.
"""

import hashlib
import io
import json
import shutil

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.data import SyntheticPuzzles
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.models import DiT, DiTConfig, create_model
from jpdvt_mt_ntnu_tpu_torch.ops import jigsaw
from jpdvt_mt_ntnu_tpu_torch.tools import weights

ARTIFACT = "artifacts/waves3_r5_step10000.manifest.json"
NOISE_TEMPLATE = "tests/golden/jax_noise_seed0_1x144x8.npy"


@pytest.fixture(scope="module")
def artifact():
    flat, step = weights.read_artifact(ARTIFACT)
    return flat, step


def test_noise_template_golden_is_jax_seed0():
    golden = np.load(NOISE_TEMPLATE)
    assert golden.dtype == np.float32 and golden.shape == (1, 144, 8)
    np.testing.assert_array_equal(
        golden, np.asarray(jax.random.normal(jax.random.key(0), (1, 144, 8))))


def test_bf16_decode_equals_ml_dtypes():
    rng = np.random.default_rng(0)
    bits = np.concatenate([rng.integers(0, 2**16, 4096, dtype=np.uint16),
                           np.array([0, 0x8000, 0x7F80, 0xFF80, 0x3F80], np.uint16)])
    np.testing.assert_array_equal(weights.decode_bf16(bits),
                                  bits.view(ml_dtypes.bfloat16).astype(np.float32))


def test_artifact_converts_every_parameter(artifact):
    flat, step = artifact
    assert step == 10000
    sd, unused = weights.params_to_state_dict(flat)
    assert unused == []
    with torch.device("meta"):
        expected = DiT(DiTConfig()).state_dict()  # the flagship, no storage
    assert sorted(sd) == sorted(expected)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(expected[k].shape), k
    assert sum(v.size for v in sd.values()) == 130747208


def test_artifact_bf16_decode_matches_ml_dtypes(artifact):
    flat, _ = artifact
    with np.load(io.BytesIO(b"".join(
            open(f"artifacts/{p['file']}", "rb").read()
            for p in json.load(open(ARTIFACT))["parts"]))) as z:
        keys = [k for k in z.files if k.endswith("__bf16")]
        assert len(keys) == len(flat)
        for k in keys[:8]:
            np.testing.assert_array_equal(
                flat[k[:-len("__bf16")]], z[k].view(ml_dtypes.bfloat16).astype(np.float32))


def test_plain_path_fast_solves_round5_wave_puzzles(artifact):
    flat, _ = artifact
    sd, _ = weights.params_to_state_dict(flat)
    model, cfg = create_model("JPDVT", 192, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    x = SyntheticPuzzles(192, n=16, seed=123).batch()
    rng = np.random.default_rng(123)
    perms = np.stack([rng.permutation(9) for _ in range(16)])
    solver = PuzzleSolver(model, cfg, create_diffusion("250", device="cpu"),
                          mode="fast", device="cpu",
                          noise_template=np.load(NOISE_TEMPLATE))
    pred = solver.solve(jigsaw.scramble(torch.from_numpy(x), torch.from_numpy(perms), 3))
    assert (np.sort(pred, axis=1) == np.arange(9)).all()
    assert (pred == perms).all(axis=1).mean() == 1.0


def test_loader_rejects_bad_manifests(tmp_path):
    manifest = json.load(open(ARTIFACT))
    small = tmp_path / "tiny.npz"
    shutil.copy("tests/fixtures/tiny_jpdvt_48px.npz", small)
    blob = small.read_bytes()
    sha = hashlib.sha256(blob).hexdigest()
    manifest.update(parts=[{"file": "tiny.npz", "bytes": len(blob), "sha256": sha}],
                    npz_sha256=sha, step=7)
    good = tmp_path / "good.manifest.json"
    good.write_text(json.dumps(manifest))
    flat, step = weights.read_artifact(str(good))
    assert step == 7 and len(flat) == 36
    for change, match in [(dict(format=2), "format"),
                          (dict(npz_sha256="0" * 64), "integrity"),
                          (dict(parts=[{"file": "tiny.npz", "bytes": 1, "sha256": "0" * 64}]),
                           "integrity")]:
        bad = tmp_path / "bad.manifest.json"
        bad.write_text(json.dumps({**manifest, **change}))
        with pytest.raises(ValueError, match=match):
            weights.read_artifact(str(bad))
    with pytest.warns(UserWarning, match="step 0"):
        assert weights.read_artifact(str(small))[1] == 0
    np.savez(tmp_path / "extra.npz", **{"params/x_embedder/kernel": np.ones((2, 2)),
                                        "params/mystery/scale": np.ones(3)})
    with pytest.raises(ValueError, match="no counterpart"), pytest.warns(UserWarning):
        weights.load_artifact(str(tmp_path / "extra.npz"), device="cpu")
