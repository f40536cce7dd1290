"""The port's exporter against the JAX package's artifact readers.

A checkpoint of the port (``train/checkpoint.py``: ``<run>/checkpoints/
<step>/state.pt`` beside ``<run>/run_config.json``) of a small DiT, and of a
small JPDVT-MoE, whose EMA holds values that bf16 does not represent,
goes through ``tools.export``. The JAX package's ``reassemble_artifact``
and ``load_artifact_params`` must read the artifact and get the EMA
rounded to bf16 by ml_dtypes, bit for bit; the port's
``weights.read_artifact`` must read the same. The manifest carries the
JAX exporter's keys; a corrupted part is refused by name by both
packages; ``--restore`` solves in a fresh process on the CPU. torch's
bf16 cast is held to ml_dtypes' on ties, extremes and random values.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.tools.torch_convert import (load_artifact_params,
                                                   reassemble_artifact)
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.tools import export, weights
from jpdvt_mt_ntnu_tpu_torch.train import CheckpointManager, create_train_state
from jpdvt_mt_ntnu_tpu_torch.utils.config import Config, apply_overrides
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

# tools/export_ckpt.py:138-150
JAX_MANIFEST_KEYS = ["format", "name", "run", "step", "contents", "dtype", "param_count",
                     "npz_bytes", "npz_sha256", "parts", "run_config"]
MODELS = {"dense": dict(depth=2, hidden_size=128, num_heads=4),
          "moe": dict(depth=2, hidden_size=64, num_heads=4, moe_experts=4)}


def write_run(root, name: str, step: int = 7):
    """A run directory with one checkpoint at ``step``; its EMA."""
    kw = MODELS[name]
    model, _ = create_model("JPDVT", 48, device="cpu", **kw)
    state = create_train_state(model)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in state.ema.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    state.step = step
    run = os.path.join(root, f"run_{name}")
    os.makedirs(run)
    overrides = ["model.image_size=48", "model.compute_dtype=float32",
                 "data.synthetic_cues=waves"] + [
        f"model.{k}={v}" for k, v in kw.items()]
    with open(os.path.join(run, "run_config.json"), "w") as f:
        f.write(apply_overrides(Config(), overrides).to_json())
    CheckpointManager(os.path.join(run, "checkpoints")).save(state)
    return run, {k: v.clone() for k, v in state.ema.state_dict().items()}


def rounded_jax_layout(ema) -> dict[str, np.ndarray]:
    return {k: v.astype(ml_dtypes.bfloat16).astype(np.float32)
            for k, v in weights.state_dict_to_params(ema).items()}


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flatten(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_readers_get_the_bf16_ema_bit_for_bit(tmp_path, name):
    run, ema = write_run(str(tmp_path), name)
    manifest_path = export.export(os.path.join(run, "checkpoints"), str(tmp_path / "art"),
                                  max_part_mb=1)
    with open(manifest_path) as f:
        manifest = json.load(f)
    assert list(manifest) == JAX_MANIFEST_KEYS
    assert manifest["name"] == f"run_{name}_step7" and manifest["step"] == 7
    assert manifest["run_config"]["model"]["depth"] == 2
    assert len(manifest["parts"]) == (2 if name == "dense" else 1)
    expected = rounded_jax_layout(ema)
    assert manifest["param_count"] == sum(v.size for v in expected.values())

    jax_manifest = reassemble_artifact(manifest_path, str(tmp_path / "whole.npz"))
    assert jax_manifest == manifest
    params, step = load_artifact_params(manifest_path)
    got = flatten(params)
    assert step == 7 and sorted(got) == sorted(expected)
    for k in expected:
        np.testing.assert_array_equal(got[k], expected[k], err_msg=k)
    if name == "moe":
        assert got["params/block_0/mlp/wi"].shape == (4, 64, 256)
        assert got["params/block_0/mlp/bo"].shape == (4, 64)

    flat, step = weights.read_artifact(manifest_path)
    assert step == 7 and sorted(flat) == sorted(expected)
    for k in expected:
        np.testing.assert_array_equal(flat[k], expected[k], err_msg=k)
    sd, _ = weights.load_artifact(manifest_path, device="cpu")  # the port loads it
    model, _ = create_model("JPDVT", 48, device="cpu", **MODELS[name])
    model.load_state_dict(sd, strict=True)


def test_corrupted_part_is_refused_by_name(tmp_path):
    run, _ = write_run(str(tmp_path), "dense")
    manifest_path = export.export(os.path.join(run, "checkpoints"), str(tmp_path / "art"),
                                  max_part_mb=1)
    part = tmp_path / "art" / "run_dense_step7.npz.part001"
    data = bytearray(part.read_bytes())
    data[100] ^= 1
    part.write_bytes(bytes(data))
    for read in (weights.read_artifact,
                 lambda p: export.restore_smoke(p, 0),
                 lambda p: reassemble_artifact(p, str(tmp_path / "x.npz"))):
        with pytest.raises(ValueError, match="integrity failure: run_dense_step7.npz.part001"):
            read(manifest_path)


def test_restore_solves_in_a_fresh_process(tmp_path, capsys):
    run, _ = write_run(str(tmp_path), "dense")
    out = str(tmp_path / "art")
    assert export.main([os.path.join(run, "checkpoints"), "--out", out, "--solve-n", "2",
                        "--device", "cpu"]) == 0
    log = capsys.readouterr().out
    assert "restore smoke passed in a fresh process" in log
    report = json.loads(log[log.index("{"):log.rindex("}") + 1])
    assert report["integrity"] == "sha256 ok" and report["pred_valid_permutations"]
    assert report["device"] == "cpu" and report["solve_n"] == 2
    npz = str(tmp_path / "kept.npz")
    export.restore_smoke(os.path.join(out, "run_dense_step7.manifest.json"), 0, as_npz=npz)
    np.testing.assert_array_equal(
        weights.read_npz(npz)["params/x_embedder/bias"],
        weights.read_artifact(os.path.join(out, "run_dense_step7.manifest.json"))[0][
            "params/x_embedder/bias"])


def test_bf16_rounding_equals_ml_dtypes():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32)
    ties = (rng.integers(0, 2 ** 16, 2000).astype(np.uint32) << 16) | 0x8000
    values = np.concatenate([bits.view(np.float32), ties.view(np.float32),
                             np.array([0.0, -0.0, 1e-45, -1e-45, 3.4028235e38, -3.4028235e38,
                                       np.inf, -np.inf], np.float32)])
    values = values[~np.isnan(values)]
    np.testing.assert_array_equal(weights.encode_bf16(values),
                                  values.astype(ml_dtypes.bfloat16).view(np.uint16))
