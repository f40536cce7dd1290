"""A checkpoint of the port as a durable artifact, and its restore in a fresh process.

Counterpart of ``tools/export_ckpt.py:74-296``. A training run's
checkpoints (``<exp_dir>/checkpoints/<step>/state.pt``,
``train/checkpoint.py``) live under ``results/``, which does not survive
the machine (the JAX package lost its round-3 and round-4 capstones that
way). This tool turns the latest one into an artifact that ``run_eval``,
the service and ``train.warm_start`` read (``artifacts/*.manifest.json``):

- the EMA weights only, in the JAX package's flattened-params layout
  (``params/block_0/attn/qkv/kernel`` ..., ``tools/weights.py``), each
  rounded to bfloat16 (nearest even) and stored as uint16 bits under
  ``<key>__bf16``, in one npz deflated at level 1 (:func:`npz_bytes`);
- that npz split into parts of at most ``--max-part-mb`` MiB, with a JSON
  manifest holding each part's sha256 and the whole's, the step, and the
  run's ``run_config.json`` (the one beside ``checkpoints/``), so that the
  model can be rebuilt;
- then a fresh Python process reassembles the parts, checks every sha256,
  rebuilds the model from the manifest's config and fast-solves
  ``--solve-n`` synthetic puzzles: the artifact restores with nothing from
  the exporting process.

::

    python -m jpdvt_mt_ntnu_tpu_torch.tools.export results/run/checkpoints --out artifacts/
    python -m jpdvt_mt_ntnu_tpu_torch.tools.export --restore artifacts/<run>_step<N>.manifest.json \\
        [--solve-n 2] [--as-npz params.npz] [--device cpu]

The restore solves on the card unless ``--device cpu``. An npz's bytes
hold zip timestamps, so two exports of one checkpoint differ in bytes and
sha256 but not in contents.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import zipfile

import numpy as np
import torch

from .weights import (ARTIFACT_FORMAT, encode_bf16, params_to_state_dict, read_npz,
                      reassemble_artifact, state_dict_to_params)

BF16_SUFFIX = "__bf16"
# The directory that holds the package, the fresh process's working directory.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def npz_bytes(arrays: dict[str, np.ndarray]) -> bytes:
    """The bytes of ``np.savez_compressed(arrays)`` at deflate level 1: on
    the flagship's 262 MB of bf16 bits 10.4 s for 198.9 MiB, against 36.9 s
    for 197.3 MiB at numpy's level 6 (one CPU); ``np.load`` reads both."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as z:
        for key, value in arrays.items():
            with z.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(value), allow_pickle=False)
    return buf.getvalue()


def latest_ema(ckpt_dir: str) -> tuple[int, dict[str, torch.Tensor]]:
    """(step, EMA ``state_dict``) of the latest checkpoint under ``ckpt_dir``."""
    from ..train.checkpoint import STATE_FILE, CheckpointManager

    step = CheckpointManager(ckpt_dir).latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    sd = torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE), map_location="cpu",
                    weights_only=True)
    return step, sd["ema"]


def export(ckpt_dir: str, out_dir: str, max_part_mb: int) -> str:
    """Write the artifact of the latest checkpoint under ``ckpt_dir`` into
    ``out_dir``; the manifest's path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    run_dir = os.path.dirname(ckpt_dir)
    run_name = os.path.basename(run_dir) or "run"
    run_config = {}
    if os.path.exists(os.path.join(run_dir, "run_config.json")):
        with open(os.path.join(run_dir, "run_config.json")) as f:
            run_config = json.load(f)
    else:
        print(f"WARNING: no run_config.json next to {ckpt_dir}; the manifest "
              "will not be able to rebuild the model for the restore smoke",
              file=sys.stderr)
    step, ema = latest_ema(ckpt_dir)
    enc: dict[str, np.ndarray] = {}
    n_params = 0
    for k, v in state_dict_to_params(ema).items():
        n_params += int(v.size)
        enc[k + BF16_SUFFIX] = encode_bf16(v)

    os.makedirs(out_dir, exist_ok=True)
    name = f"{run_name}_step{step}"
    blob = npz_bytes(enc)
    part_bytes = max_part_mb * (1 << 20)
    parts = []
    for idx, start in enumerate(range(0, len(blob), part_bytes)):
        chunk = blob[start:start + part_bytes]
        part_name = f"{name}.npz.part{idx:03d}"
        with open(os.path.join(out_dir, part_name), "wb") as pf:
            pf.write(chunk)
        parts.append({"file": part_name, "bytes": len(chunk),
                      "sha256": hashlib.sha256(chunk).hexdigest()})
    manifest = {
        "format": ARTIFACT_FORMAT,
        "name": name,
        "run": run_name,
        "step": int(step),
        "contents": "ema_params",
        "dtype": "bfloat16 (uint16 bits under *__bf16 keys)",
        "param_count": n_params,
        "npz_bytes": len(blob),
        "npz_sha256": hashlib.sha256(blob).hexdigest(),
        "parts": parts,
        "run_config": run_config,
    }
    manifest_path = os.path.join(out_dir, name + ".manifest.json")
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"exported {n_params:,} EMA params @ step {step} -> {len(parts)} part(s), "
          f"{len(blob) / (1 << 20):.1f} MiB total\nmanifest: {manifest_path}")
    return manifest_path


def restore_smoke(manifest_path: str, solve_n: int, as_npz: str = "",
                  device: str | None = None) -> dict:
    """Reassemble, check, load, rebuild the model and fast-solve: the proof
    that the artifact is enough on its own."""
    manifest, blob = reassemble_artifact(manifest_path)
    if as_npz:
        with open(as_npz, "wb") as f:
            f.write(blob)
    flat = read_npz(io.BytesIO(blob))
    n_params = sum(int(v.size) for v in flat.values())
    if n_params != manifest["param_count"]:
        raise ValueError(f"param count {n_params} != manifest {manifest['param_count']}")
    report = {"manifest": os.path.basename(manifest_path), "step": manifest["step"],
              "param_leaves": len(flat), "param_count": n_params,
              "integrity": "sha256 ok"}
    if solve_n > 0 and manifest.get("run_config"):
        from ..core.diffusion import create_diffusion
        from ..data import SyntheticPuzzles
        from ..eval.solver import PuzzleSolver
        from ..models import create_model
        from ..utils.config import config_from_dict
        from ..utils.device import default_device

        device = default_device(device)
        cfg = config_from_dict(manifest["run_config"])
        dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
        model, model_cfg = create_model(cfg.model.name, cfg.model.image_size, device=device,
                                        dtype=dtype, **cfg.model.overrides())
        sd, unused = params_to_state_dict(flat)
        if unused:
            raise ValueError(f"parameters with no counterpart in the port: {unused}")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        grid = cfg.task.grid_size
        solver = PuzzleSolver(model, model_cfg, create_diffusion("250", device=device),
                              grid_size=grid, mode="fast", seed=0, device=device)
        ds = SyntheticPuzzles(cfg.model.image_size, n=solve_n, seed=123,
                              cues=cfg.data.synthetic_cues or None)
        rng = np.random.default_rng(123)
        perms = np.stack([rng.permutation(grid * grid) for _ in range(solve_n)])
        res = solver.evaluate(ds.batch(), perms)
        if not (np.sort(res.pred, axis=1) == np.arange(grid * grid)).all():
            raise ValueError("solver output is not a permutation")
        report.update({"solve_n": solve_n, "grid_size": grid, "device": str(device),
                       "pred_valid_permutations": True,
                       "puzzle_acc_on_smoke": res.puzzle_accuracy})
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpt_dir", nargs="?", help="checkpoint directory of a run to export")
    p.add_argument("--out", default="artifacts/", help="artifact directory")
    p.add_argument("--max-part-mb", type=int, default=90,
                   help="split the npz into parts of at most this many MiB")
    p.add_argument("--restore", default="",
                   help="manifest path: reassemble + verify + solve instead of exporting")
    p.add_argument("--as-npz", default="",
                   help="with --restore: keep the reassembled npz here (an eval.checkpoint)")
    p.add_argument("--solve-n", type=int, default=2,
                   help="synthetic puzzles for the restore smoke (0 = integrity only)")
    p.add_argument("--no-smoke", action="store_true",
                   help="skip the fresh-process restore smoke after export")
    p.add_argument("--device", default=None, help="the restore's device (default: the card)")
    a = p.parse_args(argv)

    if a.restore:
        print(json.dumps(restore_smoke(a.restore, a.solve_n, a.as_npz, a.device), indent=2))
        return 0
    if not a.ckpt_dir:
        p.error("ckpt_dir required (or --restore MANIFEST)")
    manifest_path = os.path.abspath(export(a.ckpt_dir, a.out, a.max_part_mb))
    if a.no_smoke:
        return 0
    # A fresh interpreter, its output in a file (a filled pipe can block it).
    cmd = [sys.executable, "-m", "jpdvt_mt_ntnu_tpu_torch.tools.export",
           "--restore", manifest_path, "--solve-n", str(a.solve_n)]
    if a.device:
        cmd += ["--device", a.device]
    with tempfile.TemporaryFile("w+") as log:
        code = subprocess.call(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=_ROOT)
        log.seek(0)
        print(log.read())
    if code != 0:
        print(f"restore smoke FAILED (exit {code})", file=sys.stderr)
        return code
    print("restore smoke passed in a fresh process")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
