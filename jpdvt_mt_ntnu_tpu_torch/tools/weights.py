"""Carry the JAX package's weights into the port.

Counterpart of ``jpdvt_mt_ntnu_tpu/tools/torch_convert.py:154-220``, numpy
only. Reads the committed durable artifacts (``artifacts/*.manifest.json``:
a split npz with sha256 per part and for the whole file) and bare
flattened-params npz files, and maps JAX parameters (a nested dict of
arrays, or the flat ``params/block_0/attn/qkv/kernel`` keys) to the port's
``state_dict``: ``block_{i}`` -> ``blocks.{i}``, ``kernel`` (in, out) ->
``weight`` (out, in), ``bias`` -> ``bias``. Keys under ``*__bf16`` hold
bfloat16 bit patterns as uint16; they are widened to float32 bit for bit.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import warnings
from typing import Mapping

import numpy as np
import torch

from ..utils.device import default_device

ARTIFACT_FORMAT = 1
_BLOCK = re.compile(r"block_(\d+)")


def decode_bf16(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> float32 (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def read_npz(source) -> dict[str, np.ndarray]:
    """A flattened-params npz (path or file object) -> flat float arrays."""
    flat = {}
    with np.load(source) as z:
        for key in z.files:
            if key.endswith("__bf16"):
                flat[key[: -len("__bf16")]] = decode_bf16(z[key])
            else:
                flat[key] = z[key]
    return flat


def read_artifact(path: str) -> tuple[dict[str, np.ndarray], int]:
    """(flat params, training step) from a ``*.manifest.json`` artifact,
    checked against its sha256s, or from a bare ``.npz`` (step 0)."""
    if not path.endswith(".json"):
        warnings.warn(f"{path} is a bare npz and records no training step; "
                      "returning step 0", stacklevel=2)
        return read_npz(path), 0
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("format") != ARTIFACT_FORMAT:
        raise ValueError(f"{path}: unknown artifact format "
                         f"{manifest.get('format')!r} (expected {ARTIFACT_FORMAT})")
    art_dir = os.path.dirname(os.path.abspath(path))
    whole = hashlib.sha256()
    chunks = []
    for part in manifest["parts"]:
        with open(os.path.join(art_dir, part["file"]), "rb") as pf:
            chunk = pf.read()
        got = hashlib.sha256(chunk).hexdigest()
        if got != part["sha256"]:
            raise ValueError(f"integrity failure: {part['file']} sha256 {got} "
                             f"!= manifest {part['sha256']}")
        whole.update(chunk)
        chunks.append(chunk)
    if whole.hexdigest() != manifest["npz_sha256"]:
        raise ValueError(f"integrity failure: reassembled npz sha256 "
                         f"{whole.hexdigest()} != manifest {manifest['npz_sha256']}")
    blob = b"".join(chunks)
    del chunks
    return read_npz(io.BytesIO(blob)), int(manifest["step"])


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def params_to_state_dict(params: Mapping) -> tuple[dict[str, np.ndarray], list[str]]:
    """JAX params (nested or flat) -> (port state_dict arrays, unused keys)."""
    flat = _flatten(params)
    sd: dict[str, np.ndarray] = {}
    unused = []
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        names = []
        for part in parts[:-1]:
            m = _BLOCK.fullmatch(part)
            names += ["blocks", m.group(1)] if m else [part]
        if parts[-1] == "kernel" and value.ndim == 2:
            sd[".".join(names + ["weight"])] = value.T
        elif parts[-1] == "bias" and value.ndim == 1:
            sd[".".join(names + ["bias"])] = value
        else:
            unused.append(key)
    return sd, sorted(unused)


def load_artifact(path: str, *, device: str | torch.device | None = None
                  ) -> tuple[dict[str, torch.Tensor], int]:
    """(state_dict on ``device``, training step) from an artifact or npz.

    ``device`` defaults to the card. Raises if any parameter has no place
    in the port's model; ``DiT.load_state_dict`` then reports any missing."""
    device = default_device(device)
    flat, step = read_artifact(path)
    sd, unused = params_to_state_dict(flat)
    if unused:
        raise ValueError(f"{path}: parameters with no counterpart in the port: {unused}")
    return {k: torch.from_numpy(v).to(device).contiguous() for k, v in sd.items()}, step
