"""Carry the JAX package's weights into the port.

Counterpart of ``jpdvt_mt_ntnu_tpu/tools/torch_convert.py:154-220``, numpy
only. Reads the committed durable artifacts (``artifacts/*.manifest.json``:
a split npz with sha256 per part and for the whole file) and bare
flattened-params npz files, and maps JAX parameters (a nested dict of
arrays, or the flat ``params/block_0/attn/qkv/kernel`` keys) to the port's
``state_dict``: ``block_{i}`` -> ``blocks.{i}``, ``kernel`` (in, out) ->
``weight`` (out, in), ``bias`` -> ``bias``; an expert-choice MLP's
``mlp/router`` is a Dense like the others and its ``wi``, ``bi``, ``wo``
and ``bo`` keep their shapes. Keys under ``*__bf16`` hold
bfloat16 bit patterns as uint16; they are widened to float32 bit for bit.
:func:`state_dict_to_params` is the inverse map (the exporter and the
converter write the JAX key names with it), :func:`encode_bf16` the
inverse of :func:`decode_bf16` after a round to nearest even.
:func:`load_jax_train_state` carries a whole JAX ``TrainState`` (params,
EMA and the AdamW moments) into the port's train state.
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
# ExpertChoiceMoE's stacked expert weights, kept in the JAX layout.
_MOE_PARAMS = ("wi", "bi", "wo", "bo")


def decode_bf16(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> float32 (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def encode_bf16(values) -> np.ndarray:
    """float values -> uint16 bfloat16 bit patterns, rounded to nearest even
    (torch's cast, which ml_dtypes' ``astype(bfloat16)`` equals)."""
    t = torch.as_tensor(np.asarray(values, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


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


def reassemble_artifact(path: str) -> tuple[dict, bytes]:
    """(manifest, npz bytes) of a ``*.manifest.json`` artifact, each part
    and the whole checked against the manifest's sha256s; a part that
    differs is refused by name."""
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
    return manifest, b"".join(chunks)


def read_artifact(path: str) -> tuple[dict[str, np.ndarray], int]:
    """(flat params, training step) from a ``*.manifest.json`` artifact,
    checked against its sha256s, or from a bare ``.npz`` (step 0)."""
    if not path.endswith(".json"):
        warnings.warn(f"{path} is a bare npz and records no training step; "
                      "returning step 0", stacklevel=2)
        return read_npz(path), 0
    manifest, blob = reassemble_artifact(path)
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
        elif parts[-1] in _MOE_PARAMS and names[-1:] == ["mlp"]:
            sd[".".join(names + [parts[-1]])] = value
        else:
            unused.append(key)
    return sd, sorted(unused)


def state_dict_to_params(sd: Mapping) -> dict[str, np.ndarray]:
    """The port's ``state_dict`` (tensors or arrays) -> flat JAX params,
    ``params/block_{i}/.../kernel`` keys, the inverse of
    :func:`params_to_state_dict`: ``weight`` (out, in) -> ``kernel``
    (in, out), the MoE's ``wi``, ``bi``, ``wo`` and ``bo`` as they are.
    Raises on a name with no JAX counterpart."""
    flat = {}
    for name, value in sd.items():
        a = (value.detach().cpu().float().numpy() if isinstance(value, torch.Tensor)
             else np.asarray(value, np.float32))
        parts = name.split(".")
        path = []
        i = 0
        while i < len(parts) - 1:
            if parts[i] == "blocks":
                path.append(f"block_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        leaf = parts[-1]
        if leaf == "weight" and a.ndim == 2:
            path.append("kernel")
            a = a.T
        elif leaf == "bias" and a.ndim == 1:
            path.append("bias")
        elif leaf in _MOE_PARAMS and path[-1:] == ["mlp"]:
            path.append(leaf)
        else:
            raise ValueError(f"{name}: no counterpart in the JAX parameters")
        flat["/".join(["params"] + path)] = np.ascontiguousarray(a)
    return flat


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


def _tree_to_tensors(tree: Mapping, what: str) -> dict[str, torch.Tensor]:
    sd, unused = params_to_state_dict(tree)
    if unused:
        raise ValueError(f"{what}: entries with no counterpart in the port: {unused}")
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in sd.items()}


def load_jax_train_state(state, *, step: int, params: Mapping,
                         ema_params: Mapping, mu: Mapping, nu: Mapping,
                         count: int):
    """Carry a whole JAX ``TrainState`` into the port's ``train.TrainState``
    in place: params, ``ema_params`` and optax's AdamW ``mu``/``nu``/
    ``count`` (numpy trees of the JAX layout: Dense kernels (in, out)).
    Raises on any entry that has no place, or any place left unfilled."""
    sd = {"step": int(step),
          "model": _tree_to_tensors(params, "params"),
          "ema": _tree_to_tensors(ema_params, "ema_params"),
          "opt": {"count": int(count), "mu": _tree_to_tensors(mu, "mu"),
                  "nu": _tree_to_tensors(nu, "nu")}}
    state.load_state_dict(sd)
    return state
