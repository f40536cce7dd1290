"""Reference checkpoints into the port, and back.

Counterpart of ``jpdvt_mt_ntnu_tpu/tools/torch_convert.py:28-131,
223-247``. The reference's users hold pickled PyTorch checkpoints
``{"model", "ema", "opt", "args", "train_steps"}`` (reference
image_model/train_JPDVT.py:410-418) whose keys are in timm's layout;
:func:`reference_to_state_dict` maps one of their state dicts to the port's
``DiT.state_dict`` names:

- the conv patch embed ``x_embedder.proj.weight`` (D, C, p, p), OIHW,
  becomes the port's ``x_embedder.weight`` (D, p*p*C) with each patch
  flattened in (row, col, channel) order (``models/dit.py`` ``patchify``);
- timm's fused qkv orders its 3*D outputs as (qkv, head, head_dim), which is
  the port's order too: the Linears carry over as they are
  (``t_embedder.mlp.{0,2}`` -> ``t_embedder.fc{1,2}``, ``time_emb_in`` ->
  ``code_in``, ``time_emb_out{1,2}`` -> ``code_out{1,2}``,
  ``*.adaLN_modulation.1`` -> ``*.adaLN_modulation``);
- the frozen ``pos_embed`` buffer is skipped (the port makes its own);
- missing or left-over keys are reported, not fatal (the reference loads
  key-filtered with ``strict=False``, inference.py:207-211).

:func:`state_dict_to_reference` is the inverse. The CLI writes a
flattened-params npz with the keys of the JAX package's ``save_npz_params``
(``params/block_0/attn/qkv/kernel`` ...), which both packages'
``run_eval`` take as ``eval.checkpoint``::

    python -m jpdvt_mt_ntnu_tpu_torch.tools.convert 2850000.pt out.npz \\
        [--depth 12] [--which ema|model]

The checkpoint is read with ``torch.load(weights_only=True)``, with
``argparse.Namespace`` (the reference's ``args`` entry) the one class
allowed beyond tensors and containers, so that a checkpoint's pickle runs
no code. A checkpoint that holds any other object is refused.
"""

from __future__ import annotations

import argparse
import warnings

import numpy as np
import torch

from .weights import state_dict_to_params

# reference prefix -> the port's (both Linears: weight (out, in), bias)
_SIMPLE_LINEARS = {
    "t_embedder.mlp.0": "t_embedder.fc1",
    "t_embedder.mlp.2": "t_embedder.fc2",
    "time_emb_in": "code_in",
    "time_emb_out1": "code_out1",
    "time_emb_out2": "code_out2",
    "final_layer.adaLN_modulation.1": "final_layer.adaLN_modulation",
    "final_layer.linear": "final_layer.linear",
}
_BLOCK_LINEARS = {
    "adaLN_modulation.1": "adaLN_modulation",
    "attn.qkv": "attn.qkv",
    "attn.proj": "attn.proj",
    "mlp.fc1": "mlp.fc1",
    "mlp.fc2": "mlp.fc2",
}


def _linears(depth: int) -> dict[str, str]:
    out = dict(_SIMPLE_LINEARS)
    for i in range(depth):
        out.update({f"blocks.{i}.{k}": f"blocks.{i}.{v}" for k, v in _BLOCK_LINEARS.items()})
    return out


def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float()
    return torch.as_tensor(np.asarray(v, np.float32))


def reference_to_state_dict(state_dict: dict, depth: int
                            ) -> tuple[dict[str, torch.Tensor], list[str]]:
    """A reference DiT ``state_dict`` -> (the port's ``state_dict`` as
    float32 CPU tensors, the reference keys left unused, sorted)."""
    sd = {k: _f32(v) for k, v in state_dict.items()}
    out: dict[str, torch.Tensor] = {}
    used = {"pos_embed"}  # a frozen buffer the port computes itself
    w = sd.get("x_embedder.proj.weight")
    if w is not None:  # (D, C, p, p) -> (D, p, p, C) -> (D, p*p*C)
        out["x_embedder.weight"] = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous()
        used.add("x_embedder.proj.weight")
    if "x_embedder.proj.bias" in sd:
        out["x_embedder.bias"] = sd["x_embedder.proj.bias"]
        used.add("x_embedder.proj.bias")
    for ref, mine in _linears(depth).items():
        for leaf in ("weight", "bias"):
            if f"{ref}.{leaf}" in sd:
                out[f"{mine}.{leaf}"] = sd[f"{ref}.{leaf}"]
                used.add(f"{ref}.{leaf}")
    return out, sorted(set(sd) - used)


def state_dict_to_reference(sd: dict, *, patch_size: int, in_channels: int = 3,
                            pos_embed: np.ndarray | None = None) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` -> the reference's names and layouts
    (float32 CPU tensors); ``pos_embed`` (N, D), when given, is stored as
    the reference's (1, N, D) buffer."""
    sd = {k: _f32(v) for k, v in sd.items()}
    depth = 1 + max((int(k.split(".")[1]) for k in sd if k.startswith("blocks.")), default=-1)
    out: dict[str, torch.Tensor] = {}
    w = sd["x_embedder.weight"]  # (D, p*p*C) -> (D, C, p, p)
    out["x_embedder.proj.weight"] = (w.reshape(w.shape[0], patch_size, patch_size, in_channels)
                                     .permute(0, 3, 1, 2).contiguous())
    out["x_embedder.proj.bias"] = sd["x_embedder.bias"]
    for ref, mine in _linears(depth).items():
        for leaf in ("weight", "bias"):
            out[f"{ref}.{leaf}"] = sd[f"{mine}.{leaf}"]
    if pos_embed is not None:
        out["pos_embed"] = torch.as_tensor(np.asarray(pos_embed, np.float32))[None]
    return out


def load_reference_checkpoint(path: str) -> dict:
    """``torch.load`` of a reference checkpoint with ``weights_only=True``:
    tensors, containers and ``argparse.Namespace`` (its ``args``) only."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def save_npz_params(path: str, sd: dict) -> None:
    """The port's ``state_dict`` -> a flattened-params npz in the JAX
    package's layout and key names (``save_npz_params``, float32), stored
    without compression: deflating the flagship's 131M fp32 values takes
    ~2 minutes for half the bytes, and the durable, committed form of a
    checkpoint is ``tools/export.py``'s bf16 artifact."""
    np.savez(path, **state_dict_to_params(sd))


def convert_checkpoint(torch_path: str, out_path: str, depth: int = 12,
                       which: str = "ema") -> list[str]:
    """Reference ``.pt`` -> flattened-params ``.npz``; the unused keys. A
    parameter of the port's depth-``depth`` DiT that the checkpoint lacks
    is warned of by name (the npz then lacks it too)."""
    ckpt = load_reference_checkpoint(torch_path)
    sd = ckpt[which] if isinstance(ckpt, dict) and which in ckpt else ckpt
    converted, unused = reference_to_state_dict(sd, depth)
    wanted = {"x_embedder.weight", "x_embedder.bias"} | {
        f"{mine}.{leaf}" for mine in _linears(depth).values() for leaf in ("weight", "bias")}
    missing = sorted(wanted - set(converted))
    if missing:
        warnings.warn(f"{torch_path}: {len(missing)} parameters missing: {missing[:10]}",
                      stacklevel=2)
    save_npz_params(out_path, converted)
    return unused


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("torch_ckpt")
    ap.add_argument("out_npz")
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--which", default="ema", choices=["ema", "model"])
    a = ap.parse_args(argv)
    unused = convert_checkpoint(a.torch_ckpt, a.out_npz, a.depth, a.which)
    if unused:
        print(f"unused torch keys ({len(unused)}): {unused[:10]} ...")
    print(f"wrote {a.out_npz}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
