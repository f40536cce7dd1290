"""Golden-activation compare: a reference-format checkpoint against its
conversion, forward outputs side by side.

Counterpart of ``jpdvt_mt_ntnu_tpu/tools/activation_compare.py``, step 2
of the parity path (``tools/parity.py``). The same weights go through two
paths on random inputs, in fp32, and the outputs are compared head by
head (the image and the positional code):

- path one: the reference checkpoint loaded into the independently
  written reference-semantics DiT (``tools/make_dit_goldens.build_torch_dit``:
  timm's fused-qkv layout, the adaLN chunk order, the dual head reading
  the final layer's image; reference image_model/models.py:101-293), on
  the CPU;
- path two: the flattened-params npz that ``tools/convert.py`` wrote from
  it, loaded into the port's ``DiT`` on ``--device`` (the card unless
  ``--device cpu``; its attention is K1's fp32 path there), with float32
  products (TF32 off for the call).

A conversion that computes another function (qkv's heads put in another
order, say) passes every round trip and shows only here::

    python -m jpdvt_mt_ntnu_tpu_torch.tools.activation_compare CKPT.pt NPZ \\
        [--model JPDVT] [--image-size 192] [--which ema] [--tol 2e-4] \\
        [--depth 0 --hidden-size 0 --num-heads 0 --patch-size 0] [--device cpu]

(0: the registry's value). Exit code 0 within ``--tol``, 1 on a mismatch
(each head's largest absolute difference is printed).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models import create_model
from ..utils.device import apply_matmul_precision, default_device
from .convert import load_reference_checkpoint
from .make_dit_goldens import build_torch_dit, run_torch_forward
from .weights import params_to_state_dict, read_npz


def compare(ckpt_path: str, npz_path: str, model_name: str = "JPDVT", image_size: int = 192,
            which: str = "ema", tol: float = 2e-4, batch: int = 2, seed: int = 0,
            device: str | torch.device | None = None, **overrides) -> dict:
    """``{"img_max_abs", "code_max_abs", "ok"}`` of the two paths on
    ``batch`` random inputs drawn from ``seed``."""
    device = default_device(device)
    ov = {k: v for k, v in overrides.items() if v}
    model, cfg = create_model(model_name, image_size, device=device, dtype=torch.float32, **ov)
    sd, unused = params_to_state_dict(read_npz(npz_path))
    if unused:
        raise ValueError(f"{npz_path}: parameters with no counterpart in the port: {unused}")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    model.requires_grad_(False)
    oracle = build_torch_dit(dict(
        input_size=cfg.input_size, patch_size=cfg.patch_size, in_channels=cfg.in_channels,
        hidden_size=cfg.hidden_size, depth=cfg.depth, num_heads=cfg.num_heads,
        mlp_ratio=cfg.mlp_ratio, code_dim=cfg.code_dim, code_head_hidden=cfg.code_head_hidden))
    # The checkpoint into the oracle: the reference's names without timm's
    # ".proj" of the conv; pos_embed is the same deterministic buffer in both.
    ckpt = load_reference_checkpoint(ckpt_path)
    ref = ckpt[which] if isinstance(ckpt, dict) and which in ckpt else ckpt
    renamed = {k.replace("module.", "").replace("x_embedder.proj.", "x_embedder."):
               torch.as_tensor(np.asarray(v)) for k, v in ref.items()}
    missing, unexpected = oracle.load_state_dict(renamed, strict=False)
    bad = [k for k in [*missing, *unexpected] if "pos_embed" not in k]
    if bad:
        raise ValueError(f"{ckpt_path} does not fit the {model_name} geometry: unmatched "
                         f"keys {bad[:8]}")

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, cfg.in_channels, image_size, image_size)).astype(np.float32)
    t = np.asarray(rng.integers(0, 1000, size=batch), dtype=np.int64)
    code = rng.standard_normal((batch, cfg.num_tokens, cfg.code_dim)).astype(np.float32)
    ref_img, ref_code = run_torch_forward(oracle, x, t, code)
    before = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    apply_matmul_precision("highest")
    try:
        with torch.no_grad():
            img, out_code = model(torch.from_numpy(x.transpose(0, 2, 3, 1)).to(device),
                                  torch.from_numpy(t).to(device), torch.from_numpy(code).to(device))
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]
    img = img.cpu().numpy().transpose(0, 3, 1, 2)
    d_img = float(np.abs(img - ref_img).max())
    d_code = float(np.abs(out_code.cpu().numpy() - ref_code).max())
    return {"img_max_abs": d_img, "code_max_abs": d_code, "ok": d_img <= tol and d_code <= tol}


def report(r: dict, tol: float) -> int:
    """Print the result line; the exit code."""
    status = "OK" if r["ok"] else "MISMATCH"
    print(f"activation_compare: {status} img_max_abs={r['img_max_abs']:.3e} "
          f"code_max_abs={r['code_max_abs']:.3e} (tol {tol:.0e})")
    return 0 if r["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("npz")
    ap.add_argument("--model", default="JPDVT")
    ap.add_argument("--image-size", type=int, default=192)
    ap.add_argument("--which", default="ema", choices=["ema", "model"])
    ap.add_argument("--tol", type=float, default=2e-4)
    # 0: the registry's value; otherwise an override (small models, tests)
    for flag in ("--depth", "--hidden-size", "--num-heads", "--patch-size"):
        ap.add_argument(flag, type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card")
    a = ap.parse_args(argv)
    r = compare(a.ckpt, a.npz, a.model, a.image_size, a.which, a.tol, device=a.device,
                depth=a.depth, hidden_size=a.hidden_size, num_heads=a.num_heads,
                patch_size=a.patch_size)
    return report(r, a.tol)


if __name__ == "__main__":
    raise SystemExit(main())
