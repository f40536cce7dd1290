"""Accuracy parity with a reference checkpoint, one command.

The port's counterpart of ``scripts/parity_when_available.sh``, for when
the reference's checkpoint (``2850000.pt``) and its test images are at
hand::

    python -m jpdvt_mt_ntnu_tpu_torch.tools.parity CKPT.pt IMAGE_DIR \\
        [--out results/parity] [--which ema] [--tol 2e-4] [--device cpu] \\
        [section.field=value ...]

e.g. ``... /models/3x3_Full/2850000.pt /data/imagenet/test task.grid_size=3
model.image_size=192``. Three steps, each stopping the run where it fails:

1. ``tools/convert.py``: the checkpoint's ``--which`` weights to a
   flattened-params npz under ``--out``;
2. ``tools/activation_compare.py``: the checkpoint in the reference's
   semantics against the npz in the port's DiT, fp32, within ``--tol``
   (exit 1 otherwise);
3. ``eval/run_eval.py``: the reference's protocol on the folder
   (faithful-250, greedy, fp32 with float32 products, the npz's weights),
   journal under ``--out/logs``.

The overrides go to ``run_eval`` after those defaults (so they win) and
give the geometry of steps 1 and 2 (``model.name``, ``model.image_size``,
``model.depth`` ...). The target is puzzle 0.6789 / patch 0.8002 on
ImageNet's test images (the reference's ``logs/3/inference_progress.csv``).
"""

from __future__ import annotations

import argparse
import os

from ..eval import run_eval
from ..models import DIT_CONFIGS
from ..utils.config import Config, apply_overrides
from . import activation_compare, convert


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("data_dir")
    ap.add_argument("overrides", nargs="*", help="run_eval's section.field=value")
    ap.add_argument("--out", default="results/parity")
    ap.add_argument("--which", default="ema", choices=["ema", "model"])
    ap.add_argument("--tol", type=float, default=2e-4)
    ap.add_argument("--device", default=None, help="default: the card")
    a = ap.parse_intermixed_args(argv)
    m = apply_overrides(Config(), a.overrides).model
    arch = {**DIT_CONFIGS[m.name], **m.overrides()}
    os.makedirs(a.out, exist_ok=True)
    stem = os.path.splitext(os.path.basename(a.ckpt))[0]
    npz = os.path.join(a.out, f"{stem}_{a.which}.npz")

    print(f"== 1/3 convert: {a.ckpt} -> {npz} (--which {a.which})", flush=True)
    unused = convert.convert_checkpoint(a.ckpt, npz, arch["depth"], a.which)
    if unused:
        print(f"unused reference keys ({len(unused)}): {unused[:10]}")
    print(f"== 2/3 golden-activation compare (fp32, tol {a.tol:.0e})", flush=True)
    r = activation_compare.compare(
        a.ckpt, npz, m.name, m.image_size, a.which, a.tol, device=a.device,
        **{k: arch[k] for k in ("depth", "hidden_size", "num_heads", "patch_size")})
    if activation_compare.report(r, a.tol):
        return 1
    print("== 3/3 reference-protocol eval (faithful-250, greedy, fp32)", flush=True)
    code = run_eval.main(
        ([f"device={a.device}"] if a.device else [])
        + [f"data.data_path={a.data_dir}", f"eval.checkpoint={npz}",
           "model.compute_dtype=float32", "model.matmul_precision=highest",
           "diffusion.sampling_steps=250", "diffusion.sampler_mode=faithful",
           "eval.assignment=greedy", f"eval.logs_dir={os.path.join(a.out, 'logs')}",
           *a.overrides])
    print(f"parity run complete: the journal is in {os.path.join(a.out, 'logs')}")
    return code


if __name__ == "__main__":
    raise SystemExit(main())
