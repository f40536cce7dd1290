"""CLI for the per-checkpoint quantization gate (ServiceConfig.quant_gate).

Counterpart of ``jpdvt_mt_ntnu_tpu/serve/quant_gate.py``. int8's accuracy
cost is checkpoint-specific, not geometric: the JAX package measured one
16x16 checkpoint losing 9.7pt puzzle accuracy under int8 and another 1.0pt,
same geometry, same code path. This tool runs the same gate the service
enforces at startup, standalone, and writes a JSON report — use it to
validate a checkpoint BEFORE deploying ``--quant int8`` (the reference
has no quantized path at all).

Exit status: 0 = agreement within tolerance, 1 = gate refused.

Usage (on the card; ``--device cpu`` for the CPU):
    python -m jpdvt_mt_ntnu_tpu_torch.serve.quant_gate \
        --checkpoint artifacts/waves3_r5_step10000.manifest.json \
        --image-size 192 --grid 3 --quant int8 --out gate.json
"""

from __future__ import annotations

import argparse
import json
import os


_OVERRIDE_MAP = {
    # repo-style key=value overrides (the syntax every other CLI here uses)
    "model.name": "--model", "model.image_size": "--image-size",
    "task.grid_size": "--grid", "eval.checkpoint": "--checkpoint",
    "model.quant": "--quant", "serve.quant_gate_out": "--out",
    "serve.quant_gate_n": "--n", "serve.quant_gate_tol": "--tol",
}


def _translate_overrides(argv):
    """Accept `model.name=JPDVT eval.checkpoint=...` alongside flags."""
    out = []
    for a in argv:
        key, eq, val = a.partition("=")
        if eq and key in _OVERRIDE_MAP:
            out += [_OVERRIDE_MAP[key], val]
        else:
            out.append(a)
    return out


def main(argv=None) -> int:
    import sys

    argv = _translate_overrides(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="artifact manifest, flattened-params .npz, or a checkpoint "
                        "directory of this package")
    p.add_argument("--model", default="JPDVT")
    p.add_argument("--image-size", type=int, default=192)
    p.add_argument("--grid", type=int, default=3)
    p.add_argument("--quant", default="int8",
                   help="quant mode to validate (int8 | int8:K)")
    p.add_argument("--n", type=int, default=32,
                   help="synthetic wave puzzles to compare")
    p.add_argument("--tol", type=float, default=0.02,
                   help="max patch-level disagreement fraction")
    p.add_argument("--out", default="", help="write the report JSON here")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    a = p.parse_args(argv)

    from .service import PuzzleService, ServiceConfig

    try:
        svc = PuzzleService(ServiceConfig(
            model_name=a.model, checkpoint=a.checkpoint,
            image_size=a.image_size, grid_size=a.grid, quant=a.quant,
            quant_gate="warn", quant_gate_n=a.n, quant_gate_tol=a.tol,
            sampler_mode="fast"), device=a.device)
        report = svc.quant_gate_report
    except Exception as e:  # restore/compile failures are gate failures too
        report = {"error": str(e), "passed": False, "quant": a.quant}
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0 if report and report.get("passed") else 1


if __name__ == "__main__":
    raise SystemExit(main())
