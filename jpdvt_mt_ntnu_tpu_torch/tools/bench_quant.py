"""int8 against bf16 solve throughput.

Counterpart of ``tools/bench_quant.py``. Measures the flagship ``JPDVT``
(131M parameters, N = 144 at 192 px by default; weights random from seed
0) with and without ``model.quant=int8`` (w8a8 products, ``ops/quant.py``)
in the fast one-step and the faithful 250-step samplers: back-to-back
solves of one batch, one ``torch.cuda.synchronize()`` closing the window.
The reference has no quantization (fp32/TF32 throughout, reference
image_model/train_JPDVT.py:5-6).

    python -m jpdvt_mt_ntnu_tpu_torch.tools.bench_quant [--image-size 192] \\
        [--batch 128] [--iters 20] [--faithful-iters 3] [--quants bf16,int8] [--device cpu]

``--faithful-iters 0`` skips the faithful sampler. Prints one JSON line:
puzzles/s per ``<mode>_<quant>``, each quantized one's ratio to bf16, and
the card. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils.device import default_device, describe_device
from .bench import build, pipelined


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(device, image_size: int, batch: int, iters: int, faithful_iters: int, quants,
        **overrides) -> dict:
    rows = {}
    modes = [("fast", iters)] + ([("faithful", faithful_iters)] if faithful_iters else [])
    for mode, n in modes:
        for quant in quants:
            solver, x = build(mode, batch, device, image_size=image_size,
                              quant=None if quant == "bf16" else quant, **overrides)
            solver.solve_codes(x)  # warm: the bf16 copy, the int8 weights
            rows[f"{mode}_{quant}"] = round(pipelined(solver, x, n), 2)
            log(f"{mode:9s} quant={quant:7s}: {rows[f'{mode}_{quant}']:10.2f} puzzles/s")
            del solver, x
    for mode, _ in modes:
        base = rows.get(f"{mode}_bf16")
        for quant in quants:
            if base and quant != "bf16":
                rows[f"{mode}_{quant}_speedup"] = round(rows[f"{mode}_{quant}"] / base, 3)
                log(f"{mode}: {quant} is {rows[f'{mode}_{quant}_speedup']:.2f}x bf16")
    rows["device"] = describe_device(device)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image-size", type=int, default=192)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--faithful-iters", type=int, default=3)
    ap.add_argument("--quants", default="bf16,int8",
                    help="comma list: bf16 | int8 | int8:K (the first K blocks)")
    ap.add_argument("--device", default=None, help="default: the card")
    a = ap.parse_args(argv)
    device = default_device(a.device)
    log(f"device={describe_device(device)} image_size={a.image_size} batch={a.batch}")
    quants = [q.strip() for q in a.quants.split(",") if q.strip()]
    print(json.dumps(run(device, a.image_size, a.batch, a.iters, a.faithful_iters, quants)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
