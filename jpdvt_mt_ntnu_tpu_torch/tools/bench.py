"""Headline benchmark: faithful-250 puzzles/s on one card, 3x3 at 192 px.

Counterpart of the JAX package's root ``bench.py``. Runs the flagship
``JPDVT`` (131M parameters, weights random from seed 0: the time does not
depend on them) in bf16 with the parity sampler, the full 250-step
faithful reverse diffusion (reference image_model/inference.py:281-290,
~0.8 puzzles/s on the baseline GPU at batch 1), at batch 32 (``--full``:
32, 64 and 128, the best reported), and beside it the one-step fast solve
back to back at batch 128. Each timed window ends in
``torch.cuda.synchronize()``. The MFU counts
:func:`faithful_flops_per_puzzle` (analytic, as the JAX bench counts it)
against the H100 SXM data sheet's dense bf16 peak, 989 TFLOP/s.

Prints ONE JSON line with the JAX bench's keys and ``device``, the card's
name and power limit as ``nvidia-smi`` gives them::

    {"metric": "puzzles_per_sec_per_chip", "value": N, "unit": "puzzles/s",
     "vs_baseline": N / 0.8, "config": ..., "fast_mode_equivalent": ...,
     "mfu": ..., "device": "NVIDIA H100 80GB HBM3, 700.00 W"}

    python -m jpdvt_mt_ntnu_tpu_torch.tools.bench [--full] [--device cpu]

Runs on the card unless ``--device cpu``; progress goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..core.diffusion import create_diffusion
from ..eval.solver import PuzzleSolver
from ..models import create_model
from ..utils.device import default_device, describe_device, synchronize

BASELINE_PUZZLES_PER_SEC = 0.8  # BASELINE.md row 1: 1.25 s/img, batch 1
STEPS = 250
IMAGE_SIZE = 192
GRID = 3
H100_BF16_PEAK = 989e12  # FLOP/s, dense, H100 SXM data sheet (700 W)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build(mode: str, batch: int, device: torch.device, steps: int = STEPS,
          image_size: int = IMAGE_SIZE, **overrides) -> tuple[PuzzleSolver, torch.Tensor]:
    """A seed-0 bf16 flagship (``overrides`` replace config fields) with its
    ``mode`` solver, and a batch of random images on ``device``."""
    overrides.setdefault("dtype", torch.bfloat16)
    model, cfg = create_model("JPDVT", image_size, device=device, **overrides)
    solver = PuzzleSolver(model, cfg, create_diffusion(str(steps), device=device),
                          grid_size=GRID, mode=mode, device=device)
    x = torch.randn((batch, image_size, image_size, 3),
                    generator=torch.Generator(device).manual_seed(1), device=device)
    return solver, x


def throughput(solver: PuzzleSolver, x: torch.Tensor, iters: int = 3) -> float:
    """Puzzles/s of ``evaluate`` (scramble, solve, score) after a warm call."""
    res = solver.evaluate(x)
    synchronize(solver.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        res = solver.evaluate(x)
    synchronize(solver.device)
    dt = (time.perf_counter() - t0) / iters
    assert res.pred.shape == (x.shape[0], solver.pieces)
    return x.shape[0] / dt


def pipelined(solver: PuzzleSolver, x_scrambled: torch.Tensor, iters: int) -> float:
    """Puzzles/s of ``iters`` back-to-back solves of scrambled images, one
    synchronise at the end (the serving-relevant rate of short solves);
    the caller has run a solve of these shapes first."""
    synchronize(solver.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        solver.solve_codes(x_scrambled)
    synchronize(solver.device)
    return x_scrambled.shape[0] / ((time.perf_counter() - t0) / iters)


def faithful_flops_per_puzzle(cfg, steps: int = STEPS) -> float:
    """Analytic bf16 FLOPs of one faithful solve (dense matmuls + attention;
    elementwise ignored), as the JAX bench counts them (``bench.py:83-104``).
    The condition embedding is hoisted out of the loop, so it counts once;
    each of the ``steps`` model calls counts the full DiT stack on N tokens."""
    n, d = cfg.num_tokens, cfg.hidden_size
    m = int(cfg.mlp_ratio * d)
    pd = cfg.patch_dim
    per_fwd = (
        2 * n * cfg.code_dim * d            # code_in
        + 2 * 256 * d + 2 * d * d           # t_embedder MLP
        + cfg.depth * (
            2 * n * d * 3 * d               # qkv
            + 4 * n * n * d                 # scores + weighted sum
            + 2 * n * d * d                 # proj
            + 2 * (2 * n * d * m)           # mlp fc1+fc2
            + 2 * d * 6 * d)                # adaLN
        + 2 * n * d * pd + 2 * d * 2 * d    # final layer
        + 2 * n * (pd * cfg.code_head_hidden
                   + cfg.code_head_hidden * cfg.code_dim))
    return steps * per_fwd + 2 * n * pd * d  # + one condition embed


def run(device: torch.device, batches=(32,), fast_batch: int = 128, steps: int = STEPS,
        iters: int = 3, fast_iters: int = 20, **overrides) -> dict:
    """The bench's JSON object on ``device`` (``overrides`` shrink the
    model for a run on the CPU)."""
    best, best_batch, flops = 0.0, 0, None
    for batch in batches:
        solver, x = build("faithful", batch, device, steps, **overrides)
        flops = faithful_flops_per_puzzle(solver.cfg, steps)
        tp = throughput(solver, x, iters)
        log(f"faithful {steps}-step batch={batch}: {tp:.2f} puzzles/s")
        if tp > best:
            best, best_batch = tp, batch
        del solver, x
    solver, x = build("fast", fast_batch, device, steps, **overrides)
    solver.solve_codes(x)  # warm
    fast_tp = pipelined(solver, x, fast_iters)
    log(f"fast-equivalent batch={fast_batch} (back to back): {fast_tp:.1f} puzzles/s")
    mfu = best * flops / H100_BF16_PEAK
    log(f"MFU (faithful): {mfu:.1%} of the H100's dense bf16 peak "
        f"({flops / 1e12:.2f} TFLOP/puzzle)")
    size = overrides.get("image_size", IMAGE_SIZE)
    return {
        "metric": "puzzles_per_sec_per_chip",
        "value": round(best, 3),
        "unit": "puzzles/s",
        "vs_baseline": round(best / BASELINE_PUZZLES_PER_SEC, 2),
        "config": f"3x3@{size}, {steps}-step faithful, batch {best_batch}, "
                  f"{str(solver.cfg.dtype).removeprefix('torch.')}",
        "fast_mode_equivalent": round(fast_tp, 1),
        "mfu": round(mfu, 4),
        "device": describe_device(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="sweep batches 32, 64 and 128")
    ap.add_argument("--device", default=None, help="default: the card")
    a = ap.parse_args(argv)
    device = default_device(a.device)
    log(f"device={describe_device(device)}")
    print(json.dumps(run(device, (32, 64, 128) if a.full else (32,))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
