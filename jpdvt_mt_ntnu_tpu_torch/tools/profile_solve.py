"""Where a puzzle solve's time goes on the card.

Runs fast and faithful solves of the flagship (``JPDVT`` at 192 px, 3x3,
bf16, weights random from a seed: the time does not depend on them) under
``torch.profiler`` and prints one JSON line: per mode, the wall time of a
solve, the device time summed over its kernels by group (K1, K3, GEMM,
other), the device's idle share, the kernel count, and the time of the
parameter cast that the solver makes once and keeps. Counterpart of the
JAX package's ``tools/profile_step.py``.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.profile_solve [--batch 32] [--attn-impl block]

Needs a CUDA card; it fails without one.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def _group(name: str) -> str:
    if "attention_fwd_kernel" in name:
        return "k1_attention"
    if "block_attention_kernel" in name or "out_proj_kernel" in name:
        return "k3_attention_block"
    if "flash_fwd_kernel" in name:
        return "k4_flash_fwd"
    low = name.lower()
    if any(tag in low for tag in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "gemm"
    return "other"


def profile_mode(solver, x, perms) -> dict:
    """Wall and device time of one warm ``evaluate``, kernels grouped."""
    from torch.profiler import ProfilerActivity, profile

    solver.evaluate(x, perms)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.evaluate(x, perms)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups: dict[str, float] = {}
    names: dict[str, float] = {}
    count = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        count += 1
        groups[_group(evt.name)] = groups.get(_group(evt.name), 0.0) + us / 1e3
        names[evt.name] = names.get(evt.name, 0.0) + us / 1e3
    if not count:
        raise RuntimeError("the profiler recorded no device kernel")
    busy = sum(groups.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1 - busy / wall_ms,
            "kernels": count, "device_ms_by_group": groups,
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-impl", default=None, choices=["pallas", "flash", "block"],
                    help="model.attn_impl (default: the automatic route, K1 here)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_solve needs a CUDA card")
    from ..core.diffusion import create_diffusion
    from ..data import SyntheticPuzzles
    from ..eval.solver import PuzzleSolver
    from ..models import create_model
    from ..ops.jigsaw import random_permutations

    model, cfg = create_model("JPDVT", 192, dtype=torch.bfloat16, seed=args.seed,
                              attn_impl=args.attn_impl)
    x = SyntheticPuzzles(192, n=args.batch, seed=7).batch()
    perms = random_permutations(args.batch, 9, generator=torch.Generator().manual_seed(
        args.seed)).numpy()
    out = {"device": torch.cuda.get_device_name(0), "batch": args.batch,
           "attn_impl": args.attn_impl}
    for mode in ("fast", "faithful"):
        solver = PuzzleSolver(model, cfg, create_diffusion("250"), mode=mode,
                              seed=args.seed)
        out[mode] = profile_mode(solver, x, perms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        solver._cast = (None, None)  # drop the kept copy: time the cast itself
        solver._cast_params()
    torch.cuda.synchronize()
    out["cast_params_ms"] = 1e3 * (time.perf_counter() - t0) / 10
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
