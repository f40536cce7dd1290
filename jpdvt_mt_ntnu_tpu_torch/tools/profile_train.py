"""Where a train step's time goes on the card.

Runs train steps of ``JPDVT`` (default: the flagship at 192 px, 3x3;
``--image-size 320 --grid 20`` the grid-20 geometry, N = 400; bf16
compute, fp32 parameters, AdamW + EMA with warmup, ``t_bias`` 2; weights
random from a seed: the time does not depend on them) on device-streamed
waves, under ``torch.profiler``, and prints one JSON line: the wall time
of a step, the device time summed over its kernels by group (K1, K2, K4,
K5, K6, GEMM, optimizer, other), the device's idle share, the kernel
count, the step's time without the profiler and its peak memory. Beside
``tools/profile_solve.py``.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.profile_train [--batch 96] [--steps 3] \
        [--image-size 320 --grid 20]

Needs a CUDA card; it fails without one.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .profile_solve import _group as _solve_group


def _group(name: str) -> str:
    if "attention_bwd_" in name:  # attention_bwd_{dq,dkv}_mma_kernel in bf16, _kernel<float>
        return "k2_attention_bwd"
    if "flash_dq_" in name:  # flash_dq_mma_kernel in bf16, flash_dq_kernel<float> in fp32
        return "k5_flash_dq"
    if "flash_dkv_" in name:  # flash_dkv_mma_kernel, flash_dkv_kernel<float>
        return "k6_flash_dkv"
    if "multi_tensor_apply" in name or "foreach" in name.lower():
        return "optimizer_foreach"
    return _solve_group(name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--image-size", type=int, default=192)
    ap.add_argument("--grid", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from ..core.diffusion import create_diffusion
    from ..data import SyntheticPuzzles
    from ..models import create_model
    from ..train import TrainTask, create_train_state, make_optimizer, make_train_step
    from ..utils.pos_embed import grid_code

    torch.backends.cuda.matmul.allow_tf32 = False
    size, grid = args.image_size, args.grid
    model, cfg = create_model("JPDVT", size, dtype=torch.bfloat16, seed=args.seed)
    state = create_train_state(model)
    task = TrainTask(grid_size=grid, block_size=size // grid, patch_size=16,
                     ema_warmup=True, t_bias=2.0)
    step = make_train_step(create_diffusion(""), make_optimizer(1e-4), task,
                           torch.as_tensor(grid_code(8, grid), device="cuda"),
                           seed=args.seed)
    ds = SyntheticPuzzles(size, n=9600, hard_frac=0.25)
    batches = [ds.device_batch(range(i * args.batch, (i + 1) * args.batch))
               for i in range(args.steps + 2)]
    for x in batches[:2]:  # warm
        step(state, x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for x in batches[2:]:
        step(state, x)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in batches[2:]:
            step(state, x)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    groups: dict[str, float] = {}
    names: dict[str, float] = {}
    count = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.time_range.elapsed_us() / 1e3 / args.steps
        count += 1
        groups[_group(evt.name)] = groups.get(_group(evt.name), 0.0) + ms
        names[evt.name] = names.get(evt.name, 0.0) + ms
    if not count:
        raise RuntimeError("the profiler recorded no device kernel")
    busy = sum(groups.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "batch": args.batch,
        "image_size": size, "grid": grid, "tokens": cfg.num_tokens,
        "steps": args.steps, "step_ms_without_profiler": plain_ms,
        "peak_gib": peak_gib,
        "step_wall_ms_under_profiler": wall_ms, "device_ms_per_step": busy,
        "idle_share": 1 - busy / wall_ms, "kernels_per_step": count / args.steps,
        "device_ms_by_group": groups,
        "top_kernels_ms": [[n[:90], ms] for n, ms in top]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
