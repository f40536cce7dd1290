"""Train-step throughput: ms a step and images/s of the port's training step.

Counterpart of ``tools/bench_train.py``. Times the whole step (jigsaw
shuffle, q-sample, forward, backward, AdamW + EMA) of ``--model`` at
``--image-size`` and ``--grid`` in bf16 on a batch of zeros (the time
does not depend on the data): steps run back to back (each updates the
state the next reads) and one ``torch.cuda.synchronize()`` closes the
window. ``--image-size 320 --grid 20`` runs the grid-20 geometry on the
flash kernels K4-K6; grid 3 runs K1 and K2.

The JAX tool times two optimizer paths, its fused AdamW + EMA and an optax
chain. The port has one, the foreach ``fused_adamw_ema``
(``train/state.py``); its line says so, and ``--only optax`` is refused.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.bench_train [--steps 50] [--batch 96] \\
        [--model JPDVT] [--image-size 192] [--grid 3] [--attn block] [--device cpu]

Prints one JSON line. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..core.diffusion import create_diffusion
from ..models import create_model
from ..ops import attention as attn_ops
from ..ops import flash_attention as flash_ops
from ..train import TrainTask, create_train_state, make_optimizer, make_train_step
from ..utils.device import default_device, describe_device, synchronize
from ..utils.pos_embed import grid_code

# The kernels a train step may launch, by the launch counter of their wrapper.
COUNTERS = {"k1": attn_ops.attention, "k2": attn_ops.attention_bwd,
            "k3": attn_ops.fused_attention_block, "k4": flash_ops.flash_attention_fwd,
            "k5": flash_ops.flash_dq, "k6": flash_ops.flash_dkv}


def bench(args, device: torch.device, **overrides) -> dict:
    """The JSON object of ``args``' configuration on ``device``."""
    model, cfg = create_model(args.model, args.image_size, device=device,
                              dtype=torch.bfloat16, attn_impl=args.attn, **overrides)
    task = TrainTask(grid_size=args.grid, block_size=args.image_size // args.grid,
                     patch_size=cfg.patch_size)
    step = make_train_step(create_diffusion("", device=device),
                           make_optimizer(lr=1e-4, weight_decay=0.0), task,
                           torch.as_tensor(grid_code(cfg.code_dim, args.grid), device=device))
    state = create_train_state(model)
    batch = torch.zeros((args.batch, args.image_size, args.image_size, 3),
                        dtype=torch.bfloat16, device=device)
    for _ in range(4):  # warm
        step(state, batch)
    synchronize(device)
    before = {k: fn.launches for k, fn in COUNTERS.items()}
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(state, batch)
    synchronize(device)
    dt = time.perf_counter() - t0
    return {
        "optimizer_path": "fused_adamw_ema",
        "optax_chain": "no counterpart: the port has one optimizer path",
        "ms_per_step": round(dt / args.steps * 1e3, 2),
        "steps_per_sec": round(args.steps / dt, 2),
        "imgs_per_sec": round(args.steps * args.batch / dt, 1),
        "params_m": round(sum(p.numel() for p in model.parameters()) / 1e6, 1),
        "batch": args.batch,
        "launches_per_step": {k: (fn.launches - before[k]) / args.steps
                              for k, fn in COUNTERS.items()},
        "device": describe_device(device),
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--model", default="JPDVT")
    p.add_argument("--image-size", type=int, default=192)
    p.add_argument("--grid", type=int, default=3)
    p.add_argument("--only", choices=["fused", "optax"], default=None)
    # None = the automatic route (ops/attention.attention_route).
    p.add_argument("--attn", default=None, choices=[None, "pallas", "flash", "block"])
    p.add_argument("--device", default=None, help="default: the card")
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    if args.only == "optax":
        p.error("the port has no optax chain: its one optimizer path is fused_adamw_ema")
    print(json.dumps(bench(args, default_device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
