"""One rank of a gloo group on the CPU running the train step on a data x fsdp x model mesh.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_mesh_worker.py <out.npz> <weights.npz> <data> <fsdp> <model> [ckpt dir]

joins the group as torchrun's ranks do, cuts the state of a 48 px DiT
(depth 2, hidden 64, 4 heads, fp32) by ``parallel/sharding.py``'s layout and
runs every case of :data:`CASES` (fp32, and one in bf16, whose FSDP path
casts the gathered weights) for 3 steps on the same global batches as
``tests/torch_parallel_worker.py``, writing to ``out.npz`` the per-step
metrics, the whole state gathered after the last step, this rank's shards of
a few leaves, how many weights the FSDP Linears gathered again for their
backward and the largest tensor their autograd nodes saved. With a
checkpoint directory, rank 0 writes the first case's final state there
through ``CheckpointManager``. The test runs :func:`run_case` with no layout
in its own process as the one-process reference. It imports torch, numpy
and the port only.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import torch_parallel_worker as dpw
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.parallel import MeshSpec, maybe_initialize_distributed, rank_rows
from jpdvt_mt_ntnu_tpu_torch.parallel import sharding
from jpdvt_mt_ntnu_tpu_torch.parallel.sharding import make_layout
from jpdvt_mt_ntnu_tpu_torch.train import (CheckpointManager, TrainTask, create_train_state,
                                           make_optimizer, make_train_step)
from jpdvt_mt_ntnu_tpu_torch.utils.pos_embed import grid_code

MODEL = dict(depth=2, hidden_size=64, num_heads=4)
# name -> (grad_accum, global-norm clip, injected draws, compute type)
CASES = {"injected": (1, None, True, torch.float32),
         "clip_accum2": (2, 0.05, False, torch.float32),
         "bf16": (1, None, False, torch.bfloat16)}
SHARD_LEAVES = ("blocks.0.attn.qkv.weight", "blocks.0.attn.qkv.bias", "blocks.1.mlp.fc2.weight",
                "blocks.0.adaLN_modulation.weight", "x_embedder.weight", "final_layer.linear.bias")


def run_case(name: str, weights: dict, dp=None, spec: MeshSpec | None = None,
             ckpt: str | None = None) -> dict:
    accum, clip, inject, dtype = CASES[name]
    model, _ = create_model("JPDVT", dpw.SIZE, device="cpu", dtype=dtype, **MODEL)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    state = create_train_state(model)
    layout = make_layout(spec, dp, model) if spec is not None else None
    if layout is not None:
        layout.shard_(state)
    task = TrainTask(grid_size=dpw.GRID, block_size=dpw.SIZE // dpw.GRID, patch_size=16,
                     ema_warmup=True)
    diffusion = create_diffusion("", device="cpu")
    if inject:
        diffusion = dpw.Injected(diffusion, accum)
    step = make_train_step(diffusion, make_optimizer(dpw.LR, grad_clip=clip), task,
                           torch.as_tensor(grid_code(8, dpw.GRID)), grad_accum=accum,
                           dp=dp, layout=layout)
    parts, index = (layout.batch_size, layout.batch_index) if layout else (1, 0)
    rows = rank_rows(dpw.B, index, parts, accum)
    regathered, saved = [], [0]
    backward = sharding._GatheredLinear.backward

    def counting(ctx, g):  # the weights gathered again, and what was saved
        regathered.append(int(ctx.needs_input_grad[0]))
        saved[0] = max([saved[0]] + [t.numel() for t in ctx.saved_tensors[1:]])
        return backward(ctx, g)

    sharding._GatheredLinear.backward = staticmethod(counting)
    out: dict = {k: [] for k in ("loss", "code_mse", "img_mse", "grad_norm")}
    try:
        for s in range(dpw.STEPS):
            state, metrics = step(state, torch.from_numpy(dpw.images(s)[rows]))
            for k in out:
                out[k].append(float(metrics[k]))
    finally:
        sharding._GatheredLinear.backward = staticmethod(backward)
    res = {k: np.asarray(v) for k, v in out.items()}
    sd = state.state_dict()  # gathered where the state is sharded
    for part in ("model", "ema"):
        res.update({f"{part}.{k}": v.detach().numpy().copy() for k, v in sd[part].items()})
    for part in ("mu", "nu"):
        res.update({f"{part}.{k}": v.detach().numpy().copy() for k, v in sd["opt"][part].items()})
    if layout is not None:
        local = dict(state.model.named_parameters())
        res.update({f"shard.{k}": local[k].detach().numpy().copy() for k in SHARD_LEAVES})
        res["regathered"] = np.asarray(sum(regathered))
        res["saved_weight"] = np.asarray(saved[0])
    if ckpt is not None:
        CheckpointManager(ckpt, dp=dp).save(state)
    return res


def main(argv) -> None:
    out_path, weights_path, data, fsdp, model = argv[:5]
    torch.set_num_threads(2)
    dp = maybe_initialize_distributed(device="cpu")
    spec = MeshSpec(data=int(data), fsdp=int(fsdp), model=int(model))
    with np.load(weights_path) as z:
        weights = dict(z)
    res = {}
    for i, name in enumerate(CASES):
        ckpt = argv[5] if len(argv) > 5 and i == 0 else None
        res.update({f"{name}/{k}": v for k, v in run_case(name, weights, dp, spec,
                                                          ckpt).items()})
    np.savez(out_path, **res)
    dp.close()


if __name__ == "__main__":
    main(sys.argv[1:])
