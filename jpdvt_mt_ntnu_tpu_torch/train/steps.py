"""The training step.

Counterpart of ``jpdvt_mt_ntnu_tpu/train/steps.py``: timestep draw, jigsaw
shuffle/mask, q-sampling, forward, loss, backward, AdamW and EMA
(reference: image_model/train_JPDVT.py:335-372). The JAX package traces
this into one jitted program; here it runs eagerly, and the DiT's attention
runs forward through K1 and backward through K2 on the card.

Randomness: every step draws from a generator seeded from (seed, step), the
counterpart of ``fold_in(rng, state.step)``, so a resumed run draws what an
uninterrupted one would without storing generator state. Across processes
each rank draws for the global batch and keeps its rows, and the ranks
average their gradients (``make_train_step``'s ``dp``, or its ``layout`` on
a mesh with more axes than data), where the JAX package's step shards one
program's batch over a mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.diffusion import Diffusion
from ..ops import jigsaw
from ..parallel.mesh import DataParallel
from ..parallel.sharding import Layout
from .state import AdamW, TrainState, fused_adamw_ema


@dataclasses.dataclass(frozen=True)
class TrainTask:
    """Static description of the jigsaw training task (JAX ``TrainTask``).

    Matches the reference's training_losses call site
    (train_JPDVT.py:357-367): block_size = image_size // grid,
    patch_size = model patch, one shared permutation per batch.
    ``ema_warmup`` ramps the EMA decay as min(ema_decay, (1+s)/(10+s)) with
    s counted from ``ema_anchor`` (a warm start re-arms it at its step).
    ``t_bias`` > 0 skews the timestep draw toward high t as
    t = min(int(T * u^(1/(1+bias))), T-1); 0 is the reference's uniform
    draw."""

    grid_size: int = 3
    block_size: int = 64
    patch_size: int = 16
    add_mask: bool = False
    shared_perm: bool = True
    ema_decay: float = 0.9999
    ema_warmup: bool = False
    ema_anchor: int = 0
    crop_pieces: int | None = None
    t_bias: float = 0.0


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step, seeded from (seed, step)."""
    return torch.Generator(device).manual_seed((int(seed) << 32) + int(step))


def timesteps_from_uniform(u: torch.Tensor, num_timesteps: int,
                           t_bias: float) -> torch.Tensor:
    """The biased timestep draw (JAX ``steps.py:134-141``): u in [0, 1),
    float32 -> min(int(T * u^(1/(1+bias))), T-1)."""
    t = (num_timesteps * u.float() ** (1.0 / (1.0 + t_bias))).to(torch.int32)
    return torch.clamp(t, max=num_timesteps - 1).long()


def draw_timesteps(batch: int, num_timesteps: int, t_bias: float,
                   generator: torch.Generator) -> torch.Tensor:
    """(B,) spaced timesteps: uniform (the reference's torch.randint,
    train_JPDVT.py:354), or skewed by ``t_bias``."""
    if t_bias > 0:
        u = torch.rand((batch,), generator=generator, device=generator.device)
        return timesteps_from_uniform(u, num_timesteps, t_bias)
    return torch.randint(0, num_timesteps, (batch,), generator=generator,
                         device=generator.device)


def ema_decay_at(task: TrainTask, step: int):
    """The EMA decay of the update that takes ``step`` to ``step + 1``:
    ``task.ema_decay``, or with the warmup min(ema_decay, (1+s)/(10+s)),
    s = step + 1 - anchor, in float32 as the JAX step computes it."""
    if not task.ema_warmup:
        return task.ema_decay
    s = np.float32(step + 1 - task.ema_anchor)
    return min(np.float32(task.ema_decay), (np.float32(1.0) + s) / (np.float32(10.0) + s))


def _global_norm(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def make_train_step(diffusion: Diffusion, optimizer: AdamW, task: TrainTask,
                    piece_code: torch.Tensor, *, grad_accum: int = 1,
                    seed: int = 0, dp: DataParallel | None = None,
                    layout: Layout | None = None) -> Callable:
    """Build ``train_step(state, images) -> (state, metrics)``.

    images: (B, H, W, C) clean images in [-1, 1] (float32 or bfloat16), or
    uint8 in [0, 255]; both are brought to float32. The step updates
    ``state`` in place and returns it. ``grad_accum`` > 1 runs the
    forward/backward over that many microbatches of B/grad_accum samples
    and applies one update on the mean gradient; each parameter's ``.grad``
    holds that mean after the step. Metrics ``loss``, ``code_mse``,
    ``img_mse`` and ``grad_norm`` (before any clip) stay on the device as
    0-dim tensors, so that a caller reads them without a sync per step.

    ``dp``: this process's rank of a data-parallel run
    (``parallel.DataParallel``). ``images`` are then the rank's rows of
    the global batch (``parallel.rank_rows``: each microbatch cut across
    the ranks), the global batch is ``dp.world`` times theirs, and the step
    equals one process's step on the global batch up to summation order:
    every draw is made for the global batch (or microbatch) and the rank
    keeps its rows, the gradients and the loss metrics are averaged over
    the ranks before the global norm, the clip and AdamW + EMA, so every
    rank ends the step with the same state.

    ``layout``: the state's layout on a mesh with more axes than data
    (``parallel/sharding.py``, which ``state`` was cut by). The batch is then
    cut over data x fsdp only (``layout.batch_index`` and ``batch_size`` in
    place of the rank and the world: the ranks of a pipe, ep, seq or model
    group take the same rows), the gradients and metrics are reduced as the
    layout reduces them, and the global norm sums each leaf once; every rank
    ends the step with its shards of the state one process would hold.
    Under ``mesh.pipe`` the forward and backward run the layout's GPipe
    schedule (``parallel/pipeline.py``), and a leaf a stage did not use
    gets a zero gradient before the reduction.
    """
    dp = dp or DataParallel()
    # This rank's shard of the batch, and their number.
    part_index, parts = ((layout.batch_index, layout.batch_size) if layout is not None
                         else (dp.rank, dp.world))

    def loss_fn(model, images, t, generator, draw_batch, rows):
        out = diffusion.training_losses(
            model, images, t, piece_code, block_size=task.block_size,
            patch_size=task.patch_size, add_mask=task.add_mask,
            grid_size=task.grid_size, shared_perm=task.shared_perm,
            generator=generator, draw_batch=draw_batch, rows=rows)
        return out["loss"].mean(), out

    pipeline = layout.pipeline if layout is not None else None

    def train_step(state: TrainState, images: torch.Tensor):
        model = state.model
        model_fn = model if pipeline is None else (
            lambda x, t, code: pipeline.forward(model, x, t, code))
        device = next(model.parameters()).device
        images = torch.as_tensor(images, device=device)
        if images.dtype == torch.uint8:
            images = images.float() / 127.5 - 1.0
        else:
            images = images.float()
        if task.crop_pieces is not None:
            images = jigsaw.inner_crop_pieces(images, task.grid_size, task.crop_pieces)
        b = images.shape[0] * parts  # the global batch
        if b % (grad_accum * parts):
            raise ValueError(f"batch {b} not divisible by grad_accum={grad_accum}"
                             + (f" x {parts} ranks" if parts > 1 else ""))
        gen = step_generator(seed, state.step, device)
        t = draw_timesteps(b, diffusion.num_timesteps, task.t_bias, gen)

        named = list(model.named_parameters())
        params = [p for _, p in named]
        for p in params:
            p.grad = None
        micro = b // grad_accum
        part = micro // parts  # this rank's rows of each microbatch
        mine = slice(part_index * part, (part_index + 1) * part) if parts > 1 else None
        loss = code_mse = img_mse = 0.0
        # Each fsdp-cut leaf's gradient is reduce-scattered once, after every backward.
        with layout.mesh.deferred_scatter() if layout is not None else contextlib.nullcontext():
            for i in range(grad_accum):
                t_i = t[i * micro:(i + 1) * micro]
                l, aux = loss_fn(model_fn, images[i * part:(i + 1) * part],
                                 t_i if mine is None else t_i[mine], gen, micro, mine)
                if pipeline is None:
                    l.backward()
                else:
                    pipeline.backward(l)
                loss = loss + l.detach()
                code_mse = code_mse + aux["code_mse"].detach().mean()
                img_mse = img_mse + aux["img_mse"].detach().mean()
        for p in params:
            if p.grad is None:  # a leaf of the stem or head on another stage
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if grad_accum > 1:
            torch._foreach_div_(grads, grad_accum)
            loss, code_mse, img_mse = (v / grad_accum for v in (loss, code_mse, img_mse))
        if layout is not None:
            means = torch.stack([loss, code_mse, img_mse])
            layout.reduce_grads_([(n, p.grad) for n, p in named])
            layout.mean_over_batch_(means)
            loss, code_mse, img_mse = means.unbind()
            grad_norm = layout.global_norm([(n, p.grad) for n, p in named])
        else:
            if dp.in_group:
                means = torch.stack([loss, code_mse, img_mse])
                dp.all_reduce_mean_(grads + [means])
                loss, code_mse, img_mse = means.unbind()
            grad_norm = _global_norm(grads)
        if optimizer.grad_clip is not None:
            # optax.clip_by_global_norm: g * clip / norm where norm > clip.
            factor = torch.clamp(optimizer.grad_clip / grad_norm, max=1.0)
            grads = torch._foreach_mul(grads, factor)
        fused_adamw_ema(params, grads, list(state.ema.parameters()), state.opt,
                        lr=optimizer.lr, weight_decay=optimizer.weight_decay,
                        ema_decay=ema_decay_at(task, state.step))
        state.step += 1
        return state, {"loss": loss, "code_mse": code_mse, "img_mse": img_mse,
                       "grad_norm": grad_norm}

    return train_step
