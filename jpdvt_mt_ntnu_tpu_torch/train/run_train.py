"""CLI training loop on one card.

Counterpart of ``jpdvt_mt_ntnu_tpu/train/run_train.py``, with the same
``section.field=value`` overrides:

    python -m jpdvt_mt_ntnu_tpu_torch.train.run_train \\
        data.synthetic_cues=waves data.device_stream=true \\
        data.synthetic_hard_frac=0.25 train.ema_warmup=true train.t_bias=2.0 \\
        train.warm_start=artifacts/waves3_r5_step10000.manifest.json \\
        train.epochs=1 data.synthetic_n=960 train.exp_dir=results/run

A fresh start, ``train.resume=<checkpoint dir>`` and ``train.warm_start=``
(an artifact manifest/npz, or a checkpoint directory of this package) are
supported. The run runs on the card; ``device=cpu`` (an argument without a
section) runs it on the CPU instead. ``model.attn_impl`` takes None
(auto), ``pallas`` (the whole-row kernels K1/K2) or ``flash`` (K4-K6);
``block`` (K3) runs the eval path only and is refused here. Not
ported yet, and refused with ``NotImplementedError`` where their keys are
set, before any weights load: the mesh (data, tensor, FSDP, pipeline,
expert and sequence parallelism, multi-host), ``task.multi_grid``,
``data.device_cache``, datasets other than the synthetic ``waves``, MoE and
int8 models, the other attention routes, and any geometry that no
attention kernel takes (``ops.attention.attention_route``).

SIGTERM/SIGINT: the loop finishes its step, saves a checkpoint and exits
with code 42 (``PREEMPTED_EXIT``) for a wrapper to relaunch with
``train.resume``.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import warnings

import torch

from ..core.diffusion import create_diffusion
from ..data import Loader, SyntheticPuzzles
from ..models import DIT_CONFIGS, create_model
from ..ops.attention import ATTN_IMPLS, attention_route
from ..tools.weights import load_artifact
from ..utils.config import Config, apply_overrides
from ..utils.device import default_device
from ..utils.logging import MetricWriter, auto_experiment_dir, rank0_logger
from ..utils.pos_embed import grid_code
from .checkpoint import CheckpointManager
from .state import create_train_state, make_optimizer
from .steps import TrainTask, make_train_step
from .validate import Validator, jax_draws

# Exit code signalling "preempted after a clean checkpoint".
PREEMPTED_EXIT = 42


def check_supported(cfg: Config, on_card: bool = True) -> None:
    """Raise ``NotImplementedError`` for every set key the port cannot run,
    and for a model whose attention no kernel takes (``on_card``: the
    kernels' limits; the CPU's plain versions take any head dim)."""
    m, t, d, mesh = cfg.model, cfg.task, cfg.data, cfg.mesh
    refused = []
    if mesh.data not in (-1, 1) or any(getattr(mesh, k) != 1 for k in
                                       ("model", "fsdp", "pipe", "ep", "seq")):
        refused.append("mesh parallelism (mesh.data/model/fsdp/pipe/ep/seq)")
    if mesh.pipe_microbatches:
        refused.append("mesh.pipe_microbatches")
    if (mesh.distributed == "force" or mesh.coordinator or mesh.num_processes
            or mesh.process_id >= 0):
        refused.append("multi-host training (mesh.distributed/coordinator/...)")
    if t.multi_grid:
        refused.append("task.multi_grid")
    if d.device_cache or d.device_cache_augment:
        refused.append("data.device_cache")
    if d.dataset != "synthetic":
        refused.append(f"data.dataset={d.dataset!r} (only 'synthetic' is ported)")
    elif (d.synthetic_cues or ("coords" if d.synthetic_position_cues else "none")) != "waves":
        refused.append("synthetic cue regimes other than data.synthetic_cues=waves")
    if m.quant or m.moe_experts or m.moe_capacity:
        refused.append("model.quant / model.moe_*")
    if m.attn_impl == "block":
        refused.append("model.attn_impl='block' for training (K3, the fused sublayer, "
                       "runs the eval path; its training route is queued in ROADMAP.md)")
    elif m.attn_impl not in ATTN_IMPLS:
        refused.append(f"model.attn_impl={m.attn_impl!r} (the port runs {ATTN_IMPLS})")
    elif m.name in DIT_CONFIGS:
        arch = {**DIT_CONFIGS[m.name], **m.overrides()}
        dtype = torch.bfloat16 if m.compute_dtype == "bfloat16" else torch.float32
        try:  # the train step's route; the no-grad validation then fits too
            attention_route((m.image_size // arch["patch_size"]) ** 2, dtype, True,
                            m.attn_impl, head_dim=arch["hidden_size"] // arch["num_heads"],
                            on_card=on_card)
        except ValueError as e:
            refused.append(f"the attention of model.image_size={m.image_size}: {e}")
    if m.matmul_precision not in (None, "highest"):
        refused.append("model.matmul_precision other than 'highest'")
    if refused:
        raise NotImplementedError("not ported yet: " + "; ".join(refused))


class _PreemptionGuard:
    """SIGTERM/SIGINT request a clean stop: the loop finishes its step,
    saves, and exits with ``PREEMPTED_EXIT``. Handlers are restored on exit."""

    def __init__(self):
        self.flag = threading.Event()
        self._prev: dict = {}
        self._enabled = threading.current_thread() is threading.main_thread()

    def __enter__(self):
        if self._enabled:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, lambda *_: self.flag.set())
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        return False

    @property
    def preempted(self) -> bool:
        return self.flag.is_set()


def _split_device(argv) -> tuple[list[str], str | None]:
    device, rest = None, []
    for item in argv:
        if item.lstrip("-").startswith("device="):
            device = item.split("=", 1)[1]
        else:
            rest.append(item)
    return rest, device


def main(argv=None, device: str | torch.device | None = None) -> int:
    argv, cli_device = _split_device(sys.argv[1:] if argv is None else argv)
    cfg = apply_overrides(Config(), argv)
    device = device if device is not None else cli_device
    check_supported(cfg, on_card=torch.device(device or "cuda").type == "cuda")
    device = default_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    exp_dir = cfg.train.exp_dir or auto_experiment_dir(
        cfg.train.results_dir, cfg.data.dataset, cfg.model.name,
        crop=cfg.task.crop, with_mask=cfg.task.add_mask)
    os.makedirs(exp_dir, exist_ok=True)
    logger = rank0_logger(True, exp_dir)
    writer = MetricWriter(exp_dir, use_wandb=cfg.train.wandb,
                          run_name=exp_dir.split("/")[-1], config=cfg.to_dict(),
                          tags=[cfg.model.name, cfg.data.dataset,
                                f"grid{cfg.task.grid_size}"])
    logger.info(f"Config:\n{cfg.to_json()}")

    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    size, grid = cfg.model.image_size, cfg.task.grid_size
    model, model_cfg = create_model(cfg.model.name, size, device=device,
                                    seed=cfg.train.global_seed, dtype=dtype,
                                    attn_impl=cfg.model.attn_impl, **cfg.model.overrides())
    toks = size // model_cfg.patch_size
    if size % grid or toks % grid:
        raise SystemExit(f"task grid {grid} must divide image_size ({size}) and "
                         f"tokens/side ({toks})")
    diffusion = create_diffusion(cfg.diffusion.timestep_respacing,
                                 cfg.diffusion.noise_schedule,
                                 cfg.diffusion.predict_xstart,
                                 cfg.diffusion.sigma_small, device=device)
    optimizer = make_optimizer(cfg.train.lr, cfg.train.weight_decay, cfg.train.grad_clip)
    state = create_train_state(model)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"{cfg.model.name}: {n_params / 1e6:.1f}M params on {device}")

    if cfg.train.resume and cfg.train.warm_start:
        raise SystemExit(
            "train.resume and train.warm_start are mutually exclusive: "
            "resume continues a run in place; warm_start seeds a NEW run "
            "(fresh exp_dir checkpoints, EMA reset, warmup re-armed)")
    ckpt = CheckpointManager(cfg.train.resume or os.path.join(exp_dir, "checkpoints"))
    ema_anchor = 0
    if cfg.train.resume:
        if ckpt.latest_step() is None:
            raise FileNotFoundError(
                f"train.resume={cfg.train.resume!r} contains no checkpoints "
                "- refusing to silently restart from scratch")
        ckpt.restore(state)
        logger.info(f"Resumed from step {state.step}")
    elif cfg.train.warm_start:
        # Params carry over; the EMA belongs to the old run and is reset to
        # them, with the warmup re-armed at the restored step. The step
        # counter carries over, so the stream cursor and the step budget
        # continue where the donor stopped.
        ws = cfg.train.warm_start
        if ws.endswith((".json", ".npz")):
            # A durable artifact holds EMA weights only: the optimizer
            # starts fresh; the step comes from the manifest.
            sd, ws_step = load_artifact(ws, device=device)
            try:
                state.model.load_state_dict(sd, strict=True)
            except RuntimeError as e:
                raise SystemExit(f"train.warm_start={ws!r} does not fit the "
                                 f"model: {e}") from e
            del sd
            state.step = ws_step
            if ws_step == 0:
                warnings.warn(
                    f"train.warm_start={ws!r} records no training step (a bare "
                    ".npz reads as step 0): the data stream cursor, the EMA "
                    "warmup anchor and the step budget restart from 0. Point "
                    "at the artifact's .manifest.json to continue its stream.",
                    stacklevel=1)
                logger.warning(f"warm start {ws} reads step 0")
            src = "artifact, params-only, fresh optimizer"
        else:
            warm = CheckpointManager(ws)
            if warm.latest_step() is None:
                raise FileNotFoundError(f"train.warm_start={ws!r} contains no checkpoints")
            warm.restore(state)
            src = "checkpoint"
        state.ema.load_state_dict(state.model.state_dict())
        ema_anchor = state.step
        logger.info(f"Warm-started from {ws} [{src}] at step {ema_anchor} "
                    "(EMA reset to params, warmup re-armed)")

    # train.epochs is a TOTAL budget from this run's anchor step, persisted
    # in the exp dir beside the EMA warmup anchor, so that a resume
    # recomputes the same target and keeps a warm start's EMA warmup.
    anchor_path = os.path.join(exp_dir, "step_anchor.json")
    if os.path.exists(anchor_path):
        with open(anchor_path) as f:
            anchors = json.load(f)
        start_anchor = int(anchors["start_step"])
        if cfg.train.resume:  # an anchor file from before the key reads as 0
            ema_anchor = int(anchors.get("ema_anchor", 0))
    else:
        start_anchor = state.step
        with open(anchor_path, "w") as f:
            json.dump({"start_step": start_anchor, "ema_anchor": ema_anchor}, f)

    task = TrainTask(grid_size=grid, block_size=size // grid,
                     patch_size=model_cfg.patch_size, add_mask=cfg.task.add_mask,
                     shared_perm=cfg.task.shared_perm, ema_decay=cfg.train.ema_decay,
                     ema_warmup=cfg.train.ema_warmup, ema_anchor=ema_anchor,
                     crop_pieces=size // grid if cfg.task.crop else None,
                     t_bias=cfg.train.t_bias)
    piece_code = torch.as_tensor(grid_code(model_cfg.code_dim, grid), device=device)
    train_step = make_train_step(diffusion, optimizer, task, piece_code,
                                 grad_accum=cfg.train.grad_accum,
                                 seed=cfg.train.global_seed)

    d = cfg.data
    load_size = 288 if cfg.task.crop else size
    train_ds = SyntheticPuzzles(load_size, n=d.synthetic_n, cues="waves",
                                hard_frac=d.synthetic_hard_frac)
    val_ds = SyntheticPuzzles(load_size, n=128, seed=7, cues="waves")
    loader = Loader(train_ds, d.global_batch_size, shuffle=True,
                    seed=cfg.train.global_seed, num_workers=d.num_workers)
    # The JAX validator's own puzzles where they are committed (grid 3 at
    # 192 px, grid 20 at 320 px), else the port's draws.
    validator = Validator(model_cfg, grid_size=grid,
                          sampling_steps=cfg.diffusion.sampling_steps,
                          sampler_mode=cfg.diffusion.sampler_mode,
                          crop_pieces=size // grid if cfg.task.crop else None,
                          device=device, **jax_draws(grid, model_cfg.num_tokens))

    # Stream cursor in items: item index = step * batch, so a resumed run
    # continues the never-repeating stream where its checkpoint stopped.
    stream_pos = state.step * d.global_batch_size

    def epoch_batches(epoch: int):
        nonlocal stream_pos
        if d.device_stream:
            b = d.global_batch_size
            for _ in range(max(1, len(loader))):
                lo, stream_pos = stream_pos, stream_pos + b
                yield train_ds.device_batch(range(lo, lo + b), device)
            return
        loader.set_epoch(epoch)
        for batch in loader:
            yield torch.from_numpy(batch).to(device, non_blocking=True)

    steps_per_epoch = max(1, len(loader))
    target_steps = start_anchor + cfg.train.epochs * steps_per_epoch
    logger.info(f"Training for {cfg.train.epochs} epochs, {steps_per_epoch} "
                f"steps/epoch (anchor {start_anchor}, target step {target_steps})")

    def validate(tag: str) -> dict:
        return validator(state.ema if tag == "ema" else state.model, val_ds)

    # Losses stay on the device until the log boundary.
    step = loop_start_step = state.step
    loop_start = time.perf_counter()
    window_losses: list = []
    window_start = time.time()
    val_every = cfg.train.val_every or cfg.train.ckpt_every
    with _PreemptionGuard() as guard:
        for epoch in range(cfg.train.epochs):
            if guard.preempted or step >= target_steps:
                break
            for batch in epoch_batches(epoch):
                if guard.preempted or step >= target_steps:
                    break
                state, metrics = train_step(state, batch)
                window_losses.append(metrics["loss"])
                step = state.step
                if step % cfg.train.log_every == 0:
                    avg = float(torch.stack(window_losses).mean())  # sync point
                    dt = time.time() - window_start
                    sps = len(window_losses) / dt if dt > 0 else 0.0
                    logger.info(f"(step={step:08d}) Train Loss: {avg:.4f}, "
                                f"Train Steps/Sec: {sps:.2f}")
                    writer.log({"train_loss": avg, "steps_per_sec": sps,
                                "epoch": epoch}, step)
                    window_losses.clear()
                    window_start = time.time()
                if step % cfg.train.ckpt_every == 0:
                    ckpt.save(state, metadata={"config": cfg.to_dict(), "step": step})
                    logger.info(f"Saved checkpoint at step {step}")
                if step % val_every == 0:
                    val = validate("ema")
                    raw = {f"raw_{k}": v for k, v in validate("raw").items()}
                    logger.info(f"Validation: {val} | raw: {raw}")
                    writer.log({**val, **raw}, step)
                    window_losses.clear()
                    window_start = time.time()
    preempted = guard.preempted
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # End to end: every image of the loop over its whole wall time, data,
    # logging and in-loop checkpoints and validations included.
    loop_s = time.perf_counter() - loop_start
    images = (step - loop_start_step) * d.global_batch_size
    loop = {"loop_images": images, "loop_s": loop_s,
            "train_images_per_s": images / loop_s if loop_s > 0 else 0.0}
    logger.info(f"Loop: {images} images in {loop_s:.3f} s, "
                f"{loop['train_images_per_s']:.1f} images/s")
    ckpt.save(state, metadata={"config": cfg.to_dict(), "step": step,
                               "preempted" if preempted else "final": True})
    if preempted:
        logger.info(f"Preempted: checkpoint saved at step {step}")
        writer.finish(summary={"preempted_at_step": step, **loop})
        return PREEMPTED_EXIT
    val = validate("ema")
    logger.info(f"Final validation: {val}")
    writer.finish(summary={**val, **loop})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
