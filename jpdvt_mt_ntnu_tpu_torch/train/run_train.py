"""CLI training loop, on one card or as one rank of a data-parallel run.

Counterpart of ``jpdvt_mt_ntnu_tpu/train/run_train.py``, with the same
``section.field=value`` overrides:

    python -m jpdvt_mt_ntnu_tpu_torch.train.run_train \\
        data.synthetic_cues=waves data.device_stream=true \\
        data.synthetic_hard_frac=0.25 train.ema_warmup=true train.t_bias=2.0 \\
        train.warm_start=artifacts/waves3_r5_step10000.manifest.json \\
        train.epochs=1 data.synthetic_n=960 train.exp_dir=results/run

On N processes, one rank each (``parallel/mesh.py`` names the launchers it
reads and the backend rule):

    python -m torch.distributed.run --nproc_per_node N \\
        -m jpdvt_mt_ntnu_tpu_torch.train.run_train ...

or the same command in each process with ``mesh.coordinator=host:port
mesh.num_processes=N mesh.process_id=<rank>``. ``data.global_batch_size``
stays the global batch: each rank takes its rows of it and the ranks
average their gradients, so N ranks train what one process would, up to
summation order. Rank 0 picks the exp dir and writes the logs, metrics,
``step_anchor.json`` and checkpoints; the others wait for its writes and
read the same files.

Every axis of the JAX package's mesh is ported (``parallel/``): the N
ranks are pipe x data x fsdp x ep x seq x model, ``pipe`` outermost and
``model`` innermost, as the JAX mesh places its devices:

    python -m torch.distributed.run --nproc_per_node 4 \\
        -m jpdvt_mt_ntnu_tpu_torch.train.run_train mesh.model=2 mesh.fsdp=2 ...

The batch is cut over data x fsdp (the ranks of a pipe, ep, seq or model
group take the same rows). ``mesh.model`` cuts the DiT blocks' four
matrices (qkv by heads, so each rank's attention kernels run on its own
heads) and the experts' hidden features; ``mesh.fsdp`` every matrix of
the params, the EMA and the moments, gathered block by block for the
forward and again for the backward (``parallel/sharding.py``);
``mesh.ep`` the MoE's experts (``model.name=JPDVT-MoE``); ``mesh.pipe``
the blocks into GPipe stages of ``mesh.pipe_microbatches`` microbatches
(``parallel/pipeline.py``); ``mesh.seq`` each puzzle's tokens, with the
attention as a ring (``parallel/sequence.py``). Checkpoints are written
whole, in the one-process layout, and a resume cuts them anew for its own
mesh. The axes compose as the JAX trainer's do: ``mesh.pipe`` with
``model`` or ``fsdp`` (each stage's blocks cut by TP or FSDP), ``mesh.seq``
with ``model`` (the ring on each rank's heads) or ``ep`` (the MoE on the
gathered sequence). ``model.attn_impl=block`` under ``mesh.model``,
``mesh.fsdp`` or ``mesh.seq`` takes the default route, and says so in the
log. Refused by name, before any weights load: ``mesh.pipe`` with ``seq``
or ``ep``, on which the JAX trainer fails (:data:`COMPOSITIONS_REFUSED`).

A fresh start, ``train.resume=<checkpoint dir>`` and ``train.warm_start=``
(an artifact manifest/npz, or a checkpoint directory of this package) are
supported. The run runs on the card; ``device=cpu`` (an argument without a
section) runs it on the CPU instead. ``model.attn_impl`` takes None
(auto), ``pallas`` (the whole-row kernels K1/K2, at every N: in fp32 past
their whole-row instances' shared memory, their streaming ones), ``flash``
(K4-K6), ``block`` (K3 forward, its backward by autograd of the plain
version, as the JAX package leaves it to XLA), ``xla`` and ``xla_split``
(K1 forward, autograd of the JAX package's plain XLA attention backward),
and the JAX aliases ``xla2``, ``interpret`` and ``block_interpret``
(``ops.attention.ATTN_ALIASES``); ``ring`` is ``mesh.seq``'s, refused by
name as a setting. ``task.multi_grid=3,4,6`` cycles one
step per grid; ``data.device_cache`` keeps the whole set on the card (on
each rank's card, one host only), ``device_cache_augment`` rolls and flips
its batches;
``model.matmul_precision`` sets float32 products (``utils/device.py``).
``data.dataset`` takes ``synthetic`` (every cue regime; ``coords`` is the
default), ``met``, ``texmet`` or an image folder (``data.data_path``);
``model.name=JPDVT-MoE`` and ``model.moe_experts`` train the expert-choice
MoE (``models/moe.py``). Not ported yet, and refused with
``NotImplementedError`` where their keys are set, before any weights load:
the two mesh compositions above, ``data.device_stream`` for anything but
``waves`` (as in JAX), ``model.quant`` (the JAX trainer trains dense), the other attention
routes, and any geometry that no attention kernel takes
(``ops.attention.attention_route``). Datasets decode PNG and JPEG with the
port's own decoder on every machine (``ops/native.py``).

SIGTERM/SIGINT: the loop finishes its step, saves a checkpoint and exits
with code 42 (``PREEMPTED_EXIT``) for a wrapper to relaunch with
``train.resume``. The ranks agree on the stop at every step, so a signal
to any one of them stops all at the same step.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.diffusion import create_diffusion
from ..data import ImageFolderDataset, Loader, METDataset, SyntheticPuzzles, TEXMETDataset
from ..data.synthetic import CUES
from ..models import DIT_CONFIGS, create_model
from ..ops.attention import attention_route, attn_impl_refusal
from ..parallel import DataParallel, MeshSpec, maybe_initialize_distributed, rank_rows
from ..parallel.sharding import MeshRanks, make_layout
from ..tools.weights import load_artifact
from ..utils.config import Config, apply_overrides, split_device
from ..utils.device import MATMUL_PRECISION, apply_matmul_precision
from ..utils.logging import MetricWriter, auto_experiment_dir, rank0_logger
from ..utils.pos_embed import grid_code
from .checkpoint import CheckpointManager
from .state import create_train_state, make_optimizer
from .steps import TrainTask, make_train_step
from .validate import Validator, jax_draws

# Exit code signalling "preempted after a clean checkpoint".
PREEMPTED_EXIT = 42


def build_datasets(cfg: Config):
    """(train, validation) sets of ``data.dataset`` (JAX ``run_train.py:41-70``):
    ``met`` and ``texmet`` at their train and val splits, ``synthetic`` (any
    cue regime; validation: 128 items at seed 7), and otherwise an image
    folder at ``data.data_path`` (288 px under ``task.crop``, as the
    reference's ImageNet trainer), which validates on its own items."""
    d, size = cfg.data, cfg.model.image_size
    load_size = 288 if cfg.task.crop else size
    if d.dataset == "met":
        return METDataset(d.data_path, "train"), METDataset(d.data_path, "val")
    if d.dataset == "texmet":
        return (TEXMETDataset(d.data_path, "train", size),
                TEXMETDataset(d.data_path, "val", size))
    if d.dataset == "synthetic":
        cues = d.synthetic_cues or None
        return (SyntheticPuzzles(load_size, n=d.synthetic_n,
                                 position_cues=d.synthetic_position_cues, cues=cues,
                                 hard_frac=d.synthetic_hard_frac),
                SyntheticPuzzles(load_size, n=128, seed=7,
                                 position_cues=d.synthetic_position_cues, cues=cues))
    train = ImageFolderDataset(d.data_path, load_size)
    if not len(train):
        raise ValueError(f"data.dataset={d.dataset!r}: data.data_path={d.data_path!r} holds "
                         "no .jpg, .jpeg or .png file")
    return train, train


# The mesh compositions the port does not run, because the JAX trainer fails
# on them: its pipeline stage builds each block without the ring's mesh or
# the MoE's experts (jpdvt_mt_ntnu_tpu/parallel/pipeline.py:147-153).
COMPOSITIONS_REFUSED = {
    ("pipe", "seq"): "the JAX trainer's pipeline stage builds its blocks with the ring but no "
                     "seq mesh and fails (AttributeError: 'NoneType' object has no attribute "
                     "'shape')",
    ("pipe", "ep"): "the JAX trainer's pipeline stage builds its blocks without moe_experts, "
                    "looks for a dense MLP and fails (ScopeParamNotFoundError: no parameter "
                    "\"kernel\" in \"/mlp/fc1\")",
}


def check_supported(cfg: Config, on_card: bool = True) -> None:
    """Raise ``NotImplementedError`` for every set key the port cannot run,
    and for a model whose attention no kernel takes (``on_card``: the
    kernels' limits; the CPU's plain versions take any head dim)."""
    m, d, mesh = cfg.model, cfg.data, cfg.mesh
    refused = [f"mesh.{a} with mesh.{b} ({why})" for (a, b), why in COMPOSITIONS_REFUSED.items()
               if getattr(mesh, a) > 1 and getattr(mesh, b) > 1]
    if d.dataset == "synthetic":
        cues = d.synthetic_cues or ("coords" if d.synthetic_position_cues else "none")
        if cues not in CUES:
            refused.append(f"data.synthetic_cues={cues!r} (the regimes are {CUES})")
        elif d.device_stream and cues != "waves":
            refused.append(f"data.device_stream with data.synthetic_cues={cues!r} (device "
                           "generation is waves-only, as in the JAX package)")
    elif d.device_stream:
        refused.append(f"data.device_stream with data.dataset={d.dataset!r} (device "
                       "generation is waves-only, as in the JAX package)")
    if m.quant:
        refused.append("model.quant (the JAX trainer does not read it and trains dense)")
    if attn_impl_refusal(m.attn_impl):
        refused.append(attn_impl_refusal(m.attn_impl))
    elif m.name in DIT_CONFIGS:
        arch = {**DIT_CONFIGS[m.name], **m.overrides()}
        dtype = torch.bfloat16 if m.compute_dtype == "bfloat16" else torch.float32
        try:  # the train step's route; the no-grad validation then fits too
            attention_route((m.image_size // arch["patch_size"]) ** 2, dtype, True,
                            m.attn_impl, head_dim=arch["hidden_size"] // arch["num_heads"],
                            on_card=on_card)
        except ValueError as e:
            refused.append(f"the attention of model.image_size={m.image_size}: {e}")
    if m.matmul_precision not in MATMUL_PRECISION:
        refused.append(f"model.matmul_precision={m.matmul_precision!r} (the port takes "
                       f"{sorted(k for k in MATMUL_PRECISION if k)})")
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


def main(argv=None, device: str | torch.device | None = None) -> int:
    argv, cli_device = split_device(sys.argv[1:] if argv is None else argv)
    cfg = apply_overrides(Config(), argv)
    device = device if device is not None else cli_device
    check_supported(cfg, on_card=torch.device(device or "cuda").type == "cuda")
    precision = apply_matmul_precision(cfg.model.matmul_precision)
    dp = maybe_initialize_distributed(cfg.mesh, device)
    code = train(cfg, dp, precision)
    dp.close()
    return code


def train(cfg: Config, dp: DataParallel, precision: str = "highest") -> int:
    """The run of ``main`` on this process's rank of ``dp``."""
    device, is_main = dp.device, dp.is_main
    if cfg.data.device_cache and not cfg.data.device_stream and dp.local_world < dp.world:
        raise NotImplementedError(
            "data.device_cache across hosts: each rank stages the whole set on its own card, "
            "which the JAX trainer does on one host only; use the loader or "
            "data.device_stream for a multi-host run")
    exp_dir = None
    if is_main:
        exp_dir = cfg.train.exp_dir or auto_experiment_dir(
            cfg.train.results_dir, cfg.data.dataset, cfg.model.name,
            crop=cfg.task.crop, with_mask=cfg.task.add_mask)
        os.makedirs(exp_dir, exist_ok=True)
    exp_dir = dp.broadcast(exp_dir)
    logger = rank0_logger(is_main, exp_dir)
    writer = MetricWriter(exp_dir, use_wandb=cfg.train.wandb,
                          run_name=exp_dir.split("/")[-1], config=cfg.to_dict(),
                          tags=[cfg.model.name, cfg.data.dataset,
                                f"grid{cfg.task.grid_size}"], is_main=is_main)
    logger.info(f"Config:\n{cfg.to_json()}")
    procs = {**dp.describe(), "matmul_precision": precision}
    logger.info(f"Processes: {json.dumps(procs)}")

    # The data first: a missing split file fails before the model is built.
    d = cfg.data
    train_ds, val_ds = build_datasets(cfg)
    logger.info(f"Data: {d.dataset} ({type(train_ds).__name__}), {len(train_ds)} train items, "
                f"{len(val_ds)} validation items")
    # Each rank's rows of every global batch (None: all of them), cut over
    # the batch's data x fsdp shards.
    mesh_spec = MeshSpec.from_config(cfg.mesh)
    ranks = MeshRanks.from_spec(mesh_spec, dp.world)
    rows = (rank_rows(d.global_batch_size, ranks.batch_index(dp.rank), ranks.batch_size,
                      cfg.train.grad_accum) if ranks.batch_size > 1 else None)
    loader = Loader(train_ds, d.global_batch_size, shuffle=True,
                    seed=cfg.train.global_seed, num_workers=d.num_workers, rows=rows)

    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    size = cfg.model.image_size
    model, model_cfg = create_model(cfg.model.name, size, device=device,
                                    seed=cfg.train.global_seed, dtype=dtype,
                                    attn_impl=cfg.model.attn_impl, **cfg.model.overrides())
    # Multi-grid: the DiT is grid-agnostic, so one parameter set trains on
    # several grids, one step per grid, cycled per training step (JAX
    # run_train.py:183-208).
    grids = ([int(g) for g in str(cfg.task.multi_grid).split(",") if g]
             if cfg.task.multi_grid else [cfg.task.grid_size])
    toks = size // model_cfg.patch_size
    for g in grids:
        if size % g or toks % g:
            raise SystemExit(f"task grid {g} must divide image_size ({size}) and "
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
    ckpt = CheckpointManager(cfg.train.resume or os.path.join(exp_dir, "checkpoints"), dp=dp)
    ema_anchor = 0
    if cfg.train.resume:
        if ckpt.latest_step() is None:
            raise FileNotFoundError(
                f"train.resume={cfg.train.resume!r} contains no checkpoints "
                "- refusing to silently restart from scratch")
        ckpt.restore(state)
        logger.info(f"Resumed from step {state.step}")
    elif cfg.train.warm_start:
        ws = cfg.train.warm_start
        src = warm_start(state, ws, device)
        if state.step == 0 and ws.endswith((".json", ".npz")):
            logger.warning(f"warm start {ws} reads step 0")
        ema_anchor = state.step
        logger.info(f"Warm-started from {ws} [{src}] at step {ema_anchor} "
                    "(EMA reset to params, warmup re-armed)")
    # Every rank built or read the same state; hold it to that.
    dp.check_replicas(state.tensors(), "the train state")
    if dp.world > 1:
        logger.info(f"The train state is bit-equal on all {dp.world} ranks at step {state.step}")
    # Then each rank keeps its shards of it, on a mesh with more axes than data.
    layout = make_layout(mesh_spec, dp, state.model, cfg.mesh.pipe_microbatches)
    if ranks.seq > 1:
        logger.info(f"mesh.seq={ranks.seq}: attention = ring (sequence parallel)")
    if layout is not None:
        layout.shard_(state)
        held = sum(t.numel() for t in state.tensors()[1:])
        logger.info(f"Mesh: {json.dumps(layout.mesh.describe)}; this rank holds {held} of "
                    f"the state's {4 * n_params} elements (params, EMA, moments)")

    # train.epochs is a TOTAL budget from this run's anchor step, persisted
    # in the exp dir beside the EMA warmup anchor, so that a resume
    # recomputes the same target and keeps a warm start's EMA warmup.
    if is_main:
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
    else:
        start_anchor = None
    start_anchor, ema_anchor = dp.broadcast((start_anchor, ema_anchor))

    def make_task(g: int) -> TrainTask:
        return TrainTask(grid_size=g, block_size=size // g,
                         patch_size=model_cfg.patch_size, add_mask=cfg.task.add_mask,
                         shared_perm=cfg.task.shared_perm, ema_decay=cfg.train.ema_decay,
                         ema_warmup=cfg.train.ema_warmup, ema_anchor=ema_anchor,
                         crop_pieces=size // g if cfg.task.crop else None,
                         t_bias=cfg.train.t_bias)

    grid_steps = [make_train_step(diffusion, optimizer, make_task(g),
                                  torch.as_tensor(grid_code(model_cfg.code_dim, g),
                                                  device=device),
                                  grad_accum=cfg.train.grad_accum,
                                  seed=cfg.train.global_seed, dp=dp, layout=layout)
                  for g in grids]

    # The JAX validator's own puzzles where they are committed (grid 3 at
    # 192 px, grid 20 at 320 px), else the port's draws. Every rank
    # validates, as every JAX host does; rank 0 logs.
    validators = {g: Validator(model_cfg, grid_size=g,
                               sampling_steps=cfg.diffusion.sampling_steps,
                               sampler_mode=cfg.diffusion.sampler_mode,
                               crop_pieces=size // g if cfg.task.crop else None,
                               device=device, **jax_draws(g, model_cfg.num_tokens))
                  for g in grids}

    cached = None
    if d.device_cache and not d.device_stream:  # the stream takes precedence, as in JAX
        # The whole set on the card, bf16 (JAX run_train.py:386-405):
        # synthesised there for waves, else made on the host and copied.
        if getattr(train_ds, "cues", None) == "waves":
            cached = train_ds.device_generate_all(device)
        else:
            with ThreadPoolExecutor(max(4, d.num_workers)) as pool:
                stack = np.stack(list(pool.map(train_ds.__getitem__, range(len(train_ds)))))
            cached = torch.from_numpy(stack).to(device, torch.bfloat16)
            del stack
        logger.info(f"device-cached dataset: {tuple(cached.shape)} "
                    f"({cached.numel() * cached.element_size() / 1e6:.0f} MB bf16 on {device})")

    # Stream cursor in items: item index = step * batch, so a resumed run
    # continues the never-repeating stream where its checkpoint stopped.
    stream_pos = state.step * d.global_batch_size

    def epoch_batches(epoch: int):
        nonlocal stream_pos
        b = d.global_batch_size
        if d.device_stream:
            for _ in range(max(1, len(loader))):
                lo, stream_pos = stream_pos, stream_pos + b
                yield train_ds.device_batch(
                    range(lo, lo + b) if rows is None else (lo + rows).tolist(), device)
            return
        if cached is not None:
            yield from cached_batches(cached, b, cfg.train.global_seed, epoch,
                                      d.device_cache_augment, rows)
            return
        loader.set_epoch(epoch)
        for batch in loader:
            yield torch.from_numpy(batch).to(device, non_blocking=True)

    steps_per_epoch = max(1, len(loader))
    target_steps = start_anchor + cfg.train.epochs * steps_per_epoch
    logger.info(f"Training for {cfg.train.epochs} epochs, {steps_per_epoch} "
                f"steps/epoch (anchor {start_anchor}, target step {target_steps})")

    def validate(tag: str) -> dict:
        model_ = state.ema if tag == "ema" else state.model
        if layout is not None:  # under the pipeline, gathered from every stage
            model_ = layout.whole(model_)
        out = {}
        for g, v in validators.items():
            m = v(model_, val_ds)
            out.update(m if len(grids) == 1 else {f"{k}_g{g}": x for k, x in m.items()})
        return out

    meta = {"config": cfg.to_dict(), "grids": grids}
    writer.log({f"process_{k}": v for k, v in procs.items()}, state.step)
    # Losses stay on the device until the log boundary.
    step = loop_start_step = state.step
    loop_start = time.perf_counter()
    window_losses: list = []
    window_start = time.time()
    val_every = cfg.train.val_every or cfg.train.ckpt_every
    stop = False  # the stop the ranks agreed on
    with _PreemptionGuard() as guard:
        for epoch in range(cfg.train.epochs):
            if stop or step >= target_steps:
                break
            for batch in epoch_batches(epoch):
                if step >= target_steps:
                    break
                if dp.any(guard.preempted):
                    stop = True
                    break
                state, metrics = grid_steps[step % len(grid_steps)](state, batch)
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
                    ckpt.save(state, metadata={**meta, "step": step})
                    logger.info(f"Saved checkpoint at step {step}")
                if step % val_every == 0:
                    val = validate("ema")
                    raw = {f"raw_{k}": v for k, v in validate("raw").items()}
                    logger.info(f"Validation: {val} | raw: {raw}")
                    writer.log({**val, **raw}, step)
                    window_losses.clear()
                    window_start = time.time()
        preempted = dp.any(stop or guard.preempted)
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
    ckpt.save(state, metadata={**meta, "step": step,
                               "preempted" if preempted else "final": True})
    if preempted:
        logger.info(f"Preempted: checkpoint saved at step {step}")
        writer.finish(summary={"preempted_at_step": step, **loop})
        return PREEMPTED_EXIT
    val = validate("ema")
    logger.info(f"Final validation: {val}")
    writer.finish(summary={**val, **loop})
    return 0


def warm_start(state, ws: str, device) -> str:
    """Seed ``state`` from ``train.warm_start=ws``, before any mesh cuts it:
    params carry over, and the EMA belongs to the old run and is reset to
    them. The step counter carries over, so the stream cursor and the step
    budget continue where the donor stopped. Returns where it came from."""
    if ws.endswith((".json", ".npz")):
        # A durable artifact holds EMA weights only: the optimizer starts
        # fresh; the step comes from the manifest.
        sd, ws_step = load_artifact(ws, device=device)
        try:
            state.model.load_state_dict(sd, strict=True)
        except RuntimeError as e:
            raise SystemExit(f"train.warm_start={ws!r} does not fit the model: {e}") from e
        del sd
        state.step = ws_step
        if ws_step == 0:
            warnings.warn(
                f"train.warm_start={ws!r} records no training step (a bare "
                ".npz reads as step 0): the data stream cursor, the EMA "
                "warmup anchor and the step budget restart from 0. Point "
                "at the artifact's .manifest.json to continue its stream.",
                stacklevel=2)
        src = "artifact, params-only, fresh optimizer"
    else:
        warm = CheckpointManager(ws)
        if warm.latest_step() is None:
            raise FileNotFoundError(f"train.warm_start={ws!r} contains no checkpoints")
        warm.restore(state)
        src = "checkpoint"
    state.ema.load_state_dict(state.model.state_dict())
    return src


def cached_batches(data: torch.Tensor, batch: int, seed: int, epoch: int,
                   augment: bool, rows=None):
    """One epoch of ``data.device_cache`` (JAX run_train.py:434-447): the
    order of ``default_rng(seed * 100003 + epoch)``, ``len // batch``
    batches; with ``augment`` each batch is rolled by (dy, dx) over its
    rows and columns and flipped left-right, then up-down, each with
    probability 1/2, drawn from the same generator in that order. Every
    rank holds the whole set and draws alike; ``rows`` (None: all) are this
    rank's of each global batch. The roll and the flips act within an
    image, so the ranks' rows together are one process's batch."""
    rng = np.random.default_rng(seed * 100003 + epoch)
    perm = torch.as_tensor(rng.permutation(data.shape[0]), device=data.device)
    mine = None if rows is None else torch.as_tensor(np.asarray(rows), device=data.device)
    for i in range(data.shape[0] // batch):
        idx = perm[i * batch:(i + 1) * batch]
        x = data[idx if mine is None else idx[mine]]
        if augment:
            h = x.shape[1]
            dy, dx = int(rng.integers(0, h)), int(rng.integers(0, h))
            fh, fv = rng.random() < 0.5, rng.random() < 0.5
            x = torch.roll(x, (dy, dx), dims=(1, 2))
            if fh:
                x = x.flip(2)
            if fv:
                x = x.flip(1)
        yield x


if __name__ == "__main__":
    raise SystemExit(main())
