#!/usr/bin/env python3
"""Drive the PyTorch port's puzzle solve and training on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``; it exits non-zero, printing no result, without them.

Phases, each of which raises on failure:

1. build the CUDA kernels, one ``nvcc`` per source started together
   (``.cu`` -> ``.so`` -> ``ctypes``), and print the card's name and power
   limit;
2. hold kernel K1 (whole-row attention) against its plain PyTorch version
   on the card at the solve's shapes (B=16, 32), the train step's (B=96)
   and ragged ones, and time both beside one PyTorch call of the same
   function (SDPA, a yardstick only);
3. the main path: load ``artifacts/waves3_r5_step10000`` through the
   port's loader, fast-solve and faithful-250-solve the 16 unseen wave
   puzzles of the artifact's export smoke with the JAX package's seed-0
   noise template (``tests/golden``), in bf16, and check the accuracy, the
   kernel's launch count, that faithful and fast agree bit for bit, and
   that a solve on the plain attention gives the same permutations;
4. faithful-250 and fast puzzles/s at batch 32;
5. hold kernel K2 (the whole-row attention backward) against its plain
   version at the training path's shapes and ragged ones, and time it
   beside its bound, the plain version and SDPA's backward (a yardstick);
6. gradients through attention: one ``training_losses`` backward of the
   full-width DiT in fp32 with random weights through K1/K2 against the
   same through the plain attention (torch autograd), every parameter;
7. the training path: warm-start from the artifact (step 10,000) with its
   recorded run's settings, train at batch 96 in bf16 on device-streamed
   waves, check the losses against a freshly initialised model's on the
   same batches, 12 + 12 kernel launches per step, a bit-equal checkpoint
   restore, the EMA model's fast solve of the 16 puzzles; then the
   ``run_train`` CLI: warm start, checkpoint, validate, resume;
8. train images/s at batch 96 and 32 end to end (``run_train`` warm-started
   with the recorded run's settings and cadence: every image of its loop
   over the loop's wall time, data included), and the train step alone
   (ms per synchronised step on one pre-built batch, peak memory).

The last three lines are the ``kernels`` JSON (K1 once for each main path,
the solve and the train step, with that path's launches and shapes), the
card's name and power limit, and the device JSON.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.data import SyntheticPuzzles
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.models import dit
from jpdvt_mt_ntnu_tpu_torch.ops import _build, jigsaw
from jpdvt_mt_ntnu_tpu_torch.ops import attention as attn_ops
from jpdvt_mt_ntnu_tpu_torch.tools.weights import load_artifact
from jpdvt_mt_ntnu_tpu_torch.train import (CheckpointManager, TrainTask,
                                           create_train_state, make_optimizer,
                                           make_train_step, run_train, steps)
from jpdvt_mt_ntnu_tpu_torch.utils.pos_embed import grid_code

REPO = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(REPO, "artifacts", "waves3_r5_step10000.manifest.json")
NOISE_TEMPLATE = os.path.join(REPO, "tests", "golden", "jax_noise_seed0_1x144x8.npy")

# H100 SXM published peaks (NVIDIA data sheet) for the bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# K1's tolerance against its plain version. Both round P and O to bf16 at
# the same points; exp and summation order differ, which can move a
# rounding by one bf16 ulp: 2^-8 relative, ~0.008 at |o| ~ 2 for N(0, 1)
# inputs. fp32 keeps ~1e-6 relative; 1e-4 leaves room for summation order.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# K2's tolerance, relative to each of dq, dk, dv's largest magnitude: the
# kernel and the plain version round dS and the outputs at the same
# points, and a summation order that flips one rounding moves a value by
# one bf16 ulp (2^-8 of its scale). fp32 rounds nothing: summation order.
K2_TOL = {torch.bfloat16: 2 ** -6, torch.float32: 1e-5}
# Phase 6: every parameter gradient with K1/K2 against plain autograd, in
# fp32, relative to that gradient's largest magnitude (summation order
# through twelve blocks; no rounding differs in fp32).
GRAD_TOL = 1e-4
HEADS, HEAD_DIM, TOKENS = 12, 64, 144
STEPS = 250
# The recorded run behind the artifact (logs/waves3_r5_train/run_config.json).
TRAIN_BATCH, TRAIN_STEPS, LR, EMA_DECAY, T_BIAS, HARD_FRAC = 96, 24, 1e-4, 0.9999, 2.0, 0.25
LOSS_RATIO = 0.1  # warm-started mean loss <= this x a fresh model's


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    """``name, power.limit`` of the card, from nvidia-smi (via a file)."""
    with tempfile.TemporaryFile("w+") as out:
        subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], stdout=out,
                       stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
                       timeout=60, check=True)
        out.seek(0)
        return out.read().strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(b: int, h: int, n: int, d: int, dtype: torch.dtype,
             tensors: int = 4, products: int = 2) -> tuple[float, str]:
    """Least time for an attention kernel's work: ``tensors`` (B, H, N, Dh)
    tensors read or written once (K1: q, k, v, o; K2: q, k, v, dO, dq, dk,
    dv), against ``products`` N x N x Dh products' operations."""
    elem = torch.empty((), dtype=dtype).element_size()
    t_bytes = tensors * b * h * n * d * elem / HBM_BYTES_PER_S
    t_ops = 2 * products * b * h * n * n * d / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def qkv_views(b: int, n: int, dtype: torch.dtype, gen: torch.Generator):
    """q, k, v as the DiT hands them to K1: strided views of (B, N, 3*H*Dh)."""
    qkv = torch.randn((b, n, 3 * HEADS * HEAD_DIM), generator=gen, device="cuda").to(dtype)
    return qkv.reshape(b, n, 3, HEADS, HEAD_DIM).permute(2, 0, 3, 1, 4).unbind(0)


def check_k1(b: int, n: int, dtype: torch.dtype, gen: torch.Generator,
             timed: bool) -> dict:
    q, k, v = qkv_views(b, n, dtype, gen)
    out = attn_ops.attention(q, k, v)
    torch.cuda.synchronize()
    ref = attn_ops.attention_reference(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= TOL[dtype]:
        raise AssertionError(f"K1 {(b, HEADS, n, HEAD_DIM)} {dtype}: max abs err "
                             f"{err} > {TOL[dtype]}")
    row = {"shape": [b, HEADS, n, HEAD_DIM], "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err, "tol": TOL[dtype]}
    if timed:
        row["ms"] = cuda_ms(lambda: attn_ops.attention(q, k, v), 200)
        row["plain_ms"] = cuda_ms(lambda: attn_ops.attention_reference(q, k, v), 50)
        row["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v), 200)
        row["bound_ms"], row["bound_by"] = bound_ms(b, HEADS, n, HEAD_DIM, dtype)
    log("K1 " + json.dumps(row))
    return row


def check_k2(b: int, n: int, dtype: torch.dtype, gen: torch.Generator,
             timed: bool) -> dict:
    """K2 on q/k/v views of a fused qkv and dO of a (B, N, H*Dh) gradient,
    writing into one fused gradient buffer, as the train step calls it."""
    q, k, v = qkv_views(b, n, dtype, gen)
    do = torch.randn((b, n, HEADS * HEAD_DIM), generator=gen, device="cuda").to(dtype)
    do = do.view(b, n, HEADS, HEAD_DIM).transpose(1, 2)
    buf = torch.empty((b, n, 3 * HEADS * HEAD_DIM), dtype=dtype, device="cuda")
    out = buf.view(b, n, 3, HEADS, HEAD_DIM).permute(2, 0, 3, 1, 4).unbind(0)
    attn_ops.attention_bwd(q, k, v, do, out=out)
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in zip(("dq", "dk", "dv"), out,
                               attn_ops.attention_bwd_reference(q, k, v, do)):
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= K2_TOL[dtype] * scale:
            raise AssertionError(f"K2 {name} {(b, HEADS, n, HEAD_DIM)} {dtype}: max abs "
                                 f"err {err} > {K2_TOL[dtype]} x {scale}")
        errs[name] = [err, scale]
    row = {"shape": [b, HEADS, n, HEAD_DIM], "dtype": str(dtype).split(".")[-1],
           "max_abs_err": max(e for e, _ in errs.values()), "err_and_scale": errs,
           "rel_tol": K2_TOL[dtype]}
    if timed:
        row["ms"] = cuda_ms(lambda: attn_ops.attention_bwd(q, k, v, do, out=out), 50)
        row["plain_ms"] = cuda_ms(lambda: attn_ops.attention_bwd_reference(q, k, v, do), 10)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(*leaves)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), leaves, do)

        row["library_ms"] = cuda_ms(sdpa_fwd_bwd, 50) - cuda_ms(sdpa_fwd, 50)
        row["bound_ms"], row["bound_by"] = bound_ms(b, HEADS, n, HEAD_DIM, dtype,
                                                    tensors=7, products=5)
    log("K2 " + json.dumps(row))
    return row


@contextlib.contextmanager
def plain_attention():
    """Route the DiT's attention to the plain version for a comparison solve."""
    kernel_route = dit.fused_qkv_attention
    dit.fused_qkv_attention = attn_ops.fused_qkv_attention_reference
    try:
        yield
    finally:
        dit.fused_qkv_attention = kernel_route


def randomize(model: torch.nn.Module, seed: int) -> None:
    """Random weights with every adaLN gate open: N(0, 1/fan_in) matrices,
    N(0, 0.02) biases."""
    gen = torch.Generator("cuda").manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            std = p.shape[1] ** -0.5 if p.dim() == 2 else 0.02
            p.normal_(0.0, std, generator=gen)


def check_gradients() -> dict:
    """Phase 6: every parameter's gradient of one training-loss backward of
    the full-width DiT in fp32, through K1/K2 and through the plain
    attention (torch autograd), on identical injected draws."""
    model, cfg = create_model("JPDVT", 192, seed=0)
    randomize(model, 1)
    diff = create_diffusion("")
    rng = np.random.default_rng(2)
    b = 8
    x = torch.from_numpy(SyntheticPuzzles(192, n=b, seed=3).batch()).cuda()
    t = torch.as_tensor(rng.integers(0, 1000, b), device="cuda")
    inject = {"indices": np.stack([rng.permutation(9) for _ in range(b)]),
              "noise_x": rng.standard_normal((b, 192, 192, 3)).astype(np.float32),
              "noise_c": rng.standard_normal((b, TOKENS, 8)).astype(np.float32)}
    code = torch.as_tensor(grid_code(8, 3), device="cuda")

    def grads():
        model.zero_grad(set_to_none=True)
        out = diff.training_losses(model, x, t, code, block_size=64, patch_size=16,
                                   _inject=inject)
        out["loss"].mean().backward()
        return out["loss"].mean().item(), {k: p.grad.clone() for k, p in
                                           model.named_parameters()}

    k1, k2 = attn_ops.attention.launches, attn_ops.attention_bwd.launches
    loss, mine = grads()
    launched = (attn_ops.attention.launches - k1, attn_ops.attention_bwd.launches - k2)
    with plain_attention():
        loss_plain, plain = grads()
    if launched != (cfg.depth, cfg.depth):
        raise AssertionError(f"K1/K2 launches {launched}, expected {cfg.depth} each")
    worst, worst_name = 0.0, ""
    for name, want in plain.items():
        scale = want.abs().max().item()
        rel = (mine[name] - want).abs().max().item() / scale if scale else 0.0
        if scale == 0 or not rel <= GRAD_TOL:
            raise AssertionError(f"gradient of {name}: rel err {rel}, scale {scale}")
        if rel > worst:
            worst, worst_name = rel, name
    qkv = [mine[f"blocks.{i}.attn.qkv.weight"].abs().max().item() for i in range(cfg.depth)]
    if min(qkv) == 0:
        raise AssertionError(f"a qkv.weight gradient is zero: {qkv}")
    row = {"loss_k1k2": loss, "loss_plain": loss_plain, "params": len(plain),
           "worst_rel_err": worst, "worst_param": worst_name, "rel_tol": GRAD_TOL,
           "min_qkv_weight_grad_max": min(qkv)}
    log("gradients " + json.dumps(row))
    return row


def train_batches(ds: SyntheticPuzzles, first_step: int, count: int, batch: int):
    """The device stream's batches of steps first_step.. (cursor step x batch)."""
    return [ds.device_batch(range(s * batch, (s + 1) * batch), "cuda")
            for s in range(first_step, first_step + count)]


def fresh_losses(diff, task, code, batches, first_step: int) -> list[float]:
    """A freshly initialised model's losses on the steps' own batches and draws."""
    model, _ = create_model("JPDVT", 192, seed=0, dtype=torch.bfloat16)
    out = []
    with torch.no_grad():
        for i, x in enumerate(batches):
            gen = steps.step_generator(0, first_step + i, "cuda")
            t = steps.draw_timesteps(x.shape[0], diff.num_timesteps, task.t_bias, gen)
            res = diff.training_losses(model, x.float(), t, code,
                                       block_size=task.block_size,
                                       patch_size=task.patch_size, generator=gen)
            out.append(res["loss"].mean().item())
    return out


def warm_state(sd, step: int):
    model, cfg = create_model("JPDVT", 192, dtype=torch.bfloat16)
    model.load_state_dict(sd)
    state = create_train_state(model)
    state.step = step
    return state, cfg


def check_training(sd, art_step: int, template: np.ndarray, x16, perms16) -> dict:
    """Phase 7: warm-started training at batch 96, bf16, with the recorded
    run's settings (AdamW 1e-4, wd 0, EMA .9999 with warmup re-armed at
    the artifact's step, t_bias 2, shared permutations, no mask) on
    device-streamed waves (hard_frac 0.25)."""
    state, cfg = warm_state(sd, art_step)
    diff = create_diffusion("")
    task = TrainTask(grid_size=3, block_size=64, patch_size=16, shared_perm=True,
                     ema_decay=EMA_DECAY, ema_warmup=True, ema_anchor=art_step,
                     t_bias=T_BIAS)
    code = torch.as_tensor(grid_code(8, 3), device="cuda")
    train_step = make_train_step(diff, make_optimizer(LR, 0.0), task, code)
    ds = SyntheticPuzzles(192, n=9600, hard_frac=HARD_FRAC)
    batches = train_batches(ds, art_step, TRAIN_STEPS, TRAIN_BATCH)
    attn_ops.attention.launches = attn_ops.attention_bwd.launches = 0
    losses, per_step = [], []
    for x in batches:
        k1, k2 = attn_ops.attention.launches, attn_ops.attention_bwd.launches
        state, metrics = train_step(state, x)
        losses.append(metrics["loss"].item())
        per_step.append((attn_ops.attention.launches - k1,
                         attn_ops.attention_bwd.launches - k2))
        log(f"  train step {state.step}: loss {losses[-1]:.6f}, grad_norm "
            f"{metrics['grad_norm'].item():.4f}, K1/K2 launches {per_step[-1]}")
    launches = (attn_ops.attention.launches, attn_ops.attention_bwd.launches)
    if any(ls != (cfg.depth, cfg.depth) for ls in per_step):
        raise AssertionError(f"K1/K2 launches per step {per_step}, expected "
                             f"{cfg.depth} + {cfg.depth}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    fresh = fresh_losses(diff, task, code, batches, art_step)
    ratio = float(np.mean(losses) / np.mean(fresh))
    log(f"  warm-started mean loss {np.mean(losses):.6f} vs a fresh model's "
        f"{np.mean(fresh):.6f} on the same batches: ratio {ratio:.5f} (limit {LOSS_RATIO})")
    if not ratio <= LOSS_RATIO:
        raise AssertionError(f"warm-started loss ratio {ratio} > {LOSS_RATIO}")

    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        t0 = time.perf_counter()
        mgr.save(state)
        save_s = time.perf_counter() - t0
        other, _ = warm_state(sd, 0)
        t0 = time.perf_counter()
        mgr.restore(other)
        restore_s = time.perf_counter() - t0
    pairs = ([(state.model.state_dict(), other.model.state_dict()),
              (state.ema.state_dict(), other.ema.state_dict()),
              (state.opt.mu, other.opt.mu), (state.opt.nu, other.opt.nu)])
    if not (other.step == state.step and other.opt.count == state.opt.count
            and all(torch.equal(a[k], b[k]) for a, b in pairs for k in a)):
        raise AssertionError("the restored state differs from the saved one")
    del other
    log(f"  checkpoint of step {state.step}: saved in {save_s:.2f} s, restored "
        f"bit-equal in {restore_s:.2f} s")

    solver = PuzzleSolver(state.ema, cfg, create_diffusion("250"), grid_size=3,
                          mode="fast", noise_template=template)
    res = solver.evaluate(x16, perms16)
    log(f"  EMA model after {TRAIN_STEPS} steps: fast solve puzzle acc "
        f"{res.puzzle_accuracy:.4f}, patch acc {res.patch_accuracy:.4f}")
    if res.puzzle_accuracy != 1.0:
        raise AssertionError(f"the EMA model solved {res.puzzle_accuracy} of the 16 puzzles")
    return {"losses": losses, "fresh_losses": fresh, "ratio": ratio,
            "launches": launches, "state": state, "cfg": cfg}


def check_run_train() -> None:
    """The CLI on the card: warm start from the artifact, 10 steps, a
    checkpoint, validation, then a resume that continues to step +20."""
    with tempfile.TemporaryDirectory() as tmp:
        common = ["data.synthetic_cues=waves", "data.device_stream=true",
                  f"data.synthetic_hard_frac={HARD_FRAC}", "data.synthetic_n=960",
                  f"train.t_bias={T_BIAS}", "train.ema_warmup=true", "train.log_every=5",
                  "train.ckpt_every=10", "diffusion.sampler_mode=fast",
                  f"train.exp_dir={tmp}/exp"]
        t0 = time.perf_counter()
        code = run_train.main(common + ["train.epochs=1", f"train.warm_start={ARTIFACT}"])
        ckpt = CheckpointManager(os.path.join(tmp, "exp", "checkpoints"))
        first = ckpt.latest_step()
        code2 = run_train.main(common + ["train.epochs=2",
                                         f"train.resume={tmp}/exp/checkpoints"])
        last = ckpt.latest_step()
        log_txt = open(os.path.join(tmp, "exp", "log.txt")).read()
        metrics = [json.loads(line) for line in
                   open(os.path.join(tmp, "exp", "metrics.jsonl"))]
    vals = [m["summary"] for m in metrics if "summary" in m]
    log(f"  run_train: warm start exit {code} at step {first}, resume exit {code2} "
        f"at step {last}, final validations {vals}, {time.perf_counter() - t0:.1f} s")
    if (code, code2, first, last) != (0, 0, 10010, 10020):
        raise AssertionError(f"run_train: exits {code}/{code2}, checkpoints {first}/{last}")
    if "Resumed from step 10010" not in log_txt or len(vals) != 2:
        raise AssertionError("run_train did not resume from its checkpoint or validate")


def train_loop_throughput(batch: int, steps_: int) -> dict:
    """End to end: ``run_train`` warm-started from the artifact with the
    recorded run's settings and cadence (log every 250 steps, validation
    every 2,500, checkpoint every 5,000), ``steps_`` steps at ``batch`` on
    device-streamed waves; every image of the loop over its wall time,
    data included (the run's summary)."""
    with tempfile.TemporaryDirectory() as tmp:
        code = run_train.main([
            "data.synthetic_cues=waves", "data.device_stream=true",
            f"data.synthetic_hard_frac={HARD_FRAC}", f"data.global_batch_size={batch}",
            f"data.synthetic_n={batch * steps_}", "train.epochs=1",
            f"train.t_bias={T_BIAS}", "train.ema_warmup=true", "train.log_every=250",
            "train.ckpt_every=5000", "train.val_every=2500",
            "diffusion.sampler_mode=fast", f"train.exp_dir={tmp}/exp",
            f"train.warm_start={ARTIFACT}"])
        rows = [json.loads(line) for line in open(os.path.join(tmp, "exp", "metrics.jsonl"))]
    summary = [r["summary"] for r in rows if "summary" in r]
    if code != 0 or len(summary) != 1 or summary[0]["loop_images"] != batch * steps_:
        raise AssertionError(f"run_train at batch {batch}: exit {code}, summary {summary}")
    return {"batch": batch, "steps": steps_, **{k: summary[0][k] for k in
            ("loop_images", "loop_s", "train_images_per_s")}}


def train_throughput(state, batch: int, reps: int = 12) -> dict:
    """The train-step layer: median ms of a synchronised train step on one
    pre-built batch (no data), and every step's time."""
    diff = create_diffusion("")
    task = TrainTask(grid_size=3, block_size=64, patch_size=16, ema_warmup=True,
                     ema_anchor=state.step, t_bias=T_BIAS)
    code = torch.as_tensor(grid_code(8, 3), device="cuda")
    train_step = make_train_step(diff, make_optimizer(LR, 0.0), task, code)
    ds = SyntheticPuzzles(192, n=9600, hard_frac=HARD_FRAC)
    x = ds.device_batch(range(batch), "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        ds.device_batch(range(batch), "cuda")
    torch.cuda.synchronize()
    data_ms = 1e3 * (time.perf_counter() - t0) / 5
    for _ in range(3):
        train_step(state, x)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, x)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    ms = float(np.median(times))
    return {"batch": batch, "ms_per_step": ms, "images_per_s": batch * 1e3 / ms,
            "step_ms_all": times, "device_batch_ms": data_ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def wave_puzzles(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The export smoke's puzzles (tools/export_ckpt.py:213-222)."""
    x = SyntheticPuzzles(192, n=n, seed=seed).batch()
    rng = np.random.default_rng(seed)
    return x, np.stack([rng.permutation(9) for _ in range(n)])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. Build, one nvcc per source, all started together.
    t0 = time.perf_counter()
    lib_paths = _build.build_all("attention", "attention_bwd")
    attn_ops._kernel()
    attn_ops._bwd_kernel()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s -> {[os.path.relpath(p, REPO) for p in lib_paths]}")
    for lib_path in lib_paths:
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "Compiling entry", "spill")):
                log(f"  ptxas: {line.strip()}")

    # 2. K1 against its plain version.
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(0)
    k1_rows = [check_k1(16, TOKENS, torch.bfloat16, gen, timed=True),
               check_k1(32, TOKENS, torch.bfloat16, gen, timed=True),
               check_k1(TRAIN_BATCH, TOKENS, torch.bfloat16, gen, timed=True),
               check_k1(3, 77, torch.bfloat16, gen, timed=False),
               check_k1(2, 200, torch.bfloat16, gen, timed=False),
               check_k1(2, TOKENS, torch.float32, gen, timed=False)]
    log(f"phase k1: {time.perf_counter() - t0:.2f} s")

    # 3. The main path.
    t0 = time.perf_counter()
    attn_ops.attention.launches = attn_ops.attention_bwd.launches = 0
    sd, step = load_artifact(ARTIFACT)
    model, cfg = create_model("JPDVT", 192, dtype=torch.bfloat16)
    model.load_state_dict(sd)
    t_load = time.perf_counter() - t0
    template = np.load(NOISE_TEMPLATE)
    x16, perms16 = wave_puzzles(16, 123)

    def solver(mode: str) -> PuzzleSolver:
        return PuzzleSolver(model, cfg, create_diffusion("250"), grid_size=3,
                            mode=mode, noise_template=template)

    fast, faithful = solver("fast"), solver("faithful")
    res_fast = fast.evaluate(x16, perms16)
    launches_fast = attn_ops.attention.launches
    t1 = time.perf_counter()
    res_faithful = faithful.evaluate(x16, perms16)
    t_faithful16 = time.perf_counter() - t1
    launches_solve = attn_ops.attention.launches
    launches_faithful = launches_solve - launches_fast
    log(f"main path: artifact step {step} loaded in {t_load:.2f} s; faithful-250 "
        f"of 16 in {t_faithful16:.2f} s; K1 launches fast {launches_fast}, "
        f"faithful {launches_faithful}")
    expected = cfg.depth * STEPS  # 16 puzzles are one microbatch
    if launches_faithful != expected or launches_fast != cfg.depth:
        raise AssertionError(f"K1 launches {launches_fast}/{launches_faithful}, "
                             f"expected {cfg.depth}/{expected}")
    for name, res in (("fast", res_fast), ("faithful-250", res_faithful)):
        log(f"  {name}: puzzle acc {res.puzzle_accuracy:.4f}, "
            f"patch acc {res.patch_accuracy:.4f}")
        if res.puzzle_accuracy != 1.0:
            raise AssertionError(f"{name} solved {res.puzzle_accuracy} of the 16 "
                                 "wave puzzles; the artifact's record is 1.00")

    x_scr = jigsaw.scramble(torch.as_tensor(x16, device="cuda"),
                            torch.as_tensor(perms16, device="cuda"), 3)
    pred_fast, dist_fast = fast.solve_codes(x_scr)
    pred_faith, dist_faith = faithful.solve_codes(x_scr)
    with plain_attention():
        pred_plain, dist_plain = fast.solve_codes(x_scr)
    faith_vs_fast = (dist_faith - dist_fast).abs().max().item()
    plain_vs_k1 = (dist_plain - dist_fast).abs().max().item()
    log(f"  faithful-250 vs fast: distances max |diff| {faith_vs_fast}, "
        f"permutations equal {torch.equal(pred_faith, pred_fast)}")
    log(f"  plain attention vs K1 (fast): distances max |diff| {plain_vs_k1}, "
        f"permutations equal {torch.equal(pred_plain, pred_fast)}")
    if not (torch.equal(dist_faith, dist_fast) and torch.equal(pred_faith, pred_fast)):
        raise AssertionError("faithful-250 and fast differ; they are one computation at t=0")
    if not torch.equal(pred_plain, pred_fast):
        raise AssertionError("the plain-attention solve gives other permutations")
    if not np.isfinite(dist_fast.cpu().numpy()).all():
        raise AssertionError("non-finite distances")
    log(f"phase main path: {time.perf_counter() - t0:.2f} s")

    # 4. Throughput at batch 32.
    t0 = time.perf_counter()
    x32, perms32 = wave_puzzles(32, 7)
    faithful_pps = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res32 = faithful.evaluate(x32, perms32)
        faithful_pps.append(32 / (time.perf_counter() - t1))
    fast.evaluate(x32, perms32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        fast.evaluate(x32, perms32)
    fast_pps = 32 * reps / (time.perf_counter() - t1)
    log(f"throughput on {card}: faithful-250 {faithful_pps} puzzles/s, fast "
        f"{fast_pps:.1f} puzzles/s (batch 32, bf16; faithful puzzle acc "
        f"{res32.puzzle_accuracy:.4f}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"phase throughput: {time.perf_counter() - t0:.2f} s")

    # 5. K2 against its plain version.
    t0 = time.perf_counter()
    k2_rows = [check_k2(96, TOKENS, torch.bfloat16, gen, timed=True),
               check_k2(32, TOKENS, torch.bfloat16, gen, timed=True),
               check_k2(3, 77, torch.bfloat16, gen, timed=False),
               check_k2(2, 200, torch.bfloat16, gen, timed=False),
               check_k2(2, TOKENS, torch.float32, gen, timed=False)]
    log(f"phase k2: {time.perf_counter() - t0:.2f} s")

    # 6. Gradients through attention, K1/K2 against plain autograd.
    t0 = time.perf_counter()
    check_gradients()
    log(f"phase gradients: {time.perf_counter() - t0:.2f} s")

    # 7. The training path, warm-started from the artifact; then the CLI.
    t0 = time.perf_counter()
    del model, fast, faithful
    train = check_training(sd, step, template, x16, perms16)
    launches_train = train["launches"]
    log(f"phase training: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    check_run_train()
    log(f"phase run_train: {time.perf_counter() - t0:.2f} s")

    # 8. Train throughput at batch 96 and 32: end to end, then the step alone.
    t0 = time.perf_counter()
    for batch, n_steps in ((TRAIN_BATCH, 40), (32, 60)):
        row = train_loop_throughput(batch, n_steps)
        log(f"train end to end on {card}: " + json.dumps(row))
    for batch in (TRAIN_BATCH, 32):
        row = train_throughput(train["state"], batch)
        log(f"train step on {card}: " + json.dumps(row))
    log(f"phase train throughput: {time.perf_counter() - t0:.2f} s")

    def kernel_row(name, source, replaces, launches, rows, timed):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "shape": timed["shape"],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")}}

    k1 = ("jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention.cu",
          "jpdvt_mt_ntnu_tpu/ops/attention.py:26")
    # K1 once for each main path: the solve (B=16) and the train step (B=96),
    # each with the launches of its own run and the errors of its shapes.
    kernels = [
        kernel_row("k1_whole_row_attention_fwd", *k1, launches_solve,
                   [r for r in k1_rows if r["shape"][0] != TRAIN_BATCH], k1_rows[0]),
        kernel_row("k1_whole_row_attention_fwd_train", *k1, launches_train[0],
                   [k1_rows[2]], k1_rows[2]),
        kernel_row("k2_whole_row_attention_bwd",
                   "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention_bwd.cu",
                   "jpdvt_mt_ntnu_tpu/ops/attention.py:44", launches_train[1],
                   k2_rows, k2_rows[0])]
    log(f"total: {time.perf_counter() - t_start:.2f} s (build {build_s:.2f} s)")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
