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
   (ms per synchronised step on one pre-built batch, peak memory);

then the grid-20 geometry (JPDVT at 320 px, 20 x 20 pieces, N = 400
tokens), where the flash kernels K4-K6 carry training:

9. hold K4 (flash forward), K5 (dQ) and K6 (dK, dV) against their plain
   versions at the train step's shape (B=96, N=400, bf16), B=32 in bf16 and
   fp32, ragged N (77, 200, 401) and a contiguous layout beside the fused
   one, and time each beside its bound, its plain version and SDPA (its
   forward for K4, its backward for K5 + K6, a yardstick only);
10. gradients through the flash route: one fp32 ``training_losses``
    backward of the full-width DiT at 320 px, batch 4, random weights with
    open gates, through K4-K6 against plain autograd, every parameter;
11. the grid-20 training path with the recorded run's settings
    (``artifacts/waves20_hard_step32700``'s ``run_config``): 24 steps at
    batch 96 in bf16 on device-streamed waves, exactly 12 K4 + 12 K5 + 12
    K6 launches and no K1/K2 per step, finite losses, a bit-equal restore,
    the bare step's ms and peak memory. The default run starts from random
    weights (the copy sent to a card holds only the waves3 artifact);
12. the N = 400 solve: fast and faithful-250 of 16 fixed grid-20 wave
    puzzles in bf16 (K1) and fp32 (K4) with the JAX package's seed-0 noise
    template, the routes' launch counts, the K1 and flash routes' piece
    distances against each other, puzzles/s at batch 32.

then the fused attention sublayer K3 and the evaluation path:

13. hold K3 (``model.attn_impl="block"``: qkv projection, attention and
    output projection in one call of two launches) against its plain
    version with the weights of the artifact's first DiT block, in bf16 at
    (B, N) = (32, 144), (32, 400), (16, 144), in fp32 at N = 144, and at
    ragged N (77, 200, 401); time it beside its bound, its plain version,
    the ``linear -> SDPA -> linear`` yardstick and the port's default route
    (cuBLAS + K1 + cuBLAS);
14. the eval path on ``waves3_r5_step10000`` through ``run_eval.main``:
    1,024 synthetic waves puzzles at ``eval.seed=11``, batch 64, fast, bf16,
    with the JAX harness's seed-11 draws and noise template
    (``tests/golden``), on the default route and on ``block`` (12 K3
    launches per microbatch solve and no K1; the routes' per-puzzle
    agreement), ``eval.votes=4`` and ``eval.assignment=hungarian`` on
    ``block``, a run cut at ``eval.limit=512`` and resumed (equal to the
    uninterrupted journal), faithful-250 = fast bit for bit at 1.00 on the
    16 export-smoke puzzles on ``block``, and puzzles/s: the harness's
    (its wall time, journal included) on both routes, faithful-250 and
    fast at batch 32 on ``block`` beside the default route, alternating.

``python3 chip_smoke.py --grid20-artifact`` (the copy must then hold
``waves20_hard_step32700`` in place of waves3) skips the phases that read
the waves3 artifact (3, 4, 7, 8), warm-starts phase 11 from the artifact
at step 32,700 (losses <= 1/10 of a fresh model's on the same batches and
draws), solves the fixed set in phase 12 with the EMA model beside the
unchanged artifact, and runs the ``run_train`` CLI at grid 20 (warm start,
checkpoint, validation, resume); phase 14 is replaced by ``run_eval``
on the grid-20 artifact (1,024 puzzles, seed 11, batch 64, fast, bf16) on
the default route (K1 at N = 400) and on ``block`` (K3 at N = 400),
greedy and ``eval.votes=4``, each held to the JAX package's TPU journals
(``logs/waves20_hard_eval``: 0.9180 / 0.9938, and
``logs/waves20_hard_votes_eval``: 0.9199 / 0.9936) within 0.012 puzzle
and 0.002 patch accuracy, with the per-puzzle agreement printed.

The last three lines are the ``kernels`` JSON (each kernel with the
launches of its own path and its shape: K1 once for the solve and once for
the train step, K2, K3 on the eval path, K4, K5, K6), the card's name and
power limit, and the device JSON.
"""

from __future__ import annotations

import argparse
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
from jpdvt_mt_ntnu_tpu_torch.eval import run_eval
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.models import dit
from jpdvt_mt_ntnu_tpu_torch.ops import _build, jigsaw
from jpdvt_mt_ntnu_tpu_torch.ops import attention as attn_ops
from jpdvt_mt_ntnu_tpu_torch.ops import flash_attention as flash_ops
from jpdvt_mt_ntnu_tpu_torch.tools.weights import load_artifact
from jpdvt_mt_ntnu_tpu_torch.train import (CheckpointManager, TrainTask,
                                           create_train_state, make_optimizer,
                                           make_train_step, run_train, steps)
from jpdvt_mt_ntnu_tpu_torch.utils.pos_embed import grid_code

REPO = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(REPO, "artifacts", "waves3_r5_step10000.manifest.json")
NOISE_TEMPLATE = os.path.join(REPO, "tests", "golden", "jax_noise_seed0_1x144x8.npy")
ARTIFACT20 = os.path.join(REPO, "artifacts", "waves20_hard_step32700.manifest.json")
NOISE_TEMPLATE20 = os.path.join(REPO, "tests", "golden", "jax_noise_seed0_1x400x8.npy")
SIZE20, GRID20, TOKENS20 = 320, 20, 400
EVAL_DRAWS = os.path.join(REPO, "tests", "golden", "jax_eval_draws_seed11_b64.npz")
EVAL_NOISE = {n: os.path.join(REPO, "tests", "golden", f"jax_noise_seed11_1x{n}x8.npy")
              for n in (144, 400)}
EVAL_PIECES = {144: 9, 400: 400}  # grid 3 at 192 px, grid 20 at 320 px
# The JAX package's 1,024-puzzle seed-11 evals of waves20_hard_step32700
# (faithful-250 on a TPU: logs/waves20_hard_eval, logs/waves20_hard_votes_eval),
# held to +-0.012 puzzle accuracy (about 12 of 1,024 borderline puzzles that
# bf16 on another chip may flip) and +-0.002 patch accuracy.
JAX_EVAL20 = {1: ("logs/waves20_hard_eval", 0.9180, 0.9938),
              4: ("logs/waves20_hard_votes_eval", 0.9199, 0.9936)}
EVAL_PUZZLE_TOL, EVAL_PATCH_TOL = 0.012, 0.002
# Phase 14: the default and block routes' per-puzzle agreement on the
# waves3 eval (bf16 on both, rounded at other points).
ROUTE_AGREE = 0.97

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
# K4 against its plain version: at the kernel's own key tile (BLOCK_K) both
# round exp(S - m) to bf16 at the same points, as K1 and its plain version
# round P, so K1's tolerance; against the plain version over the whole row
# the tiles round exp(S - m) against the running max, not the row's, which
# moves a term by at most one bf16 ulp: the same 2e-2 holds. The LSE is
# fp32 in both (summation order): 1e-4 absolute at |LSE| ~ 6-10.
LSE_TOL = 1e-4
# K5, K6: K2's tolerance (dS and the outputs rounded at the same points).
# Phase 12: the bf16 solve's piece distances on the K1 route against the
# flash route, relative to the largest fp32 distance. The routes round to
# bf16 at other points (K1 normalises P before rounding it, flash rounds
# exp(S - m) per key tile and divides at the end), and the difference runs
# through twelve blocks; each bf16 route stays about 1% from the fp32 one
# (PERF.md §6 has the readings). 2% bounds the two routes' difference
# with a margin of 3 or more.
CODE_TOL = 0.02
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
             tensors: int = 4, products: int = 2, lse: bool = False) -> tuple[float, str]:
    """Least time for an attention kernel's work: ``tensors`` (B, H, N, Dh)
    tensors read or written once (K1: q, k, v, o; K2: q, k, v, dO, dq, dk,
    dv; K4: q, k, v, o; K5: q, k, v, o, dO, dq; K6: q, k, v, o, dO, dk, dv)
    and, with ``lse``, one fp32 (B, H, N) LSE, against ``products``
    N x N x Dh products' operations."""
    elem = torch.empty((), dtype=dtype).element_size()
    t_bytes = (tensors * b * h * n * d * elem + (4 * b * h * n if lse else 0)) / HBM_BYTES_PER_S
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


def check_k4(b: int, n: int, dtype: torch.dtype, gen: torch.Generator,
             timed: bool, fused: bool = True) -> dict:
    """K4 on q/k/v views of a fused qkv (or contiguous (B, H, N, Dh) tensors)
    against its plain version at the kernel's key tile and over the whole row."""
    if fused:
        q, k, v = qkv_views(b, n, dtype, gen)
    else:
        q, k, v = (torch.randn((b, HEADS, n, HEAD_DIM), generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
    o, lse = flash_ops.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    ref_o, ref_lse = flash_ops.flash_attention_fwd_reference(q, k, v, flash_ops.BLOCK_K)
    row_o, _ = flash_ops.flash_attention_fwd_reference(q, k, v)
    err = (o.float() - ref_o.float()).abs().max().item()
    err_row = (o.float() - row_o.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    if not (err <= TOL[dtype] and err_row <= TOL[dtype] and err_lse <= LSE_TOL):
        raise AssertionError(f"K4 {(b, HEADS, n, HEAD_DIM)} {dtype}: max abs err {err} "
                             f"(whole row {err_row}) > {TOL[dtype]} or LSE {err_lse}")
    row = {"shape": [b, HEADS, n, HEAD_DIM], "dtype": str(dtype).split(".")[-1],
           "layout": "fused qkv" if fused else "contiguous", "max_abs_err": err,
           "err_vs_whole_row": err_row, "lse_err": err_lse, "tol": TOL[dtype]}
    if timed:
        row["ms"] = cuda_ms(lambda: flash_ops.flash_attention_fwd(q, k, v), 50)
        row["plain_ms"] = cuda_ms(lambda: flash_ops.flash_attention_fwd_reference(
            q, k, v, flash_ops.BLOCK_K), 5)
        row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 50)
        row["bound_ms"], row["bound_by"] = bound_ms(b, HEADS, n, HEAD_DIM, dtype, lse=True)
    log("K4 " + json.dumps(row))
    return row


def check_k5_k6(b: int, n: int, dtype: torch.dtype, gen: torch.Generator,
                timed: bool) -> tuple[dict, dict]:
    """K5 and K6 as the train step calls them: q/k/v views of a fused qkv, O
    and dO views of (B, N, H*Dh) buffers, dq/dk/dv written into one fused
    gradient buffer; O and the LSE from the plain forward."""
    q, k, v = qkv_views(b, n, dtype, gen)
    o, lse = flash_ops.flash_attention_fwd_reference(q, k, v, flash_ops.BLOCK_K)
    o = o.transpose(1, 2).contiguous().transpose(1, 2)
    do = torch.randn((b, n, HEADS * HEAD_DIM), generator=gen, device="cuda").to(dtype)
    do = do.view(b, n, HEADS, HEAD_DIM).transpose(1, 2)
    buf = torch.empty((b, n, 3 * HEADS * HEAD_DIM), dtype=dtype, device="cuda")
    out = buf.view(b, n, 3, HEADS, HEAD_DIM).permute(2, 0, 3, 1, 4).unbind(0)
    flash_ops.flash_attention_bwd(q, k, v, o, lse, do, out=out)
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in zip(("dq", "dk", "dv"), out,
                               flash_ops.flash_attention_bwd_reference(q, k, v, o, lse, do)):
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= K2_TOL[dtype] * scale:
            raise AssertionError(f"K5/K6 {name} {(b, HEADS, n, HEAD_DIM)} {dtype}: max "
                                 f"abs err {err} > {K2_TOL[dtype]} x {scale}")
        errs[name] = [err, scale]
    base = {"shape": [b, HEADS, n, HEAD_DIM], "dtype": str(dtype).split(".")[-1],
            "rel_tol": K2_TOL[dtype]}
    k5 = {**base, "max_abs_err": errs["dq"][0], "err_and_scale": {"dq": errs["dq"]}}
    k6 = {**base, "max_abs_err": max(errs["dk"][0], errs["dv"][0]),
          "err_and_scale": {k: errs[k] for k in ("dk", "dv")}}
    if timed:
        k5["ms"] = cuda_ms(lambda: flash_ops.flash_dq(q, k, v, o, lse, do, out[0]), 20)
        k6["ms"] = cuda_ms(lambda: flash_ops.flash_dkv(q, k, v, o, lse, do, *out[1:]), 20)
        # The plain version computes dq, dk and dv in one pass; both rows carry it.
        k5["plain_ms"] = k6["plain_ms"] = cuda_ms(
            lambda: flash_ops.flash_attention_bwd_reference(q, k, v, o, lse, do), 3)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(*leaves)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), leaves, do)

        # SDPA's backward computes dq, dk and dv together: K5 + K6's work.
        k5["library_ms"] = k6["library_ms"] = cuda_ms(sdpa_fwd_bwd, 20) - cuda_ms(sdpa_fwd, 20)
        k5["library_covers"] = k6["library_covers"] = "dq, dk, dv (K5 + K6)"
        k5["bound_ms"], k5["bound_by"] = bound_ms(b, HEADS, n, HEAD_DIM, dtype,
                                                  tensors=6, products=3, lse=True)
        k6["bound_ms"], k6["bound_by"] = bound_ms(b, HEADS, n, HEAD_DIM, dtype,
                                                  tensors=7, products=4, lse=True)
    log("K5 " + json.dumps(k5))
    log("K6 " + json.dumps(k6))
    return k5, k6


@contextlib.contextmanager
def plain_attention():
    """Route the DiT's attention, both routes, to the plain version (torch
    autograd of the whole-row softmax) for a comparison."""
    kernel_routes = dit.fused_qkv_attention, dit.fused_qkv_flash_attention
    dit.fused_qkv_attention = attn_ops.fused_qkv_attention_reference
    dit.fused_qkv_flash_attention = attn_ops.fused_qkv_attention_reference
    try:
        yield
    finally:
        dit.fused_qkv_attention, dit.fused_qkv_flash_attention = kernel_routes


COUNTERS = {"k1": attn_ops.attention, "k2": attn_ops.attention_bwd,
            "k3": attn_ops.fused_attention_block,
            "k4": flash_ops.flash_attention_fwd, "k5": flash_ops.flash_dq,
            "k6": flash_ops.flash_dkv}


def zero_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def launched_since(before: dict) -> dict:
    return {name: n - before[name] for name, n in counts().items()}


def randomize(model: torch.nn.Module, seed: int) -> None:
    """Random weights with every adaLN gate open: N(0, 1/fan_in) matrices,
    N(0, 0.02) biases."""
    gen = torch.Generator("cuda").manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            std = p.shape[1] ** -0.5 if p.dim() == 2 else 0.02
            p.normal_(0.0, std, generator=gen)


def check_gradients(size: int = 192, grid: int = 3, b: int = 8,
                    expected: dict | None = None) -> dict:
    """Every parameter's gradient of one training-loss backward of the
    full-width DiT in fp32, through the kernels and through the plain
    attention (torch autograd), on identical injected draws. Phase 6: 192
    px, grid 3, batch 8, 12 K1 + 12 K2 launches; phase 10: 320 px, grid 20,
    batch 4, 12 K4 + 12 K5 + 12 K6."""
    expected = expected or {"k1": 12, "k2": 12}
    model, cfg = create_model("JPDVT", size, seed=0)
    randomize(model, 1)
    diff = create_diffusion("")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(SyntheticPuzzles(size, n=b, seed=3).batch()).cuda()
    t = torch.as_tensor(rng.integers(0, 1000, b), device="cuda")
    inject = {"indices": np.stack([rng.permutation(grid * grid) for _ in range(b)]),
              "noise_x": rng.standard_normal((b, size, size, 3)).astype(np.float32),
              "noise_c": rng.standard_normal((b, cfg.num_tokens, 8)).astype(np.float32)}
    code = torch.as_tensor(grid_code(8, grid), device="cuda")

    def grads():
        model.zero_grad(set_to_none=True)
        out = diff.training_losses(model, x, t, code, block_size=size // grid,
                                   patch_size=16, grid_size=grid, _inject=inject)
        out["loss"].mean().backward()
        return out["loss"].mean().item(), {k: p.grad.clone() for k, p in
                                           model.named_parameters()}

    before = counts()
    loss, mine = grads()
    launched = launched_since(before)
    with plain_attention():
        loss_plain, plain = grads()
    want = {name: expected.get(name, 0) for name in COUNTERS}
    if launched != want:
        raise AssertionError(f"kernel launches {launched}, expected {want}")
    worst, worst_name = 0.0, ""
    for name, want_g in plain.items():
        scale = want_g.abs().max().item()
        rel = (mine[name] - want_g).abs().max().item() / scale if scale else 0.0
        if scale == 0 or not rel <= GRAD_TOL:
            raise AssertionError(f"gradient of {name}: rel err {rel}, scale {scale}")
        if rel > worst:
            worst, worst_name = rel, name
    qkv = [mine[f"blocks.{i}.attn.qkv.weight"].abs().max().item() for i in range(cfg.depth)]
    if min(qkv) == 0:
        raise AssertionError(f"a qkv.weight gradient is zero: {qkv}")
    row = {"size": size, "grid": grid, "batch": b, "launches": launched,
           "loss_kernels": loss, "loss_plain": loss_plain, "params": len(plain),
           "worst_rel_err": worst, "worst_param": worst_name, "rel_tol": GRAD_TOL,
           "min_qkv_weight_grad_max": min(qkv)}
    log("gradients " + json.dumps(row))
    return row


def train_batches(ds: SyntheticPuzzles, first_step: int, count: int, batch: int):
    """The device stream's batches of steps first_step.. (cursor step x batch)."""
    return [ds.device_batch(range(s * batch, (s + 1) * batch), "cuda")
            for s in range(first_step, first_step + count)]


def fresh_losses(diff, task, code, batches, first_step: int, size: int = 192) -> list[float]:
    """A freshly initialised model's losses on the steps' own batches and draws."""
    model, _ = create_model("JPDVT", size, seed=0, dtype=torch.bfloat16)
    out = []
    with torch.no_grad():
        for i, x in enumerate(batches):
            gen = steps.step_generator(0, first_step + i, "cuda")
            t = steps.draw_timesteps(x.shape[0], diff.num_timesteps, task.t_bias, gen)
            res = diff.training_losses(model, x.float(), t, code,
                                       block_size=task.block_size,
                                       patch_size=task.patch_size, add_mask=task.add_mask,
                                       grid_size=task.grid_size,
                                       shared_perm=task.shared_perm, generator=gen)
            out.append(res["loss"].mean().item())
    return out


def warm_state(sd, step: int, size: int = 192):
    """A train state of the bf16 JPDVT at ``size`` px at ``step``, from the
    state dict ``sd`` or, where it is None, the model's own seed-0 init."""
    model, cfg = create_model("JPDVT", size, dtype=torch.bfloat16)
    if sd is not None:
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

    log("  " + check_restore(state, sd, 192))

    solver = PuzzleSolver(state.ema, cfg, create_diffusion("250"), grid_size=3,
                          mode="fast", noise_template=template)
    res = solver.evaluate(x16, perms16)
    log(f"  EMA model after {TRAIN_STEPS} steps: fast solve puzzle acc "
        f"{res.puzzle_accuracy:.4f}, patch acc {res.patch_accuracy:.4f}")
    if res.puzzle_accuracy != 1.0:
        raise AssertionError(f"the EMA model solved {res.puzzle_accuracy} of the 16 puzzles")
    return {"losses": losses, "fresh_losses": fresh, "ratio": ratio,
            "launches": launches, "state": state, "cfg": cfg}


def check_run_train(artifact: str = ARTIFACT, start: int = 10000, extra=()) -> None:
    """The CLI on the card: warm start from the artifact, 10 steps, a
    checkpoint, validation, then a resume that continues to step +20."""
    with tempfile.TemporaryDirectory() as tmp:
        common = [*extra, "data.synthetic_cues=waves", "data.device_stream=true",
                  f"data.synthetic_hard_frac={HARD_FRAC}", "data.synthetic_n=960",
                  f"train.t_bias={T_BIAS}", "train.ema_warmup=true", "train.log_every=5",
                  "train.ckpt_every=10", "diffusion.sampler_mode=fast",
                  f"train.exp_dir={tmp}/exp"]
        t0 = time.perf_counter()
        code = run_train.main(common + ["train.epochs=1", f"train.warm_start={artifact}"])
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
    if (code, code2, first, last) != (0, 0, start + 10, start + 20):
        raise AssertionError(f"run_train: exits {code}/{code2}, checkpoints {first}/{last}")
    if f"Resumed from step {start + 10}" not in log_txt or len(vals) != 2:
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


def train_throughput(state, batch: int, reps: int = 12, size: int = 192,
                     grid: int = 3) -> dict:
    """The train-step layer: median ms of a synchronised train step on one
    pre-built batch (no data), and every step's time."""
    diff = create_diffusion("")
    task = TrainTask(grid_size=grid, block_size=size // grid, patch_size=16,
                     ema_warmup=True, ema_anchor=state.step, t_bias=T_BIAS)
    code = torch.as_tensor(grid_code(8, grid), device="cuda")
    train_step = make_train_step(diff, make_optimizer(LR, 0.0), task, code)
    ds = SyntheticPuzzles(size, n=9600, hard_frac=HARD_FRAC)
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
    return {"size": size, "grid": grid, "batch": batch, "ms_per_step": ms,
            "images_per_s": batch * 1e3 / ms,
            "step_ms_all": times, "device_batch_ms": data_ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def wave_puzzles(n: int, seed: int, size: int = 192,
                 grid: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """The export smoke's puzzles (tools/export_ckpt.py:213-222); at 320 px
    and grid 20 the fixed N = 400 set is drawn the same way."""
    x = SyntheticPuzzles(size, n=n, seed=seed).batch()
    rng = np.random.default_rng(seed)
    return x, np.stack([rng.permutation(grid * grid) for _ in range(n)])


def check_restore(state, sd, size: int) -> str:
    """Checkpoint ``state`` and restore it into another state, bit-equal."""
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        t0 = time.perf_counter()
        mgr.save(state)
        save_s = time.perf_counter() - t0
        other, _ = warm_state(sd, 0, size)
        t0 = time.perf_counter()
        mgr.restore(other)
        restore_s = time.perf_counter() - t0
    pairs = ([(state.model.state_dict(), other.model.state_dict()),
              (state.ema.state_dict(), other.ema.state_dict()),
              (state.opt.mu, other.opt.mu), (state.opt.nu, other.opt.nu)])
    if not (other.step == state.step and other.opt.count == state.opt.count
            and all(torch.equal(a[k], b[k]) for a, b in pairs for k in a)):
        raise AssertionError("the restored state differs from the saved one")
    return (f"checkpoint of step {state.step}: saved in {save_s:.2f} s, restored "
            f"bit-equal in {restore_s:.2f} s")


def check_training20(sd, start: int) -> dict:
    """Phase 11: the grid-20 train step with the recorded run's settings
    (AdamW 1e-4, wd 0, EMA .9999 with warmup anchored at ``start``, t_bias
    2, shared permutations, no mask) at batch 96, bf16, on device-streamed
    waves (hard_frac 0.25); from ``sd`` at ``start``, or random weights."""
    state, cfg = warm_state(sd, start, SIZE20)
    diff = create_diffusion("")
    task = TrainTask(grid_size=GRID20, block_size=SIZE20 // GRID20, patch_size=16,
                     shared_perm=True, ema_decay=EMA_DECAY, ema_warmup=True,
                     ema_anchor=start, t_bias=T_BIAS)
    code = torch.as_tensor(grid_code(8, GRID20), device="cuda")
    train_step = make_train_step(diff, make_optimizer(LR, 0.0), task, code)
    ds = SyntheticPuzzles(SIZE20, n=9600, hard_frac=HARD_FRAC)
    batches = train_batches(ds, start, TRAIN_STEPS, TRAIN_BATCH)
    zero_counts()
    losses, per_step = [], []
    for x in batches:
        before = counts()
        state, metrics = train_step(state, x)
        losses.append(metrics["loss"].item())
        per_step.append(launched_since(before))
        log(f"  grid-20 train step {state.step}: loss {losses[-1]:.6f}, grad_norm "
            f"{metrics['grad_norm'].item():.4f}, launches {per_step[-1]}")
    launches = counts()
    want = {"k1": 0, "k2": 0, "k3": 0, "k4": cfg.depth, "k5": cfg.depth, "k6": cfg.depth}
    if any(ls != want for ls in per_step):
        raise AssertionError(f"launches per step {per_step}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    out = {"losses": losses, "launches": launches, "state": state, "cfg": cfg}
    if sd is not None:
        fresh = fresh_losses(diff, task, code, batches, start, SIZE20)
        ratio = float(np.mean(losses) / np.mean(fresh))
        log(f"  warm-started mean loss {np.mean(losses):.6f} vs a fresh model's "
            f"{np.mean(fresh):.6f} on the same batches: ratio {ratio:.5f} "
            f"(limit {LOSS_RATIO})")
        if not ratio <= LOSS_RATIO:
            raise AssertionError(f"warm-started loss ratio {ratio} > {LOSS_RATIO}")
        out.update(fresh_losses=fresh, ratio=ratio)
    else:
        log(f"  from random weights (seed 0): mean loss {np.mean(losses):.6f}, first "
            f"{losses[0]:.6f}, last {losses[-1]:.6f}")
    log("  " + check_restore(state, sd, SIZE20))
    return out


def solve_codes20(model, cfg, mode: str, template, x_scr):
    """One solve of the scrambled N = 400 set and the kernels it launched."""
    solver = PuzzleSolver(model, cfg, create_diffusion("250"), grid_size=GRID20,
                          mode=mode, noise_template=template)
    before = counts()
    pred, dist = solver.solve_codes(x_scr)
    return pred, dist, launched_since(before)


def check_solve20(sd, template: np.ndarray) -> dict:
    """Phase 12: fast and faithful-250 of the fixed N = 400 set in bf16 (K1)
    and fp32 (K4), the bf16 solve on the flash route beside K1's, and
    puzzles/s at batch 32 in bf16. Weights from ``sd``, or random with
    open gates (seed 1)."""
    x16, perms16 = wave_puzzles(16, 123, SIZE20, GRID20)
    x_scr = jigsaw.scramble(torch.as_tensor(x16, device="cuda"),
                            torch.as_tensor(perms16, device="cuda"), GRID20)
    models = {}
    for name, dtype, impl in (("bf16", torch.bfloat16, None), ("fp32", torch.float32, None),
                              ("bf16_flash", torch.bfloat16, "flash")):
        model, cfg = create_model("JPDVT", SIZE20, dtype=dtype, attn_impl=impl)
        if sd is None:
            randomize(model, 1)
        else:
            model.load_state_dict(sd)
        models[name] = (model, cfg)
    expect = {"bf16": "k1", "fp32": "k4", "bf16_flash": "k4"}
    res, row = {}, {}
    for name, (model, cfg) in models.items():
        for mode in (("fast", "faithful") if name != "bf16_flash" else ("fast",)):
            t0 = time.perf_counter()
            pred, dist, launched = solve_codes20(model, cfg, mode, template, x_scr)
            secs = time.perf_counter() - t0
            steps_ = 1 if mode == "fast" else STEPS
            want = {k: 0 for k in COUNTERS}
            want[expect[name]] = cfg.depth * steps_
            if launched != want:
                raise AssertionError(f"{name} {mode}: launches {launched}, expected {want}")
            if not torch.isfinite(dist).all():
                raise AssertionError(f"{name} {mode}: non-finite distances")
            acc = (pred.cpu().numpy() == perms16).all(axis=1).mean()
            patch = (pred.cpu().numpy() == perms16).mean()
            res[name, mode] = (pred, dist)
            row[f"{name}_{mode}"] = {"puzzle_acc": float(acc), "patch_acc": float(patch),
                                     "launches": launched, "s": secs}
            log(f"  N=400 {name} {mode}: puzzle acc {acc:.4f}, patch acc {patch:.4f}, "
                f"launches {launched}, {secs:.2f} s")
        if name != "bf16_flash" and not (
                torch.equal(res[name, "fast"][1], res[name, "faithful"][1])):
            raise AssertionError(f"{name}: faithful-250 and fast differ")
    scale = res["fp32", "fast"][1].abs().max().item()
    k1_vs_flash = (res["bf16", "fast"][1] - res["bf16_flash", "fast"][1]).abs().max().item()
    k1_vs_fp32 = (res["bf16", "fast"][1] - res["fp32", "fast"][1]).abs().max().item()
    flash_vs_fp32 = (res["bf16_flash", "fast"][1] - res["fp32", "fast"][1]).abs().max().item()
    agree = float((res["bf16", "fast"][0] == res["bf16_flash", "fast"][0]).float().mean())
    row["distances"] = {"scale": scale, "k1_vs_flash_bf16": k1_vs_flash,
                        "k1_bf16_vs_flash_fp32": k1_vs_fp32,
                        "flash_bf16_vs_flash_fp32": flash_vs_fp32,
                        "k1_flash_slots_agree": agree, "rel_tol": CODE_TOL}
    log("  N=400 piece distances " + json.dumps(row["distances"]))
    if not k1_vs_flash <= CODE_TOL * scale:
        raise AssertionError(f"K1 and flash routes' distances differ by {k1_vs_flash} > "
                             f"{CODE_TOL} x {scale}")
    model, cfg = models["bf16"]
    del models
    x32, perms32 = wave_puzzles(32, 7, SIZE20, GRID20)
    pps = {}
    for mode, reps in (("faithful", 1), ("fast", 10)):
        solver = PuzzleSolver(model, cfg, create_diffusion("250"), grid_size=GRID20,
                              mode=mode, noise_template=template)
        solver.evaluate(x32[:2], perms32[:2])  # warm at a small batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            solver.evaluate(x32, perms32)
        pps[mode] = 32 * reps / (time.perf_counter() - t0)
    row["puzzles_per_s_batch32_bf16"] = pps
    log(f"  N=400 throughput (batch 32, bf16, K1): faithful-250 {pps['faithful']:.3f}, "
        f"fast {pps['fast']:.1f} puzzles/s")
    return row


def solve_grid3(card: str) -> dict:
    """Phases 3 and 4: the waves3 artifact's solve and its throughput."""
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
    return {"launches_solve": launches_solve, "sd": sd, "step": step,
            "template": template, "x16": x16, "perms16": perms16}


def train_grid3(g3: dict, card: str) -> tuple:
    """Phases 7 and 8: training warm-started from the waves3 artifact, the
    CLI, and the train throughput. Returns the K1/K2 launches of phase 7."""
    # 7. The training path, warm-started from the artifact; then the CLI.
    t0 = time.perf_counter()
    train = check_training(g3["sd"], g3["step"], g3["template"], g3["x16"], g3["perms16"])
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
    return launches_train


def k3_bound_ms(b: int, n: int, dtype: torch.dtype, hidden: int = HEADS * HEAD_DIM
                ) -> tuple[float, str]:
    """Least time for K3's work: x read and the output written once, the
    weights read once, against the products 2 B N D 4D + 4 B H N^2 Dh."""
    elem = torch.empty((), dtype=dtype).element_size()
    t_bytes = (2 * b * n * hidden + 4 * hidden * hidden) * elem / HBM_BYTES_PER_S
    t_ops = (2 * b * n * hidden * 4 * hidden
             + 4 * b * HEADS * n * n * HEAD_DIM) / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def first_block(sd) -> tuple:
    """The first DiT block's attention weights of a state dict, on the card."""
    return tuple(sd[f"blocks.0.attn.{k}"].cuda() for k in
                 ("qkv.weight", "qkv.bias", "proj.weight", "proj.bias"))


def check_k3(b: int, n: int, dtype: torch.dtype, weights: tuple, gen: torch.Generator,
             timed: bool) -> dict:
    """K3 on one DiT block's weights, in ``dtype`` with the biases rounded
    through it and kept fp32 (as the solver hands them over), against its
    plain version; relative to the output's largest magnitude."""
    wq, bq, wp, bp = (w.to(dtype) for w in weights)
    ops = attn_ops.dense_to_block_weights(wq, bq.float(), wp, bp.float(), HEADS)
    x = torch.randn((b, n, HEADS * HEAD_DIM), generator=gen, device="cuda").to(dtype)
    out = attn_ops.fused_attention_block(x, *ops, HEADS)
    torch.cuda.synchronize()
    ref = attn_ops.fused_attention_block_plain(x, *ops, HEADS).float()
    scale = ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    if not err <= TOL[dtype] * scale:
        raise AssertionError(f"K3 {(b, n)} {dtype}: max abs err {err} > {TOL[dtype]} x {scale}")
    row = {"shape": [b, n, HEADS * HEAD_DIM], "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err, "scale": scale, "rel_tol": TOL[dtype]}
    if timed:
        def library():
            qkv = F.linear(x, wq, bq).view(b, n, 3, HEADS, HEAD_DIM).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
            return F.linear(o.transpose(1, 2).reshape(b, n, -1), wp, bp)

        def default_route():
            return F.linear(attn_ops.fused_qkv_attention(F.linear(x, wq, bq), HEADS), wp, bp)

        row["ms"] = cuda_ms(lambda: attn_ops.fused_attention_block(x, *ops, HEADS), 20)
        row["plain_ms"] = cuda_ms(
            lambda: attn_ops.fused_attention_block_plain(x, *ops, HEADS), 5)
        row["library_ms"] = cuda_ms(library, 50)
        row["library_covers"] = "F.linear -> scaled_dot_product_attention -> F.linear"
        row["default_route_ms"] = cuda_ms(default_route, 50)
        row["bound_ms"], row["bound_by"] = k3_bound_ms(b, n, dtype)
    log("K3 " + json.dumps(row))
    return row


def run_eval_cli(tmp: str, name: str, artifact: str, tokens: int, *extra: str,
                 expect: int = 1024) -> dict:
    """``run_eval.main`` on the 1,024 seed-11 waves puzzles at batch 64,
    fast, bf16, with the JAX harness's draws and template, journaling into
    ``tmp/name``: the journal (``expect`` rows), this run's kernel launches,
    and the harness's wall time from its log."""
    logs = os.path.join(tmp, name)
    before = counts()
    code = run_eval.main([
        f"eval.checkpoint={artifact}", "data.dataset=synthetic", "data.synthetic_cues=waves",
        "eval.seed=11", "eval.batch_size=64", "diffusion.sampler_mode=fast",
        f"eval.jax_draws={EVAL_DRAWS}", f"eval.jax_noise={EVAL_NOISE[tokens]}",
        f"eval.logs_dir={logs}", *extra])
    launched = launched_since(before)
    rows = journal_rows(os.path.join(logs, "inference_progress.csv"))
    secs = [float(line.rsplit(":", 1)[1].strip().rstrip("s"))
            for line in open(os.path.join(logs, "inference_log.txt"))
            if "Total inference time:" in line][-1]
    n = len(rows)
    out = {"name": name, "exit": code, "n": n, "launches": launched,
           "puzzle_acc": sum(r[0] for r in rows.values()) / max(n, 1),
           "patch_acc": sum(r[1] for r in rows.values()) / max(n * EVAL_PIECES[tokens], 1),
           "harness_s": secs, "puzzles_per_s": n / secs if secs else 0.0, "rows": rows}
    log(f"  run_eval {name}: " + json.dumps({k: v for k, v in out.items() if k != "rows"}))
    if code != 0 or n != expect:
        raise AssertionError(f"run_eval {name}: exit {code}, {n} journal rows")
    return out


def journal_rows(path: str) -> dict:
    """filename -> (puzzle_correct, patch_matches); raises on a repeated name."""
    import csv

    rows = {}
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            if r["filename"] in rows:
                raise AssertionError(f"{path}: {r['filename']} journaled twice")
            rows[r["filename"]] = (int(r["puzzle_correct"]), int(r["patch_matches"]))
    return rows


def agreement(a: dict, b: dict) -> float:
    """Share of puzzles whose puzzle_correct agrees between two journals."""
    return sum(a[k][0] == b[k][0] for k in a) / len(a)


def eval_grid3(card: str) -> dict:
    """Phase 14: the eval path on the waves3 artifact, both routes."""
    t0 = time.perf_counter()
    per_mb = 12 * 2  # 12 blocks, two microbatches of 32 per batch of 64
    with tempfile.TemporaryDirectory() as tmp:
        default = run_eval_cli(tmp, "default", ARTIFACT, TOKENS)
        zero_counts()
        block = run_eval_cli(tmp, "block", ARTIFACT, TOKENS, "model.attn_impl=block")
        eval_launches = counts()
        want = {k: 0 for k in COUNTERS}
        if default["launches"] != {**want, "k1": 16 * per_mb}:
            raise AssertionError(f"default route launches {default['launches']}")
        if eval_launches != {**want, "k3": 16 * per_mb}:
            raise AssertionError(f"block route launches {eval_launches}, expected "
                                 f"{16 * per_mb} K3 and no K1")
        agree = agreement(default["rows"], block["rows"])
        log(f"  routes agree on {agree:.4f} of the puzzles (limit {ROUTE_AGREE})")
        if not agree >= ROUTE_AGREE:
            raise AssertionError(f"the default and block routes agree on {agree}")
        votes = run_eval_cli(tmp, "block_votes4", ARTIFACT, TOKENS, "model.attn_impl=block",
                             "eval.votes=4")
        hung = run_eval_cli(tmp, "block_hungarian", ARTIFACT, TOKENS,
                            "model.attn_impl=block", "eval.assignment=hungarian")
        if votes["launches"]["k3"] != 4 * 16 * per_mb or hung["launches"]["k3"] != 16 * per_mb:
            raise AssertionError(f"votes / hungarian K3 launches {votes['launches']}, "
                                 f"{hung['launches']}")
        cut = run_eval_cli_resumed(tmp, block)
    # Faithful-250 and fast of the 16 export-smoke puzzles on the block route.
    sd, _ = load_artifact(ARTIFACT)
    models = {}
    for impl in (None, "block"):
        model, cfg = create_model("JPDVT", 192, dtype=torch.bfloat16, attn_impl=impl)
        model.load_state_dict(sd)
        models[impl] = (model, cfg)
    del sd
    template = np.load(NOISE_TEMPLATE)
    x16, perms16 = wave_puzzles(16, 123)
    model, cfg = models["block"]
    x_scr = jigsaw.scramble(torch.as_tensor(x16, device="cuda"),
                            torch.as_tensor(perms16, device="cuda"), 3)
    res = {}
    for mode in ("fast", "faithful"):
        solver = PuzzleSolver(model, cfg, create_diffusion("250"), grid_size=3, mode=mode,
                              noise_template=template)
        before = counts()
        pred, dist = solver.solve_codes(x_scr)
        launched = launched_since(before)
        acc = float((pred.cpu().numpy() == perms16).all(axis=1).mean())
        res[mode] = (pred, dist)
        log(f"  block route {mode}: 16 export-smoke puzzles, puzzle acc {acc:.4f}, "
            f"launches {launched}")
        steps_ = 1 if mode == "fast" else STEPS
        if launched != {**{k: 0 for k in COUNTERS}, "k3": cfg.depth * steps_} or acc != 1.0:
            raise AssertionError(f"block route {mode}: launches {launched}, accuracy {acc}")
    if not (torch.equal(res["fast"][0], res["faithful"][0])
            and torch.equal(res["fast"][1], res["faithful"][1])):
        raise AssertionError("block route: faithful-250 and fast differ")
    log("  block route: faithful-250 equals fast bit for bit")
    # Puzzles/s at batch 32, the routes alternating (default, block, block, default).
    x32, perms32 = wave_puzzles(32, 7)
    pps = {f"{impl or 'default'}_{mode}": [] for impl in (None, "block")
           for mode in ("faithful", "fast")}
    for mode, reps in (("faithful", 1), ("fast", 10)):
        solvers = {impl: PuzzleSolver(*models[impl], create_diffusion("250"), grid_size=3,
                                      mode=mode, noise_template=template)
                   for impl in models}
        for s_ in solvers.values():
            s_.evaluate(x32[:2], perms32[:2])  # warm
        for impl in (None, "block", "block", None):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(reps):
                solvers[impl].evaluate(x32, perms32)
            pps[f"{impl or 'default'}_{mode}"].append(32 * reps / (time.perf_counter() - t1))
    row = {"default": {k: default[k] for k in ("puzzle_acc", "patch_acc", "harness_s",
                                                "puzzles_per_s")},
           "block": {k: block[k] for k in ("puzzle_acc", "patch_acc", "harness_s",
                                            "puzzles_per_s")},
           "block_votes4": {k: votes[k] for k in ("puzzle_acc", "patch_acc", "puzzles_per_s")},
           "block_hungarian": {k: hung[k] for k in ("puzzle_acc", "patch_acc",
                                                     "puzzles_per_s")},
           "route_agreement": agree, "resume": cut, "eval_launches": eval_launches,
           "puzzles_per_s_batch32_bf16": pps}
    log(f"eval on {card}: " + json.dumps(row))
    log(f"phase eval: {time.perf_counter() - t0:.2f} s")
    return row


def run_eval_cli_resumed(tmp: str, whole: dict) -> dict:
    """``eval.limit=512``, then the rest in the same journal: the rows (and
    so the totals) must equal the uninterrupted block-route run's."""
    args = (ARTIFACT, TOKENS, "model.attn_impl=block")
    run_eval_cli(tmp, "resumed", *args, "eval.limit=512", expect=512)
    rest = run_eval_cli(tmp, "resumed", *args)
    same = rest["rows"] == whole["rows"]
    out = {"rows": rest["n"], "puzzle_acc": rest["puzzle_acc"], "patch_acc": rest["patch_acc"],
           "equals_uninterrupted": same}
    log("  resume: " + json.dumps(out))
    if not same:
        raise AssertionError(f"resume: {out}")
    return out


def eval_grid20(card: str) -> tuple[dict, dict]:
    """``--grid20-artifact``: run_eval on waves20_hard_step32700 on both
    routes, greedy and votes = 4, against the JAX package's TPU journals."""
    t0 = time.perf_counter()
    row, block_launches = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for votes in (1, 4):
            journal, want_puzzle, want_patch = JAX_EVAL20[votes]
            theirs = journal_rows(os.path.join(REPO, journal, "inference_progress.csv"))
            for impl in (None, "block"):
                name = f"{impl or 'default'}_votes{votes}"
                extra = [f"model.image_size={SIZE20}", f"task.grid_size={GRID20}",
                         f"eval.votes={votes}"] + (["model.attn_impl=block"] if impl else [])
                if impl and votes == 1:
                    zero_counts()
                res = run_eval_cli(tmp, name, ARTIFACT20, TOKENS20, *extra)
                if impl and votes == 1:
                    block_launches = counts()
                kernel = "k3" if impl else "k1"
                if res["launches"][kernel] != votes * 16 * 2 * 12:
                    raise AssertionError(f"{name}: launches {res['launches']}")
                agree = agreement(res["rows"], theirs)
                d_puzzle = res["puzzle_acc"] - want_puzzle
                d_patch = res["patch_acc"] - want_patch
                row[name] = {k: res[k] for k in ("puzzle_acc", "patch_acc", "harness_s",
                                                  "puzzles_per_s")}
                row[name].update(jax_puzzle_acc=want_puzzle, jax_patch_acc=want_patch,
                                 per_puzzle_agreement_with_jax=agree)
                log(f"  {name}: puzzle {res['puzzle_acc']:.4f} (JAX {want_puzzle}, "
                    f"{d_puzzle:+.4f}), patch {res['patch_acc']:.4f} (JAX {want_patch}, "
                    f"{d_patch:+.4f}); per-puzzle agreement with the JAX journal {agree:.4f}")
                if not (abs(d_puzzle) <= EVAL_PUZZLE_TOL and abs(d_patch) <= EVAL_PATCH_TOL):
                    raise AssertionError(f"{name}: accuracy {res['puzzle_acc']} / "
                                         f"{res['patch_acc']} outside +-{EVAL_PUZZLE_TOL} / "
                                         f"+-{EVAL_PATCH_TOL} of {want_puzzle} / {want_patch}")
    log(f"grid-20 eval on {card}: " + json.dumps(row))
    log(f"phase grid-20 eval: {time.perf_counter() - t0:.2f} s")
    return row, block_launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid20-artifact", action="store_true",
                    help="skip the waves3 artifact's phases (3, 4, 7, 8) and start the "
                         "grid-20 phases from artifacts/waves20_hard_step32700")
    args = ap.parse_args(argv)
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
    lib_paths = _build.build_all("attention", "attention_bwd", "attention_block", "flash_fwd",
                                 "flash_bwd", "assignment")
    attn_ops._kernel()
    attn_ops._bwd_kernel()
    attn_ops._block_kernel()
    flash_ops._fwd_kernel()
    flash_ops._bwd_kernel()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s -> {[os.path.relpath(p, REPO) for p in lib_paths]}")
    for lib_path in lib_paths:
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "Compiling entry", "spill")):
                log(f"  ptxas: {line.strip()}")
    # The route table's shared-memory sums (ops/attention.py) are the kernels'.
    for n in (9, 144, 205, 206, 400, 571, 572):
        for elem in (2, 4):
            if (attn_ops.k1_smem_bytes(n, elem) != attn_ops._kernel().k1_attention_smem_bytes(n, elem)
                    or attn_ops.k2_smem_bytes(n, elem)
                    != attn_ops._bwd_kernel().k2_attention_bwd_smem_bytes(n, elem)):
                raise AssertionError(f"the route table's shared memory at N={n}, "
                                     f"{elem} B differs from the kernels'")
    for n in (9, 77, 144, 252, 253, 400, 401, 443, 444):
        for elem in (2, 4):
            if (attn_ops.k3_smem_bytes(n, elem)
                    != attn_ops._block_kernel().k3_attention_block_smem_bytes(n, elem)):
                raise AssertionError(f"the route table's K3 shared memory at N={n}, "
                                     f"{elem} B differs from the kernel's")

    # 2. K1 against its plain version.
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(0)
    k1_rows = [check_k1(16, TOKENS, torch.bfloat16, gen, timed=True),
               check_k1(32, TOKENS, torch.bfloat16, gen, timed=True),
               check_k1(TRAIN_BATCH, TOKENS, torch.bfloat16, gen, timed=True),
               check_k1(3, 77, torch.bfloat16, gen, timed=False),
               check_k1(2, 200, torch.bfloat16, gen, timed=False),
               check_k1(2, TOKENS, torch.float32, gen, timed=False),
               check_k1(32, TOKENS20, torch.bfloat16, gen, timed=True)]
    log(f"phase k1: {time.perf_counter() - t0:.2f} s")

    # 3-4. The waves3 artifact's solve and its throughput.
    if args.grid20_artifact:
        log("--grid20-artifact: phases 3, 4, 7 and 8 (they read the waves3 artifact, "
            "which this copy does not hold) are skipped")
        g3 = None
    else:
        g3 = solve_grid3(card)

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

    # 7-8. Training warm-started from the waves3 artifact; throughput.
    launches_train = None if g3 is None else train_grid3(g3, card)

    # 9. K4, K5, K6 against their plain versions.
    t0 = time.perf_counter()
    k4_rows = [check_k4(TRAIN_BATCH, TOKENS20, torch.bfloat16, gen, timed=True),
               check_k4(32, TOKENS20, torch.bfloat16, gen, timed=True),
               check_k4(32, TOKENS20, torch.float32, gen, timed=True),
               check_k4(3, 77, torch.bfloat16, gen, timed=False),
               check_k4(2, 200, torch.bfloat16, gen, timed=False),
               check_k4(2, 401, torch.bfloat16, gen, timed=False),
               check_k4(2, 401, torch.float32, gen, timed=False),
               check_k4(2, TOKENS20, torch.bfloat16, gen, timed=False, fused=False)]
    k56_rows = [check_k5_k6(TRAIN_BATCH, TOKENS20, torch.bfloat16, gen, timed=True),
                check_k5_k6(32, TOKENS20, torch.bfloat16, gen, timed=True),
                check_k5_k6(32, TOKENS20, torch.float32, gen, timed=True),
                check_k5_k6(3, 77, torch.bfloat16, gen, timed=False),
                check_k5_k6(2, 200, torch.bfloat16, gen, timed=False),
                check_k5_k6(2, 401, torch.bfloat16, gen, timed=False),
                check_k5_k6(2, 401, torch.float32, gen, timed=False)]
    log(f"phase k4-k6: {time.perf_counter() - t0:.2f} s")

    # 10. Gradients through the flash route at 320 px, grid 20.
    t0 = time.perf_counter()
    check_gradients(SIZE20, GRID20, 4, {"k4": 12, "k5": 12, "k6": 12})
    log(f"phase flash gradients: {time.perf_counter() - t0:.2f} s")

    # 11. The grid-20 training path.
    t0 = time.perf_counter()
    template20 = np.load(NOISE_TEMPLATE20)
    if args.grid20_artifact:
        sd20, step20 = load_artifact(ARTIFACT20)
        log(f"grid-20 training warm-started from {os.path.relpath(ARTIFACT20, REPO)} "
            f"at step {step20}")
    else:
        sd20, step20 = None, 0
        log("grid-20 training from random weights (seed 0): the default copy holds no "
            "grid-20 artifact; --grid20-artifact starts from waves20_hard_step32700")
    train20 = check_training20(sd20, step20)
    launches_train20 = train20["launches"]
    log(f"phase grid-20 training: {time.perf_counter() - t0:.2f} s")
    row = train_throughput(train20["state"], TRAIN_BATCH, size=SIZE20, grid=GRID20)
    log(f"grid-20 train step on {card}: " + json.dumps(row))

    # 12. The N = 400 solve; in artifact mode the EMA model's beside the artifact's.
    t0 = time.perf_counter()
    solve20 = check_solve20(sd20, template20)
    log(f"grid-20 solve on {card}: " + json.dumps(solve20))
    if args.grid20_artifact:
        x16, perms16 = wave_puzzles(16, 123, SIZE20, GRID20)
        for mode in ("fast", "faithful"):
            res = PuzzleSolver(train20["state"].ema, train20["cfg"], create_diffusion("250"),
                               grid_size=GRID20, mode=mode,
                               noise_template=template20).evaluate(x16, perms16)
            log(f"  EMA model after {TRAIN_STEPS} steps, {mode}: puzzle acc "
                f"{res.puzzle_accuracy:.4f}, patch acc {res.patch_accuracy:.4f} (the "
                f"unchanged artifact, bf16: puzzle acc "
                f"{solve20[f'bf16_{mode}']['puzzle_acc']:.4f}, patch acc "
                f"{solve20[f'bf16_{mode}']['patch_acc']:.4f})")
    log(f"phase grid-20 solve: {time.perf_counter() - t0:.2f} s")
    del train20, sd20
    if args.grid20_artifact:
        t0 = time.perf_counter()
        check_run_train(ARTIFACT20, step20, [f"model.image_size={SIZE20}",
                                             f"task.grid_size={GRID20}"])
        log(f"phase grid-20 run_train: {time.perf_counter() - t0:.2f} s")

    # 13. K3 against its plain version, on the artifact's first DiT block.
    t0 = time.perf_counter()
    if args.grid20_artifact:
        sd20, _ = load_artifact(ARTIFACT20)
        weights = first_block(sd20)
        del sd20
    else:
        weights = first_block(g3["sd"])
    k3_rows = [check_k3(32, TOKENS, torch.bfloat16, weights, gen, timed=True),
               check_k3(32, TOKENS20, torch.bfloat16, weights, gen, timed=True),
               check_k3(16, TOKENS, torch.bfloat16, weights, gen, timed=True),
               check_k3(4, TOKENS, torch.float32, weights, gen, timed=True),
               check_k3(3, 77, torch.bfloat16, weights, gen, timed=False),
               check_k3(2, 200, torch.bfloat16, weights, gen, timed=False),
               check_k3(2, 401, torch.bfloat16, weights, gen, timed=False)]
    log(f"phase k3: {time.perf_counter() - t0:.2f} s")

    # 14. The eval path: waves3 on both routes, or waves20 against the JAX journals.
    if args.grid20_artifact:
        _, k3_launches = eval_grid20(card)
        k3_timed = k3_rows[1]
    else:
        g3.pop("sd")
        k3_launches = eval_grid3(card)["eval_launches"]
        k3_timed = k3_rows[0]

    def kernel_row(name, source, replaces, launches, rows, timed):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "shape": timed["shape"],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")}}

    k1 = ("jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention.cu",
          "jpdvt_mt_ntnu_tpu/ops/attention.py:26")
    flash_fwd = ("jpdvt_mt_ntnu_tpu_torch/ops/csrc/flash_fwd.cu",
                 "jpdvt_mt_ntnu_tpu/ops/flash_attention.py:58")
    flash_bwd = "jpdvt_mt_ntnu_tpu_torch/ops/csrc/flash_bwd.cu"
    # Each kernel with the launches of its own path's run and the errors of
    # its shapes: K1 for the solve (B=16) and the train step (B=96), K2 and
    # K4-K6 for their train steps (B=96; N=144 and N=400), K3 for the
    # block route's eval (timed at B=32; N=144, or N=400 from the grid-20
    # artifact).
    kernels = []
    if g3 is not None:
        kernels += [
            kernel_row("k1_whole_row_attention_fwd", *k1, g3["launches_solve"],
                       [r for r in k1_rows if r["shape"][0] != TRAIN_BATCH
                        and r["shape"][2] != TOKENS20], k1_rows[0]),
            kernel_row("k1_whole_row_attention_fwd_train", *k1, launches_train[0],
                       [k1_rows[2]], k1_rows[2]),
            kernel_row("k2_whole_row_attention_bwd",
                       "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention_bwd.cu",
                       "jpdvt_mt_ntnu_tpu/ops/attention.py:44", launches_train[1],
                       k2_rows, k2_rows[0])]
    else:  # K1's own path in this mode: the bf16 N = 400 solve of phase 12
        kernels.append(kernel_row(
            "k1_whole_row_attention_fwd", *k1,
            sum(solve20[f"bf16_{m}"]["launches"]["k1"] for m in ("fast", "faithful")),
            k1_rows, k1_rows[-1]))
    kernels += [
        kernel_row("k3_fused_attention_block",
                   "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention_block.cu",
                   "jpdvt_mt_ntnu_tpu/ops/attention.py:242", k3_launches["k3"], k3_rows,
                   k3_timed),
        kernel_row("k4_flash_attention_fwd", *flash_fwd, launches_train20["k4"],
                   k4_rows, k4_rows[0]),
        kernel_row("k5_flash_attention_dq", flash_bwd,
                   "jpdvt_mt_ntnu_tpu/ops/flash_attention.py:162", launches_train20["k5"],
                   [r[0] for r in k56_rows], k56_rows[0][0]),
        kernel_row("k6_flash_attention_dkv", flash_bwd,
                   "jpdvt_mt_ntnu_tpu/ops/flash_attention.py:194", launches_train20["k6"],
                   [r[1] for r in k56_rows], k56_rows[0][1])]
    log(f"total: {time.perf_counter() - t_start:.2f} s (build {build_s:.2f} s)")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
