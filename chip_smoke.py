#!/usr/bin/env python3
"""Drive the PyTorch port's puzzle solve on one NVIDIA GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``; it exits non-zero, printing no result, without them.

Phases, each of which raises on failure:

1. build the CUDA kernel (``nvcc`` -> ``.so`` -> ``ctypes``) and print the
   card's name and power limit;
2. hold kernel K1 (whole-row attention) against its plain PyTorch version
   on the card at the main path's shapes and a ragged one, and time both
   beside one PyTorch call of the same function (SDPA, a yardstick only);
3. the main path: load ``artifacts/waves3_r5_step10000`` through the
   port's loader, fast-solve and faithful-250-solve the 16 unseen wave
   puzzles of the artifact's export smoke with the JAX package's seed-0
   noise template (``tests/golden``), in bf16, and check the accuracy, the
   kernel's launch count, that faithful and fast agree bit for bit, and
   that a solve on the plain attention gives the same permutations;
4. faithful-250 and fast puzzles/s at batch 32.

The last two lines are the ``kernels`` JSON and the device JSON.
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
HEADS, HEAD_DIM, TOKENS = 12, 64, 144
STEPS = 250


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


def bound_ms(b: int, h: int, n: int, d: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for K1's work: q, k, v read once and o written once,
    against the two products' operations."""
    elem = torch.empty((), dtype=dtype).element_size()
    t_bytes = 4 * b * h * n * d * elem / HBM_BYTES_PER_S
    t_ops = 4 * b * h * n * n * d / PEAK_FLOPS[dtype]
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


@contextlib.contextmanager
def plain_attention():
    """Route the DiT's attention to the plain version for a comparison solve."""
    kernel_route = dit.fused_qkv_attention
    dit.fused_qkv_attention = attn_ops.fused_qkv_attention_reference
    try:
        yield
    finally:
        dit.fused_qkv_attention = kernel_route


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

    # 1. Build.
    t0 = time.perf_counter()
    lib_path = _build.build("attention")
    attn_ops._kernel()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s -> {os.path.relpath(lib_path, REPO)}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # 2. K1 against its plain version.
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(0)
    k1_rows = [check_k1(16, TOKENS, torch.bfloat16, gen, timed=True),
               check_k1(32, TOKENS, torch.bfloat16, gen, timed=True),
               check_k1(3, 77, torch.bfloat16, gen, timed=False),
               check_k1(2, 200, torch.bfloat16, gen, timed=False),
               check_k1(2, TOKENS, torch.float32, gen, timed=False)]
    log(f"phase k1: {time.perf_counter() - t0:.2f} s")

    # 3. The main path.
    t0 = time.perf_counter()
    attn_ops.attention.launches = 0
    sd, step = load_artifact(ARTIFACT)
    model, cfg = create_model("JPDVT", 192, dtype=torch.bfloat16)
    model.load_state_dict(sd)
    del sd
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
    launches = attn_ops.attention.launches
    launches_faithful = launches - launches_fast
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

    main_row = k1_rows[0]
    kernels = [{
        "name": "k1_whole_row_attention_fwd", "route": "cuda",
        "source": "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention.cu",
        "replaces": "jpdvt_mt_ntnu_tpu/ops/attention.py:26",
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]
    log(f"total: {time.perf_counter() - t_start:.2f} s (build {build_s:.2f} s)")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
