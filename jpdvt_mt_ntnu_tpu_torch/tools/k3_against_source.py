"""K3 against another copy of its source, on a card.

Builds ``--other`` (another ``attention_block.cu``, for example one unpacked
from an earlier commit with ``git archive``) with the flags of
``ops/_build.py`` at each head dim, beside the port's own, and reports for
each head dim:

- the SASS instructions of each kernel of ``--other``'s library beside the
  same kernel of the port's (``cuobjdump --dump-sass``), by mangled name,
  and whether every one of them is in the port's library with an equal
  count, leaving out the bf16 long-row kernels (``block_project_*`` and
  ``block_attention_long_*`` on the tensor cores), which the two sources
  may design differently: those are held by their outputs only;
- whether ``k3_attention_block`` (the short-row launch pair) gives the same
  bits from both libraries on the same random inputs, bf16 and fp32, at
  each ``--shapes`` (B x N; the short-row instance's N), and whether
  ``k3_attention_block_long`` (the long-row instance) does at each
  ``--long-shapes`` (bf16; fp32 where its shared memory takes N).

``--time-long`` also times, on the same inputs and alternating (the other
library first in even rounds, the port's first in odd ones, ``--rounds``
rounds of 20 calls each), the two long-row instances at the shapes
``TIMED`` lists (bf16 at (32, 576, 768), (32, 400, 768) and (32, 144,
1152); fp32 at (4, 144, 1152)) and the two short-row instances at (32,
144, 768), in µs per call by CUDA events, with each bf16 long-row
instance's three launches (L.1, L.2, A.2) timed alone; and, at Dh 64 in
bf16 at batches 1, 4 and 8 (``HOST``), the host µs a call takes to return
(the device left running): each library's ``k3_attention_block_long`` alone,
alternating, and the port's whole wrapper (``fused_attention_block_k3``)
on each instance, beside each call's device µs. A source without
``k3_attention_block_long_stage`` (one before that entry point) gets one
appended, written against the earlier design's kernel names
(``_STAGE_SHIM``).

    python -m jpdvt_mt_ntnu_tpu_torch.tools.k3_against_source --other PATH
        [--shapes 32x144,2x400,3x77] [--long-shapes 8x576,2x855,3x77]
        [--time-long [--rounds 6]] [--out FILE.json]

Prints one JSON object (and writes it to ``--out``), then exits 1 if a
kernel of ``--other`` held by SASS is missing from the port's library or
has another count at a head dim, or if the outputs differ anywhere; else 0.
Needs a CUDA card and ``nvcc``; it fails without them.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..ops import _build
from ..ops import attention as attn_ops

HEADS = {64: (12, 768), 72: (16, 1152)}  # the flagship's and DiT-XL's attention
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")
# The bf16 long-row kernels, held by outputs only.
_LONG_BF16 = re.compile(r"block_project_(mma|wgmma)_kernel|block_attention_long_(mma|wgmma)_kernel")
# (B, N, head dim, dtype, instance) timed by --time-long.
TIMED = ((32, 576, 64, torch.bfloat16, "long"), (32, 400, 64, torch.bfloat16, "long"),
         (32, 144, 72, torch.bfloat16, "long"), (4, 144, 72, torch.float32, "long"),
         (32, 144, 64, torch.bfloat16, "short"))

# (B, N) timed on the host by --time-long, at Dh 64 in bf16: batches where
# host time may exceed device time.
HOST = ((1, 144), (4, 144), (8, 144), (1, 576), (4, 576), (8, 576))

# k3_attention_block_long_stage for the design before it had one (L.1
# block_project_mma_kernel, L.2 block_attention_long_mma_kernel, A.2).
_STAGE_SHIM = r"""
extern "C" int k3_attention_block_long_stage(int stage, int dtype, const void* x,
    const void* wqkv, const void* bqkv, const void* wproj, const void* bproj, void* qkv,
    void* o, void* out, int b, int n, int heads, int hidden, float scale, void* stream) {
  using bf = __nv_bfloat16;
  if (dtype != 1 || stage < 0 || stage > 2) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int np = (n + 15) / 16 * 16;
  if (stage == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc::block_project_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tc::long_proj_smem_bytes());
    if (err != cudaSuccess) return (int)err;
    tc::block_project_mma_kernel<<<dim3((np + tc::kPR - 1) / tc::kPR, heads, b),
                                   tc::kA1Threads, tc::long_proj_smem_bytes(), s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(wqkv),
        static_cast<const float*>(bqkv), static_cast<bf*>(qkv), n, heads, hidden, scale);
  } else if (stage == 1) {
    tc::block_attention_long_mma_kernel<<<dim3((np / 16 + tc::kLTiles - 1) / tc::kLTiles,
                                               heads, b),
                                          tc::kLThreads, tc::long_smem_bytes(), s>>>(
        static_cast<const bf*>(qkv), static_cast<bf*>(o), n, heads);
  } else {
    const int m = b * n;
    tc::out_proj_mma_kernel<<<dim3((m + tc::kOM - 1) / tc::kOM, hidden / tc::kON), kThreads,
                              0, s>>>(
        static_cast<const bf*>(o), static_cast<const bf*>(wproj),
        static_cast<const float*>(bproj), static_cast<bf*>(out), m, heads * kD, hidden);
  }
  return (int)cudaGetLastError();
}
"""


def _build_other(src: Path, head_dim: int, out_dir: Path) -> Path:
    out = out_dir / f"libk3_other_d{head_dim}.so"
    text = src.read_text()
    if "k3_attention_block_long_stage" not in text:
        text += _STAGE_SHIM
    # The file keeps its name: the anonymous namespace's mangled name, which
    # the kernels' names hold, is made from it.
    copy = out_dir / "other" / "attention_block.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(text)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(copy),
           f"-DHEAD_DIM={head_dim}"]
    subprocess.run(cmd, check=True, capture_output=True, stdin=subprocess.DEVNULL,
                   timeout=_build.NVCC_TIMEOUT_S)
    return out


def sass_instructions(lib: Path) -> dict:
    """Instructions of each kernel in a library's SASS, by mangled name
    with the anonymous namespace's tag (a hash of the file) taken out."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True, text=True,
                          check=True, stdin=subprocess.DEVNULL, timeout=120).stdout
    counts, kernel = collections.Counter(), None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = _ANON.sub("", line.split("Function :")[1].strip())
        elif kernel and line.strip().startswith("/*") and "*/" in line and ";" in line:
            counts[kernel] += 1
    return dict(counts)


class _Lib:
    """One K3 library's C functions, with their argument types."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for name, args in (("k3_attention_block", [i] + [ptr] * 7 + [i] * 4 + [f, ptr]),
                           ("k3_attention_block_long", [i] + [ptr] * 8 + [i] * 4 + [f, ptr]),
                           ("k3_attention_block_long_stage",
                            [i, i] + [ptr] * 8 + [i] * 4 + [f, ptr])):
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = args, i
        scratch = getattr(self.lib, "k3_attention_block_long_scratch_elems", None)
        if scratch is not None:
            scratch.argtypes, scratch.restype = [i] * 4, ctypes.c_size_t
        self.scratch_elems = scratch

    def scratch(self, b: int, n: int, heads: int, d: int, dtype: torch.dtype) -> torch.Tensor:
        elem = torch.empty((), dtype=dtype).element_size()
        elems = (self.scratch_elems(b, n, heads, elem) if self.scratch_elems is not None
                 else 3 * b * heads * -(-n // 16) * 16 * d)
        return torch.empty(elems, dtype=dtype, device="cuda")


def _operands(b: int, n: int, d: int, dtype: torch.dtype, gen: torch.Generator) -> tuple:
    heads, hidden = HEADS[d]
    x = torch.randn((b, n, hidden), generator=gen, device="cuda").to(dtype)
    wq = (torch.randn((3 * hidden, hidden), generator=gen, device="cuda")
          * hidden ** -0.5).to(dtype)
    wp = (torch.randn((hidden, hidden), generator=gen, device="cuda") * hidden ** -0.5).to(dtype)
    bq = 0.1 * torch.randn(3 * hidden, generator=gen, device="cuda")
    bp = 0.1 * torch.randn(hidden, generator=gen, device="cuda")
    ops = attn_ops.dense_to_block_weights(wq, bq, wp, bp, heads)
    laid = attn_ops._weight_strides(ops[0], ops[2])
    return (x, attn_ops._as_laid_out(ops[0], laid[0]), ops[1],
            attn_ops._as_laid_out(ops[2], laid[1]), ops[3])


class _Call:
    """One instance of one library on fixed operands: ``run()`` launches the
    whole call, ``stage(i)`` one of the bf16 long-row launches."""

    def __init__(self, lib: _Lib, instance: str, ops: tuple, d: int):
        x = ops[0]
        self.b, self.n, self.hidden = x.shape
        self.heads, self.d, self.dtype = HEADS[d][0], d, x.dtype
        self.lib, self.instance = lib, instance
        self.o = torch.empty((self.b, self.n, self.heads * d), dtype=x.dtype, device="cuda")
        self.out = torch.empty_like(x)
        self.qkv = lib.scratch(self.b, self.n, self.heads, d, x.dtype)
        self.ptrs = tuple(t.data_ptr() for t in ops)
        self.code = attn_ops._DTYPE_CODES[x.dtype]
        self.scale = attn_ops.q_scale(d, x.dtype)

    def _tail(self):
        return (self.b, self.n, self.heads, self.hidden, self.scale,
                torch.cuda.current_stream().cuda_stream)

    def run(self) -> torch.Tensor:
        if self.instance == "short":
            err = self.lib.lib.k3_attention_block(self.code, *self.ptrs, self.o.data_ptr(),
                                                  self.out.data_ptr(), *self._tail())
        else:
            err = self.lib.lib.k3_attention_block_long(
                self.code, *self.ptrs, self.qkv.data_ptr(), self.o.data_ptr(),
                self.out.data_ptr(), *self._tail())
        if err:
            raise RuntimeError(f"K3 {self.instance} launch failed: cudaError {err}")
        return self.out

    def stage(self, i: int) -> torch.Tensor:
        err = self.lib.lib.k3_attention_block_long_stage(
            i, self.code, *self.ptrs, self.qkv.data_ptr(), self.o.data_ptr(),
            self.out.data_ptr(), *self._tail())
        if err:
            raise RuntimeError(f"K3 long-row stage {i} launch failed: cudaError {err}")
        return self.out


def _same_output(mine: _Lib, theirs: _Lib, instance: str, ops: tuple, d: int) -> bool:
    a = _Call(mine, instance, ops, d).run().clone()
    b = _Call(theirs, instance, ops, d).run().clone()
    torch.cuda.synchronize()
    return torch.equal(a, b)


def compare(other: Path, shapes: list, long_shapes: list, work: Path) -> tuple:
    """The report of the module's first two points, and each head dim's pair
    of libraries (the port's, the other)."""
    work.mkdir(parents=True, exist_ok=True)
    report, libs = {}, {}
    for d in HEADS:
        mine_path = _build.build(_build.unit("attention_block", d))
        other_path = _build_other(other, d, work)
        mine_all, other_all = sass_instructions(mine_path), sass_instructions(other_path)
        mine_sass = {k: v for k, v in mine_all.items() if not _LONG_BF16.search(k)}
        other_sass = {k: v for k, v in other_all.items() if not _LONG_BF16.search(k)}
        missing = sorted(set(other_sass) - set(mine_sass))
        mine, theirs = _Lib(mine_path), _Lib(other_path)
        libs[d] = (mine, theirs)
        gen = torch.Generator("cuda").manual_seed(d)
        equal, long_equal = {}, {}
        for dtype in (torch.bfloat16, torch.float32):
            elem = torch.empty((), dtype=dtype).element_size()
            tag = str(dtype).split(".")[-1]
            for b, n in shapes:
                if attn_ops.k3_smem_bytes(n, elem, d) <= attn_ops.HOPPER_MAX_SMEM:
                    equal[f"{tag}_{b}x{n}"] = _same_output(
                        mine, theirs, "short", _operands(b, n, d, dtype, gen), d)
            for b, n in long_shapes:
                if attn_ops.k3_long_smem_bytes(n, elem, d) <= attn_ops.HOPPER_MAX_SMEM:
                    long_equal[f"{tag}_{b}x{n}"] = _same_output(
                        mine, theirs, "long", _operands(b, n, d, dtype, gen), d)
        report[f"dh{d}"] = {
            "sass_instructions": {k: [mine_sass.get(k), n] for k, n in sorted(other_sass.items())},
            "missing_in_mine": missing,
            "sass_equal": bool(other_sass) and not missing
            and all(mine_sass[k] == n for k, n in other_sass.items()),
            "only_in_mine": sorted(set(mine_sass) - set(other_sass)),
            "long_row_bf16_kernels": {
                "mine": {k: v for k, v in mine_all.items() if _LONG_BF16.search(k)},
                "other": {k: v for k, v in other_all.items() if _LONG_BF16.search(k)}},
            "outputs_bit_equal": equal, "long_outputs_bit_equal": long_equal}
    return report, libs


def _us(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / reps


def time_long(libs: dict, rounds: int) -> list:
    """Each ``TIMED`` row: µs per call of the other library's instance and
    the port's, alternating, and for the bf16 long-row instance each
    launch alone; the other's mean over the port's is the speed-up."""
    rows = []
    gen = torch.Generator("cuda").manual_seed(25)
    for b, n, d, dtype, instance in TIMED:
        ops = _operands(b, n, d, dtype, gen)
        calls = {"other": _Call(libs[d][1], instance, ops, d),
                 "mine": _Call(libs[d][0], instance, ops, d)}
        split = instance == "long" and dtype == torch.bfloat16
        if split:
            for call in calls.values():  # L.1, then L.2, then A.2, once in order
                for i in range(3):
                    call.stage(i)
        us = {k: [] for k in calls}
        stages = {k: [[], [], []] for k in calls}
        for r in range(rounds):
            for k in (("other", "mine") if r % 2 == 0 else ("mine", "other")):
                us[k].append(_us(calls[k].run))
                if split:
                    for i in range(3):
                        stages[k][i].append(_us(lambda: calls[k].stage(i)))
        row = {"shape": [b, n, HEADS[d][1]], "heads": HEADS[d][0], "head_dim": d,
               "dtype": str(dtype).split(".")[-1], "instance": instance, "rounds": rounds}
        for k in calls:
            row[f"{k}_us"] = sum(us[k]) / rounds
            row[f"{k}_us_rounds"] = us[k]
            if split:
                row[f"{k}_split_us"] = {name: sum(v) / rounds
                                        for name, v in zip(("L.1", "L.2", "A.2"), stages[k])}
        ratios = [a / b for a, b in zip(us["other"], us["mine"])]
        row["speedup"] = row["other_us"] / row["mine_us"]
        row["speedup_rounds_mean"] = sum(ratios) / rounds
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def _host_us(fn, reps: int = 100) -> float:
    """Host µs for ``fn()`` to return, the device left running (``reps``
    calls queue at most 300 launches, below the launch queue's depth)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / reps


def host_long(libs: dict, rounds: int) -> list:
    """Each ``HOST`` row: host µs a call of each library's long-row C entry,
    alternating, and of the port's wrapper on either instance, with the
    device µs of each library's call."""
    rows = []
    gen = torch.Generator("cuda").manual_seed(26)
    heads = HEADS[64][0]
    for b, n in HOST:
        ops = _operands(b, n, 64, torch.bfloat16, gen)
        calls = {"other": _Call(libs[64][1], "long", ops, 64),
                 "mine": _Call(libs[64][0], "long", ops, 64)}
        host = {k: [] for k in calls}
        for r in range(rounds):
            for k in (("other", "mine") if r % 2 == 0 else ("mine", "other")):
                host[k].append(_host_us(calls[k].run))
        row = {"shape": [b, n, HEADS[64][1]], "heads": heads, "dtype": "bfloat16",
               "rounds": rounds}
        for k in calls:
            row[f"{k}_c_host_us"] = sum(host[k]) / rounds
            row[f"{k}_device_us"] = _us(calls[k].run)
        for instance in ("long", "short"):
            if instance == "short" and \
                    attn_ops.k3_smem_bytes(n, 2, 64) > attn_ops.HOPPER_MAX_SMEM:
                continue
            row[f"wrapper_{instance}_host_us"] = _host_us(
                lambda: attn_ops.fused_attention_block_k3(*ops, heads, instance=instance))
            row[f"wrapper_{instance}_device_us"] = _us(
                lambda: attn_ops.fused_attention_block_k3(*ops, heads, instance=instance))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def same(report: dict) -> bool:
    """Every kernel held by SASS in the port's library with its count, and
    every output bit-equal, at every head dim."""
    return all(r["sass_equal"] and r["outputs_bit_equal"] and all(r["outputs_bit_equal"].values())
               and all(r["long_outputs_bit_equal"].values()) for r in report.values())


def _shapes(text: str) -> list:
    return [tuple(int(v) for v in s.split("x")) for s in text.split(",") if s]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another attention_block.cu")
    ap.add_argument("--shapes", default="32x144,2x400,3x77,2x223")
    ap.add_argument("--long-shapes", default="32x144,2x400,8x576,3x77,2x855")
    ap.add_argument("--time-long", action="store_true",
                    help="also time the two long-row instances, alternating")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available() or shutil.which("nvidia-smi") is None:
        raise SystemExit("k3_against_source needs a CUDA card")
    report, libs = compare(Path(args.other), _shapes(args.shapes), _shapes(args.long_shapes),
                           _build.BUILD_DIR / "k3_other")
    ok = same(report)
    if args.time_long:
        report["timed"] = time_long(libs, args.rounds)
        report["host"] = host_long(libs, args.rounds)
    line = json.dumps(report)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
