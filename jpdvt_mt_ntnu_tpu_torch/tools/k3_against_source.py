"""K3's short-row instance against another copy of its source, on a card.

Builds ``--other`` (another ``attention_block.cu``, for example one unpacked
from an earlier commit with ``git archive``) with the flags of
``ops/_build.py`` at each head dim, beside the port's own, and reports for
each head dim:

- the SASS instructions of each kernel of ``--other``'s library beside the
  same kernel of the port's (``cuobjdump --dump-sass``), by mangled name,
  and whether every one of them is in the port's library with an equal
  count (``--other`` holds the short-row kernels only, the port's also the
  long-row ones);
- whether ``k3_attention_block`` (the short-row launch pair) gives the same
  bits from both libraries on the same random inputs, bf16 and fp32, at
  each ``--shapes`` (B x N; the short-row instance's N).

    python -m jpdvt_mt_ntnu_tpu_torch.tools.k3_against_source --other PATH
        [--shapes 32x144,2x400,3x77] [--out FILE.json]

Prints one JSON object (and writes it to ``--out``), then exits 1 if a
kernel of ``--other`` is missing from the port's library or has another
count at a head dim, or if the outputs differ anywhere; else 0. Needs a
CUDA card and ``nvcc``; it fails without them.
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
from pathlib import Path

import torch

from ..ops import _build
from ..ops import attention as attn_ops

HEADS = {64: (12, 768), 72: (16, 1152)}  # the flagship's and DiT-XL's attention
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def _build_other(src: Path, head_dim: int, out_dir: Path) -> Path:
    out = out_dir / f"libk3_other_d{head_dim}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(src),
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


def _k3(lib: ctypes.CDLL, dtype: torch.dtype, ops: tuple, b: int, n: int, heads: int,
        hidden: int, d: int) -> torch.Tensor:
    fn = lib.k3_attention_block
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    x, w_qkv, b_qkv, w_proj, b_proj = ops
    o = torch.empty((b, n, heads * d), dtype=dtype, device="cuda")
    out = torch.empty_like(x)
    err = fn(attn_ops._DTYPE_CODES[dtype], x.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(),
             w_proj.data_ptr(), b_proj.data_ptr(), o.data_ptr(), out.data_ptr(), b, n, heads,
             hidden, attn_ops.q_scale(d, dtype), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K3 launch failed: cudaError {err}")
    torch.cuda.synchronize()
    return out


def compare(other: Path, shapes: list[tuple[int, int]], work: Path) -> dict:
    work.mkdir(parents=True, exist_ok=True)
    report = {}
    for d, (heads, hidden) in HEADS.items():
        mine_path = _build.build(_build.unit("attention_block", d))
        other_path = _build_other(other, d, work)
        mine_sass, other_sass = sass_instructions(mine_path), sass_instructions(other_path)
        missing = sorted(set(other_sass) - set(mine_sass))
        mine, theirs = ctypes.CDLL(str(mine_path)), ctypes.CDLL(str(other_path))
        gen = torch.Generator("cuda").manual_seed(d)
        equal = {}
        for dtype in (torch.bfloat16, torch.float32):
            elem = torch.empty((), dtype=dtype).element_size()
            for b, n in shapes:
                if attn_ops.k3_smem_bytes(n, elem, d) > attn_ops.HOPPER_MAX_SMEM:
                    continue
                x = torch.randn((b, n, hidden), generator=gen, device="cuda").to(dtype)
                wq = (torch.randn((3 * hidden, hidden), generator=gen, device="cuda")
                      * hidden ** -0.5).to(dtype)
                wp = (torch.randn((hidden, hidden), generator=gen, device="cuda")
                      * hidden ** -0.5).to(dtype)
                bq = 0.1 * torch.randn(3 * hidden, generator=gen, device="cuda")
                bp = 0.1 * torch.randn(hidden, generator=gen, device="cuda")
                ops = attn_ops.dense_to_block_weights(wq, bq, wp, bp, heads)
                laid = attn_ops._weight_strides(ops[0], ops[2])
                ops = (x, attn_ops._as_laid_out(ops[0], laid[0]), ops[1],
                       attn_ops._as_laid_out(ops[2], laid[1]), ops[3])
                args = (dtype, ops, b, n, heads, hidden, d)
                equal[f"{str(dtype).split('.')[-1]}_{b}x{n}"] = torch.equal(
                    _k3(mine, *args), _k3(theirs, *args))
        report[f"dh{d}"] = {
            "sass_instructions": {k: [mine_sass.get(k), n] for k, n in sorted(other_sass.items())},
            "missing_in_mine": missing,
            "sass_equal": bool(other_sass) and not missing
            and all(mine_sass[k] == n for k, n in other_sass.items()),
            "only_in_mine": sorted(set(mine_sass) - set(other_sass)),
            "outputs_bit_equal": equal}
    return report


def same(report: dict) -> bool:
    """Every kernel of the other library in the port's with its count, and
    every output bit-equal, at every head dim."""
    return all(r["sass_equal"] and r["outputs_bit_equal"] and all(r["outputs_bit_equal"].values())
               for r in report.values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another attention_block.cu")
    ap.add_argument("--shapes", default="32x144,2x400,3x77,2x223")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available() or shutil.which("nvidia-smi") is None:
        raise SystemExit("k3_against_source needs a CUDA card")
    shapes = [tuple(int(v) for v in s.split("x")) for s in args.shapes.split(",")]
    report = compare(Path(args.other), shapes, _build.BUILD_DIR / "k3_other")
    line = json.dumps(report)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0 if same(report) else 1


if __name__ == "__main__":
    raise SystemExit(main())
