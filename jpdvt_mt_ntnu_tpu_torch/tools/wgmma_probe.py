"""Does Hopper's warpgroup product give ``mma.sync``'s bits? A probe on a card.

K3's long-row instance (``ops/csrc/attention_block.cu``) is bit-equal to
its short-row instance only if ``wgmma.mma_async`` m64nNk16 with fp32
accumulators gives the same bits as ``mma.sync`` m16n8k16 for the same
bf16 operands and the same k16 steps in the same order. This tool builds
the source's own wgmma helpers (the part between ``>>> wgmma helpers`` and
``<<< wgmma helpers``) into a probe kernel of one warpgroup that computes
a 64 x N product both ways from random bf16 operands (numpy, seeded), in
each operand layout the long-row instance uses:

- ``ss_sw128``: A and B from shared memory in 64-wide K-chunks with the
  128-byte swizzle (L.1's projection; N 192 and 216, K 768);
- ``rs_core_k``: A from registers (``mma.sync``'s A fragments), B from 8 x
  8 core matrices with 8-row groups outermost (L.2's S = q k^T; N 64, K 64
  and 80 a chunk, three chunks), the first k16 step writing the
  accumulators (scale-d 0) where ``mma.sync`` adds to zeros;
- ``rs_core_vt``: A from registers, B^T per 8-key group (L.2's P v; N 64
  and 72, K 576).

For each it reports whether the two results are equal bit for bit, the
largest difference between them, and each one's largest error against a
float64 product (which shows a wrong layout). Prints one JSON object
(and writes it to ``--out``); exits 1 if a layout is wrong (an error past
2^-10 of the product's scale), else 0, whether or not the bits agree.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.wgmma_probe [--out FILE.json]

Needs a CUDA card and ``nvcc``; it fails without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops import _build

CASES = (("ss_sw128", 0, 192, 64, 768), ("ss_sw128", 0, 216, 64, 768),
         ("rs_core_k", 1, 64, 64, 192), ("rs_core_k", 1, 64, 80, 240),
         ("rs_core_vt", 2, 64, 64, 576), ("rs_core_vt", 2, 72, 64, 576))

PROBE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {
using bf16 = __nv_bfloat16;
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
HELPERS
// Generic-proxy writes of shared memory made visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ unsigned pair(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// a (64 x K) and bt (N x K) row-major; mode 0: both from shared memory with
// the 128-byte swizzle, 64-wide chunks; mode 1: a from registers, b as core
// matrices [n / 8][k / 8][8][8] of KC-wide chunks; mode 2: a from
// registers, b^T as [k / 8][n][k % 8] of KC-wide chunks.
template <int kMode, int N, int KC>
__global__ void __launch_bounds__(128) probe(const bf16* a, const bf16* bt, int K, float* outw,
                                             float* outm) {
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* sm = raw + ((1024 - smem_addr(raw) % 1024) % 1024);
  bf16* as = reinterpret_cast<bf16*>(sm);               // mode 0: 64 x 64
  bf16* bs = reinterpret_cast<bf16*>(sm + 64 * 128);    // N x KC
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < N * KC; i += 128) {
      const int r = i / KC, c = i % KC;
      const bf16 v = bt[r * K + k0 + c];
      int off;
      if (kMode == 0) off = r * 64 + (((c / 8) ^ (r % 8)) * 8) + c % 8;
      else if (kMode == 1) off = ((r / 8) * (KC / 8) + c / 8) * 64 + (r % 8) * 8 + c % 8;
      else off = ((c / 8) * N + r) * 8 + c % 8;
      bs[off] = v;
    }
    if (kMode == 0)
      for (int i = tid; i < 64 * 64; i += 128) {
        const int r = i / 64, c = i % 64;
        as[r * 64 + (((c / 8) ^ (r % 8)) * 8) + c % 8] = a[r * K + k0 + c];
      }
    fence_async_smem();
    __syncthreads();
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      if constexpr (kMode == 0) {
        wgmma_ss(d, sw128_desc(smem_addr(as) + 32 * kk), sw128_desc(smem_addr(bs) + 32 * kk));
      } else {
        const bf16* ar = a + (16 * warp + g) * K + k0 + 16 * kk + t2;
        const unsigned af[4] = {pair(ar), pair(ar + 8 * K), pair(ar + 8), pair(ar + 8 * K + 8)};
        if constexpr (kMode == 1)  // as L.2's S: the first k16 step writes d
          wgmma_rs(d, af, core_desc(smem_addr(bs) + 256 * kk, 128, KC * 16), k0 > 0 || kk > 0);
        else
          wgmma_rs(d, af, core_desc(smem_addr(bs) + 2 * kk * N * 16, N * 16, 128));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int t = i / 4, e = i % 4;
    outw[(16 * warp + g + 8 * (e / 2)) * N + 8 * t + t2 + e % 2] = d[i];
  }
  // mma.sync m16n8k16 over the same k16 steps, in order.
  for (int t = 0; t < N / 8; ++t) {
    float m[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < K; k += 16) {
      const bf16* ar = a + (16 * warp + g) * K + k + t2;
      const unsigned af[4] = {pair(ar), pair(ar + 8 * K), pair(ar + 8), pair(ar + 8 * K + 8)};
      const bf16* br = bt + (8 * t + g) * K + k + t2;
      mma(m, af, pair(br), pair(br + 8));
    }
    for (int e = 0; e < 4; ++e)
      outm[(16 * warp + g + 8 * (e / 2)) * N + 8 * t + t2 + e % 2] = m[e];
  }
}

template <int kMode, int N, int KC>
int run(const void* a, const void* bt, int K, float* outw, float* outm) {
  const int smem = 1024 + 64 * 128 + N * KC * 2;
  cudaFuncSetAttribute(probe<kMode, N, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  probe<kMode, N, KC><<<1, 128, smem>>>(static_cast<const bf16*>(a),
                                         static_cast<const bf16*>(bt), K, outw, outm);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int wgmma_probe(int mode, int n, int kc, const void* a, const void* bt, int k,
                           float* outw, float* outm) {
  if (mode == 0 && n == 192) return run<0, 192, 64>(a, bt, k, outw, outm);
  if (mode == 0 && n == 216) return run<0, 216, 64>(a, bt, k, outw, outm);
  if (mode == 1 && kc == 64) return run<1, 64, 64>(a, bt, k, outw, outm);
  if (mode == 1 && kc == 80) return run<1, 64, 80>(a, bt, k, outw, outm);
  if (mode == 2 && n == 64) return run<2, 64, 64>(a, bt, k, outw, outm);
  if (mode == 2 && n == 72) return run<2, 72, 64>(a, bt, k, outw, outm);
  return (int)cudaErrorInvalidValue;
}
"""


def helpers() -> str:
    """The wgmma helpers of ``csrc/attention_block.cu``."""
    src = (_build.CSRC / "attention_block.cu").read_text()
    return src.split("// >>> wgmma helpers")[1].split("// <<< wgmma helpers")[0]


def build(work: Path) -> Path:
    work.mkdir(parents=True, exist_ok=True)
    src, lib = work / "wgmma_probe.cu", work / "libwgmma_probe.so"
    src.write_text(PROBE.replace("HELPERS", helpers()))
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True, stdin=subprocess.DEVNULL,
                          timeout=_build.NVCC_TIMEOUT_S)
    (work / "wgmma_probe.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the probe:\n{proc.stdout}{proc.stderr}")
    return lib


def probe(lib: ctypes.CDLL, name: str, mode: int, n: int, kc: int, k: int,
          rng: np.random.Generator) -> dict:
    a = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32)).bfloat16().cuda()
    bt = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).bfloat16().cuda()
    outw = torch.full((64, n), float("nan"), device="cuda")
    outm = torch.full((64, n), float("nan"), device="cuda")
    err = lib.wgmma_probe(mode, n, kc, a.data_ptr(), bt.data_ptr(), k, outw.data_ptr(),
                          outm.data_ptr())
    if err:
        raise RuntimeError(f"probe {name} launch failed: cudaError {err}")
    torch.cuda.synchronize()
    exact = a.double() @ bt.double().t()
    scale = exact.abs().max().item()
    return {"case": name, "n": n, "k_chunk": kc, "k": k,
            "bit_equal": bool(torch.equal(outw, outm)),
            "elements_differing": int((outw != outm).sum().item()),
            "max_abs_diff": (outw - outm).abs().max().item(),
            "wgmma_err": (outw.double() - exact).abs().max().item() / scale,
            "mma_sync_err": (outm.double() - exact).abs().max().item() / scale}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available() or shutil.which("nvidia-smi") is None:
        raise SystemExit("wgmma_probe needs a CUDA card")
    lib = ctypes.CDLL(str(build(_build.BUILD_DIR / "wgmma_probe")))
    lib.wgmma_probe.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 2
    lib.wgmma_probe.restype = ctypes.c_int
    rng = np.random.default_rng(0)
    rows = [probe(lib, *case, rng) for case in CASES]
    report = {"device": torch.cuda.get_device_name(0), "cases": rows,
              "all_bit_equal": all(r["bit_equal"] for r in rows)}
    line = json.dumps(report)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0 if all(r["wgmma_err"] < 2 ** -10 and r["mma_sync_err"] < 2 ** -10
                    for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
