"""Where a kernel's bf16 time goes: text variants of its source, timed side by side.

``--kernel k3`` (the default) varies ``ops/csrc/attention_block.cu``
(its short-row instance; ``--kernel k3l`` its bf16 long-row instance, each
variant's L.1 and L.2 also timed alone and its output held bit for bit to
``base``'s), ``--kernel k1`` ``ops/csrc/attention.cu``, ``--kernel k2``
``ops/csrc/attention_bwd.cu`` (dq, dk and dv: its row and column kernels as
one call), ``--kernel k4`` ``ops/csrc/flash_fwd.cu`` (O and the LSE),
``--kernel k5`` and ``--kernel k6`` ``ops/csrc/flash_bwd.cu`` (K5's dQ,
K6's dK and dV). Each variant is a list of ``[old, new]`` substitutions
applied to the source, or ``[start, end, new]``, which replaces the text
from ``start`` up to ``end`` (for example
``[["if (step + 1 < steps) fetch(step + 1);", ""]]`` drops K3's projection
loads; ``[["int warps_for(int) { return 4; }", "int warps_for(int) {
return 8; }"]]`` gives K1 blocks of 8 warps). Every variant and the
unchanged source (``base``) is built with ``nvcc`` and the flags of
``ops/_build.py`` into ``jpdvt_mt_ntnu_tpu_torch/_build/<kernel>_variants/``;
the bf16 call (K3's launch pair; K1, K2, K4, K5 or K6 on strided views of
a fused qkv, as the DiT calls them) is then timed by CUDA events at each (B, N), the
variants alternating over rounds, on random inputs, with each output's
largest difference from the plain version beside it (a variant that drops
work is wrong by design). ``--ablations`` adds variants that each drop
one part of the kernel (``ABLATIONS``). ``--variants`` takes a JSON file
of ``{name: substitutions}`` or names of the built-in design variants
(``VARIANTS``, comma-separated); a variant that does not build is left out
of the timing and named under ``build_failed`` with its compiler's errors.
For K3, ``--clocks`` also builds ``base`` with ``clock64`` stamps at A.1's
start, after its projection and at its end, and prints the median cycles
of each phase per block and the most blocks one SM ran.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.kernel_variants [--kernel k3|k1|k2|k4|k5|k6]
        [--ablations] [--variants FILE.json|NAME,...] [--shapes 32x144,32x400]
        [--rounds 3] [--clocks] [--head-dim 64|72]

The calls take the JPDVT flagship's attention, 12 heads of 64, by default;
``--head-dim 72`` takes DiT-XL's, 16 heads of 72 (K3: D = 1152), each
variant compiled with ``-DHEAD_DIM=72``. K2's ``three_pass`` variant is
written for Dh 64 (four k16 steps).

Needs a CUDA card and ``nvcc``; it fails without them. Variants are a tool
for finding a bottleneck, never a route: the port runs only the source.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess

import numpy as np
import torch

from ..ops import _build
from ..ops import attention as attn_ops
from ..ops import flash_attention as flash_ops

SOURCES = {"k3": "attention_block.cu", "k3l": "attention_block.cu", "k1": "attention.cu",
           "k2": "attention_bwd.cu",
           "k4": "flash_fwd.cu", "k5": "flash_bwd.cu", "k6": "flash_bwd.cu"}
HEADS, HEAD_DIM = 12, 64  # the default; --head-dim 72 sets 16, 72 (DiT-XL)
# --ablations: each drops one part of the kernel (its output is then wrong).
# K3: parts of A.1. K1 (bf16): the copies of K and V (the ring's cp.async),
# pass 1's work (its copies stay), P and P V in pass 2 (S stays), every exp2.
# K4 (bf16): the ring's cp.async copies, every exp2, the round(E) V
# product, the online rescale of the accumulator (acc *= alpha).
# K5, K6 (bf16): the ring's cp.async copies, every exp2, and one product each
# (K5: dP = dO V^T or dQ += dS K; K6: dV += P^T dO or dK += dS^T q, or
# delta's dot products). K2 (bf16, both kernels): the rings' cp.async
# copies, the row kernel's pass A (its work and its copies; delta = 0),
# dQ += dS K, and the column kernel's dV += P^T dO or dK += dS^T q.
_NO_EXP2 = [["namespace {\n\nconstexpr int kD = HEAD_DIM;",
             "#define exp2f(x) (x)\nnamespace {\n\nconstexpr int kD = HEAD_DIM;"]]
_NO_LOADS = [["    cp_async16(dst, src);\n", ""]]
_FLASH_BWD_COMMON = {"no_loads": _NO_LOADS, "no_exp2": _NO_EXP2}
ABLATIONS = {
    "k3": {
        "no_attention": [["  for (int t0 = warp * per; t0 < t_end; t0 += kQT) {",
                          "  for (int t0 = t_end; t0 < t_end; t0 += kQT) {"]],
        "no_projection_mma": [["          if (r0 + wr * 48 + i * 16 < np) {\n            mma(",
                               "          if (false) {\n            mma("]],
        "no_projection_loads": [["    if (step + 1 < steps) fetch(step + 1);", ""]],
        "no_projection_ldmatrix_mma": [
            ["    for (int kk = 0; kk < kKC; kk += 16) {\n      unsigned a[3][4];",
             "    for (int kk = 0; kk < 0; kk += 16) {\n      unsigned a[3][4];"]],
    },
    "k3l": {},
    "k1": {
        "no_loads": _NO_LOADS,
        "no_pass1": [["    if (active && step < nc) {", "    if (false) {"],
                     ["    } else if (active) {", "    } else if (active && step >= nc) {"]],
        "no_pass2_p_pv": [["          mma(oacc[j], pa, vb[0], vb[1]);\n"
                           "          mma(oacc[j + 1], pa, vb[2], vb[3]);\n", ""]],
        "no_exp2": _NO_EXP2,
    },
    "k4": {
        "no_loads": _NO_LOADS,
        "no_exp2": _NO_EXP2,
        "no_ev": [["          mma(oacc[j], pa, vb[0], vb[1]);\n"
                   "          mma(oacc[j + 1], pa, vb[2], vb[3]);\n", ""]],
        "no_rescale": [["          oacc[j][2 * half] *= alpha;\n"
                        "          oacc[j][2 * half + 1] *= alpha;\n", ""]],
    },
    "k5": {
        **_FLASH_BWD_COMMON,
        "no_dp": [["          mma(dp[0], da[kk], b[0], b[1]);\n"
                   "          mma(dp[1], da[kk], b[2], b[3]);\n", ""]],
        "no_ds_k": [["          mma(acc[j], dsa, b[0], b[1]);\n"
                     "          mma(acc[j + 1], dsa, b[2], b[3]);\n", ""]],
    },
    "k6": {
        **_FLASH_BWD_COMMON,
        "no_dv": [["          mma(dva[j], pa, b[0], b[1]);\n"
                   "          mma(dva[j + 1], pa, b[2], b[3]);\n", ""]],
        "no_dk": [["          mma(dka[j], dsa, b[0], b[1]);\n"
                   "          mma(dka[j + 1], dsa, b[2], b[3]);\n", ""]],
        "no_delta": [["      for (int p = 0; p < kHalf; ++p)",
                      "      for (int p = 0; p < 0; ++p)"]],
    },
    "k2": {
        "no_loads": _NO_LOADS,
        "no_pass_a": [["steps = 2 * nc;", "steps = nc;"],
                      ["  for (int c = 0; c < nc; ++c) {\n    advance(c);",
                       "  for (int c = 0; c < 0; ++c) {\n    advance(c);"],
                      ["    advance(nc + c);", "    advance(c);"],
                      ["    const bf16* kst = ks + (nc + c) % 2 * kStage;\n"
                       "    const bf16* vst = vs + (nc + c) % 2 * kStage;",
                       "    const bf16* kst = ks + c % 2 * kStage;\n"
                       "    const bf16* vst = vs + c % 2 * kStage;"]],
        "no_dq": [["          mma(acc[j], dsa, b[0], b[1]);\n"
                   "          mma(acc[j + 1], dsa, b[2], b[3]);\n", ""]],
        "no_dv": [["          mma(dva[j], pa, b[0], b[1]);\n"
                   "          mma(dva[j + 1], pa, b[2], b[3]);\n", ""]],
        "no_dk": [["          mma(dka[j], dsa, b[0], b[1]);\n"
                   "          mma(dka[j + 1], dsa, b[2], b[3]);\n", ""]],
    },
}
# K2's row kernel with three passes over K (and V): m and l from K alone,
# then delta = sum P dP in the JAX order, then dQ.
_K2_THREE_PASSES = """  // Pass 1: the row max m and l = sum exp(S - m), this thread's share.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  issue(0);
  for (int c = 0; c < nc; ++c) {
    advance(c);
    const int j0 = c * kRows;
    const int groups = min(kRows / 16, (n - j0 + 15) / 16);
    const bf16* kst = ks + c % 2 * kStage;
    if (active) {
      float s[kRows / 8][4];
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int u = 0; u < kRows / 16; ++u)
          if (u < groups) {
            unsigned b[4];
            load_b(b, kst, 16 * u, kk * 16, lane);
            mma(s[2 * u], qa[kk], b[0], b[1]);
            mma(s[2 * u + 1], qa[kk], b[2], b[3]);
          }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float bm = -INFINITY;
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float& x = s[j][2 * half + cc];
            if (j0 + kRows > n && j0 + j * 8 + t2 + cc >= n) x = -INFINITY;
            bm = fmaxf(bm, x);
          }
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
        const float mn = fmaxf(m[half], bm), ml = mn * kLog2e;
        float sum = l[half] * exp2f(fmaf(m[half], kLog2e, -ml));
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j)
          sum += exp2f(fmaf(s[j][2 * half], kLog2e, -ml)) +
                 exp2f(fmaf(s[j][2 * half + 1], kLog2e, -ml));
        l[half] = sum;
        m[half] = mn;
      }
    }
    __syncthreads();
  }
  const long long plane = (long long)gridDim.z * h * n;
  float* wg = ws + ((long long)blockIdx.z * h + blockIdx.y) * n;
  float m2[2], il[2], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sl = l[half];
    sl += __shfl_xor_sync(0xffffffffu, sl, 1);
    sl += __shfl_xor_sync(0xffffffffu, sl, 2);
    m2[half] = m[half] * kLog2e;
    il[half] = 1.f / sl;
  }
  // Pass 2: delta = sum P dP, P = exp(S - m) (1 / l).
  for (int c = 0; c < nc; ++c) {
    advance(nc + c);
    const int j0 = c * kRows;
    const int groups = min(kRows / 16, (n - j0 + 15) / 16);
    const bf16* kst = ks + (nc + c) % 2 * kStage;
    const bf16* vst = vs + (nc + c) % 2 * kStage;
    if (active) {
#pragma unroll
      for (int u = 0; u < kRows / 16; ++u) {
        if (u >= groups) break;
        float s[2][4], dp[2][4];
        products(kst, vst, u, s, dp);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = j0 + 16 * u + 8 * j + t2 + e % 2 < n
                                ? exp2f(fmaf(s[j][e], kLog2e, -m2[e / 2])) * il[e / 2]
                                : 0.f;
            delta[e / 2] = fmaf(p, dp[j][e], delta[e / 2]);
          }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    delta[half] += __shfl_xor_sync(0xffffffffu, delta[half], 1);
    delta[half] += __shfl_xor_sync(0xffffffffu, delta[half], 2);
    const int row = q0 + g + half * 8;
    if (t2 == 0 && row < n) {
      wg[row] = m2[half];
      wg[plane + row] = il[half];
      wg[2 * plane + row] = delta[half];
    }
  }

"""
# K3l's cluster2: L.1 in clusters of two row tiles of one head, each
# K-chunk of W_h read from L2 once for both (by the CTA of rank chunk % 2)
# and multicast; a stage is refilled once both CTAs' consumers released it.
# Its launch fails where B N takes an odd number of row tiles (it runs at
# (32, 576) at Dh 64 and (32, 144) at 72).
_K3L_CLUSTER_HELPERS = r"""__device__ __forceinline__ void tma_load_2d_multicast(
    void* dst, const CUtensorMap* map, int c0, int c1, unsigned long long* bar,
    unsigned short mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// An arrival on the mbarrier at `bar`'s offset in CTA `cta` of this cluster.
__device__ __forceinline__ void mbar_arrive_cta(unsigned long long* bar, unsigned cta) {
  asm volatile("{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
               "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n}\n"
               ::"r"(smem_addr(bar)), "r"(cta) : "memory");
}

"""
_K3L_CLUSTER2 = [
    ["// q|k|v of head h for rows m0.. of x (m = B n rows), into the scratch.",
     _K3L_CLUSTER_HELPERS + "// q|k|v of head h for rows m0.. of x (m = B n rows), into the scratch."],
    ["__global__ void __launch_bounds__(kP1Threads, 1)\nblock_project_wgmma_kernel(",
     "__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kP1Threads, 1)\n"
     "block_project_wgmma_kernel("],
    ["      mbar_init(&empty[s], 4 * kP1Groups);", "      mbar_init(&empty[s], 8 * kP1Groups);"],
    ["  __syncthreads();\n  if (wg == kP1Groups) {",
     "  cluster_sync();\n  const unsigned rank = cluster_rank();\n  if (wg == kP1Groups) {"],
    ["#pragma unroll\n        for (int w = 0; w < 3; ++w)\n"
     "          tma_load_2d(xs + kP1XBytes + w * kD * 128, &wmap, s * kKC, (w * heads + h) * kD,\n"
     "                      &full[st]);\n      }\n    }\n",
     "        if (s % 2 == (int)rank) {\n#pragma unroll\n          for (int w = 0; w < 3; ++w)\n"
     "            tma_load_2d_multicast(xs + kP1XBytes + w * kD * 128, &wmap, s * kKC,\n"
     "                                  (w * heads + h) * kD, &full[st], 3);\n        }\n"
     "      }\n    }\n"
     "    __syncwarp();\n"],
    ["      if (lane == 0) mbar_arrive(&empty[st]);",
     "      if (lane == 0) {\n        mbar_arrive_cta(&empty[st], 0);\n"
     "        mbar_arrive_cta(&empty[st], 1);\n      }"],
    ["      }\n    }\n  }\n}\n\nconstexpr float kLog2e",
     "      }\n    }\n  }\n  cluster_sync();  // no CTA leaves while the other may signal it\n}\n"
     "\nconstexpr float kLog2e"],
]
_K3L_GROUPS = "  return long_kv_whole(n) && 2 * (long_smem_bytes(n) + 1024) <= 233472 ? 2 : 3;"
# Built-in design variants (``--variants NAME,...``), each timed against
# the source before it is adopted.
VARIANTS = {
    # K3's bf16 long-row instance: the designs tried before its source's.
    "k3l": {
        # L.1's rows of x a block: 128 (2 consumer warpgroups), 256 (4 at Dh
        # 64: 544 threads, at most 120 registers a thread for 96
        # accumulators), against the source's 192 at Dh 64 (128 at 72).
        "m128": [["constexpr int kP1Groups = kD == 64 ? 3 : 2;", "constexpr int kP1Groups = 2;"]],
        "m256": [["constexpr int kP1Groups = kD == 64 ? 3 : 2;",
                  "constexpr int kP1Groups = kD == 64 ? 4 : 2;"]],
        # L.1's ring of 3 stages (the source's: 4).
        "stages3": [["constexpr int kP1Stages = 4;", "constexpr int kP1Stages = 3;"]],
        # L.1 with one wgmma group in flight: a stage released a chunk later
        # (the source waits for each chunk's products).
        "pending1": [["      wgmma_wait<0>();  // the other warpgroups' products fill the "
                      "tensor cores meanwhile\n      fence_regs(acc);\n      release(st);\n    }\n",
                      "      wgmma_wait<1>();\n      fence_regs(acc);\n"
                      "      if (s > 0) release((s - 1) % kP1Stages);\n    }\n"
                      "    wgmma_wait<0>();\n    fence_regs(acc);\n"
                      "    release((nk - 1) % kP1Stages);\n"]],
        "cluster2": _K3L_CLUSTER2,
        # L.2's consumer warpgroups a block where k and v are whole: 2, 3 or
        # 4 at every such N (the source: 2 where two blocks fit an SM, else 3).
        "l2_groups2": [[_K3L_GROUPS, "  return long_kv_whole(n) ? 2 : 3;"]],
        "l2_groups3": [[_K3L_GROUPS, "  return 3;"]],
        "l2_groups4": [[_K3L_GROUPS, "  return long_kv_whole(n) ? 4 : 3;"],
                       ["                        : groups == 2 ? block_attention_long_wgmma_kernel<true, 2>",
                        "                        : groups == 4 ? block_attention_long_wgmma_kernel<true, 4>\n"
                        "                        : groups == 2 ? block_attention_long_wgmma_kernel<true, 2>"]],
    },
    "k2": {
        # Three passes over K in the row kernel (pass 1 stages K alone).
        "three_pass": [
            ["steps = 2 * nc;", "steps = 3 * nc;"],
            ["    advance(nc + c);\n    const int j0 = c * kRows;\n"
             "    const int groups = min(kRows / 16, (n - j0 + 15) / 16);\n"
             "    const bf16* kst = ks + (nc + c) % 2 * kStage;\n"
             "    const bf16* vst = vs + (nc + c) % 2 * kStage;",
             "    advance(2 * nc + c);\n    const int j0 = c * kRows;\n"
             "    const int groups = min(kRows / 16, (n - j0 + 15) / 16);\n"
             "    const bf16* kst = ks + (2 * nc + c) % 2 * kStage;\n"
             "    const bf16* vst = vs + (2 * nc + c) % 2 * kStage;"],
            ["    stage_chunk<kRowBlock>(ks + stg * kStage, vs + stg * kStage, kg, vg, st.in_sn, "
             "st.in_sn,\n                           step % nc * kRows, n, aligned);",
             "    if (step >= nc) {\n"
             "      stage_chunk<kRowBlock>(ks + stg * kStage, vs + stg * kStage, kg, vg, "
             "st.in_sn, st.in_sn, step % nc * kRows, n, aligned);\n"
             "    } else {\n"
             "      for (int i = tid; i < kRows * kC8; i += kRowBlock) {\n"
             "        const int r = i / kC8, col = i % kC8 * 8, row = step * kRows + r;\n"
             "        stage_piece(ks + stg * kStage + r * kRow + col,\n"
             "                    kg + (long long)min(row, n - 1) * st.in_sn + col, row < n, "
             "aligned);\n"
             "      }\n"
             "    }"],
            ["  // Pass A: the row max m;", "  // Pass B: dQ += dS K", _K2_THREE_PASSES]],
        # 48-row tiles in the row kernel (3 warps; N = 144 is 3 tiles).
        "rows48": [["constexpr int kRowWarps = 4;", "constexpr int kRowWarps = 3;"]],
        "rows48_min5": [["constexpr int kRowWarps = 4;", "constexpr int kRowWarps = 3;"],
                        ["constexpr int kRowMinBlocks = 4;", "constexpr int kRowMinBlocks = 5;"]],
        # Launch bounds: blocks an SM (registers a thread).
        "row_min3": [["constexpr int kRowMinBlocks = 4;", "constexpr int kRowMinBlocks = 3;"]],
        "col_min2": [["constexpr int kColMinBlocks = 3;", "constexpr int kColMinBlocks = 2;"]],
        "col_min4": [["constexpr int kColMinBlocks = 3;", "constexpr int kColMinBlocks = 4;"]],
    },
}
# --clocks: (anchor in the source, text put before it); the last entry's text
# is put after it. Each stamp is taken by every thread; thread 0 stores them.
_CLOCKS = (
    ("namespace tc {",
     "__device__ long long g_k3_clocks[1 << 16];\n"),
    ("  const int np = (n + 15) / 16 * 16;\n  bf16* qs",
     "  const long long c0 = clock64();\n"),
    ("  // Attention: warp w takes",
     "  const long long c1 = clock64();\n"),
)
_CLOCKS_END = ("__floats2bfloat162_rn(oacc[q][j][2 * half], oacc[q][j][2 * half + 1]);\n"
               "      }\n  }\n",
               "  __syncthreads();\n  if (threadIdx.x == 0) {\n    unsigned sm;\n"
               "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
               "    long long* p = g_k3_clocks + 4 * (blockIdx.y * gridDim.x + blockIdx.x);\n"
               "    p[0] = c0; p[1] = c1; p[2] = clock64(); p[3] = sm;\n  }\n")
_CLOCKS_EXPORT = ("\nextern \"C\" int k3_clocks(long long* host) {\n"
                  "  return (int)cudaMemcpyFromSymbol(host, g_k3_clocks, sizeof(g_k3_clocks));\n}\n")


def _substitute(src: str, subs) -> str:
    """Apply ``[old, new]`` (the first ``old``) and ``[start, end, new]``
    (the text from the first ``start`` up to the next ``end``) in order."""
    for sub in subs:
        for text in sub[:-1]:
            if text not in src:
                raise ValueError(f"variant text not in the source: {text[:80]!r}")
        if len(sub) == 2:
            src = src.replace(sub[0], sub[1], 1)
        else:
            start, end, new = sub
            i = src.index(start)
            j = src.index(end, i)
            src = src[:i] + new + src[j:]
    return src


def _with_clocks(src: str) -> str:
    src = _substitute(src, [(a, text + a) for a, text in _CLOCKS])
    return _substitute(src, [(_CLOCKS_END[0], _CLOCKS_END[0] + _CLOCKS_END[1])]) + _CLOCKS_EXPORT


def _build_all(kernel: str, sources: dict, head_dim: int = 64) -> dict:
    """name -> source text; returns name -> ctypes library (each built for
    ``head_dim``), or None for a variant other than ``base`` that does not
    build (its compiler's messages are in its ``.log``)."""
    out = _build.BUILD_DIR / f"{kernel}_variants"
    out.mkdir(parents=True, exist_ok=True)

    def build(name: str):
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(sources[name])
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu),
                               f"-DHEAD_DIM={head_dim}"],
                              capture_output=True, text=True, stdin=subprocess.DEVNULL,
                              timeout=_build.NVCC_TIMEOUT_S)
        (out / f"{name}.log").write_text(proc.stdout + proc.stderr)  # ptxas -v: registers, spills
        if proc.returncode and name.startswith("base"):
            raise RuntimeError(f"variant {name} failed to build:\n{proc.stdout}{proc.stderr}")
        return name, None if proc.returncode else ctypes.CDLL(str(so))

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(pool.map(build, sources))
    for lib in filter(None, libs.values()):
        if kernel == "k3":
            lib.k3_attention_block.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                               + [ctypes.c_int] * 4
                                               + [ctypes.c_float, ctypes.c_void_p])
        elif kernel == "k3l":
            lib.k3_attention_block_long_stage.argtypes = (
                [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_void_p])
            lib.k3_attention_block_long_scratch_elems.argtypes = [ctypes.c_int] * 4
            lib.k3_attention_block_long_scratch_elems.restype = ctypes.c_size_t
        elif kernel == "k4":
            lib.k4_flash_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                         + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3
                                         + [ctypes.c_float, ctypes.c_void_p])
        elif kernel == "k1":
            lib.k1_attention_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                             + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3
                                             + [ctypes.c_float, ctypes.c_void_p])
        elif kernel == "k2":
            lib.k2_attention_bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                             + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
                                             + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        else:
            lib.k5_flash_dq.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                        + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                                        + [ctypes.c_float] * 2 + [ctypes.c_void_p])
            lib.k6_flash_dkv.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                         + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                                         + [ctypes.c_float, ctypes.c_void_p])
    return libs


def _build_errors(kernel: str, name: str) -> list:
    """The first error lines of a variant's build log."""
    log = _build.BUILD_DIR / f"{kernel}_variants" / f"{name}.log"
    return [line for line in log.read_text().splitlines() if "error" in line][:3]


def _k3_case(b: int, n: int, gen: torch.Generator, weights: tuple):
    """(call(lib), outputs, plain outputs, reset()) for K3 at (b, n)."""
    wq, bq, wp, bp, ops = weights
    d = wq.shape[1]
    x = torch.randn((b, n, d), generator=gen, device="cuda").bfloat16()
    want = attn_ops.fused_attention_block_plain(x, *ops, HEADS).float()
    o = torch.empty((b, n, d), dtype=torch.bfloat16, device="cuda")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        err = lib.k3_attention_block(1, x.data_ptr(), wq.data_ptr(), bq.data_ptr(),
                                     wp.data_ptr(), bp.data_ptr(), o.data_ptr(),
                                     out.data_ptr(), b, n, HEADS, d,
                                     attn_ops.q_scale(HEAD_DIM, torch.bfloat16), stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    def reset():
        o.zero_()  # a variant that skips a phase reads no earlier variant's o

    return call, (out,), (want,), reset


def _k3l_case(b: int, n: int, gen: torch.Generator, weights: tuple):
    """(call(lib), outputs, plain outputs, reset(), stage(lib, i)) for K3's
    bf16 long-row instance at (b, n): ``call`` launches L.1, L.2 and A.2,
    ``stage`` one of them (0, 1, 2) on the buffers the last call left."""
    wq, bq, wp, bp, ops = weights
    d = wq.shape[1]
    x = torch.randn((b, n, d), generator=gen, device="cuda").bfloat16()
    want = attn_ops.fused_attention_block_plain(x, *ops, HEADS).float()
    o = torch.empty((b, n, d), dtype=torch.bfloat16, device="cuda")
    out = torch.empty_like(x)
    scratch = {}
    stream = torch.cuda.current_stream().cuda_stream

    def stage(lib, i):
        if id(lib) not in scratch:
            scratch[id(lib)] = torch.empty(
                lib.k3_attention_block_long_scratch_elems(b, n, HEADS, 2),
                dtype=torch.bfloat16, device="cuda")
        err = lib.k3_attention_block_long_stage(
            i, 1, x.data_ptr(), wq.data_ptr(), bq.data_ptr(), wp.data_ptr(), bp.data_ptr(),
            scratch[id(lib)].data_ptr(), o.data_ptr(), out.data_ptr(), b, n, HEADS, d,
            attn_ops.q_scale(HEAD_DIM, torch.bfloat16), stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    def call(lib):
        for i in range(3):
            stage(lib, i)

    def reset():
        o.zero_()

    return call, (out,), (want,), reset, stage


def _k1_case(b: int, n: int, gen: torch.Generator):
    """(call(lib), outputs, plain outputs, reset()) for K1 at (b, n), on
    strided views of a fused (B, N, 3*H*Dh) qkv."""
    qkv = torch.randn((b, n, 3 * HEADS * HEAD_DIM), generator=gen, device="cuda").bfloat16()
    q, k, v = qkv.view(b, n, 3, HEADS, HEAD_DIM).permute(2, 0, 3, 1, 4).unbind(0)
    want = attn_ops.attention_reference(q, k, v).float()
    out = torch.empty((b, n, HEADS, HEAD_DIM), dtype=torch.bfloat16,
                      device="cuda").transpose(1, 2)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        err = lib.k1_attention_fwd(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   *q.stride()[:3], *out.stride()[:3], b, HEADS, n,
                                   attn_ops.q_scale(HEAD_DIM, torch.bfloat16), stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    return call, (out,), (want,), out.zero_


def _k2_case(b: int, n: int, gen: torch.Generator):
    """(call(lib), outputs, plain outputs, reset()) for K2 at (b, n), as the
    train step calls it: q, k, v strided views of a fused qkv, dO a view of
    a (B, N, H*Dh) gradient, dq, dk, dv slots of one fused buffer."""
    shape = (b, n, 3, HEADS, HEAD_DIM)
    qkv = torch.randn((b, n, 3 * HEADS * HEAD_DIM), generator=gen, device="cuda").bfloat16()
    q, k, v = qkv.view(shape).permute(2, 0, 3, 1, 4).unbind(0)
    do = torch.randn((b, n, HEADS * HEAD_DIM), generator=gen, device="cuda").bfloat16()
    do = do.view(b, n, HEADS, HEAD_DIM).transpose(1, 2)
    buf = torch.zeros_like(qkv)
    out = buf.view(shape).permute(2, 0, 3, 1, 4).unbind(0)
    ws = torch.empty((3, b, HEADS, n), device="cuda")
    want = [t.float() for t in attn_ops.attention_bwd_reference(q, k, v, do)]
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        err = lib.k2_attention_bwd(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                   *(t.data_ptr() for t in out), ws.data_ptr(),
                                   *q.stride()[:3], *do.stride()[:3], *out[0].stride()[:3],
                                   b, HEADS, n, attn_ops.q_scale(HEAD_DIM, torch.bfloat16),
                                   HEAD_DIM ** -0.5, stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    def reset():
        buf.zero_()
        ws.zero_()

    return call, out, want, reset


def _flash_fwd_case(b: int, n: int, gen: torch.Generator):
    """(call(lib), outputs, plain outputs, reset()) for K4 (O and the LSE) at
    (b, n), on strided views of a fused (B, N, 3*H*Dh) qkv, O written as
    (B, N, H*Dh), as the train step calls it."""
    qkv = torch.randn((b, n, 3 * HEADS * HEAD_DIM), generator=gen, device="cuda").bfloat16()
    q, k, v = qkv.view(b, n, 3, HEADS, HEAD_DIM).permute(2, 0, 3, 1, 4).unbind(0)
    want = [t.float() for t in flash_ops.flash_attention_fwd_reference(q, k, v,
                                                                       flash_ops.BLOCK_K)]
    out = torch.empty((b, n, HEADS, HEAD_DIM), dtype=torch.bfloat16,
                      device="cuda").transpose(1, 2)
    lse = torch.empty((b, HEADS, n), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        err = lib.k4_flash_fwd(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               lse.data_ptr(), *q.stride()[:3], *out.stride()[:3], b, HEADS,
                               n, attn_ops.q_scale(HEAD_DIM, torch.bfloat16), stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    def reset():
        out.zero_()
        lse.zero_()

    return call, (out, lse), want, reset


def _flash_bwd_case(kernel: str, b: int, n: int, gen: torch.Generator):
    """(call(lib), outputs, plain outputs, reset()) for K5 (dq) or K6 (dk,
    dv) at (b, n), as the train step calls them: q, k, v strided views of a
    fused qkv, O and dO views of (B, N, H*Dh) buffers, the gradients slots
    of one fused buffer; O and the LSE from the plain forward."""
    shape = (b, n, 3, HEADS, HEAD_DIM)
    qkv = torch.randn((b, n, 3 * HEADS * HEAD_DIM), generator=gen, device="cuda").bfloat16()
    q, k, v = qkv.view(shape).permute(2, 0, 3, 1, 4).unbind(0)
    o, lse = flash_ops.flash_attention_fwd_reference(q, k, v, flash_ops.BLOCK_K)
    o = o.transpose(1, 2).contiguous().transpose(1, 2)
    do = torch.randn((b, n, HEADS * HEAD_DIM), generator=gen, device="cuda").bfloat16()
    do = do.view(b, n, HEADS, HEAD_DIM).transpose(1, 2)
    buf = torch.zeros_like(qkv)
    dq, dk, dv = buf.view(shape).permute(2, 0, 3, 1, 4).unbind(0)
    want = [t.float() for t in flash_ops.flash_attention_bwd_reference(q, k, v, o, lse, do)]
    stream = torch.cuda.current_stream().cuda_stream
    common = (*q.stride()[:3], *o.stride()[:3], *do.stride()[:3], *dq.stride()[:3], b, HEADS,
              n, attn_ops.q_scale(HEAD_DIM, torch.bfloat16))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr())

    def call(lib):
        err = (lib.k5_flash_dq(1, *ptrs, dq.data_ptr(), *common, HEAD_DIM ** -0.5, stream)
               if kernel == "k5" else
               lib.k6_flash_dkv(1, *ptrs, dk.data_ptr(), dv.data_ptr(), *common, stream))
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    if kernel == "k5":
        return call, (dq,), want[:1], buf.zero_
    return call, (dk, dv), want[1:], buf.zero_


def main() -> int:
    global HEADS, HEAD_DIM
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="k3")
    ap.add_argument("--variants", help="JSON file: {name: [[old, new], ...]}, or names "
                                       "of VARIANTS[kernel], comma-separated")
    ap.add_argument("--shapes", default="32x144,32x400", help="B x N, comma-separated")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ablations", action="store_true", help="add the built-in ABLATIONS")
    ap.add_argument("--clocks", action="store_true", help="per-block phase cycles (K3)")
    ap.add_argument("--head-dim", type=int, choices=attn_ops.HEAD_DIMS, default=HEAD_DIM,
                    help="72: DiT-XL's 16 heads of 72")
    args = ap.parse_args()
    if args.kernel != "k3" and args.clocks:
        raise SystemExit("--clocks takes K3's source only")
    if args.head_dim == 72:
        HEADS, HEAD_DIM = 16, 72
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants needs a CUDA card")
    src = (_build.CSRC / SOURCES[args.kernel]).read_text()
    variants = {"base": [], **(ABLATIONS[args.kernel] if args.ablations else {})}
    if args.variants and args.variants.endswith(".json"):
        with open(args.variants) as f:
            variants.update(json.load(f))
    elif args.variants:
        variants.update({name: VARIANTS[args.kernel][name]
                         for name in args.variants.split(",")})
    sources = {name: _substitute(src, subs) for name, subs in variants.items()}
    if args.clocks:
        sources["base_clocks"] = _with_clocks(src)
    libs = _build_all(args.kernel, sources, HEAD_DIM)
    failed = sorted(name for name, lib in libs.items() if lib is None)
    variants = {name: subs for name, subs in variants.items() if name not in failed}
    gen = torch.Generator("cuda").manual_seed(0)
    if args.kernel in ("k3", "k3l"):
        d = HEADS * HEAD_DIM
        wq = (torch.randn(3 * d, d, generator=gen, device="cuda") * d ** -0.5).bfloat16()
        bq = 0.1 * torch.randn(3 * d, generator=gen, device="cuda")
        wp = (torch.randn(d, d, generator=gen, device="cuda") * d ** -0.5).bfloat16()
        bp = 0.1 * torch.randn(d, generator=gen, device="cuda")
        weights = (wq, bq, wp, bp, attn_ops.dense_to_block_weights(wq, bq, wp, bp, HEADS))
    result = {"device": torch.cuda.get_device_name(0), "kernel": args.kernel,
              "heads": HEADS, "head_dim": HEAD_DIM,
              "build_failed": {name: _build_errors(args.kernel, name) for name in failed}}
    for shape in args.shapes.split(","):
        b, n = (int(v) for v in shape.split("x"))
        stage = None
        if args.kernel == "k3":
            call, outs, wants, reset = _k3_case(b, n, gen, weights)
        elif args.kernel == "k3l":
            call, outs, wants, reset, stage = _k3l_case(b, n, gen, weights)
        elif args.kernel == "k1":
            call, outs, wants, reset = _k1_case(b, n, gen)
        elif args.kernel == "k2":
            call, outs, wants, reset = _k2_case(b, n, gen)
        elif args.kernel == "k4":
            call, outs, wants, reset = _flash_fwd_case(b, n, gen)
        else:
            call, outs, wants, reset = _flash_bwd_case(args.kernel, b, n, gen)
        row = {name: {"us": []} for name in variants}
        base_outs = None

        def timed(fn):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(args.reps):
                fn()
            stop.record()
            torch.cuda.synchronize()
            return 1e3 * start.elapsed_time(stop) / args.reps

        for rnd in range(args.rounds):
            for name in variants:
                reset()
                call(libs[name])
                row[name]["us"].append(timed(lambda: call(libs[name])))
                if stage is not None:  # K3's long-row launches alone
                    for i, part in ((0, "L.1"), (1, "L.2")):
                        row[name].setdefault(f"{part}_us", []).append(
                            timed(lambda: stage(libs[name], i)))
                if rnd == 0:
                    row[name]["max_abs_err"] = max((out.float() - want).abs().max().item()
                                                   for out, want in zip(outs, wants))
                    if stage is not None:
                        if name == "base":
                            base_outs = [out.clone() for out in outs]
                        row[name]["bit_equal_to_base"] = all(
                            torch.equal(out, ref) for out, ref in zip(outs, base_outs))
        if args.clocks:
            lib = libs["base_clocks"]
            call(lib)
            torch.cuda.synchronize()
            buf = np.zeros(1 << 16, dtype=np.int64)
            lib.k3_clocks.argtypes = [ctypes.c_void_p]
            if lib.k3_clocks(buf.ctypes.data):
                raise RuntimeError("reading the clocks failed")
            c = buf[:4 * b * HEADS].reshape(-1, 4)
            row["clocks"] = {"projection_cycles_median": float(np.median(c[:, 1] - c[:, 0])),
                             "attention_cycles_median": float(np.median(c[:, 2] - c[:, 1])),
                             "blocks_per_sm_max": int(np.bincount(c[:, 3]).max())}
        result[f"{b}x{n}"] = row
        print(json.dumps({shape: row}), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
