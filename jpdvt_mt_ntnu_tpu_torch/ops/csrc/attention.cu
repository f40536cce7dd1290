// K1: whole-row multi-head attention forward, written for Hopper (sm_90a).
//
// Replaces jpdvt_mt_ntnu_tpu/ops/attention.py:_attn_kernel, the Pallas
// kernel behind _attention_pallas_fwd_only and fused_qkv_attention. Same
// arithmetic: q * s_q rounded to the input type, where s_q is Dh^-1/2
// rounded to the input type first (JAX rounds its weakly typed Python float
// so; the wrapper passes s_q as `scale`, and bf16 q times a bf16 s_q is
// exact in fp32, so the one rounding is JAX's), S = Q K^T in fp32, a max-subtracted softmax in fp32 normalised before P
// is rounded to the V type, O = P V accumulated in fp32 and stored in the
// input type. No masking, no dropout. The kernel takes element strides for
// batch, head and token, so it reads q/k/v straight out of the fused
// (B, N, 3*H*Dh) projection and writes (B, N, H*Dh).
//
// Bound on an H100 SXM at the solve's B = 32, H = 12, Dh = 64, bf16: q, k,
// v read once and o written once is 4 B H N Dh 2 B = 28.3 MB at N = 144,
// 8.45 us at 3.35 TB/s, and 78.6 MB at N = 400, 23.5 us; the two products
// are 4 B H N^2 Dh = 2.0 and 15.7 GFLOP, 2.1 and 15.9 us at 989 TFLOP/s.
// So the bound is the memory traffic. The faithful 250-step solve launches
// this kernel once per DiT block per step: 12 x 250 = 3,000 launches per
// microbatch.
//
// bf16 (the solve's type) runs on the tensor cores (namespace tc):
// mma.sync m16n8k16, bf16 in, fp32 accumulators. One block per (batch,
// head, tile of 16 query rows per warp, 4 warps). Each warp loads its 16
// query rows once, scaled and rounded, straight into mma A fragments. K
// and V stream through shared memory in chunks of 64 keys by cp.async (16
// bytes a thread) into a ring of two stages, rows of 64 + 8 elements (144
// B, so the eight rows of an 8 x 8 ldmatrix fall on distinct banks), K
// loaded with ldmatrix, V with ldmatrix.trans. Pass 1 streams K and keeps
// each row's max and sum of exp(S - max) in fp32 (quad shuffles); pass 2
// streams K and V again, computes S again, forms the exact normalised P =
// exp(S - max) (1 / sum) in fp32 in registers, rounds it to bf16 (the
// accumulators of two 8-key n-tiles are one 16 x 16 A operand) and adds
// P V. exp is exp2 of one FFMA on the special-function unit (2 ulp): P
// moves by a few fp32 ulp, far below its bf16 rounding. The last key chunk
// and the last query tile are masked; K and V rows past N are zero.
// Each output element has one owning accumulator and keys run in a fixed
// order (no atomics, no split over keys): two calls are bit-equal.
//
// The head dim is a compile-time constant, HEAD_DIM (64 by default; the
// build compiles this file again with -DHEAD_DIM=72 for DiT-XL, a library
// of its own). At Dh 72: S = q K^T takes five k16 steps, the fifth over
// dims 64-79 with dims 72-79 zero (in the q fragments, and in K's shared
// memory rows, padding the copies never write), which keeps one mma path
// for every step at the cost of 8 zero dims in 72 (the other choice, a
// closing m16n8k8 with ldmatrix.x2 operands, is a second path for each
// operand); O = P V takes nine n8 tiles over Dh, in pairs by
// ldmatrix.x4.trans and the ninth alone by ldmatrix.x2.trans. Rows are 88
// elements (176 B, eleven 16-byte units, odd, so ldmatrix stays free of
// bank conflicts; 80 would be ten), 45,056 B of shared memory a block.
// The fp32 kernel's threads own three column pairs of O each at Dh 72
// (two at 64), the third only where it lies inside Dh.
//
// What the earlier scalar design (kept below for fp32) left, and what this
// one does about it: its products were scalar fp32 FMAs (now mma.sync);
// its fp32 score rows sat in shared memory beside K and V whole (165 KB a
// block at N = 400, one block of 4 warps per SM; now 36 KB at every N, two
// stages of K and V, so several blocks share an SM and N has no limit);
// it staged all of K and V for every 32-row tile (now each 64-row tile
// streams K twice and V once, from L2). Not done: wgmma, TMA, a persistent
// grid.
//
// fp32 (the tests' type; mma.sync takes fp32 only as TF32, which would
// change its numbers) keeps the scalar design: one block per (batch, head,
// tile of 32 query rows), K and V of that (batch, head) staged whole in
// shared memory with rows of Dh + 2, the tile's fp32 score rows too, so
// the softmax sees whole rows; the products are scalar fp32 FMAs on 4 x 3
// and 4 x 4 register tiles. Its shared memory caps fp32 N at 341 (309 at Dh
// 72); past that the fp32 streaming instance (namespace stream) takes over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifndef HEAD_DIM
#define HEAD_DIM 64
#endif

namespace {

constexpr int kD = HEAD_DIM;     // head dim (64 or 72); the Python wrapper checks it
static_assert(kD % 8 == 0, "rows are staged in 16-byte pieces");
// The scalar fp32 kernel.
constexpr int kTQ = 32;          // query rows per block
constexpr int kThreads = 128;    // 8 row groups x 16 column groups
constexpr int kKS = kD + 2;      // smem row stride of K and V (elements)
constexpr int kQS = kD + 2;      // smem row stride of the query tile (floats)
constexpr int kCT = 3;           // key columns per thread in one score chunk
constexpr int kChunk = 16 * kCT; // key columns per score chunk
constexpr int kCP = (kD / 2 + 15) / 16;  // column pairs of O a thread owns

// Whether column-pair group cg owns its p-th pair of O (dims 2 (cg + 16 p)).
__device__ __forceinline__ bool owns_pair(int cg, int p) {
  return kD / 2 % 16 == 0 || cg + 16 * p < kD / 2;
}

// The scalar kernel below is a template of the element type T as it was
// written; since the bf16 design moved to the tensor cores (namespace tc)
// only T = float is instantiated.
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };

__device__ __forceinline__ float2 to_float2(float2 v) { return v; }

// Round to T and back: the casts to the input type in the TPU kernel.
__device__ __forceinline__ float round_as(float v, const float*) { return v; }

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The bf16 design on the tensor cores (see the head of this file).
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kKB = 64;             // keys per chunk
// smem row stride of K and V (elements), an odd count of 16-byte units:
// 144 B at Dh 64, 176 B at 72.
constexpr int kRow = kD / 8 % 2 == 0 ? kD + 8 : kD + 16;
constexpr int kStage = kKB * kRow;  // elements of one chunk of K or V
constexpr int kC8 = kD / 8;         // 16-byte pieces of a row
// k16 steps over Dh (S = q K^T); the last one's dims past kD are zero.
constexpr int kK16 = (kD + 15) / 16;
static_assert(kK16 * 16 - kD <= 8 && kK16 * 16 <= kRow, "one zero piece a row pads Dh");
// K and V, two stages each: 36,864 B at every N (Dh 64), 45,056 B (Dh 72).
constexpr size_t kSmemBytes = 4 * (size_t)kStage * sizeof(bf16);
static_assert(kSmemBytes <= 48 * 1024, "launched without opting into more shared memory");
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;           // 16 query rows each
constexpr int kBlock = 32 * kWarps;
// Four blocks an SM caps registers at 128 a thread; left alone the
// compiler takes 148 (three blocks), which was 1-13% slower from N = 144 to
// 576 on an H100 (PERF.md §6; 8-warp blocks were no faster).
constexpr int kMinBlocks = 4;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give matrix i's row addresses.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// Two 8 x 8 b16 matrices, transposed; lanes 8i..8i+7 (i < 2) give matrix
// i's row addresses.
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; d 16 x 8 fp32.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// B operands of two n-tiles (n0.., n0 + 8..) x k16, from B^T as
// [n][kStride]: r[0], r[1] the first tile's, r[2], r[3] the second's.
template <int kStride>
__device__ __forceinline__ void load_b(unsigned (&r)[4], const bf16* base, int n0, int k0,
                                       int lane) {
  ldsm_x4(r, base + (n0 + lane % 8 + (lane / 16) * 8) * kStride + k0 + ((lane / 8) % 2) * 8);
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most one committed group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One 16-byte piece of a K or V row into shared memory: by cp.async where
// the source is 16-byte aligned, else by four 4-byte loads; zeros past N
// (P is 0 there, and 0 times a stale NaN would not be).
__device__ __forceinline__ void stage_piece(bf16* dst, const bf16* src, bool valid,
                                            bool aligned) {
  if (!valid) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else if (aligned) {
    cp_async16(dst, src);
  } else {
    const unsigned* s = reinterpret_cast<const unsigned*>(src);
    *reinterpret_cast<uint4*>(dst) = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         long long in_sb, long long in_sh, long long in_sn,
                         long long out_sb, long long out_sh, long long out_sn,
                         int n, float scale, int aligned) {
  // A thread's pieces of one chunk of K (or V); at Dh 72 the last round
  // takes half the threads.
  constexpr int kPieces = (kKB * kC8 + kBlock - 1) / kBlock;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][kKB][kRow]
  bf16* vs = ks + 2 * kStage;                // [2][kKB][kRow]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);  // accumulator row, column pair
  const long long in_base = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const bf16* qg = q + in_base;
  const bf16* kg = k + in_base;
  const bf16* vg = v + in_base;
  // This warp's rows: q0 + g (accumulator elements 0, 1) and q0 + g + 8 (2, 3).
  const int q0 = (blockIdx.x * kWarps + warp) * 16;
  const bool active = q0 < n;  // warp-uniform; idle warps still stage K and V
  if (kK16 * 16 > kD) {
    // K's dims kD.. of the last k16 step, in both stages: zero (the copies
    // never write them; the barrier of the first step orders these stores).
    for (int i = tid; i < 2 * kKB; i += kBlock)
      *reinterpret_cast<uint4*>(ks + i * kRow + kD) = make_uint4(0u, 0u, 0u, 0u);
  }

  // The query tile as A operands (16 rows x kK16 slices of 16 dims), q *
  // scale rounded to bf16; zero rows past n and dims past kD.
  unsigned qa[kK16][4];
#pragma unroll
  for (int kk = 0; kk < kK16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + g + (e % 2) * 8, col = kk * 16 + t2 + (e / 2) * 8;
      const float2 x = row < n && (kK16 * 16 == kD || col < kD)
                           ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                 qg + row * in_sn + col))
                           : make_float2(0.f, 0.f);
      qa[kk][e] = pack(x.x * scale, x.y * scale);
    }

  // Step s < nc stages key chunk s of K (pass 1), step nc + c chunk c of K
  // and V (pass 2), into stage s % 2 of the ring.
  const int nc = (n + kKB - 1) / kKB, steps = 2 * nc;
  auto issue = [&](int step) {
    const int c = step < nc ? step : step - nc, st = step % 2;
#pragma unroll
    for (int u = 0; u < kPieces; ++u) {
      const int i = tid + u * kBlock;
      if (kKB * kC8 % kBlock != 0 && i >= kKB * kC8) break;
      const int r = i / kC8, col = i % kC8 * 8, key = c * kKB + r;
      const long long off = (long long)min(key, n - 1) * in_sn + col;
      stage_piece(ks + st * kStage + r * kRow + col, kg + off, key < n, aligned);
      if (step >= nc) stage_piece(vs + st * kStage + r * kRow + col, vg + off, key < n, aligned);
    }
    cp_async_commit();
  };

  // S (16 rows x 64 keys from the chunk at kst) = q k^T, n-tile t holding
  // keys 8 t..; 16-key groups at or past `groups` hold only keys past n and
  // are skipped (left at 0, masked below).
  float s[kKB / 8][4];
  auto scores = [&](const bf16* kst, int groups) {
#pragma unroll
    for (int t = 0; t < kKB / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK16; ++kk)
#pragma unroll
      for (int u = 0; u < kKB / 16; ++u)
        if (u < groups) {
          unsigned kb[4];
          load_b<kRow>(kb, kst, 16 * u, kk * 16, lane);
          mma(s[2 * u], qa[kk], kb[0], kb[1]);
          mma(s[2 * u + 1], qa[kk], kb[2], kb[3]);
        }
  };

  // m: the row's running max (after pass 1, max log2(e)); l: this thread's
  // share of the sum of exp(S - m) (after pass 1, 1 / the row's sum).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float oacc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;

  issue(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      issue(step + 1);  // into the stage the previous step read
    } else {
      cp_async_commit();  // an empty group, so one wait fits every step
    }
    cp_async_wait_one();
    __syncthreads();
    const int j0 = (step < nc ? step : step - nc) * kKB;
    const int groups = min(kKB / 16, (n - j0 + 15) / 16);
    const bf16* kst = ks + step % 2 * kStage;
    if (active && step < nc) {
      // Pass 1: each row's max and sum of exp(S - max), in fp32.
      scores(kst, groups);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float bm = -INFINITY;
#pragma unroll
        for (int t = 0; t < kKB / 8; ++t)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[t][2 * half + c];
            if (j0 + kKB > n && j0 + t * 8 + t2 + c >= n) x = -INFINITY;
            bm = fmaxf(bm, x);
          }
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
        const float mn = fmaxf(m[half], bm), ml = mn * kLog2e;
        float sum = l[half] * exp2f(fmaf(m[half], kLog2e, -ml));
#pragma unroll
        for (int t = 0; t < kKB / 8; ++t)
          sum += exp2f(fmaf(s[t][2 * half], kLog2e, -ml)) +
                 exp2f(fmaf(s[t][2 * half + 1], kLog2e, -ml));
        l[half] = sum;
        m[half] = mn;
      }
      if (step == nc - 1) {
        // 1 / sum: P = exp(S - max) (1 / sum) is within a few fp32 ulp of
        // the quotient, and P is rounded to bf16 only after it.
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float x = l[half];
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
          l[half] = 1.f / x;
          m[half] *= kLog2e;
        }
      }
    } else if (active) {
      // Pass 2: P in fp32, rounded to bf16; o += P v.
      scores(kst, groups);
      const bf16* vst = vs + step % 2 * kStage;
#pragma unroll
      for (int u = 0; u < kKB / 16; ++u) {
        if (u >= groups) break;
        unsigned pa[4];  // two accumulator n-tiles are one A operand (16 x 16 keys)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float p[2];
#pragma unroll
            for (int c = 0; c < 2; ++c)
              p[c] = j0 + 16 * u + 8 * t + t2 + c < n
                         ? exp2f(fmaf(s[2 * u + t][2 * half + c], kLog2e, -m[half])) * l[half]
                         : 0.f;
            pa[2 * t + half] = pack(p[0], p[1]);
          }
        // Pairs of n8 tiles over Dh, counted: a loop on j + 1 < kD / 8 put
        // the accumulators in local memory at Dh 72.
#pragma unroll
        for (int jp = 0; jp < kD / 16; ++jp) {
          const int j = 2 * jp;
          unsigned vb[4];  // v as [key][dim]: B (k = key, n = dim) through .trans
          ldsm_x4_trans(vb, vst + (16 * u + lane % 8 + ((lane / 8) % 2) * 8) * kRow + j * 8 +
                                (lane / 16) * 8);
          mma(oacc[j], pa, vb[0], vb[1]);
          mma(oacc[j + 1], pa, vb[2], vb[3]);
        }
        if (kD / 8 % 2) {  // an odd count of n8 tiles (Dh 72): the last alone
          unsigned vb[2];
          ldsm_x2_trans(vb, vst + (16 * u + lane % 8 + ((lane / 8) % 2) * 8) * kRow + kD - 8);
          mma(oacc[kD / 8 - 1], pa, vb[0], vb[1]);
        }
      }
    }
    __syncthreads();  // the next step's copies overwrite this stage
  }

  bf16* og = o + blockIdx.z * out_sb + blockIdx.y * out_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + g + half * 8;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + r * out_sn + j * 8 + t2) =
          __floats2bfloat162_rn(oacc[j][2 * half], oacc[j][2 * half + 1]);
  }
}

int launch(const void* q, const void* k, const void* v, void* o, long long in_sb,
           long long in_sh, long long in_sn, long long out_sb, long long out_sh,
           long long out_sn, int b, int h, int n, float scale, cudaStream_t stream) {
  // cp.async copies 16 bytes: the rows of q, k and v must start on 16 bytes.
  const bool aligned =
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 == 0 &&
      (in_sb | in_sh | in_sn) % 8 == 0;
  const dim3 grid((n + 16 * kWarps - 1) / (16 * kWarps), h, b);
  attention_fwd_mma_kernel<<<grid, kBlock, kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), in_sb, in_sh, in_sn, out_sb, out_sh, out_sn, n, scale,
      aligned ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace tc

// Shared memory one block needs. bf16: two stages of K and V chunks
// (tc::kSmemBytes, the same at every N). fp32: K and V whole with rows of
// Dh + 2, a 32-row fp32 query tile and its fp32 score rows.
size_t smem_bytes(int n, size_t elem) {
  if (elem == sizeof(__nv_bfloat16)) return tc::kSmemBytes;
  return 2 * (size_t)n * kKS * elem + (size_t)kTQ * kQS * sizeof(float) +
         (size_t)kTQ * (n + 1) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     long long in_sb, long long in_sh, long long in_sn,
                     long long out_sb, long long out_sh, long long out_sn,
                     int n, float scale) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                         // [n][kKS]
  T* vs = ks + (size_t)n * kKS;                               // [n][kKS]
  float* qs = reinterpret_cast<float*>(vs + (size_t)n * kKS); // [kTQ][kQS]
  float* ss = qs + kTQ * kQS;                                 // [kTQ][n + 1]
  const int sst = n + 1;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTQ;
  const long long in_base = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const T* qg = q + in_base;
  const T* kg = k + in_base;
  const T* vg = v + in_base;

  // Stage K and V of this (batch, head) and the scaled query tile.
  for (int i = tid; i < n * (kD / 2); i += kThreads) {
    const int j = i / (kD / 2), c = (i % (kD / 2)) * 2;
    *reinterpret_cast<T2*>(ks + j * kKS + c) =
        *reinterpret_cast<const T2*>(kg + j * in_sn + c);
    *reinterpret_cast<T2*>(vs + j * kKS + c) =
        *reinterpret_cast<const T2*>(vg + j * in_sn + c);
  }
  for (int i = tid; i < kTQ * (kD / 2); i += kThreads) {
    const int r = i / (kD / 2), c = (i % (kD / 2)) * 2;
    float2 x = make_float2(0.f, 0.f);
    if (q0 + r < n)
      x = to_float2(*reinterpret_cast<const T2*>(qg + (q0 + r) * in_sn + c));
    qs[r * kQS + c] = round_as(x.x * scale, q);
    qs[r * kQS + c + 1] = round_as(x.y * scale, q);
  }
  __syncthreads();

  const int rg = tid / 16;  // this thread's rows: rg * 4 .. rg * 4 + 3
  const int cg = tid % 16;  // this thread's column group

  // S = (q * scale) K^T, fp32, one chunk of 48 key columns at a time.
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    float acc[4][kCT];
    int kj[kCT];
#pragma unroll
    for (int c = 0; c < kCT; ++c) {
      kj[c] = min(c0 + cg + 16 * c, n - 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < kD; d += 2) {
      float2 kv[kCT];
#pragma unroll
      for (int c = 0; c < kCT; ++c)
        kv[c] = to_float2(*reinterpret_cast<const T2*>(ks + kj[c] * kKS + d));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 qv =
            *reinterpret_cast<const float2*>(qs + (rg * 4 + i) * kQS + d);
#pragma unroll
        for (int c = 0; c < kCT; ++c) {
          acc[i][c] = fmaf(qv.x, kv[c].x, acc[i][c]);
          acc[i][c] = fmaf(qv.y, kv[c].y, acc[i][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCT; ++c) {
      const int j = c0 + cg + 16 * c;
      if (j < n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ss[(rg * 4 + i) * sst + j] = acc[i][c];
      }
    }
  }
  __syncthreads();

  // Softmax over whole rows in fp32; P rounded to the V type.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp * (kTQ / 4); r < (warp + 1) * (kTQ / 4); ++r) {
    float* row = ss + r * sst;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) row[j] = round_as(row[j] / sum, v);
  }
  __syncthreads();

  // O = P V, fp32; this thread owns rows rg*4.. and the column pairs
  // 2 (cg + 16 p), p < kCP, that lie inside Dh (Dh 64: columns 2cg, 2cg+1,
  // 2cg+32, 2cg+33).
  float acc[4][2 * kCP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 2 * kCP; ++c) acc[i][c] = 0.f;
  for (int j = 0; j < n; ++j) {
    float2 vv[kCP];
#pragma unroll
    for (int p = 0; p < kCP; ++p)
      vv[p] = owns_pair(cg, p)
                  ? to_float2(*reinterpret_cast<const T2*>(vs + j * kKS + 2 * (cg + 16 * p)))
                  : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pr = ss[(rg * 4 + i) * sst + j];
#pragma unroll
      for (int p = 0; p < kCP; ++p) {
        acc[i][2 * p] = fmaf(pr, vv[p].x, acc[i][2 * p]);
        acc[i][2 * p + 1] = fmaf(pr, vv[p].y, acc[i][2 * p + 1]);
      }
    }
  }
  T* og = o + blockIdx.z * out_sb + blockIdx.y * out_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r < n) {
#pragma unroll
      for (int p = 0; p < kCP; ++p)
        if (owns_pair(cg, p))
          store_pair(og + r * out_sn + 2 * (cg + 16 * p), acc[i][2 * p], acc[i][2 * p + 1]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           long long in_sb, long long in_sh, long long in_sn,
           long long out_sb, long long out_sh, long long out_sn,
           int b, int h, int n, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + kTQ - 1) / kTQ, h, b);
  attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), in_sb, in_sh, in_sn,
      out_sb, out_sh, out_sn, n, scale);
  return (int)cudaGetLastError();
}

// The fp32 streaming instance (namespace stream): what the scalar kernel
// computes, at every N. One block per (batch, head, tile of 32 query rows),
// 128 threads; the tile's q * scale sits in shared memory, K and V stream
// through it in chunks of 64 keys (rows of Dh + 2 floats), and nothing in
// shared memory grows with N (50,560 B a block at Dh 64, 55,680 B at 72).
// Pass 1 streams K: each row's max m and l = sum exp(S - m), kept online (l
// rescaled by exp(m_old - m_new) as m grows). Pass 2 streams K and V: S
// again (the same FMAs in the same order, so the same bits), P = exp(S - m)
// / l, exact since m and l are final, through a 32 x 64 chunk of shared
// memory, and O += P V in registers. A thread owns 4 rows x 4 keys of each
// S chunk (keys cg + 16 c) and the rows' column pairs of O as the scalar
// kernel's threads do. The products are scalar fp32 FMAs (mma.sync takes
// fp32 only as TF32). exp is expf, the division a division, as in the
// scalar kernel; the sum is rescaled online, which moves l by fp32 ulps.
// Keys past N are -inf in pass 1 and P = 0 in pass 2; K and V rows past N
// are zero. Rows of q past N are zero and not stored.
namespace stream {

constexpr int kTQ = 32;             // query rows per block
constexpr int kKB = 64;             // keys per chunk
constexpr int kThreads = 128;       // 8 row groups x 16 column groups
constexpr int kS = kD + 2;          // smem row stride (floats) of q, K and V
constexpr int kPS = kKB + 1;        // smem row stride of the P chunk
constexpr int kCols = kKB / 16;     // keys of a chunk a thread owns: cg + 16 c
constexpr size_t kSmemBytes =
    ((size_t)kTQ * kS + 2 * (size_t)kKB * kS + (size_t)kTQ * kPS) * sizeof(float);

// Rows r0.. of src (row stride sn, kD contiguous floats), `rows` of them,
// into dst (stride kS), times `mul`; rows past n are zero.
__device__ __forceinline__ void stage(float* dst, const float* src, long long sn, int r0,
                                      int rows, int n, float mul) {
  for (int i = threadIdx.x; i < rows * (kD / 2); i += kThreads) {
    const int r = i / (kD / 2), c = i % (kD / 2) * 2;
    float2 x = make_float2(0.f, 0.f);
    if (r0 + r < n) {
      x = *reinterpret_cast<const float2*>(src + (r0 + r) * sn + c);
      x.x *= mul;
      x.y *= mul;
    }
    *reinterpret_cast<float2*>(dst + r * kS + c) = x;
  }
}

// s[i][c] = q_(rg 4 + i) . k_(cg + 16 c) over Dh, in pairs of dims.
__device__ __forceinline__ void scores(float (&s)[4][kCols], const float* qs,
                                       const float* ks, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; d += 2) {
    float2 kv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      kv[c] = *reinterpret_cast<const float2*>(ks + (cg + 16 * c) * kS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 qv = *reinterpret_cast<const float2*>(qs + (rg * 4 + i) * kS + d);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        s[i][c] = fmaf(qv.x, kv[c].x, s[i][c]);
        s[i][c] = fmaf(qv.y, kv[c].y, s[i][c]);
      }
    }
  }
}

// Over the 16 lanes of a half warp (one row group).
__device__ __forceinline__ float group_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
attention_fwd_streaming_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ o,
                               long long in_sb, long long in_sh, long long in_sn,
                               long long out_sb, long long out_sh, long long out_sn,
                               int n, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kTQ][kS]
  float* ks = qs + kTQ * kS;                   // [kKB][kS]
  float* vs = ks + kKB * kS;                   // [kKB][kS]
  float* ps = vs + kKB * kS;                   // [kTQ][kPS]

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int q0 = blockIdx.x * kTQ;
  const long long in_base = blockIdx.z * in_sb + blockIdx.y * in_sh;
  stage(qs, q + in_base, in_sn, q0, kTQ, n, scale);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  float s[4][kCols];
  // Pass 1: each row's max and sum of exp(S - max).
  for (int j0 = 0; j0 < n; j0 += kKB) {
    __syncthreads();  // q staged; the previous chunk's readers done
    stage(ks, k + in_base, in_sn, j0, kKB, n, 1.f);
    __syncthreads();
    scores(s, qs, ks, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float bm = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (j0 + cg + 16 * c >= n) s[i][c] = -INFINITY;
        bm = fmaxf(bm, s[i][c]);
      }
      const float mn = fmaxf(m[i], group_max(bm));
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) part += expf(s[i][c] - mn);
      l[i] = l[i] * expf(m[i] - mn) + group_sum(part);
      m[i] = mn;
    }
  }

  // Pass 2: P = exp(S - m) / l and O += P V.
  float acc[4][2 * kCP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 2 * kCP; ++c) acc[i][c] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kKB) {
    __syncthreads();
    stage(ks, k + in_base, in_sn, j0, kKB, n, 1.f);
    stage(vs, v + in_base, in_sn, j0, kKB, n, 1.f);
    __syncthreads();
    scores(s, qs, ks, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        ps[(rg * 4 + i) * kPS + cg + 16 * c] =
            j0 + cg + 16 * c < n ? expf(s[i][c] - m[i]) / l[i] : 0.f;
    __syncthreads();
    const int keys = min(kKB, n - j0);
    for (int j = 0; j < keys; ++j) {
      float2 vv[kCP];
#pragma unroll
      for (int p = 0; p < kCP; ++p)
        vv[p] = owns_pair(cg, p)
                    ? *reinterpret_cast<const float2*>(vs + j * kS + 2 * (cg + 16 * p))
                    : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pr = ps[(rg * 4 + i) * kPS + j];
#pragma unroll
        for (int p = 0; p < kCP; ++p) {
          acc[i][2 * p] = fmaf(pr, vv[p].x, acc[i][2 * p]);
          acc[i][2 * p + 1] = fmaf(pr, vv[p].y, acc[i][2 * p + 1]);
        }
      }
    }
  }
  float* og = o + blockIdx.z * out_sb + blockIdx.y * out_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r < n) {
#pragma unroll
      for (int p = 0; p < kCP; ++p)
        if (owns_pair(cg, p))
          store_pair(og + r * out_sn + 2 * (cg + 16 * p), acc[i][2 * p], acc[i][2 * p + 1]);
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* o, long long in_sb,
           long long in_sh, long long in_sn, long long out_sb, long long out_sh,
           long long out_sn, int b, int h, int n, float scale, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_streaming_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kTQ - 1) / kTQ, h, b);
  attention_fwd_streaming_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), in_sb, in_sh, in_sn, out_sb, out_sh, out_sn, n, scale);
  return (int)cudaGetLastError();
}

}  // namespace stream

}  // namespace

extern "C" {

// The head dim this library was built for (HEAD_DIM).
int k1_attention_head_dim() { return kD; }

// Shared memory one block needs for sequence length n and element size.
size_t k1_attention_smem_bytes(int n, int elem_bytes) {
  return smem_bytes(n, (size_t)elem_bytes);
}

// Largest dynamic shared memory a block may opt into on `device`, or -1.
int k1_attention_max_smem(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// q, k, v share the element strides (in_sb, in_sh, in_sn); the last dim is
// contiguous and kD long. scale is q's factor s_q, Dh^-1/2 rounded to the
// input type. dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of
// the launch (0 on success).
int k1_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                     void* o, long long in_sb, long long in_sh, long long in_sn,
                     long long out_sb, long long out_sh, long long out_sn,
                     int b, int h, int n, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, in_sb, in_sh, in_sn, out_sb, out_sh,
                         out_sn, b, h, n, scale, s);
  if (dtype == 1)
    return tc::launch(q, k, v, o, in_sb, in_sh, in_sn, out_sb, out_sh, out_sn,
                      b, h, n, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The fp32 streaming instance's shared memory per block (any N).
size_t k1_attention_streaming_smem_bytes() { return stream::kSmemBytes; }

// As k1_attention_fwd, on the fp32 streaming instance, which takes every N;
// dtype must be 0 (float32).
int k1_attention_fwd_streaming(int dtype, const void* q, const void* k, const void* v,
                               void* o, long long in_sb, long long in_sh, long long in_sn,
                               long long out_sb, long long out_sh, long long out_sn,
                               int b, int h, int n, float scale, void* stream) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return stream::launch(q, k, v, o, in_sb, in_sh, in_sn, out_sb, out_sh, out_sn, b, h, n,
                        scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
