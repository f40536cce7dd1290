// K3: the whole attention sublayer (qkv projection, multi-head attention,
// output projection), written for Hopper (sm_90a).
//
// Replaces jpdvt_mt_ntnu_tpu/ops/attention.py:_attn_block_kernel, the Pallas
// kernel behind fused_attention_block (model.attn_impl="block"). Same
// arithmetic and rounding points, per (item, head h):
//   q = T(T(x Wq_h + bq_h) * s_q), s_q being Dh^-1/2 rounded to T first, as
//     JAX rounds its weakly typed Python float (the wrapper passes s_q as
//     `scale`; a bf16 q times a bf16 s_q is exact in fp32, so the one
//     rounding is JAX's; at Dh 64 s_q is 2^-3 and nothing rounds),
//   k = T(x Wk_h + bk_h), v = T(x Wv_h + bv_h), products in fp32, fp32 biases;
//   S = q k^T in fp32, P = exp(S - rowmax) / rowsum in fp32, o_h = T(T(P) v);
//   out = T(sum_h o_h Wp_h + bp), the sum over heads in fp32, in head order.
// T is the input type (bf16 on the solve, fp32 in tests).
//
// Design. The TPU kernel keeps all of a program's weights (4.7 MB in bf16 at
// D = 768, H = 12) in VMEM; a Hopper block has 227 KB of shared memory, and
// the fp32 (N, D) accumulator alone is 442 KB at N = 144. So two launches,
// A.1 one block per (head, item) and A.2 the output projection; o_h goes,
// in T, through a (B, N, H Dh) buffer (the layout K1's output has).
//
// bf16 (the solve's type) runs on the tensor cores, mma.sync m16n8k16 with
// fp32 accumulators, operands staged in shared memory as bf16 and loaded
// with ldmatrix (rows of 64 + 8 elements, 144 B, so the eight rows of an
// 8 x 8 matrix fall on distinct banks):
//   A.1, grid (H, B), 12 warps. The projection computes q|k|v (N x 192) =
//     x W_h^T in passes of 144 rows (N = 144 is one pass) over K-chunks of
//     64, on 3 x 4 warp tiles of 48 x 48; each thread holds the next
//     chunk's share in registers while the warps multiply this one. The
//     weights are read as the port's Linear weights lie ((3 H Dh, D) rows,
//     K contiguous: the .col B operand as it is), so no copy is made per
//     call. q, k, v stay whole in shared memory (rows padded to a multiple
//     of 16, zero beyond N). Attention: each warp takes its share of the
//     16-row query tiles, two at once where there are more tiles than
//     warps (sharing each k and v fragment); pass 1 runs S = q k^T through
//     mma 32 keys at a time to each row's max and sum in fp32; pass 2
//     computes S again, P = exp(S - max) (1 / sum) in fp32, rounds P to bf16
//     in registers (the accumulator layout of two n-tiles is the A
//     operand's) and adds P v, v read with ldmatrix.trans. P is normalised
//     before it is rounded, as in the TPU kernel; whole fp32 score rows for
//     12 warps would not fit beside q, k, v at N = 400, so S is computed
//     twice (4% more FLOPs at N = 144, 10% at N = 400). exp is exp2 of one
//     FFMA on the special-function unit (2 ulp), the sum's reciprocal one
//     division per row: P moves by a few fp32 ulp, far below its bf16
//     rounding.
//   A.2, grid (B N / 128, D / 64), 8 warps: out = o Wp^T + bp, Wp the
//     Linear weight ((D, H Dh) rows, K contiguous), K-chunks of one head
//     in head order inside each warp's 32 x 32 accumulators: each output
//     element has one owning accumulator (no atomics, no split-K), so two
//     calls are bit-equal and faithful-250 and fast solves agree bit for
//     bit.
// Shared memory caps bf16 N at 416 (smem_bytes). What bounds it on the card
// (tools/k3_variants.py): A.1's projection, by its traffic from L2 (each
// of the H blocks of an item reads x, each of the B blocks of a head reads
// W_h) and shared memory more than by its products; then the attention's
// two passes at N = 400.
//
// fp32 (the tests' type; mma.sync takes fp32 only as TF32) keeps the
// scalar design: A.1 streams 32-wide K-chunks of x and of the three weight
// slices ((3H, D, Dh), contiguous) through shared memory in fp32, 48 rows
// of x at a time (6 x 6 fp32 accumulators a thread), keeps q, k, v whole
// with rows of Dh + 2, and runs attention as K1 does, on 32-row query
// tiles with whole fp32 score rows; A.2 is a scalar product on 64 x 64
// tiles over the heads in order. It is launched only for fp32.
//
// Not done in the short-row instance: wgmma, TMA (the long-row instance
// below has both), multicast of W_h to the blocks of a head, and a cluster
// of H blocks that reduces over heads in distributed shared memory (no bf16
// o round trip). A cp.async double buffer of 32-wide chunks (the room two
// stages leave) was slower than the register prefetch of 64-wide ones: one
// chunk in flight did not hide the copies' latency.
//
// Bound on an H100 SXM at the solve's B = 32, N = 144, D = 768, H = 12, Dh =
// 64, bf16: the products are 2 B N D 4D + 4 B H N^2 Dh = 23.8 GFLOP, 24 us at
// 989 TFLOP/s; x and out once plus the weights once are 18.9 MB, 5.6 us at
// 3.35 TB/s. So the bound is the operations. The fast solve launches this
// pair once per DiT block (12 per microbatch), faithful-250 3,000 times.
// At DiT-XL/8's 96 px solve (B = 32, N = 144, D = 1152, H = 16, Dh = 72):
// 52.0 GFLOP, 52.6 us, against 31.9 MB, 9.5 us: the operations again; 28
// launches a fast microbatch, 7,000 a faithful-250 one.
//
// The head dim is a compile-time constant, HEAD_DIM (64 by default; the build
// compiles this file again with -DHEAD_DIM=72 for DiT-XL, a library of its
// own). At Dh 72, bf16: q|k|v is 216 columns, 27 n8 tiles, which 4 warp
// columns cannot split evenly, so the warp columns take 7, 7, 7 and 6 tiles
// (56 columns; three pairs by ldmatrix.x4 and a seventh by ldmatrix.x2, which
// the last column skips); the weight chunks staged are 144 + 216 rows; q, k, v
// take rows of 88 elements (176 B, an odd count of 16-byte units); S = q k^T
// takes five k16 steps, the fifth over dims 64-79 with dims 72-79 of q and k
// zero in shared memory (written once, before the projection), and P v nine n8
// tiles, in pairs over a loop of constant trip count and the ninth by
// ldmatrix.x2.trans. A.2's K-chunks stay one head wide, in head order: a
// head's 72 dims are five k16 steps, dims 72-79 of the staged rows zero.
// Shared memory caps bf16 N at 336 (416 at Dh 64). fp32: 32 column groups x 7
// cover the 216 projection columns (the seventh only for groups below 24),
// lanes 0-3 own a second column pair of o, and A.2's K-chunks are 36 wide (a
// head is two); fp32 N <= 223 (252 at Dh 64).

#include <cuda.h>  // CUtensorMap and its enums only: the driver is reached through cudart
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include <map>
#include <mutex>
#include <utility>

#ifndef HEAD_DIM
#define HEAD_DIM 64
#endif

namespace {

constexpr int kD = HEAD_DIM;    // head dim (64 or 72); the Python wrapper checks it
static_assert(kD % 8 == 0, "rows are staged in 16-byte pieces");
constexpr int kThreads = 256;
constexpr int kS = kD + 2;      // smem row stride of q, k, v (elements)
// A.1, the projections: 48 rows of x (8 row groups x 6) by q|k|v (3 Dh
// columns, 32 column groups x kPJ: 6 at Dh 64, 7 at 72), over K-chunks of
// 32.
constexpr int kPR = 48;
constexpr int kKC = 32;
constexpr int kXS = kKC + 1;    // smem row stride of the x chunk (floats)
constexpr int kPC = 3 * kD;
constexpr int kPJ = (kPC + 31) / 32;
// Whether column group cg owns its j-th projection column (cg + 32 j).
__device__ __forceinline__ bool owns_col(int cg, int j) {
  return kPC % 32 == 0 || cg + 32 * j < kPC;
}
// A.1, attention: 32 query rows (8 row groups x 4), key columns in chunks of
// 64 (32 column groups x 2).
constexpr int kTQ = 32;
constexpr int kCT = 2;
constexpr int kChunk = 32 * kCT;
constexpr int kOP = (kD / 2 + 31) / 32;  // column pairs of o a lane owns
// Whether lane cg owns its p-th column pair of o (dims 2 (cg + 32 p)).
__device__ __forceinline__ bool owns_o_pair(int cg, int p) {
  return kD / 2 % 32 == 0 || cg + 32 * p < kD / 2;
}
// A.2, the output projection: 64 x 64 output tiles (16 row groups x 4 rows,
// 16 column groups x 4 columns), K-chunks of half a head (32 at Dh 64, 36
// at 72), so that H Dh is a multiple of them.
constexpr int kOM = 64;
constexpr int kON = 64;
constexpr int kOK = kD / 2;

// The scalar kernels below are templates of the element type T as they
// were written; since the bf16 design moved to the tensor cores (namespace
// tc) only T = float is instantiated.
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };

__device__ __forceinline__ float2 to_float2(float2 v) { return v; }

// Round to T and back: the casts to the input type in the TPU kernel.
__device__ __forceinline__ float round_as(float v, const float*) { return v; }

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
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

// q, k, v of one (item, head), rounded up to 16 bytes.
__host__ __device__ size_t qkv_bytes(int n, size_t elem) {
  return (3 * (size_t)n * kS * elem + 15) / 16 * 16;
}

// The bf16 design on the tensor cores (see the head of this file).
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kA1Threads = 384;  // A.1: 12 warps
constexpr int kA1Warps = kA1Threads / 32;
// Row stride (elements) of q, k, v and A.2's chunks, an odd count of
// 16-byte units: 144 B at Dh 64, 176 B at 72.
constexpr int kRow = kD / 8 % 2 == 0 ? kD + 8 : kD + 16;
// k16 steps over Dh (S = q k^T, A.2's head chunk); the last one's dims
// past kD are zero.
constexpr int kK16 = (kD + 15) / 16;
static_assert(kK16 * 16 - kD <= 8 && kK16 * 16 <= kRow, "one zero piece a row pads Dh");
// A.1, the projection: 144 rows of x by q|k|v (3 Dh columns, kNT n8 tiles)
// over K-chunks of 64; warp tiles of 48 rows x kWT n8 tiles (3 x 4 warps;
// Dh 64: 48 x 48; Dh 72: 48 x 56, the last warp column 48 x 48).
constexpr int kPR = 144;
constexpr int kKC = 64;
constexpr int kCRow = kKC + 8; // row stride of the staged chunks: 144 B
constexpr int kPC = 3 * kD;
constexpr int kNT = kPC / 8;
constexpr int kWT = (kNT + 3) / 4;
// A.1, attention: keys 32 at a time; a warp takes up to kQT (a template
// parameter: 1 where the query tiles are no more than the warps, else 2)
// 16-row query tiles at once.
constexpr int kKB = 32;
// A.2: 128 x 64 output tiles (warp tiles 32 x 32), K-chunks of one head.
constexpr int kOM = 128;
constexpr int kON = 64;
constexpr int kWN = kON / 2;
constexpr int kOK = kD;

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
// Two 8 x 8 b16 matrices (.trans: transposed); lanes 8i..8i+7 (i < 2)
// give matrix i's row addresses.
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A operand (16 x 16) at rows r0.., columns k0.. of a [row][kStride] array.
template <int kStride>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* base, int r0, int k0,
                                       int lane) {
  ldsm_x4(a, base + (r0 + lane % 16) * kStride + k0 + (lane / 16) * 8);
}
// B operands of two n-tiles (n0.., n0 + 8..) x k16, from B^T as
// [n][kStride]: r[0], r[1] the first tile's, r[2], r[3] the second's.
template <int kStride>
__device__ __forceinline__ void load_b(unsigned (&r)[4], const bf16* base, int n0, int k0,
                                       int lane) {
  ldsm_x4(r, base + (n0 + lane % 8 + (lane / 16) * 8) * kStride + k0 + ((lane / 8) % 2) * 8);
}
// The B operand of one n-tile (n0..) x k16 alone, from B^T as [n][kStride].
template <int kStride>
__device__ __forceinline__ void load_b1(unsigned (&r)[2], const bf16* base, int n0, int k0,
                                        int lane) {
  ldsm_x2(r, base + (n0 + lane % 8) * kStride + k0 + ((lane / 8) % 2) * 8);
}

// Rounds of 16-byte pieces of a chunk, kC8 to a row, spread over kBlock
// threads; where they do not split evenly (Dh 72) the last round takes
// some of the threads (has_piece).
template <int kRows, int kC8, int kBlock>
__host__ __device__ constexpr int per_thread() {
  return (kRows * kC8 + kBlock - 1) / kBlock;
}
template <int kRows, int kC8, int kBlock>
__device__ __forceinline__ bool has_piece(int i) {
  return kRows * kC8 % kBlock == 0 || i < kRows * kC8;
}

// q, k, v (rows padded to 16), then the projection's staged chunks.
__host__ __device__ constexpr size_t qkv_bytes(int np) {
  return 3 * (size_t)np * kRow * sizeof(bf16);
}
__host__ __device__ constexpr size_t smem_bytes(int n) {
  return qkv_bytes((n + 15) / 16 * 16) + (size_t)(kPR + kPC) * kCRow * sizeof(bf16);
}

template <int kQT>
__global__ void __launch_bounds__(kA1Threads)
block_attention_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                           const float* __restrict__ bqkv, bf16* __restrict__ o, int n,
                           int heads, int hidden, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = (n + 15) / 16 * 16;
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [np][kRow]
  bf16* ks = qs + np * kRow;
  bf16* vs = ks + np * kRow;
  bf16* xs = vs + np * kRow;                 // [kPR][kCRow]
  bf16* ws = xs + kPR * kCRow;               // [kPC][kCRow]: W_h rows, K contiguous

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);  // accumulator row, column pair
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const bf16* xg = x + b * n * hidden;
  const int wr = warp / 4, wc = warp % 4;       // projection tile: 48 rows x kWT n8 tiles
  if (kK16 * 16 > kD) {
    // Dims kD.. of q's and k's rows, read by the last k16 step of S: zero
    // (the projection never writes them; its first barrier orders these).
    for (int i = tid; i < 2 * np; i += kA1Threads)
      *reinterpret_cast<uint4*>(qs + i * kRow + kD) = make_uint4(0u, 0u, 0u, 0u);
  }

  // q|k|v (np x 3 Dh) = x W_h^T, kPR rows at a time, over K-chunks; step s
  // is (row chunk s / nk, K-chunk s % nk). Each thread holds its share of
  // the next step's chunks in registers while the warps multiply this one.
  constexpr int kC8 = kKC / 8;
  constexpr int kXU = per_thread<kPR, kC8, kA1Threads>();
  static_assert(kPR * kC8 % kA1Threads == 0, "x's chunk splits evenly");
  constexpr int kWU = per_thread<kPC, kC8, kA1Threads>();
  const int nk = hidden / kKC, steps = (np + kPR - 1) / kPR * nk;
  uint4 xr[kXU], wreg[kWU];
  auto fetch = [&](int step) {
    const int r0 = step / nk * kPR, k0 = step % nk * kKC;
#pragma unroll
    for (int u = 0; u < kXU; ++u) {
      const int i = tid + u * kA1Threads, r = i / kC8, c = i % kC8 * 8;
      xr[u] = r0 + r < n ? *reinterpret_cast<const uint4*>(
                               xg + (long long)(r0 + r) * hidden + k0 + c)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kWU; ++u) {
      const int i = tid + u * kA1Threads, r = i / kC8, c = i % kC8 * 8;
      const int which = r / kD, d = r % kD;  // 0 q, 1 k, 2 v
      if (has_piece<kPC, kC8, kA1Threads>(i))
        wreg[u] = *reinterpret_cast<const uint4*>(
            wqkv + ((long long)(which * heads + h) * kD + d) * hidden + k0 + c);
    }
  };
  fetch(0);
  float acc[3][kWT][4];
  for (int step = 0; step < steps; ++step) {
    const int r0 = step / nk * kPR, k0 = step % nk * kKC;
    if (k0 == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < kWT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int u = 0; u < kXU; ++u) {
      const int i = tid + u * kA1Threads;
      *reinterpret_cast<uint4*>(xs + i / kC8 * kCRow + i % kC8 * 8) = xr[u];
    }
#pragma unroll
    for (int u = 0; u < kWU; ++u) {
      const int i = tid + u * kA1Threads;
      if (has_piece<kPC, kC8, kA1Threads>(i))
        *reinterpret_cast<uint4*>(ws + i / kC8 * kCRow + i % kC8 * 8) = wreg[u];
    }
    __syncthreads();
    if (step + 1 < steps) fetch(step + 1);
    // Whether this warp's last n8 tile lies inside q|k|v (at Dh 72 the
    // last warp column has one tile fewer); warp-uniform.
    const bool last_tile = kNT % 4 == 0 || wc * kWT + kWT - 1 < kNT;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      unsigned a[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i)  // m-tiles past the padded rows: skipped, warp-uniform
        if (r0 + wr * 48 + i * 16 < np) load_a<kCRow>(a[i], xs, wr * 48 + i * 16, kk, lane);
#pragma unroll
      for (int jp = 0; jp < kWT / 2; ++jp) {
        const int j = 2 * jp;
        unsigned wb[4];
        load_b<kCRow>(wb, ws, wc * (kWT * 8) + j * 8, kk, lane);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (r0 + wr * 48 + i * 16 < np) {
            mma(acc[i][j], a[i], wb[0], wb[1]);
            mma(acc[i][j + 1], a[i], wb[2], wb[3]);
          }
      }
      if (kWT % 2 && last_tile) {  // an odd count of n8 tiles a warp (Dh 72): the last alone
        unsigned wb[2];
        load_b1<kCRow>(wb, ws, wc * (kWT * 8) + (kWT - 1) * 8, kk, lane);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (r0 + wr * 48 + i * 16 < np) mma(acc[i][kWT - 1], a[i], wb[0], wb[1]);
      }
    }
    if (k0 + kKC < hidden) continue;
    // The fp32 bias, then bf16; q scaled in bf16; zero rows past n.
#pragma unroll
    for (int j = 0; j < kWT; ++j) {
      if (j == kWT - 1 && !last_tile) continue;
      const int col = wc * (kWT * 8) + j * 8 + t2;
      const int which = col / kD, d = col % kD;
      const float* bias = bqkv + (which * heads + h) * kD + d;
      bf16* dst = (which == 0 ? qs : which == 1 ? ks : vs) + d;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + wr * 48 + i * 16 + g + half * 8;
          if (r >= np) continue;
          float y0 = bf16_round(acc[i][j][2 * half] + bias[0]);
          float y1 = bf16_round(acc[i][j][2 * half + 1] + bias[1]);
          if (which == 0) {
            y0 = bf16_round(y0 * scale);
            y1 = bf16_round(y1 * scale);
          }
          if (r >= n) y0 = y1 = 0.f;
          *reinterpret_cast<__nv_bfloat162*>(dst + r * kRow) = __floats2bfloat162_rn(y0, y1);
        }
    }
  }
  __syncthreads();

  // Attention: warp w takes the 16-row query tiles [w per, (w + 1) per),
  // up to kQT at a time sharing each k and v fragment. In tile q this
  // thread's rows are q0 + 16 q + g (accumulator elements 0, 1) and that + 8
  // (elements 2, 3).
  bf16* og = o + b * n * (long long)(heads * kD) + h * kD;
  const int tiles = np / 16, per = (tiles + kA1Warps - 1) / kA1Warps;
  const int t_end = min((warp + 1) * per, tiles);
  for (int t0 = warp * per; t0 < t_end; t0 += kQT) {
    const int q0 = 16 * t0, nq = min(kQT, t_end - t0);  // warp-uniform
    unsigned qa[kQT][kK16][4];
#pragma unroll
    for (int q = 0; q < kQT; ++q)
      if (q < nq)
#pragma unroll
        for (int kk = 0; kk < kK16; ++kk)
          load_a<kRow>(qa[q][kk], qs, q0 + 16 * q, kk * 16, lane);

    // S (tiles x kKB keys from j0) = q k^T, n-tile t holding keys j0 + 8 t..;
    // 16-key groups at or past np are skipped (left at 0, masked below).
    float s[kQT][kKB / 8][4];
    auto scores = [&](int j0) {
#pragma unroll
      for (int q = 0; q < kQT; ++q)
#pragma unroll
        for (int t = 0; t < kKB / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[q][t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK16; ++kk)
#pragma unroll
        for (int u = 0; u < kKB / 16; ++u) {
          if (j0 + 16 * u >= np) break;
          unsigned kb[4];
          load_b<kRow>(kb, ks, j0 + 16 * u, kk * 16, lane);
#pragma unroll
          for (int q = 0; q < kQT; ++q)
            if (q < nq) {
              mma(s[q][2 * u], qa[q][kk], kb[0], kb[1]);
              mma(s[q][2 * u + 1], qa[q][kk], kb[2], kb[3]);
            }
        }
    };

    // exp(S - max) as exp2(S log2(e) - max log2(e)): one FFMA and the
    // special-function unit's exp2 (2 ulp) in place of expf's sequence.
    constexpr float kLog2e = 1.4426950408889634f;
    // Pass 1: each row's max and sum of exp(S - max), in fp32.
    float m[kQT][2], l[kQT][2];
#pragma unroll
    for (int q = 0; q < kQT; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) m[q][half] = -INFINITY, l[q][half] = 0.f;
    for (int j0 = 0; j0 < np; j0 += kKB) {
      scores(j0);
#pragma unroll
      for (int q = 0; q < kQT; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (q >= nq) continue;
          float bm = -INFINITY;
#pragma unroll
          for (int t = 0; t < kKB / 8; ++t)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float& v = s[q][t][2 * half + c];
              if (j0 + kKB > n && j0 + t * 8 + t2 + c >= n) v = -INFINITY;
              bm = fmaxf(bm, v);
            }
          bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
          bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
          const float mn = fmaxf(m[q][half], bm), ml = mn * kLog2e;
          float sum = l[q][half] * exp2f(fmaf(m[q][half], kLog2e, -ml));
#pragma unroll
          for (int t = 0; t < kKB / 8; ++t)
            sum += exp2f(fmaf(s[q][t][2 * half], kLog2e, -ml)) +
                   exp2f(fmaf(s[q][t][2 * half + 1], kLog2e, -ml));
          l[q][half] = sum;
          m[q][half] = mn;
        }
    }
    // 1 / sum: P = exp(S - max) (1 / sum) is within a few fp32 ulp of the
    // quotient, and P is rounded to bf16 only after it. m becomes max log2(e).
#pragma unroll
    for (int q = 0; q < kQT; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = l[q][half];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        l[q][half] = 1.f / v;
        m[q][half] *= kLog2e;
      }

    // Pass 2: P in fp32, rounded to bf16; o += P v.
    float oacc[kQT][kD / 8][4];
#pragma unroll
    for (int q = 0; q < kQT; ++q)
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[q][j][e] = 0.f;
    for (int j0 = 0; j0 < np; j0 += kKB) {
      scores(j0);
#pragma unroll
      for (int u = 0; u < kKB / 16; ++u) {
        if (j0 + 16 * u >= np) break;
        unsigned pa[kQT][4];  // two accumulator n-tiles are one A operand (16 x 16 keys)
#pragma unroll
        for (int q = 0; q < kQT; ++q)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              if (q >= nq) continue;
              float p[2];
#pragma unroll
              for (int c = 0; c < 2; ++c)
                p[c] = j0 + 16 * u + 8 * t + t2 + c < n
                           ? exp2f(fmaf(s[q][2 * u + t][2 * half + c], kLog2e, -m[q][half])) *
                                 l[q][half]
                           : 0.f;
              pa[q][2 * t + half] = pack(p[0], p[1]);
            }
        // Pairs of n8 tiles over Dh, a constant trip count: a loop on
        // j + 1 < kD / 8 put K1's accumulators in local memory at Dh 72.
#pragma unroll
        for (int j = 0; j < kD / 16 * 2; j += 2) {
          unsigned vb[4];  // v as [key][dim]: B (k = key, n = dim) through .trans
          ldsm_x4_trans(vb, vs + (j0 + 16 * u + lane % 8 + ((lane / 8) % 2) * 8) * kRow +
                                j * 8 + (lane / 16) * 8);
#pragma unroll
          for (int q = 0; q < kQT; ++q)
            if (q < nq) {
              mma(oacc[q][j], pa[q], vb[0], vb[1]);
              mma(oacc[q][j + 1], pa[q], vb[2], vb[3]);
            }
        }
        if (kD / 8 % 2) {  // an odd count of n8 tiles (Dh 72): the last alone
          unsigned vb[2];
          ldsm_x2_trans(vb, vs + (j0 + 16 * u + lane % 8 + ((lane / 8) % 2) * 8) * kRow + kD - 8);
#pragma unroll
          for (int q = 0; q < kQT; ++q)
            if (q < nq) mma(oacc[q][kD / 8 - 1], pa[q], vb[0], vb[1]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kQT; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = q0 + 16 * q + g + half * 8;
        if (q >= nq || r >= n) continue;
#pragma unroll
        for (int j = 0; j < kD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(og + (long long)r * heads * kD + j * 8 + t2) =
              __floats2bfloat162_rn(oacc[q][j][2 * half], oacc[q][j][2 * half + 1]);
      }
  }
}

// out (m x hidden) = o (m x inner) Wp^T + bp; Wp as [hidden][inner] rows.
__global__ void __launch_bounds__(kThreads)
out_proj_mma_kernel(const bf16* __restrict__ o, const bf16* __restrict__ wproj,
                    const float* __restrict__ bproj, bf16* __restrict__ out, int m, int inner,
                    int hidden) {
  __shared__ __align__(16) bf16 os[kOM * kRow];
  __shared__ __align__(16) bf16 ws[kON * kRow];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int wr = warp / 2, wc = warp % 2;  // warp tile: 32 rows x kWN columns
  const long long m0 = (long long)blockIdx.x * kOM;
  const int n0 = blockIdx.y * kON;
  if (kK16 * 16 > kD) {
    // Dims kD.. of a head's chunk, read by its last k16 step: zero (the
    // staging never writes them; the loop's first barrier orders these).
    for (int i = tid; i < kOM; i += kThreads)
      *reinterpret_cast<uint4*>(os + i * kRow + kOK) = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kON; i += kThreads)
      *reinterpret_cast<uint4*>(ws + i * kRow + kOK) = make_uint4(0u, 0u, 0u, 0u);
  }
  float acc[2][kWN / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // Inner index k = h * Dh + e runs through the heads in order; the next
  // K-chunk waits in registers while this one is multiplied.
  constexpr int kC8 = kOK / 8;
  constexpr int kAU = per_thread<kOM, kC8, kThreads>(), kBU = per_thread<kON, kC8, kThreads>();
  uint4 ar[kAU], br[kBU];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kAU; ++u) {
      const int i = tid + u * kThreads, r = i / kC8, c = i % kC8 * 8;
      if (has_piece<kOM, kC8, kThreads>(i))
        ar[u] = m0 + r < m ? *reinterpret_cast<const uint4*>(o + (m0 + r) * inner + k0 + c)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kBU; ++u) {
      const int i = tid + u * kThreads, r = i / kC8, c = i % kC8 * 8;
      if (has_piece<kON, kC8, kThreads>(i))
        br[u] = *reinterpret_cast<const uint4*>(wproj + (long long)(n0 + r) * inner + k0 + c);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < inner; k0 += kOK) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kAU; ++u) {
      const int i = tid + u * kThreads;
      if (has_piece<kOM, kC8, kThreads>(i))
        *reinterpret_cast<uint4*>(os + i / kC8 * kRow + i % kC8 * 8) = ar[u];
    }
#pragma unroll
    for (int u = 0; u < kBU; ++u) {
      const int i = tid + u * kThreads;
      if (has_piece<kON, kC8, kThreads>(i))
        *reinterpret_cast<uint4*>(ws + i / kC8 * kRow + i % kC8 * 8) = br[u];
    }
    __syncthreads();
    if (k0 + kOK < inner) fetch(k0 + kOK);
#pragma unroll
    for (int kk = 0; kk < kK16 * 16; kk += 16) {
      unsigned a[2][4];
      load_a<kRow>(a[0], os, wr * 32, kk, lane);
      load_a<kRow>(a[1], os, wr * 32 + 16, kk, lane);
#pragma unroll
      for (int j = 0; j < kWN / 8; j += 2) {
        unsigned wb[4];
        load_b<kRow>(wb, ws, wc * kWN + j * 8, kk, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(acc[i][j], a[i], wb[0], wb[1]);
          mma(acc[i][j + 1], a[i], wb[2], wb[3]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kWN / 8; ++j) {
    const int c = n0 + wc * kWN + j * 8 + t2;
    const float b0 = bproj[c], b1 = bproj[c + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long r = m0 + wr * 32 + i * 16 + g + half * 8;
        if (r < m)
          *reinterpret_cast<__nv_bfloat162*>(out + r * hidden + c) = __floats2bfloat162_rn(
              acc[i][j][2 * half] + b0, acc[i][j][2 * half + 1] + b1);
      }
  }
}

template <int kQT>
int launch_a1(const void* x, const void* wqkv, const void* bqkv, void* o, int b, int n,
              int heads, int hidden, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_attention_mma_kernel<kQT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  block_attention_mma_kernel<kQT><<<dim3(heads, b), kA1Threads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<bf16*>(o), n, heads, hidden, scale);
  return (int)cudaGetLastError();
}

// x (b, n, hidden); wqkv (3 heads kD, hidden) and wproj (hidden, heads kD),
// the Linear weights as they lie.
int launch(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
           const void* bproj, void* o, void* out, int b, int n, int heads, int hidden,
           float scale, cudaStream_t stream) {
  const int err = (n + 15) / 16 <= kA1Warps
                      ? launch_a1<1>(x, wqkv, bqkv, o, b, n, heads, hidden, scale, stream)
                      : launch_a1<2>(x, wqkv, bqkv, o, b, n, heads, hidden, scale, stream);
  if (err) return err;
  const int m = b * n;
  out_proj_mma_kernel<<<dim3((m + kOM - 1) / kOM, hidden / kON), kThreads, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(wproj),
      static_cast<const float*>(bproj), static_cast<bf16*>(out), m, heads * kD, hidden);
  return (int)cudaGetLastError();
}


// ---- The long-row instance (any N): q, k, v through a global scratch ----
//
// Three launches, bf16 on Hopper's warpgroup products (wgmma.mma_async,
// fp32 accumulators), the same arithmetic in the same order as the
// short-row instance, so the two give the same bits wherever both run
// (wgmma's k16 step gives mma.sync m16n8k16's bits, tools/wgmma_probe.py):
//   L.1, grid (B N / kP1Rows, H): kP1Groups consumer warpgroups of 64 rows
//     of x (3 at Dh 64, 2 at Dh 72) and a producer warp: q|k|v of one head
//     (192 columns at Dh 64, 216 at 72: one wgmma m64n192k16 / m64n216k16 a
//     k16 step, both operands from shared memory) for rows taken across
//     items (x viewed as (B N, D)). x and the head's three weight slices
//     arrive by TMA (tensor maps with the 128-byte swizzle, encoded through
//     the runtime's driver entry point and cached) in 64-wide K-chunks
//     through a ring of kP1Stages stages under mbarriers. The K-chunks and
//     their k16 steps run in A.1's order, and the epilogue is A.1's (the
//     fp32 bias, q times `scale`, rounding to bf16), so q, k and v are
//     A.1's bit for bit. They go to a (3, B, H) scratch of np x kDP slots
//     (np = long_rows(n), N rounded up to a 32-key group; kDP = 16 kK16, Dh
//     72 padded to 80 with zero dims) in the order L.2's descriptors read:
//     q and k in 8 x 8 core matrices, 8-row groups outermost ([j / 8][d /
//     8][j % 8][d % 8]); v transposed per 8-key group ([j / 8][d][j % 8]),
//     the K-major B operand of P v. So 64 keys of k or v are one contiguous
//     run that one cp.async.bulk brings in. Rows n..np-1 are zero.
//   L.2, grid (np / (64 l2_groups), H, B): consumer warpgroups of 64 query
//     rows, 2 a block where two blocks fit an SM's shared memory, else 3.
//     Up to N = 896 at Dh 64 (704 at 72) the head's k and v come in whole,
//     one bulk copy and one mbarrier per 64-key chunk, all issued by thread
//     0 at the start, so each block reads them once and pass 1 starts on
//     the first chunk; past that a producer warp streams them through a
//     ring of kL2Ring chunks of k and v. A warpgroup keeps its q as
//     mma.sync A fragments in registers. Pass 1: S = q k^T by wgmma
//     m64n32k16 (A from registers, k from shared memory), one 32-key group
//     at a time from key 0, then the rows' max and sum of exp(S - max) over
//     the group, each lane owning the columns it owns in mma.sync's layout
//     (wgmma's accumulator layout per warp), so max, sum and 1 / sum are the
//     short-row instance's. Pass 2: S again, P in fp32 rounded to bf16 in
//     registers as the A operand, o += P v by wgmma m64n64k16 / m64n72k16
//     (v^T from shared memory), 16 keys a step in key order. In both passes
//     the next group's products run while this group's softmax does; every
//     wgmma is issued on every path and no accumulator is touched between
//     its issue and its wait, so ptxas keeps them asynchronous.
//   A.2 as the short-row instance's.
// No step splits a sum or adds with atomics: an output element's arithmetic
// does not depend on B or on the block that computes it.
//
// Bound at (B, N, D, H) = (32, 576, 768, 12): L.1 65.2 GFLOP (66 us at 989
// TFLOP/s), whose blocks take x and W_h from L2 at 96 FLOP a byte: the
// SMs' intake (~3.4 TB/s measured) bounds it first; L.2 6 B H N^2 Dh = 48.9
// GFLOP (49 us) and 2 B H N^2 exp2 on the special-function units (16 a
// clock an SM: 68 us at 1.755 GHz). Tried and dropped (PERF.md section 6):
// 256 rows a block (192 accumulators a thread spill), a cluster multicasting
// W_h (slower), S of 64 keys a wgmma with no overlap.

// ---- Hopper primitives (tools/wgmma_probe.py builds this part into its
// probe kernel). ----
// >>> wgmma helpers

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets (bytes, multiples of 16), and the 128-byte swizzle or none.
__device__ __forceinline__ unsigned long long smem_desc(unsigned addr, unsigned lbo, unsigned sbo,
                                                        bool swizzle128) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         (unsigned long long)((lbo & 0x3FFFF) >> 4) << 16 |
         (unsigned long long)((sbo & 0x3FFFF) >> 4) << 32 |
         (unsigned long long)(swizzle128 ? 1 : 0) << 62;
}
// K-major tiles of 64-element (128-byte) rows written by TMA with the
// 128-byte swizzle, 1024-byte aligned: the k16 step kk starts 32 kk bytes in.
__device__ __forceinline__ unsigned long long sw128_desc(unsigned addr) {
  return smem_desc(addr, 16, 1024, true);
}
// K-major 8 x 8 core matrices, no swizzle: `lbo` between neighbours along
// K, `sbo` between 8-row groups.
__device__ __forceinline__ unsigned long long core_desc(unsigned addr, unsigned lbo,
                                                        unsigned sbo) {
  return smem_desc(addr, lbo, sbo, false);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// The wgmma wrappers below add a b to d, or (accumulate false, the first
// k16 step of a product) write it: a fresh sum, with no instruction
// writing d first while other products are in flight.
// Until at most kPending of this warpgroup's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16) from global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void wgmma_ss(float (&d)[96], unsigned long long da,
                                         unsigned long long db, bool accumulate = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"((int)accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[108], unsigned long long da,
                                         unsigned long long db, bool accumulate = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %110, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n216k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107}, "
      "%108, %109, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107])
      : "l"(da), "l"(db), "r"((int)accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const unsigned (&a)[4],
                                         unsigned long long db, bool accumulate = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"((int)accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const unsigned (&a)[4],
                                         unsigned long long db, bool accumulate = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"((int)accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[36], const unsigned (&a)[4],
                                         unsigned long long db, bool accumulate = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"((int)accumulate));
}

// <<< wgmma helpers

constexpr int kDP = kK16 * 16;        // dims of a q or k row in the scratch (Dh 72: 80)
constexpr int kCM = 64;               // elements of an 8 x 8 core matrix
// L.1: kP1Groups consumer warpgroups of 64 rows of x each (Dh 64: 3; Dh 72:
// 2, whose 108 accumulators a thread need the registers of a smaller block)
// and a producer warp; a ring of kP1Stages 64-wide K-chunks of x (kP1Rows
// rows) and of W_h (3 Dh rows), 128-byte rows.
constexpr int kP1Groups = kD == 64 ? 3 : 2;
constexpr int kP1Rows = 64 * kP1Groups;
constexpr int kP1Threads = kP1Groups * 128 + 32;
constexpr int kP1Stages = 4;
constexpr int kP1XBytes = kP1Rows * 128;
constexpr int kP1Stage = kP1XBytes + kPC * 128;  // 1024-byte multiples at Dh 64 and 72
static_assert(kP1Stage % 1024 == 0 && kD * 128 % 1024 == 0, "swizzled tiles stay aligned");
__host__ __device__ constexpr size_t project_smem_bytes() {
  return (size_t)kP1Stages * kP1Stage + 2 * kP1Stages * 8 + 1024;  // + alignment slack
}
// L.2: consumer warpgroups of 64 query rows, three a block, or two where
// two blocks' k and v fit one SM's shared memory (l2_groups); k and v in
// 64-key chunks (k rows of kDP, v^T per 8 keys), whole (thread 0 issues
// every copy at the start) or in a ring that a producer warp refills.
__host__ __device__ constexpr int l2_threads(bool whole, int groups) {
  return groups * 128 + (whole ? 0 : 32);
}
constexpr int kKeys = 64;
constexpr int kKChunk = kKeys * kDP * 2;
constexpr int kVChunk = kKeys * kD * 2;
constexpr int kL2Ring = 4;

// Rows of each (item, head) slot of the scratch: n rounded up to a 32-key
// group, rows n.. zero (their P is 0 and their v rows 0, so o is the
// short-row instance's, whose last 16-key step stops at n rounded to 16).
__host__ __device__ constexpr int long_rows(int n) { return (n + 31) / 32 * 32; }
__host__ __device__ constexpr size_t long_whole_bytes(int np) {
  return (size_t)(np + kKeys - 1) / kKeys * (kKChunk + kVChunk + 16);
}
// Whether L.2 takes the head's k and v whole (else through the ring).
__host__ __device__ constexpr bool long_kv_whole(int n) {
  return long_whole_bytes(long_rows(n)) <= 232448;
}
__host__ __device__ constexpr size_t long_smem_bytes(int n) {
  return long_kv_whole(n) ? long_whole_bytes(long_rows(n))
                          : (size_t)kL2Ring * (kKChunk + kVChunk + 16);
}
// L.2's warpgroups a block at n: two while two blocks fit an SM's 228 KB of
// shared memory (each with its 1 KB the system keeps), so that one block's
// loads and softmax overlap the other's products (Dh 64: N <= 448; Dh 72: N
// <= 320); else three, one block an SM.
__host__ __device__ constexpr int l2_groups(int n) {
  return long_kv_whole(n) && 2 * (long_smem_bytes(n) + 1024) <= 233472 ? 2 : 3;
}
// Elements of the scratch: q, k, v slots of np x kDP a (item, head).
__host__ __device__ constexpr size_t long_scratch_elems(int b, int n, int heads) {
  return 3 * (size_t)b * heads * (long_rows(n)) * kDP;
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// q|k|v of head h for rows m0.. of x (m = B n rows), into the scratch.
__global__ void __launch_bounds__(kP1Threads, 1)
block_project_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const float* __restrict__ bqkv, bf16* __restrict__ qkv, int m, int n,
                           int heads, int hidden, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + kP1Stages * kP1Stage);
  unsigned long long* empty = full + kP1Stages;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int m0 = blockIdx.x * kP1Rows, h = blockIdx.y;
  const int nk = hidden / kKC;
  constexpr int kConsumers = kP1Groups * 128;
  if (tid == 0) {
    for (int s = 0; s < kP1Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kP1Groups);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == kP1Groups) {  // the producer warp: one thread drives the TMA
    if (tid == kConsumers) {
      for (int s = 0; s < nk; ++s) {
        const int st = s % kP1Stages;
        if (s >= kP1Stages) mbar_wait(&empty[st], (s / kP1Stages - 1) & 1);
        unsigned char* xs = smem + st * kP1Stage;
        mbar_expect_tx(&full[st], kP1Stage);
        tma_load_2d(xs, &xmap, s * kKC, m0, &full[st]);
#pragma unroll
        for (int w = 0; w < 3; ++w)
          tma_load_2d(xs + kP1XBytes + w * kD * 128, &wmap, s * kKC, (w * heads + h) * kD,
                      &full[st]);
      }
    }
  } else {
    auto release = [&](int st) {  // this warp is done with stage st
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };
    float acc[kPC / 2];
#pragma unroll
    for (int e = 0; e < kPC / 2; ++e) acc[e] = 0.f;
    for (int s = 0; s < nk; ++s) {
      const int st = s % kP1Stages;
      mbar_wait(&full[st], (s / kP1Stages) & 1);
      const unsigned xa = smem_addr(smem + st * kP1Stage) + wg * 64 * 128;
      const unsigned wa = smem_addr(smem + st * kP1Stage + kP1XBytes);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk)
        wgmma_ss(acc, sw128_desc(xa + 32 * kk), sw128_desc(wa + 32 * kk));
      wgmma_commit();
      wgmma_wait<0>();  // the other warpgroups' products fill the tensor cores meanwhile
      fence_regs(acc);
      release(st);
    }

    // A.1's epilogue: the fp32 bias, then bf16; q scaled in bf16.
    const int g = lane / 4, t2 = 2 * (lane % 4);
    const int np = long_rows(n);
    const long long batch = m / n, slot = (long long)np * kDP;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wg * 64 + (tid % 128) / 32 * 16 + g + 8 * half;
      if (r >= m) continue;
      const int b = r / n, j = r % n;
#pragma unroll
      for (int t = 0; t < kPC / 8; ++t) {
        const int col = 8 * t + t2, which = col / kD, d = col % kD;
        const float* bias = bqkv + (which * heads + h) * kD + d;
        float y0 = bf16_round(acc[4 * t + 2 * half] + bias[0]);
        float y1 = bf16_round(acc[4 * t + 2 * half + 1] + bias[1]);
        bf16* base = qkv + ((which * batch + b) * heads + h) * slot;
        if (which == 2) {  // v^T: [j / 8][d][j % 8]
          bf16* p = base + ((long long)(j / 8) * kD + d) * 8 + j % 8;
          p[0] = __float2bfloat16_rn(y0);
          p[8] = __float2bfloat16_rn(y1);
          continue;
        }
        if (which == 0) {
          y0 = bf16_round(y0 * scale);
          y1 = bf16_round(y1 * scale);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            base + ((long long)(j / 8) * (kDP / 8) + d / 8) * kCM + (j % 8) * 8 + d % 8) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
    // Zeros: dims kD..kDP-1 of this block's q and k rows, and rows n..np-1 of
    // q, k and v of each item whose last row is in this block.
    if (kDP > kD) {
      for (int i = tid; i < 2 * kP1Rows; i += kConsumers) {
        const int r = m0 + i / 2;
        if (r >= m) continue;
        const int b = r / n, j = r % n;
        *reinterpret_cast<uint4*>(qkv + (((i % 2) * batch + b) * heads + h) * slot +
                                  ((long long)(j / 8) * (kDP / 8) + kD / 8) * kCM + (j % 8) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (np > n) {
      const int last = min(m0 + kP1Rows, m) - 1;
      for (int b = m0 / n; b <= last / n; ++b) {
        if (b * n + n - 1 < m0 || b * n + n - 1 > last) continue;
        const int pad = np - n;
        // q and k: 16-byte pieces of rows n.., kDP / 8 a row.
        for (int i = tid; i < 2 * pad * (kDP / 8); i += kConsumers) {
          const int which = i / (pad * (kDP / 8)), rest = i % (pad * (kDP / 8));
          const int j = n + rest / (kDP / 8), c = rest % (kDP / 8);
          *reinterpret_cast<uint4*>(qkv + ((which * batch + b) * heads + h) * slot +
                                    ((long long)(j / 8) * (kDP / 8) + c) * kCM + (j % 8) * 8) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        // v^T: single elements.
        for (int i = tid; i < pad * kD; i += kConsumers) {
          const int j = n + i / kD, d = i % kD;
          qkv[((2 * batch + b) * heads + h) * slot + ((long long)(j / 8) * kD + d) * 8 + j % 8] =
              __float2bfloat16_rn(0.f);
        }
      }
    }
  }
}

constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2(e))

// Pass 1 of L.2 on one 32-key group from key j0 (S in s, as the
// accumulators of mma.sync's n8 tiles): each of the lane's two rows' max m
// and sum l of exp(S - max), A.1's arithmetic. kMasked: the group holds
// keys at or past n, which count as -inf.
template <bool kMasked>
__device__ __forceinline__ void group_stats(const float (&s)[16], int j0, int n, int t2,
                                            float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float bm = -INFINITY, v[8];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        v[2 * t + cc] = kMasked && j0 + t * 8 + t2 + cc >= n ? -INFINITY
                                                              : s[4 * t + 2 * half + cc];
        bm = fmaxf(bm, v[2 * t + cc]);
      }
    bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
    bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
    const float mn = fmaxf(m[half], bm), ml = mn * kLog2e;
    float sum = l[half] * exp2f(fmaf(m[half], kLog2e, -ml));
#pragma unroll
    for (int t = 0; t < 4; ++t)
      sum += exp2f(fmaf(v[2 * t], kLog2e, -ml)) + exp2f(fmaf(v[2 * t + 1], kLog2e, -ml));
    l[half] = sum;
    m[half] = mn;
  }
}

// Pass 2 of L.2 on one 32-key group from key j0: P = exp(S - max) (1 / sum)
// in fp32 (m = max log2(e), l = 1 / sum), 0 at keys at or past n (kMasked).
// p[8 u + 4 t + 2 half + c]: 16-key step u, its n8 tile t, row half, column c.
template <bool kMasked>
__device__ __forceinline__ void group_probabilities(const float (&s)[16], int j0, int n, int t2,
                                                    const float (&m)[2], const float (&l)[2],
                                                    float (&p)[16]) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          p[8 * u + 4 * t + 2 * half + cc] =
              !kMasked || j0 + 16 * u + 8 * t + t2 + cc < n
                  ? exp2f(fmaf(s[4 * (2 * u + t) + 2 * half + cc], kLog2e, -m[half])) * l[half]
                  : 0.f;
}

// o for query rows 64 kGroups blockIdx.x.. of (item, head) (blockIdx.z,
// blockIdx.y); whole: long_kv_whole(n).
template <bool whole, int kGroups>
__global__ void __launch_bounds__(l2_threads(whole, kGroups), kGroups == 2 ? 2 : 1)
block_attention_long_wgmma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o, int n,
                                  int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = long_rows(n), chunks = (np + kKeys - 1) / kKeys;
  const int stages = whole ? chunks : kL2Ring;
  unsigned char* kbuf = smem;                                  // [stage][kKChunk]
  unsigned char* vbuf = smem + (size_t)stages * kKChunk;       // [stage][kVChunk]
  // whole: chunk c's k on bar[c], its v on bar[chunks + c]; ring: full, empty.
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(vbuf + (size_t)stages * kVChunk);
  const int tid = threadIdx.x, wg = tid / 128;
  const int h = blockIdx.y;
  const long long b = blockIdx.z, batch = gridDim.z, slot = (long long)np * kDP;
  const bf16* qg = qkv + (b * heads + h) * slot;
  const bf16* kg = qkv + ((batch + b) * heads + h) * slot;
  const bf16* vg = qkv + ((2 * batch + b) * heads + h) * slot;
  const int tile0 = blockIdx.x * kGroups;  // 64-row query tiles of this block
  const int active = min(kGroups, (np - 64 * tile0 + 63) / 64);
  if (tid == 0) {
    if (whole) {
      for (int i = 0; i < 2 * chunks; ++i) mbar_init(&bar[i], 1);
    } else {
      for (int s = 0; s < kL2Ring; ++s) {
        mbar_init(&bar[s], 1);
        mbar_init(&bar[kL2Ring + s], 4 * active);  // one arrival a consumer warp
      }
    }
    mbar_init_fence();
  }
  __syncthreads();
  auto kbytes = [&](int c) { return (unsigned)(min(kKeys, np - c * kKeys) * kDP * 2); };
  auto vbytes = [&](int c) { return (unsigned)(min(kKeys, np - c * kKeys) * kD * 2); };
  if (whole && tid == 0) {  // every copy, in the order the passes read them
    for (int c = 0; c < chunks; ++c) {
      mbar_expect_tx(&bar[c], kbytes(c));
      bulk_load(kbuf + (size_t)c * kKChunk, kg + (long long)c * kKeys * kDP, kbytes(c), &bar[c]);
    }
    for (int c = 0; c < chunks; ++c) {
      mbar_expect_tx(&bar[chunks + c], vbytes(c));
      bulk_load(vbuf + (size_t)c * kVChunk, vg + (long long)c * kKeys * kD, vbytes(c),
                &bar[chunks + c]);
    }
  }
  if (!whole && wg == kGroups) {  // the producer warp: one thread refills the ring
    if (tid == kGroups * 128) {
      {  // items 0..chunks-1: k chunks (pass 1); then k and v chunks (pass 2)
        for (int i = 0; i < 2 * chunks; ++i) {
          const int s = i % kL2Ring, c = i < chunks ? i : i - chunks;
          if (i >= kL2Ring) mbar_wait(&bar[kL2Ring + s], (i / kL2Ring - 1) & 1);
          mbar_expect_tx(&bar[s], kbytes(c) + (i < chunks ? 0 : vbytes(c)));
          bulk_load(kbuf + (size_t)s * kKChunk, kg + (long long)c * kKeys * kDP, kbytes(c),
                    &bar[s]);
          if (i >= chunks)
            bulk_load(vbuf + (size_t)s * kVChunk, vg + (long long)c * kKeys * kD, vbytes(c),
                      &bar[s]);
        }
      }
    }
    return;
  }
  if (wg >= active) return;

  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int r0 = 64 * (tile0 + wg) + 16 * warp;  // this warp's 16 query rows
  // q as mma.sync A fragments: [j / 8][d / 8][j % 8][d % 8], 128 contiguous
  // bytes a fragment register across the warp.
  unsigned qa[kK16][4];
#pragma unroll
  for (int kk = 0; kk < kK16; ++kk) {
    const bf16* q0 = qg + ((long long)(r0 / 8) * (kDP / 8) + 2 * kk) * kCM + g * 8 + t2;
    const bf16* q1 = q0 + (kDP / 8) * kCM;  // rows + 8
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qa[kk][e] = r0 < np ? *reinterpret_cast<const unsigned*>((e % 2 ? q1 : q0) +
                                                                (e / 2) * kCM)
                          : 0u;
  }
  // Item i (pass 1: k chunk i; pass 2: k and v chunk i - chunks): its stage,
  // and the wait for it.
  auto stage_of = [&](int i) {
    return whole ? (i < chunks ? i : i - chunks) : i % kL2Ring;
  };
  auto wait_item = [&](int i) {
    if (!whole) {
      mbar_wait(&bar[i % kL2Ring], (i / kL2Ring) & 1);
    } else if (i < chunks) {
      mbar_wait(&bar[i], 0);
    } else {
      mbar_wait(&bar[i], 0);             // v of chunk i - chunks
      mbar_wait(&bar[i - chunks], 0);    // its k, long since arrived
    }
  };
  auto release = [&](int i) {
    if (whole) return;
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar[kL2Ring + i % kL2Ring]);
  };
  // S (64 rows x the 32 keys of group gi, from item i's stage) = q k^T,
  // issued and committed: n8 tile t holds keys 32 gi + 8 t...
  auto issue_scores = [&](float (&s)[16], int i, int gi) {
    const unsigned ka = smem_addr(kbuf + (size_t)stage_of(i) * kKChunk) + gi % 2 * 64 * kDP;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK16; ++kk)
      wgmma_rs(s, qa[kk], core_desc(ka + 256 * kk, 128, kDP * 16), kk > 0);
    wgmma_commit();
  };
  const int groups = np / kKB;
  // Every wgmma below is issued on every path, the softmax reading only
  // products already waited for: so ptxas keeps them asynchronous.

  // Pass 1: each row's max and sum of exp(S - max), in fp32, 32 keys at a
  // time from key 0, as the short-row instance (group_stats); the next
  // group's S is in the tensor cores meanwhile (the last group's is issued
  // again, unread).
  float m[2], l[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) m[half] = -INFINITY, l[half] = 0.f;
  float s[16], cur[16];
  wait_item(0);
  issue_scores(s, 0, 0);
  wgmma_wait<0>();
  fence_regs(s);
  for (int gi = 0; gi < groups; ++gi) {
#pragma unroll
    for (int e = 0; e < 16; ++e) cur[e] = s[e];
    const int next = min(gi + 1, groups - 1);
    if (next % 2 == 0 && next != gi) wait_item(next / 2);
    issue_scores(s, next / 2, next);
    if (kKB * gi + kKB <= n)
      group_stats<false>(cur, kKB * gi, n, t2, m, l);
    else
      group_stats<true>(cur, kKB * gi, n, t2, m, l);
    wgmma_wait<0>();
    fence_regs(s);
    if (gi % 2 == 1) release(gi / 2);
  }
  if (groups % 2) release(groups / 2);  // a last chunk of one group
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v = l[half];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    l[half] = 1.f / v;
    m[half] *= kLog2e;
  }

  // Pass 2: P in fp32, rounded to bf16; o += P v, 16 keys a wgmma in key
  // order (rows np.. of v are zero, P there too). Group gi's S is issued
  // beside group gi - 1's P v, and its P computed while that runs.
  float oacc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) oacc[i] = 0.f;
  // Group gi's P from its S, in fp32 (p), then as the A operand of its two
  // 16-key steps u (two accumulator n8 tiles each), rounded to bf16.
  float p[16];
  unsigned pa[2][4];
  auto probabilities = [&](int gi) {
    if (kKB * gi + kKB <= n)
      group_probabilities<false>(s, kKB * gi, n, t2, m, l, p);
    else
      group_probabilities<true>(s, kKB * gi, n, t2, m, l, p);
  };
  auto to_operand = [&]() {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[u][e] = pack(p[8 * u + 2 * e], p[8 * u + 2 * e + 1]);
  };
  auto issue_pv = [&](int gi) {
    const unsigned va =
        smem_addr(vbuf + (size_t)stage_of(chunks + gi / 2) * kVChunk) + gi % 2 * 64 * kD;
    fence_regs(oacc);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 2; ++u)
      wgmma_rs(oacc, pa[u], core_desc(va + 2 * u * kD * 16, kD * 16, 128));
    wgmma_commit();
  };
  wait_item(chunks);
  issue_scores(s, chunks, 0);
  wgmma_wait<0>();
  fence_regs(s);
  probabilities(0);
  to_operand();
  for (int gi = 1; gi < groups; ++gi) {
    if (gi % 2 == 0) wait_item(chunks + gi / 2);
    issue_scores(s, chunks + gi / 2, gi);
    issue_pv(gi - 1);
    wgmma_wait<1>();  // this group's S
    fence_regs(s);
    probabilities(gi);
    wgmma_wait<0>();  // the group before's P v: its P registers and its stage are free
    fence_regs(oacc);
    if (gi % 2 == 0) release(chunks + gi / 2 - 1);
    to_operand();
  }
  issue_pv(groups - 1);
  wgmma_wait<0>();
  fence_regs(oacc);
  release(chunks + (groups - 1) / 2);
  bf16* og = o + b * n * (long long)(heads * kD) + h * kD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + half * 8;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)r * heads * kD + j * 8 + t2) =
          __floats2bfloat162_rn(oacc[4 * j + 2 * half], oacc[4 * j + 2 * half + 1]);
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (rows, cols) bf16 row-major matrix read in boxes of (box_rows, 64) with
// the 128-byte swizzle; rows past the end read as zeros.
bool bf16_tensor_map(CUtensorMap* map, const void* ptr, long long rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16_tensor_map through a per-thread cache of the last kMapCache maps,
// keyed by what they encode: a layer's weights are encoded once, not on each
// call, since encoding costs host time the launch waits for.
constexpr int kMapCache = 64;
bool cached_tensor_map(CUtensorMap* map, const void* ptr, long long rows, int cols,
                       int box_rows) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    long long rows;
    int cols, box_rows;
  };
  thread_local Entry cache[kMapCache] = {};
  thread_local int next = 0;
  for (const Entry& e : cache)
    if (e.ptr == ptr && e.rows == rows && e.cols == cols && e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  if (!bf16_tensor_map(map, ptr, rows, cols, box_rows)) return false;
  cache[next] = {*map, ptr, rows, cols, box_rows};
  next = (next + 1) % kMapCache;
  return true;
}

// cudaFuncSetAttribute for a kernel's dynamic shared memory, called only when
// a launch on the current device needs more than the kernel was given there
// before (the call costs host time on every launch otherwise).
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> given;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  size_t& have = given[{kernel, device}];
  if (have >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

// stage -1: L.1, L.2 and A.2; 0, 1, 2: that launch alone (for timing).
int launch_long(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                const void* bproj, void* qkv, void* o, void* out, int b, int n, int heads,
                int hidden, float scale, cudaStream_t stream, int stage) {
  const int np = long_rows(n), m = b * n;
  cudaError_t err;
  if (stage < 0 || stage == 0) {
    CUtensorMap xmap, wmap;
    if (!cached_tensor_map(&xmap, x, m, hidden, kP1Rows) ||
        !cached_tensor_map(&wmap, wqkv, 3LL * heads * kD, hidden, kD))
      return (int)cudaErrorInvalidValue;
    err = allow_smem(reinterpret_cast<const void*>(block_project_wgmma_kernel),
                     project_smem_bytes());
    if (err != cudaSuccess) return (int)err;
    block_project_wgmma_kernel<<<dim3((m + kP1Rows - 1) / kP1Rows, heads), kP1Threads,
                                 project_smem_bytes(), stream>>>(
        xmap, wmap, static_cast<const float*>(bqkv), static_cast<bf16*>(qkv), m, n, heads,
        hidden, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (stage < 0 || stage == 1) {
    const bool whole = long_kv_whole(n);
    const int groups = l2_groups(n);
    const auto kernel = !whole       ? block_attention_long_wgmma_kernel<false, 3>
                        : groups == 2 ? block_attention_long_wgmma_kernel<true, 2>
                                      : block_attention_long_wgmma_kernel<true, 3>;
    err = allow_smem(reinterpret_cast<const void*>(kernel), long_smem_bytes(n));
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(((np + 63) / 64 + groups - 1) / groups, heads, b), l2_threads(whole, groups),
             long_smem_bytes(n), stream>>>(static_cast<const bf16*>(qkv), static_cast<bf16*>(o),
                                           n, heads);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (stage < 0 || stage == 2) {
    out_proj_mma_kernel<<<dim3((m + kOM - 1) / kOM, hidden / kON), kThreads, 0, stream>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(wproj),
        static_cast<const float*>(bproj), static_cast<bf16*>(out), m, heads * kD, hidden);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace tc

// A.1's shared memory. bf16: tc::smem_bytes. fp32: q, k, v, then one area
// used first by the projection's staged chunks and then by a query tile's
// fp32 score rows.
size_t smem_bytes(int n, size_t elem) {
  if (elem == sizeof(__nv_bfloat16)) return tc::smem_bytes(n);
  const size_t proj = ((size_t)kPR * kXS + (size_t)kKC * kPC) * sizeof(float);
  const size_t scores = (size_t)kTQ * (n + 1) * sizeof(float);
  return qkv_bytes(n, elem) + (proj > scores ? proj : scores);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_attention_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                       const float* __restrict__ bqkv, T* __restrict__ o,
                       int n, int heads, int hidden, float scale) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);                          // [n][kS]
  T* ks = qs + (size_t)n * kS;                                 // [n][kS]
  T* vs = ks + (size_t)n * kS;                                 // [n][kS]
  float* xs = reinterpret_cast<float*>(smem + qkv_bytes(n, sizeof(T)));  // [kPR][kXS]
  float* ws = xs + kPR * kXS;                                  // [kKC][kPC]
  float* ss = xs;                                              // [kTQ][n + 1]
  const int sst = n + 1;

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const T* xg = x + b * n * hidden;
  const int rg = tid / 32;  // the warp: its rows
  const int cg = tid % 32;  // the lane: its columns

  // q|k|v (n x 3 Dh) = x (n x hidden) [Wq_h | Wk_h | Wv_h], 48 rows at a
  // time; this thread's columns cg + 32 j, j < kPJ, inside 3 Dh.
  for (int r0 = 0; r0 < n; r0 += kPR) {
    float acc[6][kPJ];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < kPJ; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < hidden; k0 += kKC) {
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < kPR * (kKC / 2); i += kThreads) {
        const int r = i / (kKC / 2), c = (i % (kKC / 2)) * 2;
        float2 v = make_float2(0.f, 0.f);
        if (r0 + r < n)
          v = to_float2(*reinterpret_cast<const T2*>(xg + (long long)(r0 + r) * hidden + k0 + c));
        xs[r * kXS + c] = v.x;
        xs[r * kXS + c + 1] = v.y;
      }
      for (int i = tid; i < kKC * (kPC / 2); i += kThreads) {
        const int kk = i / (kPC / 2), c = (i % (kPC / 2)) * 2;
        const int which = c / kD, cc = c % kD;  // 0 q, 1 k, 2 v
        const T* wg = wqkv + ((long long)(which * heads + h) * hidden + k0 + kk) * kD + cc;
        const float2 v = to_float2(*reinterpret_cast<const T2*>(wg));
        ws[kk * kPC + c] = v.x;
        ws[kk * kPC + c + 1] = v.y;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKC; ++kk) {
        float xv[6], wv[kPJ];
#pragma unroll
        for (int i = 0; i < 6; ++i) xv[i] = xs[(rg * 6 + i) * kXS + kk];
#pragma unroll
        for (int j = 0; j < kPJ; ++j)
          wv[j] = owns_col(cg, j) ? ws[kk * kPC + cg + 32 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = 0; j < kPJ; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
    // The fp32 bias, then T; q scaled in T.
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int r = r0 + rg * 6 + i;
      if (r < n) {
#pragma unroll
        for (int j = 0; j < kPJ; ++j) {
          if (!owns_col(cg, j)) continue;
          const int which = (cg + 32 * j) / kD, cc = (cg + 32 * j) % kD;
          float y = round_as(acc[i][j] + bqkv[(which * heads + h) * kD + cc], x);
          if (which == 0) y = round_as(y * scale, x);
          store_one((which == 0 ? qs : which == 1 ? ks : vs) + r * kS + cc, y);
        }
      }
    }
  }
  __syncthreads();

  T* og = o + b * n * (long long)(heads * kD) + h * kD;
  for (int q0 = 0; q0 < n; q0 += kTQ) {
    // S = q k^T in fp32, one chunk of 64 key columns at a time.
    int qr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qr[i] = min(q0 + rg * 4 + i, n - 1);
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      float acc[4][kCT];
      int kj[kCT];
#pragma unroll
      for (int c = 0; c < kCT; ++c) {
        kj[c] = min(c0 + cg + 32 * c, n - 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = 0.f;
      }
#pragma unroll 4
      for (int d = 0; d < kD; d += 2) {
        float2 kv[kCT];
#pragma unroll
        for (int c = 0; c < kCT; ++c)
          kv[c] = to_float2(*reinterpret_cast<const T2*>(ks + kj[c] * kS + d));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 qv = to_float2(*reinterpret_cast<const T2*>(qs + qr[i] * kS + d));
#pragma unroll
          for (int c = 0; c < kCT; ++c) {
            acc[i][c] = fmaf(qv.x, kv[c].x, acc[i][c]);
            acc[i][c] = fmaf(qv.y, kv[c].y, acc[i][c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCT; ++c) {
        const int j = c0 + cg + 32 * c;
        if (j < n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) ss[(rg * 4 + i) * sst + j] = acc[i][c];
        }
      }
    }
    __syncthreads();

    // Softmax over whole rows in fp32; P rounded to T. Warp w owns its
    // thread group's four rows.
    for (int r = rg * 4; r < rg * 4 + 4; ++r) {
      float* row = ss + r * sst;
      float m = -INFINITY;
      for (int j = cg; j < n; j += 32) m = fmaxf(m, row[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = cg; j < n; j += 32) {
        const float e = expf(row[j] - m);
        row[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = cg; j < n; j += 32) row[j] = round_as(row[j] / sum, x);
    }
    __syncwarp();

    // o = P v in fp32: this thread's four rows, the column pairs
    // 2 (cg + 32 p), p < kOP, inside Dh (Dh 64: columns 2 cg, 2 cg + 1).
    // A warp reads only the score rows it normalised.
    float oacc[4][2 * kOP];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 2 * kOP; ++c) oacc[i][c] = 0.f;
    for (int j = 0; j < n; ++j) {
      float2 vv[kOP];
#pragma unroll
      for (int p = 0; p < kOP; ++p)
        vv[p] = owns_o_pair(cg, p)
                    ? to_float2(*reinterpret_cast<const T2*>(vs + j * kS + 2 * (cg + 32 * p)))
                    : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ss[(rg * 4 + i) * sst + j];
#pragma unroll
        for (int c = 0; c < kOP; ++c) {
          oacc[i][2 * c] = fmaf(p, vv[c].x, oacc[i][2 * c]);
          oacc[i][2 * c + 1] = fmaf(p, vv[c].y, oacc[i][2 * c + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + rg * 4 + i;
      if (r < n) {
#pragma unroll
        for (int p = 0; p < kOP; ++p)
          if (owns_o_pair(cg, p))
            store_pair(og + (long long)r * heads * kD + 2 * (cg + 32 * p), oacc[i][2 * p],
                       oacc[i][2 * p + 1]);
      }
    }
    __syncthreads();  // the next tile overwrites the score rows
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
out_proj_kernel(const T* __restrict__ o, const T* __restrict__ wproj,
                const float* __restrict__ bproj, T* __restrict__ out, int m,
                int inner, int hidden) {
  using T2 = typename Pair<T>::type;
  __shared__ float os[kOM][kOK + 1];
  __shared__ float ws[kOK][kON];
  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;
  const long long m0 = (long long)blockIdx.x * kOM;
  const int n0 = blockIdx.y * kON;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // Inner index k = h * Dh + e runs through the heads in order.
  for (int k0 = 0; k0 < inner; k0 += kOK) {
    __syncthreads();
    for (int i = tid; i < kOM * (kOK / 2); i += kThreads) {
      const int r = i / (kOK / 2), c = (i % (kOK / 2)) * 2;
      float2 v = make_float2(0.f, 0.f);
      if (m0 + r < m)
        v = to_float2(*reinterpret_cast<const T2*>(o + (m0 + r) * inner + k0 + c));
      os[r][c] = v.x;
      os[r][c + 1] = v.y;
    }
    for (int i = tid; i < kOK * (kON / 2); i += kThreads) {
      const int kk = i / (kON / 2), c = (i % (kON / 2)) * 2;
      const float2 v = to_float2(
          *reinterpret_cast<const T2*>(wproj + (long long)(k0 + kk) * hidden + n0 + c));
      ws[kk][c] = v.x;
      ws[kk][c + 1] = v.y;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kOK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = os[rg * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = ws[kk][cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = m0 + rg * 4 + i;
    if (r < m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + cg + 16 * j;
        store_one(out + r * hidden + c, acc[i][j] + bproj[c]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
           const void* bproj, void* o, void* out, int b, int n, int heads,
           int hidden, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  block_attention_kernel<T><<<dim3(heads, b), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<T*>(o), n, heads, hidden, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int m = b * n;
  out_proj_kernel<T><<<dim3((m + kOM - 1) / kOM, hidden / kON), kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(wproj),
      static_cast<const float*>(bproj), static_cast<T*>(out), m, heads * kD, hidden);
  return (int)cudaGetLastError();
}


// The long-row instance in fp32: the projection of one 48-row tile (the
// same code and K-chunk order as block_attention_kernel's) into a (3, B,
// H, np, Dh) scratch, then one block per 32-row query tile: the tile's q
// and 64-row chunks of k, then of v, staged in shared memory in turn, S
// into the tile's whole fp32 score rows, the softmax and P v as
// block_attention_kernel computes them, element for element.
size_t long_smem_bytes(int n, size_t elem) {
  if (elem == sizeof(__nv_bfloat16))
    return tc::long_smem_bytes(n) > tc::project_smem_bytes() ? tc::long_smem_bytes(n)
                                                             : tc::project_smem_bytes();
  return (size_t)(kTQ + kChunk) * kS * sizeof(float) + (size_t)kTQ * (n + 1) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_project_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                     const float* __restrict__ bqkv, T* __restrict__ qkv, int n, int heads,
                     int hidden, float scale) {
  using T2 = typename Pair<T>::type;
  __shared__ float xs[kPR * kXS];
  __shared__ float ws[kKC * kPC];
  const int np = (n + 15) / 16 * 16;
  const int tid = threadIdx.x, rg = tid / 32, cg = tid % 32;
  const int r0 = blockIdx.x * kPR, h = blockIdx.y;
  const long long b = blockIdx.z, batch = gridDim.z;
  const T* xg = x + b * n * hidden;
  float acc[6][kPJ];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < kPJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < hidden; k0 += kKC) {
    __syncthreads();
    for (int i = tid; i < kPR * (kKC / 2); i += kThreads) {
      const int r = i / (kKC / 2), c = (i % (kKC / 2)) * 2;
      float2 v = make_float2(0.f, 0.f);
      if (r0 + r < n)
        v = to_float2(*reinterpret_cast<const T2*>(xg + (long long)(r0 + r) * hidden + k0 + c));
      xs[r * kXS + c] = v.x;
      xs[r * kXS + c + 1] = v.y;
    }
    for (int i = tid; i < kKC * (kPC / 2); i += kThreads) {
      const int kk = i / (kPC / 2), c = (i % (kPC / 2)) * 2;
      const int which = c / kD, cc = c % kD;
      const T* wg = wqkv + ((long long)(which * heads + h) * hidden + k0 + kk) * kD + cc;
      const float2 v = to_float2(*reinterpret_cast<const T2*>(wg));
      ws[kk * kPC + c] = v.x;
      ws[kk * kPC + c + 1] = v.y;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      float xv[6], wv[kPJ];
#pragma unroll
      for (int i = 0; i < 6; ++i) xv[i] = xs[(rg * 6 + i) * kXS + kk];
#pragma unroll
      for (int j = 0; j < kPJ; ++j) wv[j] = owns_col(cg, j) ? ws[kk * kPC + cg + 32 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < kPJ; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int r = r0 + rg * 6 + i;
    if (r < n) {
#pragma unroll
      for (int j = 0; j < kPJ; ++j) {
        if (!owns_col(cg, j)) continue;
        const int which = (cg + 32 * j) / kD, cc = (cg + 32 * j) % kD;
        float y = round_as(acc[i][j] + bqkv[(which * heads + h) * kD + cc], x);
        if (which == 0) y = round_as(y * scale, x);
        store_one(qkv + ((which * batch + b) * heads + h) * (long long)np * kD +
                      (long long)r * kD + cc,
                  y);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_attention_long_kernel(const T* __restrict__ qkv, T* __restrict__ o, int n, int heads) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qt = reinterpret_cast<T*>(smem);  // [kTQ][kS]: rows q0.. (clamped to n - 1)
  T* cs = qt + kTQ * kS;               // [kChunk][kS]: k, then v rows c0..
  float* ss = reinterpret_cast<float*>(cs + kChunk * kS);  // [kTQ][n + 1]
  const int sst = n + 1;
  const int np = (n + 15) / 16 * 16;
  const int tid = threadIdx.x, rg = tid / 32, cg = tid % 32;
  const int q0 = blockIdx.x * kTQ, h = blockIdx.y;
  const long long b = blockIdx.z, batch = gridDim.z, head = (long long)np * kD;
  const T* qg = qkv + (b * heads + h) * head;
  const T* kg = qkv + ((batch + b) * heads + h) * head;
  const T* vg = qkv + ((2 * batch + b) * heads + h) * head;
  for (int i = tid; i < kTQ * (kD / 2); i += kThreads) {
    const int r = i / (kD / 2), c = (i % (kD / 2)) * 2;
    *reinterpret_cast<T2*>(qt + r * kS + c) =
        *reinterpret_cast<const T2*>(qg + (long long)min(q0 + r, n - 1) * kD + c);
  }
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    __syncthreads();  // the chunk before is consumed
    for (int i = tid; i < kChunk * (kD / 2); i += kThreads) {
      const int r = i / (kD / 2), c = (i % (kD / 2)) * 2;
      *reinterpret_cast<T2*>(cs + r * kS + c) =
          *reinterpret_cast<const T2*>(kg + (long long)min(c0 + r, n - 1) * kD + c);
    }
    __syncthreads();
    float acc[4][kCT];
#pragma unroll
    for (int c = 0; c < kCT; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 2) {
      float2 kv[kCT];
#pragma unroll
      for (int c = 0; c < kCT; ++c)
        kv[c] = to_float2(*reinterpret_cast<const T2*>(cs + (cg + 32 * c) * kS + d));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 qv = to_float2(*reinterpret_cast<const T2*>(qt + (rg * 4 + i) * kS + d));
#pragma unroll
        for (int c = 0; c < kCT; ++c) {
          acc[i][c] = fmaf(qv.x, kv[c].x, acc[i][c]);
          acc[i][c] = fmaf(qv.y, kv[c].y, acc[i][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCT; ++c) {
      const int j = c0 + cg + 32 * c;
      if (j < n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ss[(rg * 4 + i) * sst + j] = acc[i][c];
      }
    }
  }
  __syncthreads();
  for (int r = rg * 4; r < rg * 4 + 4; ++r) {
    float* row = ss + r * sst;
    float m = -INFINITY;
    for (int j = cg; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = cg; j < n; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = cg; j < n; j += 32) row[j] = round_as(row[j] / sum, qkv);
  }
  float oacc[4][2 * kOP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 2 * kOP; ++c) oacc[i][c] = 0.f;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    __syncthreads();  // the softmax, or the chunk before, is done
    const int rows = min(kChunk, n - c0);
    for (int i = tid; i < rows * (kD / 2); i += kThreads) {
      const int r = i / (kD / 2), c = (i % (kD / 2)) * 2;
      *reinterpret_cast<T2*>(cs + r * kS + c) =
          *reinterpret_cast<const T2*>(vg + (long long)(c0 + r) * kD + c);
    }
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      float2 vv[kOP];
#pragma unroll
      for (int p = 0; p < kOP; ++p)
        vv[p] = owns_o_pair(cg, p)
                    ? to_float2(*reinterpret_cast<const T2*>(cs + j * kS + 2 * (cg + 32 * p)))
                    : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ss[(rg * 4 + i) * sst + c0 + j];
#pragma unroll
        for (int c = 0; c < kOP; ++c) {
          oacc[i][2 * c] = fmaf(p, vv[c].x, oacc[i][2 * c]);
          oacc[i][2 * c + 1] = fmaf(p, vv[c].y, oacc[i][2 * c + 1]);
        }
      }
    }
  }
  T* og = o + b * n * (long long)(heads * kD) + h * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r < n) {
#pragma unroll
      for (int p = 0; p < kOP; ++p)
        if (owns_o_pair(cg, p))
          store_pair(og + (long long)r * heads * kD + 2 * (cg + 32 * p), oacc[i][2 * p],
                     oacc[i][2 * p + 1]);
    }
  }
}

template <typename T>
int launch_long(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                const void* bproj, void* qkv, void* o, void* out, int b, int n, int heads,
                int hidden, float scale, cudaStream_t stream) {
  const int np = (n + 15) / 16 * 16;
  block_project_kernel<T><<<dim3((np + kPR - 1) / kPR, heads, b), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<T*>(qkv), n, heads, hidden, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = long_smem_bytes(n, sizeof(T));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(block_attention_long_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  block_attention_long_kernel<T><<<dim3((n + kTQ - 1) / kTQ, heads, b), kThreads, smem,
                                   stream>>>(static_cast<const T*>(qkv), static_cast<T*>(o), n,
                                             heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int m = b * n;
  out_proj_kernel<T><<<dim3((m + kOM - 1) / kOM, hidden / kON), kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(wproj),
      static_cast<const float*>(bproj), static_cast<T*>(out), m, heads * kD, hidden);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The head dim this library was built for (HEAD_DIM).
int k3_attention_block_head_dim() { return kD; }

// A.1's shared memory per block for sequence length n and element size.
size_t k3_attention_block_smem_bytes(int n, int elem_bytes) {
  return smem_bytes(n, (size_t)elem_bytes);
}

// Largest dynamic shared memory a block may opt into on `device`, or -1.
int k3_attention_block_max_smem(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// x (b, n, hidden); bqkv (3 heads, kD) fp32; bproj (hidden) fp32; o (b, n,
// heads kD) scratch; out (b, n, hidden); all contiguous. scale is q's
// factor s_q, Dh^-1/2 rounded to the input type. The weights: fp32,
// wqkv (3 heads, hidden, kD) and wproj (heads kD, hidden), contiguous;
// bf16, the Linear weights as they lie, wqkv (3 heads kD, hidden) and
// wproj (hidden, heads kD) rows, with x and both 16-byte aligned. hidden is
// a multiple of 64. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launches (0 on success).
int k3_attention_block(int dtype, const void* x, const void* wqkv,
                       const void* bqkv, const void* wproj, const void* bproj,
                       void* o, void* out, int b, int n, int heads, int hidden,
                       float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, wqkv, bqkv, wproj, bproj, o, out, b, n, heads,
                         hidden, scale, s);
  if (dtype == 1)
    return tc::launch(x, wqkv, bqkv, wproj, bproj, o, out, b, n, heads, hidden,
                      scale, s);
  return (int)cudaErrorInvalidValue;
}

// The long-row instance: the most shared memory one of its blocks takes at
// sequence length n and element size (fp32: the attention launch's, growing
// with n; bf16: the larger of L.1's ring and L.2's k and v, whole or in a
// ring).
size_t k3_attention_block_long_smem_bytes(int n, int elem_bytes) {
  return long_smem_bytes(n, (size_t)elem_bytes);
}

// Whether the bf16 L.2 takes one head's k and v whole at n (else a ring).
int k3_attention_block_long_kv_whole(int n) { return tc::long_kv_whole(n) ? 1 : 0; }

// Elements of the long-row instance's scratch: 3 b heads np kD in fp32
// (np: n rounded up to 16), 3 b heads np kDP in bf16 (np: n rounded up to
// 32; kDP: Dh, or 80 at Dh 72).
size_t k3_attention_block_long_scratch_elems(int b, int n, int heads, int elem_bytes) {
  if (elem_bytes == (int)sizeof(__nv_bfloat16)) return tc::long_scratch_elems(b, n, heads);
  return 3 * (size_t)b * heads * ((n + 15) / 16 * 16) * kD;
}

// K3 at any n: as k3_attention_block, with qkv a scratch of
// k3_attention_block_long_scratch_elems elements of the input type, 16-byte
// aligned, that it overwrites.
int k3_attention_block_long(int dtype, const void* x, const void* wqkv, const void* bqkv,
                            const void* wproj, const void* bproj, void* qkv, void* o,
                            void* out, int b, int n, int heads, int hidden, float scale,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_long<float>(x, wqkv, bqkv, wproj, bproj, qkv, o, out, b, n, heads, hidden,
                              scale, s);
  if (dtype == 1)
    return tc::launch_long(x, wqkv, bqkv, wproj, bproj, qkv, o, out, b, n, heads, hidden,
                           scale, s, -1);
  return (int)cudaErrorInvalidValue;
}

// One launch of the bf16 long-row instance, to time it alone: stage 0 L.1
// (x to the scratch), 1 L.2 (the scratch to o), 2 A.2 (o to out). Arguments
// as k3_attention_block_long's (dtype 1 only).
int k3_attention_block_long_stage(int stage, int dtype, const void* x, const void* wqkv,
                                  const void* bqkv, const void* wproj, const void* bproj,
                                  void* qkv, void* o, void* out, int b, int n, int heads,
                                  int hidden, float scale, void* stream) {
  if (dtype != 1 || stage < 0 || stage > 2) return (int)cudaErrorInvalidValue;
  return tc::launch_long(x, wqkv, bqkv, wproj, bproj, qkv, o, out, b, n, heads, hidden, scale,
                         static_cast<cudaStream_t>(stream), stage);
}

}  // extern "C"
