// K4: flash (KV-streaming) multi-head attention forward, written for Hopper
// (sm_90a).
//
// Replaces jpdvt_mt_ntnu_tpu/ops/flash_attention.py:_fwd_kernel, the Pallas
// kernel behind _flash_fwd and fused_qkv_flash_attention. Same arithmetic:
// q * s_q rounded to the input type, s_q being Dh^-1/2 rounded to the input
// type first, as JAX rounds its weakly typed Python float (the wrapper
// passes s_q as `scale`; bf16 q times a bf16 s_q is exact in fp32, so the
// one rounding is JAX's); per key tile S = Q K^T in fp32,
// padded key columns at -inf; the online softmax m' = max(m, rowmax S),
// alpha = exp(m - m'), E = exp(S - m'), l' = l alpha + rowsum E (fp32 E),
// acc' = acc alpha + round(E) V with E rounded to the V type and the
// product accumulated in fp32; at the end O = acc / l in the input type and
// LSE = m + log l in fp32 (the backward's only residual besides O). The key
// tile is 64 (kBK, BLOCK_K in flash_attention.py): E is rounded against
// the running max of the tiles seen so far, so the plain version takes the
// same tile, and the two differ only in the order of their fp32 sums.
//
// Bound on an H100 SXM at the grid-20 train step, B = 96, H = 12, N = 400,
// Dh = 64, bf16: q, k, v read once, O written once and the LSE written
// once is 4 * 59.0 MB + 1.8 MB = 237.8 MB, 71 us at 3.35 TB/s; the two
// products are 4 * B * H * N^2 * Dh = 47.2 GFLOP, 48 us at 989 TFLOP/s
// bf16. So the bound is the memory traffic. The train step launches this
// kernel once per DiT block: 12 launches per step.
//
// bf16 (the train step's type) runs on the tensor cores (namespace tc):
// mma.sync m16n8k16, bf16 in, fp32 accumulators. One block per (batch,
// head, 64 queries), 4 warps each owning 16 query rows; a warp whose rows
// all lie past N stages K and V with the others but skips the math. Each
// warp loads its q * scale, rounded to bf16, once into mma A fragments. K and V stream through a two-stage
// cp.async ring of 64-key chunks, rows of 64 + 8 elements (144 B, so the
// eight rows of an 8 x 8 ldmatrix fall on distinct banks): 36,864 B at
// every N, so no sequence length is refused. Per chunk, all in registers
// (no shared-memory score tile, one barrier pair per chunk): S = q K^T (B
// by ldmatrix), keys past N at -inf; the row max over the quad by two
// shuffles; m' and alpha; E = exp(S - m') in fp32, summed unrounded into
// the thread's share of l; acc *= alpha; acc += round(E) V, two
// accumulator n-tiles of E repacked as one 16 x 16 A operand and V as B
// by ldmatrix.trans. At the end l is summed over the quad, O = acc / l is
// stored as bf16 straight into the strided output, and the LSE as fp32.
// exp is exp2 of one FFMA on the special-function unit (2 ulp): E moves by
// a few fp32 ulp before its bf16 rounding, and l by as little. Rows past N
// are zero in the ring (0 times a stale NaN would not be 0); rows whose
// source is not 16-byte aligned (pair-aligned views the wrapper admits)
// are staged by 4-byte loads instead of cp.async. Each output element has
// one owning accumulator and the chunks run in a fixed order (no atomics,
// no split of a row over blocks): two calls are bit-equal.
//
// What the earlier scalar design (kept below for fp32) left, and what this
// one does about it: every product was a scalar fp32 FMA from shared
// memory (now mma.sync); the query tile sat in shared memory as fp32 (now
// bf16 A fragments in registers); the scores made a round trip through an
// fp32 shared-memory tile between four barriers a tile (now registers, two
// barriers); K and V were loaded synchronously by 4-byte pairs (now the
// cp.async ring, the next chunk in flight while this one is used). Not
// done: wgmma (each warp loads its own B operands by ldmatrix; a
// warpgroup would share them), TMA, a persistent grid.
//
// fp32 (the tests' type and the fp32 N = 400 solve's; mma.sync takes fp32
// only as TF32, which would change its numbers) keeps the scalar design:
// one block per (batch, head, tile of 64 query rows), looping over tiles
// of 64 key rows, m and l in shared memory, the 64 x 64 fp32 accumulator
// in registers (4 x 4 per thread). Shared memory holds the fp32 query
// tile, one K and one V tile and the tile's fp32 scores: 68 KB whatever N
// is. The ragged last key tile is zero-filled and its columns set to -inf;
// the ragged last query tile computes zero rows that are never stored.
// Padded shared-memory rows (Dh + 2, 64 + 1) keep column reads free of
// bank conflicts; the products are scalar fp32 FMAs.
//
// Both designs take element strides, so they read q/k/v straight out of
// the fused (B, N, 3*H*Dh) projection and write O as (B, N, H*Dh); the LSE
// is a contiguous (B, H, N) fp32 tensor.
//
// The head dim is a compile-time constant, HEAD_DIM (64 by default; the
// build compiles this file again with -DHEAD_DIM=72 for DiT-XL, a library
// of its own), laid out as in attention.cu (K1): at Dh 72, S = q K^T takes
// five k16 steps, the fifth over dims 64-79 with dims 72-79 zero in the q
// fragments and in K's shared-memory rows; round(E) V nine n8 tiles over
// Dh, the ninth alone by ldmatrix.x2.trans; rows of 88 elements (176 B, an
// odd count of 16-byte units), 45,056 B of shared memory a block; the fp32
// kernel's threads own three column pairs of O (two at 64), the third only
// inside Dh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifndef HEAD_DIM
#define HEAD_DIM 64
#endif

namespace {

constexpr int kD = HEAD_DIM;   // head dim (64 or 72); the Python wrapper checks it
static_assert(kD % 8 == 0, "rows are staged in 16-byte pieces");
constexpr int kBK = 64;        // key rows per tile (BLOCK_K in flash_attention.py)
// The scalar fp32 kernel.
constexpr int kBQ = 64;        // query rows per block
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kS = kD + 2;     // smem row stride of q, K, V (elements)
constexpr int kPS = kBK + 1;   // smem row stride of the score tile (floats)
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

__device__ __forceinline__ float2 zero_pair(const float*) {
  return make_float2(0.f, 0.f);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(size_t elem) {
  return 2 * (size_t)kBK * kS * elem          // K, V tile
         + (size_t)kBQ * kS * sizeof(float)   // scaled query tile
         + (size_t)kBQ * kPS * sizeof(float)  // scores, then round(E)
         + 3 * (size_t)kBQ * sizeof(float);   // m, l, alpha per row
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse,
                 long long in_sb, long long in_sh, long long in_sn,
                 long long out_sb, long long out_sh, long long out_sn,
                 int h, int n, float scale) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                         // [kBK][kS]
  T* vs = ks + kBK * kS;                                      // [kBK][kS]
  float* qs = reinterpret_cast<float*>(vs + kBK * kS);        // [kBQ][kS]
  float* ps = qs + kBQ * kS;                                  // [kBQ][kPS]
  float* m_s = ps + kBQ * kPS;                                // [kBQ]
  float* l_s = m_s + kBQ;                                     // [kBQ]
  float* a_s = l_s + kBQ;                                     // [kBQ]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const long long in_base = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const T* qg = q + in_base;
  const T* kg = k + in_base;
  const T* vg = v + in_base;

  // The scaled query tile, rounded to T as the TPU kernel's q * scale.
  for (int i = tid; i < kBQ * (kD / 2); i += kThreads) {
    const int r = i / (kD / 2), c = (i % (kD / 2)) * 2;
    float2 x = make_float2(0.f, 0.f);
    if (q0 + r < n)
      x = to_float2(*reinterpret_cast<const T2*>(qg + (q0 + r) * in_sn + c));
    qs[r * kS + c] = round_as(x.x * scale, q);
    qs[r * kS + c + 1] = round_as(x.y * scale, q);
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int rg = tid / 16;  // this thread's rows: rg * 4 .. rg * 4 + 3
  const int cg = tid % 16;  // this thread's column group
  const int warp = tid / 32, lane = tid % 32;
  // acc[i][2p, 2p + 1]: row rg*4+i, head-dim columns 2 (cg + 16 p) and the
  // next, p < kCP, inside Dh (Dh 64: 2cg, 2cg+1, 2cg+32, 2cg+33).
  float acc[4][2 * kCP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 2 * kCP; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done with K, V, P
    for (int i = tid; i < kBK * (kD / 2); i += kThreads) {
      const int j = i / (kD / 2), c = (i % (kD / 2)) * 2;
      T2 kx = zero_pair(k), vx = zero_pair(v);
      if (k0 + j < n) {
        kx = *reinterpret_cast<const T2*>(kg + (k0 + j) * in_sn + c);
        vx = *reinterpret_cast<const T2*>(vg + (k0 + j) * in_sn + c);
      }
      *reinterpret_cast<T2*>(ks + j * kS + c) = kx;
      *reinterpret_cast<T2*>(vs + j * kS + c) = vx;
    }
    __syncthreads();

    // S = (q * scale) K^T for rows rg*4.. and key columns cg + 16c.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 2) {
      float2 kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = to_float2(*reinterpret_cast<const T2*>(ks + (cg + 16 * c) * kS + d));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 qv = *reinterpret_cast<const float2*>(qs + (rg * 4 + i) * kS + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv.x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv.y, kv[c].y, s[i][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool valid = k0 + cg + 16 * c < n;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ps[(rg * 4 + i) * kPS + cg + 16 * c] = valid ? s[i][c] : -INFINITY;
    }
    __syncthreads();

    // The online softmax, one warp per 8 rows; E rounded to the V type.
    for (int r = warp * (kBQ / 8); r < (warp + 1) * (kBQ / 8); ++r) {
      float* row = ps + r * kPS;
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float e0 = expf(x0 - m_new), e1 = expf(x1 - m_new);
      const float sum = warp_sum(e0 + e1);
      row[lane] = round_as(e0, v);
      row[lane + 32] = round_as(e1, v);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + round(E) V.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[rg * 4 + i];
#pragma unroll
      for (int c = 0; c < 2 * kCP; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float2 vv[kCP];
#pragma unroll
      for (int p = 0; p < kCP; ++p)
        vv[p] = owns_pair(cg, p)
                    ? to_float2(*reinterpret_cast<const T2*>(vs + j * kS + 2 * (cg + 16 * p)))
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
  __syncthreads();

  T* og = o + blockIdx.z * out_sb + blockIdx.y * out_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r < n) {
      const float l = l_s[rg * 4 + i];
#pragma unroll
      for (int p = 0; p < kCP; ++p)
        if (owns_pair(cg, p))
          store_pair(og + r * out_sn + 2 * (cg + 16 * p), acc[i][2 * p] / l,
                     acc[i][2 * p + 1] / l);
    }
  }
  float* lg = lse + ((long long)blockIdx.z * h + blockIdx.y) * n;
  for (int r = tid; r < kBQ; r += kThreads)
    if (q0 + r < n) lg[q0 + r] = m_s[r] + logf(l_s[r]);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           long long in_sb, long long in_sh, long long in_sn,
           long long out_sb, long long out_sh, long long out_sn,
           int b, int h, int n, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + kBQ - 1) / kBQ, h, b);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, in_sb, in_sh, in_sn, out_sb, out_sh, out_sn, h, n,
      scale);
  return (int)cudaGetLastError();
}

// The bf16 design on the tensor cores (see the head of this file).
namespace tc {

using bf16 = __nv_bfloat16;
// smem row stride of K and V (elements), an odd count of 16-byte units:
// 144 B at Dh 64, 176 B at 72.
constexpr int kRow = kD / 8 % 2 == 0 ? kD + 8 : kD + 16;
constexpr int kStage = kBK * kRow;    // elements of one chunk of K or V
constexpr int kC8 = kD / 8;           // 16-byte pieces of a row
// k16 steps over Dh (S = q K^T); the last one's dims past kD are zero.
constexpr int kK16 = (kD + 15) / 16;
static_assert(kK16 * 16 - kD <= 8 && kK16 * 16 <= kRow, "one zero piece a row pads Dh");
// K and V, two stages each: 36,864 B at every N (Dh 64), 45,056 B (Dh 72).
constexpr size_t kSmemBytes = 4 * (size_t)kStage * sizeof(bf16);
static_assert(kSmemBytes <= 48 * 1024, "launched without opting into more shared memory");
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;             // 16 query rows each
constexpr int kBlock = 32 * kWarps;
// Four blocks an SM cap registers at 128 a thread (12 B of spill); by
// measurement on an H100 (PERF.md §6) 3 blocks without spill, 5- or 8-warp
// blocks and a three-stage ring were 3-13% slower.
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
// (E is 0 there, and 0 times a stale NaN would not be).
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
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse,
                     long long in_sb, long long in_sh, long long in_sn,
                     long long out_sb, long long out_sh, long long out_sn,
                     int h, int n, float scale, int aligned) {
  // A thread's pieces of one chunk of K (or V). With 4 warps they split
  // evenly; the bound check lets tools/kernel_variants.py time other
  // block sizes (5 warps: 80 rows) by changing kWarps alone.
  constexpr int kPieces = (kBK * kC8 + kBlock - 1) / kBlock;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][kBK][kRow]
  bf16* vs = ks + 2 * kStage;                // [2][kBK][kRow]

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
    // never write them; the barrier of the first chunk orders these stores).
    for (int i = tid; i < 2 * kBK; i += kBlock)
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

  // Chunk c of K and V into stage c % 2 of the ring.
  const int nc = (n + kBK - 1) / kBK;
  auto issue = [&](int c) {
    const int st = c % 2;
#pragma unroll
    for (int u = 0; u < kPieces; ++u) {
      const int i = tid + u * kBlock;
      if (kBK * kC8 % kBlock != 0 && i >= kBK * kC8) break;
      const int r = i / kC8, col = i % kC8 * 8, key = c * kBK + r;
      const long long off = (long long)min(key, n - 1) * in_sn + col;
      stage_piece(ks + st * kStage + r * kRow + col, kg + off, key < n, aligned);
      stage_piece(vs + st * kStage + r * kRow + col, vg + off, key < n, aligned);
    }
    cp_async_commit();
  };

  // m: the row's running max; l: this thread's share of the row's running
  // sum of exp(S - m) (its two column pairs of each n-tile).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float oacc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;

  issue(0);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      issue(c + 1);  // into the stage the previous chunk read
    } else {
      cp_async_commit();  // an empty group, so one wait fits every chunk
    }
    cp_async_wait_one();
    __syncthreads();
    if (active) {
      const int j0 = c * kBK;
      // 16-key groups at or past `groups` hold only keys past n: skipped.
      const int groups = min(kBK / 16, (n - j0 + 15) / 16);
      const bf16* kst = ks + c % 2 * kStage;
      const bf16* vst = vs + c % 2 * kStage;
      // S (16 rows x 64 keys) = q K^T, n-tile t holding keys j0 + 8 t..
      float s[kBK / 8][4];
#pragma unroll
      for (int t = 0; t < kBK / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK16; ++kk)
#pragma unroll
        for (int u = 0; u < kBK / 16; ++u)
          if (u < groups) {
            unsigned kb[4];
            load_b<kRow>(kb, kst, 16 * u, kk * 16, lane);
            mma(s[2 * u], qa[kk], kb[0], kb[1]);
            mma(s[2 * u + 1], qa[kk], kb[2], kb[3]);
          }
      // The online softmax of rows g (half 0) and g + 8 (half 1); S becomes
      // E = exp(S - m') in place, 0 at keys past n.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float bm = -INFINITY;
#pragma unroll
        for (int t = 0; t < kBK / 8; ++t)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float& x = s[t][2 * half + cc];
            if (j0 + kBK > n && j0 + t * 8 + t2 + cc >= n) x = -INFINITY;
            bm = fmaxf(bm, x);
          }
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
        const float mn = fmaxf(m[half], bm), ml = mn * kLog2e;
        const float alpha = exp2f(fmaf(m[half], kLog2e, -ml));  // 0 on the first chunk
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < kBK / 8; ++t)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float& x = s[t][2 * half + cc];
            x = exp2f(fmaf(x, kLog2e, -ml));
            sum += x;
          }
        l[half] = l[half] * alpha + sum;
        m[half] = mn;
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          oacc[j][2 * half] *= alpha;
          oacc[j][2 * half + 1] *= alpha;
        }
      }
      // acc += round(E) V.
#pragma unroll
      for (int u = 0; u < kBK / 16; ++u) {
        if (u >= groups) break;
        unsigned pa[4];  // two accumulator n-tiles are one A operand (16 x 16 keys)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            pa[2 * t + half] = pack(s[2 * u + t][2 * half], s[2 * u + t][2 * half + 1]);
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
    __syncthreads();  // the next chunk's copies overwrite this stage
  }

  // l over the quad; O = acc / l into the strided output, the LSE per row.
  bf16* og = o + blockIdx.z * out_sb + blockIdx.y * out_sh;
  float* lg = lse + ((long long)blockIdx.z * h + blockIdx.y) * n;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float x = l[half];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    const int r = q0 + g + half * 8;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + r * out_sn + j * 8 + t2) =
          __floats2bfloat162_rn(oacc[j][2 * half] / x, oacc[j][2 * half + 1] / x);
    if (lane % 4 == 0) lg[r] = m[half] + logf(x);
  }
}

int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           long long in_sb, long long in_sh, long long in_sn,
           long long out_sb, long long out_sh, long long out_sn,
           int b, int h, int n, float scale, cudaStream_t stream) {
  // cp.async copies 16 bytes: the rows of k and v must start on 16 bytes,
  // else the ring is staged by 4-byte loads.
  const bool aligned =
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 == 0 &&
      (in_sb | in_sh | in_sn) % 8 == 0;
  const dim3 grid((n + 16 * kWarps - 1) / (16 * kWarps), h, b);
  flash_fwd_mma_kernel<<<grid, kBlock, kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, in_sb, in_sh, in_sn, out_sb, out_sh, out_sn, h, n, scale,
      aligned ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// The head dim this library was built for (HEAD_DIM).
int k4_flash_fwd_head_dim() { return kD; }

// Shared memory one block needs for the element size (any sequence length).
// bf16: the ring (tc::kSmemBytes); fp32: the scalar kernel's tiles.
size_t k4_flash_fwd_smem_bytes(int elem_bytes) {
  if (elem_bytes == (int)sizeof(__nv_bfloat16)) return tc::kSmemBytes;
  return smem_bytes((size_t)elem_bytes);
}

// q, k, v share the element strides (in_sb, in_sh, in_sn); o has
// (out_sb, out_sh, out_sn); the last dim of each is contiguous and kD long.
// lse is contiguous (b, h, n) float32. scale is q's factor s_q, Dh^-1/2
// rounded to the input type. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
int k4_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                 void* lse, long long in_sb, long long in_sh, long long in_sn,
                 long long out_sb, long long out_sh, long long out_sn,
                 int b, int h, int n, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch<float>(q, k, v, o, l, in_sb, in_sh, in_sn, out_sb, out_sh,
                         out_sn, b, h, n, scale, s);
  if (dtype == 1)
    return tc::launch(q, k, v, o, l, in_sb, in_sh, in_sn, out_sb, out_sh, out_sn, b, h, n,
                      scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
