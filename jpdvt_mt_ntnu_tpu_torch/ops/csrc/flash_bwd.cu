// K5 and K6: flash (KV-streaming) multi-head attention backward, written for
// Hopper (sm_90a).
//
// K5 replaces jpdvt_mt_ntnu_tpu/ops/flash_attention.py:_dq_kernel and K6
// replaces _dkv_kernel, the two Pallas kernels of _flash_bwd, the
// FlashAttention-2 recomputation. Same arithmetic: qs = q * s_q rounded to
// the input type, s_q being Dh^-1/2 rounded to the input type first, as JAX
// rounds its weakly typed Python float; S = Q K^T in fp32, padded key columns out; P = exp(S -
// LSE) in fp32 from the forward's LSE; dP = dO V^T; delta = rowsum(dO * O)
// from the saved output O in the input type; dS = P (dP - delta) rounded
// to the input type. K5: dQ = sum over key tiles of (dS K) * scale, with
// the fp32 scale Dh^-1/2 (the JAX kernel multiplies an fp32 product by
// it). K6: dV = sum over query tiles of round(P)^T dO with P rounded to the
// dO type, dK = sum over query tiles of dS^T qs. Every product accumulates
// in fp32; the outputs are stored in the input type. P uses the saved row
// LSE, so nothing rounded depends on the tiling: a kernel may pick any
// tile, and only the order of the fp32 sums differs from the Pallas one.
//
// Bound on an H100 SXM at the grid-20 train step, B = 96, H = 12, N = 400,
// Dh = 64, bf16 (one (B, H, N, Dh) tensor is 59.0 MB, the LSE 1.8 MB):
// K5 reads q, k, v, O, dO and the LSE and writes dQ, 355.7 MB, 106 us at
// 3.35 TB/s, against 6 * B * H * N^2 * Dh = 70.8 GFLOP, 72 us at 989
// TFLOP/s bf16; K6 reads the same and writes dK and dV, 414.7 MB, 124 us,
// against 8 * B * H * N^2 * Dh = 94.4 GFLOP, 95 us. Both are bound by the
// memory traffic. The train step launches each once per DiT block: 12 +
// 12 launches per step.
//
// bf16 (the train step's type) runs on the tensor cores (namespace tc):
// mma.sync m16n8k16, bf16 in, fp32 accumulators, 4 warps a block, each
// warp owning 16 rows of the block's 64. Streamed operands go through a
// two-stage cp.async ring of 64-row chunks, rows of 64 + 8 elements (144
// B, so the eight rows of an 8 x 8 ldmatrix fall on distinct banks).
// - K6 (dK, dV): one block per (batch, head, 64 keys). Each warp loads its
//   16 K and V rows once into mma A fragments. q, dO and O stream through
//   the ring with each chunk's LSE; each chunk's delta = rowsum(dO * O) is
//   taken from the ring, two threads a row. The warp works in the
//   transposed form, so P and dS never leave registers: S^T = K q^T, P^T =
//   exp(S^T - LSE), dP^T = V dO^T, dS^T = P^T (dP^T - delta) rounded to
//   bf16; dV += round(P^T) dO and dK += dS^T q, the accumulators of two
//   8-query n-tiles repacked as one 16 x 16 A operand, B from the ring by
//   ldmatrix.trans. At Dh 64 the ring takes q as it is: s_q is 2^-3, so q *
//   s_q is exact in bf16 and S = s_q (K q^T), dK = s_q (sum dS^T q) are the
//   same fp32 numbers. At any other Dh (72) q * s_q rounds, so each q
//   chunk is scaled and rounded in place once it has landed (the barrier
//   that publishes delta publishes it), and S and dK take qs as they are.
// - K5 (dQ): one block per (batch, head, 64 queries), K1's structure. Each
//   warp loads its 16 rows of q * scale (rounded to bf16) and of dO into A
//   fragments once, with their LSE and delta (dO from the fragments, O
//   read at the same places, summed over the quad). K and V stream through
//   the ring: S = q K^T, dP = dO V^T (B by ldmatrix), P = exp(S - LSE) with
//   keys past N masked to 0, dS = P (dP - delta) rounded to bf16 and
//   repacked as A, dQ += dS K (B by ldmatrix.trans); dQ is multiplied by
//   the fp32 scale once, at the store (the JAX kernel multiplies each key
//   tile's product: at Dh 64, 2^-3, the same numbers; elsewhere they differ
//   by summation order only).
// exp is exp2 of one FFMA on the special-function unit (2 ulp): P moves by
// a few fp32 ulp, far below its bf16 rounding. Rows past N are zero in
// shared memory and in the fragments (0 times a stale NaN would not be 0);
// K6 gives query rows past N an LSE of +inf, so P = 0 there. Rows whose
// source is not 16-byte aligned (pair-aligned views the wrappers admit)
// are staged by 4-byte loads instead of cp.async. Each output element has
// one owning accumulator and the chunks run in a fixed order (no atomics,
// no split of a sum across blocks): two calls are bit-equal, and a train
// run resumed from a checkpoint repeats the uninterrupted one.
//
// What the earlier scalar design (kept below for fp32) left, and what this
// one does about it: every product was a scalar fp32 FMA from shared
// memory (now mma.sync); q and dO were staged as fp32 and P and dS made a
// round trip through shared memory as fp32 tiles between barriers (now
// bf16 in the ring, P and dS in registers); 68 KB (K5) and 85 KB (K6) of
// shared memory a block (now 36,864 B and 56,320 B). Not done: wgmma, TMA,
// a persistent grid.
//
// fp32 (the tests' type; mma.sync takes fp32 only as TF32, which would
// change its numbers) keeps the scalar design: K5 one block per (batch,
// head, tile of 64 query rows), looping over tiles of 64 key rows, the
// fp32 dQ tile in registers (4 x 4 per thread); K6 one block per (batch,
// head, tile of 64 key rows), looping over tiles of 64 query rows, dK and
// dV in registers (2 x 4 x 4 per thread). Shared memory holds one K and one
// V tile, the q and dO tiles, the rows' LSE and delta, and the P and dS
// tiles. Ragged tiles are zero-filled; padded key columns and padded query
// rows get P = 0, so they add exactly 0.
//
// Both designs take element strides: q/k/v are read out of the saved fused
// (B, N, 3*H*Dh) projection, O and dO out of (B, N, H*Dh) buffers, and
// dq/dk/dv are written into one (B, N, 3, H, Dh) gradient buffer.
//
// The head dim is a compile-time constant, HEAD_DIM (64 by default; the
// build compiles this file again with -DHEAD_DIM=72 for DiT-XL, a library
// of its own), laid out as in attention.cu (K1): at Dh 72 the products over
// Dh (S = q K^T, dP = dO V^T, and their transposes in K6) take five k16
// steps, the fifth over dims 64-79 with dims 72-79 zero in the fragments
// and in the shared-memory rows of the operands read over Dh (K5: K and V;
// K6: q and dO); the products into Dh (dQ, dK, dV) nine n8 tiles, the
// ninth alone by ldmatrix.x2.trans; K6's delta splits a row's nine 16-byte
// pieces five and four over its two threads. Rows of 88 elements (176 B,
// an odd count of 16-byte units): 45,056 B a K5 block, 68,608 B a K6
// block. The fp32 kernels' threads own three column pairs (two at 64), the
// third only inside Dh.

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
// Dh^-1/2 is 2^-3: q * s_q is exact in bf16, and K6 may scale S and dK
// instead of q.
constexpr bool kPow2Scale = kD == 64;
// The scalar fp32 kernels.
constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kS = kD + 2;     // smem row stride of q, dO, K, V (elements)
constexpr int kPS = kBK + 1;   // smem row stride of the P and dS tiles (floats)
constexpr int kCP = (kD / 2 + 15) / 16;  // column pairs of dQ (dK, dV) a thread owns

// Whether column-pair group cg owns its p-th pair of the outputs (dims
// 2 (cg + 16 p)).
__device__ __forceinline__ bool owns_pair(int cg, int p) {
  return kD / 2 % 16 == 0 || cg + 16 * p < kD / 2;
}

// The scalar kernels below are templates of the element type T as they
// were written; since the bf16 design moved to the tensor cores (namespace
// tc) only T = float is instantiated.
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };

__device__ __forceinline__ float2 to_float2(float2 v) { return v; }

// Round to T and back: the casts to the input type in the TPU kernels.
__device__ __forceinline__ float round_as(float v, const float*) { return v; }

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float2 zero_pair(const float*) {
  return make_float2(0.f, 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Element strides of the (B, H, N, Dh) operands.
struct Strides {
  long long in_sb, in_sh, in_sn;    // q, k, v
  long long o_sb, o_sh, o_sn;       // O
  long long do_sb, do_sh, do_sn;    // dO
  long long out_sb, out_sh, out_sn; // dq (K5); dk and dv (K6)
};

size_t dq_smem_bytes(size_t elem) {
  return 2 * (size_t)kBK * kS * elem          // K, V tile
         + 2 * (size_t)kBQ * kS * sizeof(float)  // q, dO tiles
         + (size_t)kBQ * kPS * sizeof(float)  // dS tile
         + 2 * (size_t)kBQ * sizeof(float);   // LSE, delta per row
}

size_t dkv_smem_bytes(size_t elem) {
  return dq_smem_bytes(elem) + (size_t)kBQ * kPS * sizeof(float);  // + P tile
}

// Stage rows r0.. of a (N, Dh) slice as fp32 (the q tile scaled and
// rounded to T, as the TPU kernels' q * scale), zero beyond n; and each
// row's LSE and delta = rowsum(dO * O), zero beyond n.
template <typename T>
__device__ void stage_q_rows(const T* qg, const T* og, const T* dog,
                             const float* lg, const Strides& st, int r0, int n,
                             float scale, float* qs, float* dos, float* lse_s,
                             float* delta_s) {
  using T2 = typename Pair<T>::type;
  const int tid = threadIdx.x;
  for (int i = tid; i < kBQ * (kD / 2); i += kThreads) {
    const int r = i / (kD / 2), c = (i % (kD / 2)) * 2;
    float2 x = make_float2(0.f, 0.f), g = make_float2(0.f, 0.f);
    if (r0 + r < n) {
      x = to_float2(*reinterpret_cast<const T2*>(qg + (r0 + r) * st.in_sn + c));
      g = to_float2(*reinterpret_cast<const T2*>(dog + (r0 + r) * st.do_sn + c));
    }
    qs[r * kS + c] = round_as(x.x * scale, qg);
    qs[r * kS + c + 1] = round_as(x.y * scale, qg);
    dos[r * kS + c] = g.x;
    dos[r * kS + c + 1] = g.y;
  }
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp * (kBQ / 8); r < (warp + 1) * (kBQ / 8); ++r) {
    float part = 0.f;
    if (r0 + r < n) {
      const float2 g = to_float2(
          *reinterpret_cast<const T2*>(dog + (r0 + r) * st.do_sn + 2 * lane));
      const float2 y = to_float2(
          *reinterpret_cast<const T2*>(og + (r0 + r) * st.o_sn + 2 * lane));
      part = g.x * y.x + g.y * y.y;
      for (int c = 2 * lane + 64; c < kD; c += 64) {  // Dh 72: columns 64-71
        const float2 g2 = to_float2(*reinterpret_cast<const T2*>(dog + (r0 + r) * st.do_sn + c));
        const float2 y2 = to_float2(*reinterpret_cast<const T2*>(og + (r0 + r) * st.o_sn + c));
        part += g2.x * y2.x + g2.y * y2.y;
      }
    }
    const float delta = warp_sum(part);
    if (lane == 0) {
      delta_s[r] = delta;
      lse_s[r] = r0 + r < n ? lg[r0 + r] : 0.f;
    }
  }
}

// Stage key rows k0.. of K and V (T, zero beyond n).
template <typename T>
__device__ void stage_kv_rows(const T* kg, const T* vg, long long sn, int k0,
                              int n, T* ks, T* vs) {
  using T2 = typename Pair<T>::type;
  for (int i = threadIdx.x; i < kBK * (kD / 2); i += kThreads) {
    const int j = i / (kD / 2), c = (i % (kD / 2)) * 2;
    T2 kx = zero_pair(kg), vx = zero_pair(vg);
    if (k0 + j < n) {
      kx = *reinterpret_cast<const T2*>(kg + (k0 + j) * sn + c);
      vx = *reinterpret_cast<const T2*>(vg + (k0 + j) * sn + c);
    }
    *reinterpret_cast<T2*>(ks + j * kS + c) = kx;
    *reinterpret_cast<T2*>(vs + j * kS + c) = vx;
  }
}

// S = (q * scale) K^T and dP = dO V^T of one (query tile, key tile) pair,
// this thread's rows rg*4.. and key columns cg + 16c.
template <typename T>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const T* ks, const T* vs, int rg, int cg,
                                       float (&s)[4][4], float (&dp)[4][4]) {
  using T2 = typename Pair<T>::type;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kD; d += 2) {
    float2 kv[4], vv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = to_float2(*reinterpret_cast<const T2*>(ks + (cg + 16 * c) * kS + d));
      vv[c] = to_float2(*reinterpret_cast<const T2*>(vs + (cg + 16 * c) * kS + d));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 qv = *reinterpret_cast<const float2*>(qs + (rg * 4 + i) * kS + d);
      const float2 gv = *reinterpret_cast<const float2*>(dos + (rg * 4 + i) * kS + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = fmaf(qv.x, kv[c].x, s[i][c]);
        s[i][c] = fmaf(qv.y, kv[c].y, s[i][c]);
        dp[i][c] = fmaf(gv.x, vv[c].x, dp[i][c]);
        dp[i][c] = fmaf(gv.y, vv[c].y, dp[i][c]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ o,
                const T* __restrict__ dout, const float* __restrict__ lse,
                T* __restrict__ dq, Strides st, int h, int n, float scale,
                float dq_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                    // [kBK][kS]
  T* vs = ks + kBK * kS;                                 // [kBK][kS]
  float* qs = reinterpret_cast<float*>(vs + kBK * kS);   // [kBQ][kS]
  float* dos = qs + kBQ * kS;                            // [kBQ][kS]
  float* dss = dos + kBQ * kS;                           // [kBQ][kPS]
  float* lse_s = dss + kBQ * kPS;                        // [kBQ]
  float* delta_s = lse_s + kBQ;                          // [kBQ]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const long long in_base = blockIdx.z * st.in_sb + blockIdx.y * st.in_sh;
  const T* kg = k + in_base;
  const T* vg = v + in_base;
  stage_q_rows(q + in_base, o + blockIdx.z * st.o_sb + blockIdx.y * st.o_sh,
               dout + blockIdx.z * st.do_sb + blockIdx.y * st.do_sh,
               lse + ((long long)blockIdx.z * h + blockIdx.y) * n, st, q0, n,
               scale, qs, dos, lse_s, delta_s);

  const int rg = tid / 16, cg = tid % 16;
  // acc[i][2p, 2p + 1]: dQ row rg*4+i, head-dim columns 2 (cg + 16 p) and the
  // next, p < kCP, inside Dh (Dh 64: 2cg, 2cg+1, 2cg+32, 2cg+33).
  float acc[4][2 * kCP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 2 * kCP; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    __syncthreads();  // staging done; the previous tile's readers are done
    stage_kv_rows(kg, vg, st.in_sn, k0, n, ks, vs);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores(qs, dos, ks, vs, rg, cg, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = k0 + cg + 16 * c < n ? expf(s[i][c] - lse_s[r]) : 0.f;
        dss[r * kPS + cg + 16 * c] = round_as(p * (dp[i][c] - delta_s[r]), k);
      }
    }
    __syncthreads();
    // dQ += (dS K) * dq_scale, the tile's product scaled before it is added.
    float t[4][2 * kCP];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 2 * kCP; ++c) t[i][c] = 0.f;
    using T2 = typename Pair<T>::type;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float2 kv[kCP];
#pragma unroll
      for (int p = 0; p < kCP; ++p)
        kv[p] = owns_pair(cg, p)
                    ? to_float2(*reinterpret_cast<const T2*>(ks + j * kS + 2 * (cg + 16 * p)))
                    : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g = dss[(rg * 4 + i) * kPS + j];
#pragma unroll
        for (int p = 0; p < kCP; ++p) {
          t[i][2 * p] = fmaf(g, kv[p].x, t[i][2 * p]);
          t[i][2 * p + 1] = fmaf(g, kv[p].y, t[i][2 * p + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 2 * kCP; ++c) acc[i][c] += t[i][c] * dq_scale;
  }

  T* dqg = dq + blockIdx.z * st.out_sb + blockIdx.y * st.out_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r < n) {
#pragma unroll
      for (int p = 0; p < kCP; ++p)
        if (owns_pair(cg, p))
          store_pair(dqg + r * st.out_sn + 2 * (cg + 16 * p), acc[i][2 * p],
                     acc[i][2 * p + 1]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 T* __restrict__ dk, T* __restrict__ dv, Strides st, int h, int n,
                 float scale) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                    // [kBK][kS]
  T* vs = ks + kBK * kS;                                 // [kBK][kS]
  float* qs = reinterpret_cast<float*>(vs + kBK * kS);   // [kBQ][kS]
  float* dos = qs + kBQ * kS;                            // [kBQ][kS]
  float* dss = dos + kBQ * kS;                           // [kBQ][kPS]
  float* lse_s = dss + kBQ * kPS;                        // [kBQ]
  float* delta_s = lse_s + kBQ;                          // [kBQ]
  float* pcs = delta_s + kBQ;                            // [kBQ][kPS]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBK;
  const long long in_base = blockIdx.z * st.in_sb + blockIdx.y * st.in_sh;
  const T* qg = q + in_base;
  const T* og = o + blockIdx.z * st.o_sb + blockIdx.y * st.o_sh;
  const T* dog = dout + blockIdx.z * st.do_sb + blockIdx.y * st.do_sh;
  const float* lg = lse + ((long long)blockIdx.z * h + blockIdx.y) * n;
  stage_kv_rows(k + in_base, v + in_base, st.in_sn, k0, n, ks, vs);

  const int rg = tid / 16, cg = tid % 16;
  // dk/dv[j][2p, 2p + 1]: key row rg*4+j, head-dim columns 2 (cg + 16 p) and
  // the next, p < kCP, inside Dh (Dh 64: 2cg, 2cg+1, 2cg+32, 2cg+33).
  float dka[4][2 * kCP], dva[4][2 * kCP];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2 * kCP; ++c) dka[j][c] = dva[j][c] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kBQ) {
    __syncthreads();  // staging done; the previous tile's readers are done
    stage_q_rows(qg, og, dog, lg, st, q0, n, scale, qs, dos, lse_s, delta_s);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores(qs, dos, ks, vs, rg, cg, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool valid = q0 + r < n && k0 + cg + 16 * c < n;
        const float p = valid ? expf(s[i][c] - lse_s[r]) : 0.f;
        pcs[r * kPS + cg + 16 * c] = round_as(p, dout);
        dss[r * kPS + cg + 16 * c] = round_as(p * (dp[i][c] - delta_s[r]), q);
      }
    }
    __syncthreads();
    // dV += round(P)^T dO, dK += dS^T (q * scale), over this tile's rows.
#pragma unroll 2
    for (int i = 0; i < kBQ; ++i) {
      float2 gv[kCP], xv[kCP];
#pragma unroll
      for (int p = 0; p < kCP; ++p) {
        const int c = 2 * (cg + 16 * p);
        gv[p] = owns_pair(cg, p) ? *reinterpret_cast<const float2*>(dos + i * kS + c)
                                 : make_float2(0.f, 0.f);
        xv[p] = owns_pair(cg, p) ? *reinterpret_cast<const float2*>(qs + i * kS + c)
                                 : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = pcs[i * kPS + rg * 4 + j];
        const float g = dss[i * kPS + rg * 4 + j];
#pragma unroll
        for (int p = 0; p < kCP; ++p) {
          dva[j][2 * p] = fmaf(pr, gv[p].x, dva[j][2 * p]);
          dva[j][2 * p + 1] = fmaf(pr, gv[p].y, dva[j][2 * p + 1]);
          dka[j][2 * p] = fmaf(g, xv[p].x, dka[j][2 * p]);
          dka[j][2 * p + 1] = fmaf(g, xv[p].y, dka[j][2 * p + 1]);
        }
      }
    }
  }

  const long long out_base = blockIdx.z * st.out_sb + blockIdx.y * st.out_sh;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = k0 + rg * 4 + j;
    if (r < n) {
      T* kr = dk + out_base + r * st.out_sn;
      T* vr = dv + out_base + r * st.out_sn;
#pragma unroll
      for (int p = 0; p < kCP; ++p)
        if (owns_pair(cg, p)) {
          const int c = 2 * (cg + 16 * p);
          store_pair(kr + c, dka[j][2 * p], dka[j][2 * p + 1]);
          store_pair(vr + c, dva[j][2 * p], dva[j][2 * p + 1]);
        }
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, void* dq, const Strides& st,
              int b, int h, int n, float scale, float dq_scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(sizeof(T));
  if (const int err = set_smem(flash_dq_kernel<T>, smem)) return err;
  const dim3 grid((n + kBQ - 1) / kBQ, h, b);
  flash_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse,
      static_cast<T*>(dq), st, h, n, scale, dq_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, void* dk, void* dv,
               const Strides& st, int b, int h, int n, float scale,
               cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(sizeof(T));
  if (const int err = set_smem(flash_dkv_kernel<T>, smem)) return err;
  const dim3 grid((n + kBK - 1) / kBK, h, b);
  flash_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse,
      static_cast<T*>(dk), static_cast<T*>(dv), st, h, n, scale);
  return (int)cudaGetLastError();
}

// The bf16 design on the tensor cores (see the head of this file).
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;             // rows of a chunk in the ring, and of a block's tile
// smem row stride (elements), an odd count of 16-byte units: 144 B at Dh
// 64, 176 B at 72.
constexpr int kRow = kD / 8 % 2 == 0 ? kD + 8 : kD + 16;
constexpr int kStage = kRows * kRow;  // elements of one chunk of one tensor
constexpr int kC8 = kD / 8;           // 16-byte pieces of a row
// k16 steps over Dh (S and dP); the last one's dims past kD are zero.
constexpr int kK16 = (kD + 15) / 16;
static_assert(kK16 * 16 - kD <= 8 && kK16 * 16 <= kRow, "one zero piece a row pads Dh");
constexpr int kWarps = 4;             // 16 rows each
constexpr int kBlock = 32 * kWarps;
// A thread's 16-byte pieces of one chunk of one tensor; at Dh 72 the last
// round takes half the threads.
constexpr int kPieces = (kRows * kC8 + kBlock - 1) / kBlock;
constexpr float kLog2e = 1.4426950408889634f;
// K5: K and V, two stages each: 36,864 B at every N (Dh 64), 45,056 B (72).
constexpr size_t kDqSmemBytes = 4 * (size_t)kStage * sizeof(bf16);
static_assert(kDqSmemBytes <= 48 * 1024, "K5 is launched without opting into more");
// K6: q, dO and O, two stages each, and each stage's LSE and delta (fp32):
// 56,320 B at every N (Dh 64), 68,608 B (72).
constexpr size_t kDkvSmemBytes =
    2 * (3 * (size_t)kStage * sizeof(bf16) + 2 * (size_t)kRows * sizeof(float));
// Blocks an SM, by measurement on an H100 (PERF.md §6): 4 caps K5 at 128
// registers and 3 caps K6 at 168, each with a few bytes of spill; the
// spill-free 3 (149 registers) and 2 (209) were 10% and 7% slower.
constexpr int kDqMinBlocks = 4;
constexpr int kDkvMinBlocks = 3;

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

__device__ __forceinline__ float2 unpack(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// B operands of two n-tiles (n0.., n0 + 8..) x k16, from B^T as
// [n][kStride]: r[0], r[1] the first tile's, r[2], r[3] the second's.
template <int kStride>
__device__ __forceinline__ void load_b(unsigned (&r)[4], const bf16* base, int n0, int k0,
                                       int lane) {
  ldsm_x4(r, base + (n0 + lane % 8 + (lane / 16) * 8) * kStride + k0 + ((lane / 8) % 2) * 8);
}

// B operands of two n-tiles (columns j0.., j0 + 8..) x k16 (rows k0..) from
// B as [k][kRow], through .trans: r[0], r[1] the first tile's, r[2], r[3]
// the second's.
__device__ __forceinline__ void load_b_trans(unsigned (&r)[4], const bf16* base, int k0,
                                             int j0, int lane) {
  ldsm_x4_trans(r, base + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * kRow + j0 + (lane / 16) * 8);
}
// The B operand of the last n-tile over Dh alone (columns kD - 8..) x k16,
// for an odd count of n8 tiles (Dh 72).
__device__ __forceinline__ void load_b_trans_last(unsigned (&r)[2], const bf16* base, int k0,
                                                  int lane) {
  ldsm_x2_trans(r, base + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * kRow + kD - 8);
}

// The A operands (16 rows x kK16 slices of 16 dims) of rows r0.. of a
// (N, Dh) slice with row stride sn, times mul, rounded to bf16; zero rows
// past n and dims past kD.
__device__ __forceinline__ void load_a(unsigned (&a)[kK16][4], const bf16* g, long long sn,
                                       int r0, int n, float mul, int lane) {
  const int gr = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll
  for (int kk = 0; kk < kK16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + gr + (e % 2) * 8, col = kk * 16 + t2 + (e / 2) * 8;
      const float2 x = row < n && (kK16 * 16 == kD || col < kD)
                           ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                 g + row * sn + col))
                           : make_float2(0.f, 0.f);
      a[kk][e] = pack(x.x * mul, x.y * mul);
    }
}

// Dims kD.. of the last k16 step in `rows` rows of stride kRow from p:
// zero (the ring's copies never write them).
__device__ __forceinline__ void zero_pad(bf16* p, int rows) {
  if (kK16 * 16 > kD)
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
      *reinterpret_cast<uint4*>(p + i * kRow + kD) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most one committed group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One 16-byte piece of a row into shared memory: by cp.async where the
// source is 16-byte aligned, else by four 4-byte loads; zeros past N.
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

// Sum of the products of eight bf16 pairs' elements, in fp32.
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const unsigned x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = unpack(x[i]), w = unpack(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// K5: dQ of 4 warps x 16 query rows; K and V stream through the ring.
__global__ void __launch_bounds__(kBlock, kDqMinBlocks)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    bf16* __restrict__ dq, Strides st, int h, int n, float scale,
                    float dq_scale, int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][kRows][kRow]
  bf16* vs = ks + 2 * kStage;                // [2][kRows][kRow]
  zero_pad(ks, 4 * kRows);                   // K and V: both are read over Dh

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);  // accumulator row, column pair
  const long long in_base = blockIdx.z * st.in_sb + blockIdx.y * st.in_sh;
  const bf16* kg = k + in_base;
  const bf16* vg = v + in_base;
  const bf16* og = o + blockIdx.z * st.o_sb + blockIdx.y * st.o_sh;
  const bf16* dog = dout + blockIdx.z * st.do_sb + blockIdx.y * st.do_sh;
  const float* lg = lse + ((long long)blockIdx.z * h + blockIdx.y) * n;
  // This warp's rows: q0 + g (accumulator elements 0, 1) and q0 + g + 8 (2, 3).
  const int q0 = (blockIdx.x * kWarps + warp) * 16;
  const bool active = q0 < n;  // warp-uniform; idle warps still stage K and V

  // q * scale (rounded) and dO as A operands; each row's LSE log2(e) and
  // delta = rowsum(dO * O), from this lane's dO pieces and O at the same
  // places, summed over the quad.
  unsigned qa[kK16][4], da[kK16][4];
  load_a(qa, q + in_base, st.in_sn, q0, n, scale, lane);
  load_a(da, dog, st.do_sn, q0, n, 1.f, lane);
  float lse2[2], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < kK16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + g + (e % 2) * 8, col = kk * 16 + t2 + (e / 2) * 8;
      if (row < n && (kK16 * 16 == kD || col < kD)) {
        const float2 d = unpack(da[kk][e]);
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(og + row * st.o_sn + col));
        delta[e % 2] = fmaf(d.x, y.x, fmaf(d.y, y.y, delta[e % 2]));
      }
    }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    delta[half] += __shfl_xor_sync(0xffffffffu, delta[half], 1);
    delta[half] += __shfl_xor_sync(0xffffffffu, delta[half], 2);
    const int row = q0 + g + half * 8;
    lse2[half] = row < n ? lg[row] * kLog2e : 0.f;
  }

  // Chunk c of K and V into stage c % 2 of the ring.
  const int nc = (n + kRows - 1) / kRows;
  auto issue = [&](int c) {
    const int stg = c % 2;
#pragma unroll
    for (int u = 0; u < kPieces; ++u) {
      const int i = tid + u * kBlock;
      if (kRows * kC8 % kBlock != 0 && i >= kRows * kC8) break;
      const int r = i / kC8, col = i % kC8 * 8, key = c * kRows + r;
      const long long off = (long long)min(key, n - 1) * st.in_sn + col;
      stage_piece(ks + stg * kStage + r * kRow + col, kg + off, key < n, aligned);
      stage_piece(vs + stg * kStage + r * kRow + col, vg + off, key < n, aligned);
    }
    cp_async_commit();
  };

  float acc[kD / 8][4];  // dQ / scale: n-tile j holds dims 8 j..
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  issue(0);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      issue(c + 1);  // into the stage the previous chunk read
    } else {
      cp_async_commit();  // an empty group, so one wait fits every chunk
    }
    cp_async_wait_one();
    __syncthreads();
    const int j0 = c * kRows;
    const int groups = min(kRows / 16, (n - j0 + 15) / 16);  // 16-key groups with a key < n
    const bf16* kst = ks + c % 2 * kStage;
    const bf16* vst = vs + c % 2 * kStage;
    if (active) {
#pragma unroll
      for (int u = 0; u < kRows / 16; ++u) {
        if (u >= groups) break;
        // S and dP of 16 rows x 16 keys (two n-tiles each).
        float s[2][4], dp[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kK16; ++kk) {
          unsigned b[4];
          load_b<kRow>(b, kst, 16 * u, kk * 16, lane);
          mma(s[0], qa[kk], b[0], b[1]);
          mma(s[1], qa[kk], b[2], b[3]);
          load_b<kRow>(b, vst, 16 * u, kk * 16, lane);
          mma(dp[0], da[kk], b[0], b[1]);
          mma(dp[1], da[kk], b[2], b[3]);
        }
        // dS = P (dP - delta), rounded; two n-tiles are one A operand.
        unsigned dsa[4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float x[2];
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const float p = j0 + 16 * u + 8 * t + t2 + cc < n
                                  ? exp2f(fmaf(s[t][2 * half + cc], kLog2e, -lse2[half]))
                                  : 0.f;
              x[cc] = p * (dp[t][2 * half + cc] - delta[half]);
            }
            dsa[2 * t + half] = pack(x[0], x[1]);
          }
        // dQ += dS K: K as [key][dim] is B (k = key, n = dim) through .trans.
        // Pairs of n8 tiles over Dh, counted: a loop on j + 1 < kD / 8 put
        // the accumulators in local memory at Dh 72.
#pragma unroll
        for (int jp = 0; jp < kD / 16; ++jp) {
          const int j = 2 * jp;
          unsigned b[4];
          load_b_trans(b, kst, 16 * u, j * 8, lane);
          mma(acc[j], dsa, b[0], b[1]);
          mma(acc[j + 1], dsa, b[2], b[3]);
        }
        if (kD / 8 % 2) {  // an odd count of n8 tiles (Dh 72): the last alone
          unsigned b[2];
          load_b_trans_last(b, kst, 16 * u, lane);
          mma(acc[kD / 8 - 1], dsa, b[0], b[1]);
        }
      }
    }
    __syncthreads();  // the next chunk's copies overwrite this stage
  }

  bf16* dqg = dq + blockIdx.z * st.out_sb + blockIdx.y * st.out_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + g + half * 8;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqg + r * st.out_sn + j * 8 + t2) =
          __floats2bfloat162_rn(acc[j][2 * half] * dq_scale, acc[j][2 * half + 1] * dq_scale);
  }
}

// K6: dK and dV of 4 warps x 16 key rows; q, dO, O and the LSE stream
// through the ring.
__global__ void __launch_bounds__(kBlock, kDkvMinBlocks)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, Strides st, int h, int n,
                     float scale, int aligned) {
  static_assert(kBlock == 2 * kRows, "delta takes two threads a row");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);               // [2][kRows][kRow]
  bf16* dos = qs + 2 * kStage;                            // [2][kRows][kRow]
  bf16* os = dos + 2 * kStage;                            // [2][kRows][kRow]
  float* lse_s = reinterpret_cast<float*>(os + 2 * kStage);  // [2][kRows]
  float* delta_s = lse_s + 2 * kRows;                     // [2][kRows]
  zero_pad(qs, 4 * kRows);                                // q and dO: read over Dh

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);  // accumulator row (key), column pair
  const long long in_base = blockIdx.z * st.in_sb + blockIdx.y * st.in_sh;
  const bf16* qg = q + in_base;
  const bf16* og = o + blockIdx.z * st.o_sb + blockIdx.y * st.o_sh;
  const bf16* dog = dout + blockIdx.z * st.do_sb + blockIdx.y * st.do_sh;
  const float* lg = lse + ((long long)blockIdx.z * h + blockIdx.y) * n;
  // This warp's key rows: k0 + g (accumulator elements 0, 1) and k0 + g + 8 (2, 3).
  const int k0 = (blockIdx.x * kWarps + warp) * 16;
  const bool active = k0 < n;  // warp-uniform; idle warps still stage the ring

  unsigned ka[kK16][4], va[kK16][4];
  load_a(ka, k + in_base, st.in_sn, k0, n, 1.f, lane);
  load_a(va, v + in_base, st.in_sn, k0, n, 1.f, lane);
  // S^T = scale (K q^T), exact where scale = 2^-3; else S^T = K qs^T, the
  // ring's q scaled in place.
  const float sl2e = kPow2Scale ? scale * kLog2e : kLog2e;

  // Chunk c of q, dO, O and the LSE into stage c % 2 of the ring.
  const int nc = (n + kRows - 1) / kRows;
  auto issue = [&](int c) {
    const int stg = c % 2;
#pragma unroll
    for (int u = 0; u < kPieces; ++u) {
      const int i = tid + u * kBlock;
      if (kRows * kC8 % kBlock != 0 && i >= kRows * kC8) break;
      const int r = i / kC8, col = i % kC8 * 8, row = c * kRows + r;
      const long long rr = min(row, n - 1);
      const int at = stg * kStage + r * kRow + col;
      stage_piece(qs + at, qg + rr * st.in_sn + col, row < n, aligned);
      stage_piece(dos + at, dog + rr * st.do_sn + col, row < n, aligned);
      stage_piece(os + at, og + rr * st.o_sn + col, row < n, aligned);
    }
    if (tid < kRows && c * kRows + tid < n)
      cp_async4(lse_s + stg * kRows + tid, lg + c * kRows + tid);
    cp_async_commit();
  };

  // dK (at Dh 64 dK / scale) and dV: n-tile j holds dims 8 j..
  float dka[kD / 8][4], dva[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  issue(0);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      issue(c + 1);  // into the stage the previous chunk read
    } else {
      cp_async_commit();  // an empty group, so one wait fits every chunk
    }
    cp_async_wait_one();
    __syncthreads();
    const int stg = c % 2, c0 = c * kRows;
    const bf16* qst = qs + stg * kStage;
    const bf16* dost = dos + stg * kStage;
    float* ls = lse_s + stg * kRows;
    float* dl = delta_s + stg * kRows;
    {
      // Each query row's delta = rowsum(dO * O) and LSE log2(e), +inf past
      // n (P = 0 there): two threads a row, the first taking kHalf of its
      // 16-byte pieces, the second the rest.
      constexpr int kHalf = (kC8 + 1) / 2;
      const int r = tid / 2, p0 = tid % 2 * kHalf;
      float part = 0.f;
#pragma unroll
      for (int p = 0; p < kHalf; ++p)
        if (kC8 % 2 == 0 || p0 + p < kC8)
          part += dot8(
              *reinterpret_cast<const uint4*>(dost + r * kRow + (p0 + p) * 8),
              *reinterpret_cast<const uint4*>(os + stg * kStage + r * kRow + (p0 + p) * 8));
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (tid % 2 == 0) {
        dl[r] = part;
      } else {
        ls[r] = c0 + r < n ? ls[r] * kLog2e : INFINITY;
      }
      if (!kPow2Scale) {
        // qs = q * scale rounded to bf16, in place (rows past n stay 0).
        bf16* qw = qs + stg * kStage;
        for (int i = tid; i < kRows * kD / 2; i += kBlock) {
          __nv_bfloat162* x =
              reinterpret_cast<__nv_bfloat162*>(qw + i / (kD / 2) * kRow + i % (kD / 2) * 2);
          const float2 f = __bfloat1622float2(*x);
          *x = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    __syncthreads();
    const int groups = min(kRows / 16, (n - c0 + 15) / 16);  // 16-query groups with a row < n
    if (active) {
#pragma unroll
      for (int u = 0; u < kRows / 16; ++u) {
        if (u >= groups) break;
        // S^T and dP^T of 16 keys x 16 queries (two n-tiles each).
        float s[2][4], dp[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kK16; ++kk) {
          unsigned b[4];
          load_b<kRow>(b, qst, 16 * u, kk * 16, lane);
          mma(s[0], ka[kk], b[0], b[1]);
          mma(s[1], ka[kk], b[2], b[3]);
          load_b<kRow>(b, dost, 16 * u, kk * 16, lane);
          mma(dp[0], va[kk], b[0], b[1]);
          mma(dp[1], va[kk], b[2], b[3]);
        }
        // P^T and dS^T = P^T (dP^T - delta), rounded; two n-tiles are one A
        // operand (16 keys x 16 queries).
        unsigned pa[4], dsa[4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int qi = 16 * u + 8 * t + t2;
          const float2 l2 = *reinterpret_cast<const float2*>(ls + qi);
          const float2 de = *reinterpret_cast<const float2*>(dl + qi);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float p0 = exp2f(fmaf(s[t][2 * half], sl2e, -l2.x));
            const float p1 = exp2f(fmaf(s[t][2 * half + 1], sl2e, -l2.y));
            pa[2 * t + half] = pack(p0, p1);
            dsa[2 * t + half] =
                pack(p0 * (dp[t][2 * half] - de.x), p1 * (dp[t][2 * half + 1] - de.y));
          }
        }
        // dV += round(P^T) dO, dK += dS^T q: dO and q as [query][dim] are B
        // (k = query, n = dim) through .trans.
        // Pairs of n8 tiles over Dh, counted: a loop on j + 1 < kD / 8 put
        // the accumulators in local memory at Dh 72.
#pragma unroll
        for (int jp = 0; jp < kD / 16; ++jp) {
          const int j = 2 * jp;
          unsigned b[4];
          load_b_trans(b, dost, 16 * u, j * 8, lane);
          mma(dva[j], pa, b[0], b[1]);
          mma(dva[j + 1], pa, b[2], b[3]);
          load_b_trans(b, qst, 16 * u, j * 8, lane);
          mma(dka[j], dsa, b[0], b[1]);
          mma(dka[j + 1], dsa, b[2], b[3]);
        }
        if (kD / 8 % 2) {  // an odd count of n8 tiles (Dh 72): the last alone
          unsigned b[2];
          load_b_trans_last(b, dost, 16 * u, lane);
          mma(dva[kD / 8 - 1], pa, b[0], b[1]);
          load_b_trans_last(b, qst, 16 * u, lane);
          mma(dka[kD / 8 - 1], dsa, b[0], b[1]);
        }
      }
    }
    __syncthreads();  // the next chunk's copies overwrite this stage
  }

  const long long out_base = blockIdx.z * st.out_sb + blockIdx.y * st.out_sh;
  const float dk_mul = kPow2Scale ? scale : 1.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = k0 + g + half * 8;
    if (r >= n) continue;
    bf16* kr = dk + out_base + r * st.out_sn;
    bf16* vr = dv + out_base + r * st.out_sn;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(kr + j * 8 + t2) =
          __floats2bfloat162_rn(dka[j][2 * half] * dk_mul, dka[j][2 * half + 1] * dk_mul);
      *reinterpret_cast<__nv_bfloat162*>(vr + j * 8 + t2) =
          __floats2bfloat162_rn(dva[j][2 * half], dva[j][2 * half + 1]);
    }
  }
}

// cp.async copies 16 bytes: the rows of q, k, v, O and dO must start on 16
// bytes, else the ring is staged by 4-byte loads.
bool aligned16(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const Strides& st) {
  return (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
          reinterpret_cast<uintptr_t>(dout)) % 16 == 0 &&
         (st.in_sb | st.in_sh | st.in_sn | st.o_sb | st.o_sh | st.o_sn | st.do_sb |
          st.do_sh | st.do_sn) % 8 == 0;
}

int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, const Strides& st, int b, int h, int n, float scale,
              float dq_scale, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, h, b);
  flash_dq_mma_kernel<<<grid, kBlock, kDqSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
      static_cast<bf16*>(dq), st, h, n, scale, dq_scale,
      aligned16(q, k, v, o, dout, st) ? 1 : 0);
  return (int)cudaGetLastError();
}

int launch_dkv(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dk, void* dv, const Strides& st, int b, int h, int n,
               float scale, cudaStream_t stream) {
  if (const int err = set_smem(flash_dkv_mma_kernel, kDkvSmemBytes)) return err;
  const dim3 grid((n + kRows - 1) / kRows, h, b);
  flash_dkv_mma_kernel<<<grid, kBlock, kDkvSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), st, h, n, scale,
      aligned16(q, k, v, o, dout, st) ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// The head dim this library was built for (HEAD_DIM).
int k56_flash_bwd_head_dim() { return kD; }

// Shared memory one block of K5 / K6 needs for the element size (any N).
// bf16: the ring (tc::kDqSmemBytes, tc::kDkvSmemBytes); fp32: the scalar
// kernels' tiles.
size_t k5_flash_dq_smem_bytes(int elem_bytes) {
  if (elem_bytes == (int)sizeof(__nv_bfloat16)) return tc::kDqSmemBytes;
  return dq_smem_bytes((size_t)elem_bytes);
}
size_t k6_flash_dkv_smem_bytes(int elem_bytes) {
  if (elem_bytes == (int)sizeof(__nv_bfloat16)) return tc::kDkvSmemBytes;
  return dkv_smem_bytes((size_t)elem_bytes);
}

// q, k, v share the element strides (in_*); O, dO and dq have their own;
// the last dim of each is contiguous and kD long; lse is contiguous
// (b, h, n) float32. scale is q's factor s_q (Dh^-1/2 rounded to the input
// type), dq_scale dQ's, the fp32 Dh^-1/2. dtype: 0 = float32, 1 =
// bfloat16. Returns the cudaError_t of the launch (0 on success).
int k5_flash_dq(int dtype, const void* q, const void* k, const void* v,
                const void* o, const void* dout, const void* lse, void* dq,
                long long in_sb, long long in_sh, long long in_sn,
                long long o_sb, long long o_sh, long long o_sn,
                long long do_sb, long long do_sh, long long do_sn,
                long long out_sb, long long out_sh, long long out_sn,
                int b, int h, int n, float scale, float dq_scale, void* stream) {
  const Strides st{in_sb, in_sh, in_sn, o_sb, o_sh, o_sn,
                   do_sb, do_sh, do_sn, out_sb, out_sh, out_sn};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (dtype == 0)
    return launch_dq<float>(q, k, v, o, dout, l, dq, st, b, h, n, scale, dq_scale, s);
  if (dtype == 1)
    return tc::launch_dq(q, k, v, o, dout, l, dq, st, b, h, n, scale, dq_scale, s);
  return (int)cudaErrorInvalidValue;
}

// As k5_flash_dq, with q's factor s_q alone; dk and dv share the strides
// (out_*).
int k6_flash_dkv(int dtype, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const void* lse, void* dk,
                 void* dv, long long in_sb, long long in_sh, long long in_sn,
                 long long o_sb, long long o_sh, long long o_sn,
                 long long do_sb, long long do_sh, long long do_sn,
                 long long out_sb, long long out_sh, long long out_sn,
                 int b, int h, int n, float scale, void* stream) {
  const Strides st{in_sb, in_sh, in_sn, o_sb, o_sh, o_sn,
                   do_sb, do_sh, do_sn, out_sb, out_sh, out_sn};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (dtype == 0)
    return launch_dkv<float>(q, k, v, o, dout, l, dk, dv, st, b, h, n, scale, s);
  if (dtype == 1)
    return tc::launch_dkv(q, k, v, o, dout, l, dk, dv, st, b, h, n, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
