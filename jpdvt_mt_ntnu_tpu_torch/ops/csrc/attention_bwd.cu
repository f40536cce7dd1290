// K2: whole-row multi-head attention backward, written for Hopper (sm_90a).
//
// Replaces jpdvt_mt_ntnu_tpu/ops/attention.py:_attn_bwd_kernel, the Pallas
// kernel behind the custom VJP of _attention_pallas. Same arithmetic:
// qs = q * s_q rounded to the input type, s_q being Dh^-1/2 rounded to the
// input type first, as JAX rounds its weakly typed Python float (the
// wrapper passes s_q as `scale`); S = qs K^T and the softmax P in fp32
// (recomputed, nothing saved from the forward but q, k, v);
// dV = round(P)^T dO; dP = dO V^T; dS = P * (dP - rowsum(dP * P)) with the
// fp32 P; dS rounded to the q type; dQ = dS K * dq_scale, the fp32 Dh^-1/2
// (the JAX kernel multiplies an fp32 product by it); dK = dS^T qs.
// Every product accumulates in fp32; the outputs are stored in the input
// type. No masking, no dropout. K2 is given no O, so delta = rowsum(dP * P)
// (the JAX kernel's rule), not the flash backward's rowsum(dO * O).
//
// Bound on an H100 SXM at the flagship's train step, B = 96, H = 12,
// N = 144, Dh = 64, bf16: q, k, v, dO read once and dq, dk, dv written once
// is 7 * B * H * N * Dh * 2 B = 148.6 MB, 44.4 us at 3.35 TB/s; the five
// products are 10 * B * H * N^2 * Dh = 15.3 GFLOP, 15.5 us at 989 TFLOP/s
// bf16. So the bound is the memory traffic. The train step launches K2
// once per DiT block: 12 calls per step, each two kernels in bf16. At
// DiT-XL/8's step on attn_impl="pallas" (B = 8, H = 16, N = 576, Dh = 72)
// the bytes are 74.3 MB, 22.2 us, and the products 30.6 GFLOP, 30.9 us:
// bound by the operations; 28 calls per step.
//
// bf16 (the train step's type) runs on the tensor cores (namespace tc), in
// the flash backward's design (flash_bwd.cu): mma.sync m16n8k16, bf16 in,
// fp32 accumulators, 4 warps a block, each warp owning 16 rows of the
// block's 64. Streamed operands go through a two-stage cp.async ring of
// 64-row chunks, rows of 64 + 8 elements (144 B, so the eight rows of an
// 8 x 8 ldmatrix fall on distinct banks). One call is two kernels launched
// in order on the caller's stream, joined by an fp32 workspace of three
// (B, H, N) planes the wrapper allocates: each row's m log2(e), 1 / l and
// delta (2.0 MB at B = 96, N = 144).
// - Row kernel (dQ and the statistics): one block per (batch, head, 64
//   queries), K1's structure. Each warp loads its 16 rows of q * scale
//   (rounded to bf16) and of dO into A fragments once. K and V stream
//   through the ring twice. Pass A: S = q K^T (keys past N at -inf) and
//   dP = dO V^T per chunk; the row max m, l = sum exp(S - m) and t = sum
//   exp(S - m) dP kept online (l and t rescaled by exp(m_old - m_new)), so
//   delta = t / l = rowsum(dP * P). Pass B: S and dP again, P = exp(S - m)
//   (1 / l) exact since m and l are final, dS = P (dP - delta) rounded to
//   bf16 and repacked as A, dQ += dS K (K by ldmatrix.trans); dQ is
//   multiplied by the fp32 dq_scale once, at the store (at Dh 64, 2^-3, the
//   JAX kernel's numbers; elsewhere they differ by summation order only).
// - Column kernel (dK, dV): one block per (batch, head, 64 keys). Each warp
//   loads its 16 K and V rows once into A fragments. q, dO and each row's
//   three statistics stream through the ring. It works in the transposed
//   form, so P and dS never leave registers: S^T = K q^T, P^T = exp(S^T -
//   m) (1 / l), dP^T = V dO^T, dS^T = P^T (dP^T - delta) rounded to bf16;
//   dV += round(P^T) dO and dK += dS^T q, B from the ring by
//   ldmatrix.trans. At Dh 64 the ring takes q as it is: s_q is 2^-3, so
//   q * s_q is exact in bf16 and S^T = s_q (K q^T), dK = s_q (sum dS^T q)
//   are the same fp32 numbers. At any other Dh (72) q * s_q rounds, so
//   each q chunk is scaled and rounded in place once it has landed (K6's
//   rule, flash_bwd.cu), and S^T and dK take qs as they are. Both kernels
//   form P from the same stored m and 1 / l.
// exp is exp2 of one FFMA on the special-function unit (2 ulp): P moves by
// a few fp32 ulp, far below its bf16 rounding. Rows past N are zero in
// shared memory and in the fragments (0 times a stale NaN would not be 0);
// the column kernel gives query rows past N m = +inf and 1 / l = 0, so P =
// 0 there. Rows whose source is not 16-byte aligned (pair-aligned views the
// wrapper admits) are staged by 4-byte loads instead of cp.async. Each
// output element has one owning accumulator and the chunks run in a fixed
// order (no atomics, no split of a sum across blocks): two calls are
// bit-equal, and a train run resumed from a checkpoint repeats the
// uninterrupted one.
//
// What the earlier scalar design (kept below for fp32) left, and what this
// one does about it: one block owned a whole (batch, head), so K and V and
// fp32 dK and dV accumulators sat in shared memory (163 KB a block at N =
// 144, one block of 8 warps an SM, and N <= 205 in bf16; now 36,864 B and
// 38,400 B at every N); every product was a scalar fp32 FMA from shared
// memory (now mma.sync); P and dS made a round trip through shared memory
// as fp32 rows between barriers (now in registers). Not done: wgmma, TMA,
// a persistent grid.
//
// fp32 (the tests' type; mma.sync takes fp32 only as TF32, which would
// change its numbers) keeps the scalar design: one block owns one (batch,
// head) and walks its query rows in tiles of 32; K and V stay staged in
// shared memory, and the fp32 dK and dV accumulators live there too, with
// the tile's q, dO and fp32 P/dP rows (fp32 N <= 164). Each accumulator
// element has one owning thread. dQ rows are complete within a tile and go
// straight to device memory. The products are scalar fp32 FMAs from shared
// memory on small register tiles.
//
// Both designs take element strides: q/k/v are read out of the saved fused
// (B, N, 3*H*Dh) projection, dO out of the (B, N, H*Dh) upstream gradient,
// and dq/dk/dv are written into one (B, N, 3, H, Dh) gradient buffer: no
// transposes and no concatenation around the call.
//
// The head dim is a compile-time constant, HEAD_DIM (64 by default; the build
// compiles this file again with -DHEAD_DIM=72 for DiT-XL, a library of its
// own), laid out as in attention.cu (K1) and flash_bwd.cu (K5, K6): at Dh 72
// the products over Dh (S = q K^T and dP = dO V^T in the row kernel, S^T = K
// q^T and dP^T = V dO^T in the column kernel) take five k16 steps, the fifth
// over dims 64-79 with dims 72-79 zero in the fragments and in the ring's rows
// of the operands read over Dh (row kernel: K and V; column kernel: q and dO);
// the products into Dh (dQ, dK, dV) take nine n8 tiles, in pairs by
// ldmatrix.x4.trans over a loop of constant trip count and the ninth alone by
// ldmatrix.x2.trans. Rows of 88 elements (176 B, an odd count of 16-byte
// units): 45,056 B a row-kernel block, 46,592 B a column-kernel block. The
// fp32 kernel's threads own three column pairs of dK and dV (two at 64) and
// lanes 0-3 a second pair of dQ, each only inside Dh; its rows of Dh + 2 cap
// fp32 N at 148 (164 at Dh 64). Past that the fp32 streaming instance
// (namespace stream, after tc) takes over.

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
// Dh^-1/2 is 2^-3: q * s_q is exact in bf16, and the column kernel may
// scale S^T and dK instead of q.
constexpr bool kPow2Scale = kD == 64;
// The scalar fp32 kernel.
constexpr int kTQ = 32;          // query rows per tile
constexpr int kThreads = 256;
constexpr int kKS = kD + 2;      // smem row stride of K and V (elements)
constexpr int kAS = kD + 2;      // smem row stride of the fp32 rows of
                                 // dK, dV, the q tile and the dO tile
constexpr int kCT = 3;           // key columns per thread in one chunk
constexpr int kChunk = 16 * kCT; // key columns per chunk (two chunks at once)
constexpr int kJR = 4;           // key rows per thread in the dK/dV update
constexpr int kCP = (kD / 2 + 15) / 16;  // column pairs of dK (dV) a thread owns
constexpr int kQP = (kD / 2 + 31) / 32;  // column pairs of dQ a lane owns

// Whether column-pair group cg owns its p-th pair of dK and dV (dims
// 2 (cg + 16 p)).
__device__ __forceinline__ bool owns_pair(int cg, int p) {
  return kD / 2 % 16 == 0 || cg + 16 * p < kD / 2;
}
// Whether lane l owns its p-th pair of dQ (dims 2 (l + 32 p)).
__device__ __forceinline__ bool owns_dq_pair(int lane, int p) {
  return kD / 2 % 32 == 0 || lane + 32 * p < kD / 2;
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

size_t smem_bytes(int n, size_t elem) {
  return 2 * (size_t)n * kKS * elem                   // K, V
         + 2 * (size_t)n * kAS * sizeof(float)        // dK, dV accumulators
         + 2 * (size_t)kTQ * kAS * sizeof(float)      // q tile, dO tile
         + 2 * (size_t)kTQ * (n + 1) * sizeof(float); // P rows, dP/dS rows
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     T* __restrict__ dq, T* __restrict__ dk,
                     T* __restrict__ dv,
                     long long in_sb, long long in_sh, long long in_sn,
                     long long do_sb, long long do_sh, long long do_sn,
                     long long out_sb, long long out_sh, long long out_sn,
                     int n, float scale, float dq_scale) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                          // [n][kKS]
  T* vs = ks + (size_t)n * kKS;                                // [n][kKS]
  float* dks = reinterpret_cast<float*>(vs + (size_t)n * kKS); // [n][kAS]
  float* dvs = dks + (size_t)n * kAS;                          // [n][kAS]
  float* qs = dvs + (size_t)n * kAS;                           // [kTQ][kAS]
  float* dos = qs + kTQ * kAS;                                 // [kTQ][kAS]
  float* ps = dos + kTQ * kAS;                                 // [kTQ][n + 1]
  float* dss = ps + kTQ * (n + 1);                             // [kTQ][n + 1]
  const int sst = n + 1;

  const int tid = threadIdx.x;
  const long long in_base = blockIdx.y * in_sb + blockIdx.x * in_sh;
  const long long do_base = blockIdx.y * do_sb + blockIdx.x * do_sh;
  const long long out_base = blockIdx.y * out_sb + blockIdx.x * out_sh;
  const T* qg = q + in_base;
  const T* dog = dout + do_base;

  // Stage K and V of this (batch, head); zero the dK and dV accumulators.
  for (int i = tid; i < n * (kD / 2); i += kThreads) {
    const int j = i / (kD / 2), c = (i % (kD / 2)) * 2;
    *reinterpret_cast<T2*>(ks + j * kKS + c) =
        *reinterpret_cast<const T2*>(k + in_base + j * in_sn + c);
    *reinterpret_cast<T2*>(vs + j * kKS + c) =
        *reinterpret_cast<const T2*>(v + in_base + j * in_sn + c);
    store_pair(dks + j * kAS + c, 0.f, 0.f);
    store_pair(dvs + j * kAS + c, 0.f, 0.f);
  }

  const int warp = tid / 32, lane = tid % 32;
  // S/dP phase: two halves of 128 threads take alternate column chunks;
  // a thread owns rows rg*4.. and columns cg + 16c of a chunk.
  const int half = tid / 128;
  const int rg = (tid % 128) / 16, cg = tid % 16;
  // dK/dV phase: a thread owns key rows jg + 16r (r < kJR) of a 64-row
  // chunk and the head-dim column pairs 2 (dg + 16 p), p < kCP, inside Dh
  // (Dh 64: 2dg, 2dg+1, 2dg+32, 2dg+33).
  const int jg = tid / 16, dg = tid % 16;

  for (int q0 = 0; q0 < n; q0 += kTQ) {
    const int rows = min(kTQ, n - q0);
    __syncthreads();  // staging done; the previous tile's readers done

    // The tile's scaled q (rounded to T) and dO, fp32; rows past n are 0.
    for (int i = tid; i < kTQ * (kD / 2); i += kThreads) {
      const int r = i / (kD / 2), c = (i % (kD / 2)) * 2;
      float2 x = make_float2(0.f, 0.f), g = make_float2(0.f, 0.f);
      if (r < rows) {
        x = to_float2(*reinterpret_cast<const T2*>(qg + (q0 + r) * in_sn + c));
        g = to_float2(*reinterpret_cast<const T2*>(dog + (q0 + r) * do_sn + c));
      }
      qs[r * kAS + c] = round_as(x.x * scale, q);
      qs[r * kAS + c + 1] = round_as(x.y * scale, q);
      dos[r * kAS + c] = g.x;
      dos[r * kAS + c + 1] = g.y;
    }
    __syncthreads();

    // S = (q * scale) K^T and dP = dO V^T, fp32.
    for (int c0 = half * kChunk; c0 < n; c0 += 2 * kChunk) {
      float as[4][kCT], ap[4][kCT];
      int kj[kCT];
#pragma unroll
      for (int c = 0; c < kCT; ++c) {
        kj[c] = min(c0 + cg + 16 * c, n - 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) as[i][c] = ap[i][c] = 0.f;
      }
#pragma unroll 2
      for (int d = 0; d < kD; d += 2) {
        float2 kv[kCT], vv[kCT];
#pragma unroll
        for (int c = 0; c < kCT; ++c) {
          kv[c] = to_float2(*reinterpret_cast<const T2*>(ks + kj[c] * kKS + d));
          vv[c] = to_float2(*reinterpret_cast<const T2*>(vs + kj[c] * kKS + d));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 qv =
              *reinterpret_cast<const float2*>(qs + (rg * 4 + i) * kAS + d);
          const float2 gv =
              *reinterpret_cast<const float2*>(dos + (rg * 4 + i) * kAS + d);
#pragma unroll
          for (int c = 0; c < kCT; ++c) {
            as[i][c] = fmaf(qv.x, kv[c].x, as[i][c]);
            as[i][c] = fmaf(qv.y, kv[c].y, as[i][c]);
            ap[i][c] = fmaf(gv.x, vv[c].x, ap[i][c]);
            ap[i][c] = fmaf(gv.y, vv[c].y, ap[i][c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCT; ++c) {
        const int j = c0 + cg + 16 * c;
        if (j < n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ps[(rg * 4 + i) * sst + j] = as[i][c];
            dss[(rg * 4 + i) * sst + j] = ap[i][c];
          }
        }
      }
    }
    __syncthreads();

    // Softmax over whole rows in fp32, then dS = P (dP - rowsum(dP P))
    // with that fp32 P, rounded to the q type. One warp per row.
    for (int r = warp * (kTQ / 8); r < (warp + 1) * (kTQ / 8); ++r) {
      float* prow = ps + r * sst;
      float* drow = dss + r * sst;
      float m = -INFINITY;
      for (int j = lane; j < n; j += 32) m = fmaxf(m, prow[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(prow[j] - m);
        prow[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      float dot = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = prow[j] / sum;
        prow[j] = p;
        dot += drow[j] * p;
      }
      dot = warp_sum(dot);
      for (int j = lane; j < n; j += 32)
        drow[j] = round_as(prow[j] * (drow[j] - dot), q);
    }
    __syncthreads();

    // dQ = dS K * dq_scale for the tile's rows; warp w owns rows 4w.. and
    // lane l the column pairs 2 (l + 32 p), p < kQP, inside Dh (Dh 64:
    // columns 2l, 2l+1).
    {
      float acc[4][2 * kQP];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 2 * kQP; ++c) acc[i][c] = 0.f;
      for (int j = 0; j < n; ++j) {
        float2 kv[kQP];
#pragma unroll
        for (int p = 0; p < kQP; ++p)
          kv[p] = owns_dq_pair(lane, p)
                      ? to_float2(*reinterpret_cast<const T2*>(ks + j * kKS + 2 * (lane + 32 * p)))
                      : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = dss[(warp * 4 + i) * sst + j];
#pragma unroll
          for (int p = 0; p < kQP; ++p) {
            acc[i][2 * p] = fmaf(s, kv[p].x, acc[i][2 * p]);
            acc[i][2 * p + 1] = fmaf(s, kv[p].y, acc[i][2 * p + 1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp * 4 + i;
        if (r < rows) {
#pragma unroll
          for (int p = 0; p < kQP; ++p)
            if (owns_dq_pair(lane, p))
              store_pair(dq + out_base + (q0 + r) * out_sn + 2 * (lane + 32 * p),
                         acc[i][2 * p] * dq_scale, acc[i][2 * p + 1] * dq_scale);
        }
      }
    }

    // dV += round(P)^T dO and dK += dS^T (q * scale) over the tile's rows.
    for (int j0 = 0; j0 < n; j0 += 16 * kJR) {
      float av[kJR][2 * kCP], ak[kJR][2 * kCP];
      int jr[kJR];
#pragma unroll
      for (int r = 0; r < kJR; ++r) {
        jr[r] = min(j0 + jg + 16 * r, n - 1);
#pragma unroll
        for (int c = 0; c < 2 * kCP; ++c) av[r][c] = ak[r][c] = 0.f;
      }
      for (int i = 0; i < rows; ++i) {
        float2 gv[kCP], xv[kCP];
#pragma unroll
        for (int p = 0; p < kCP; ++p) {
          const int c = 2 * (dg + 16 * p);
          gv[p] = owns_pair(dg, p) ? *reinterpret_cast<const float2*>(dos + i * kAS + c)
                                   : make_float2(0.f, 0.f);
          xv[p] = owns_pair(dg, p) ? *reinterpret_cast<const float2*>(qs + i * kAS + c)
                                   : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < kJR; ++r) {
          const float p = round_as(ps[i * sst + jr[r]], v);
          const float s = dss[i * sst + jr[r]];
#pragma unroll
          for (int c = 0; c < kCP; ++c) {
            av[r][2 * c] = fmaf(p, gv[c].x, av[r][2 * c]);
            av[r][2 * c + 1] = fmaf(p, gv[c].y, av[r][2 * c + 1]);
            ak[r][2 * c] = fmaf(s, xv[c].x, ak[r][2 * c]);
            ak[r][2 * c + 1] = fmaf(s, xv[c].y, ak[r][2 * c + 1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kJR; ++r) {
        const int j = j0 + jg + 16 * r;
        if (j < n) {
#pragma unroll
          for (int p = 0; p < kCP; ++p)
            if (owns_pair(dg, p)) {
              float* a = dvs + j * kAS + 2 * (dg + 16 * p);
              a[0] += av[r][2 * p];
              a[1] += av[r][2 * p + 1];
              float* b = dks + j * kAS + 2 * (dg + 16 * p);
              b[0] += ak[r][2 * p];
              b[1] += ak[r][2 * p + 1];
            }
        }
      }
    }
  }
  __syncthreads();

  // dK and dV out, in the input type.
  for (int i = tid; i < n * (kD / 2); i += kThreads) {
    const int j = i / (kD / 2), c = (i % (kD / 2)) * 2;
    store_pair(dk + out_base + j * out_sn + c, dks[j * kAS + c], dks[j * kAS + c + 1]);
    store_pair(dv + out_base + j * out_sn + c, dvs[j * kAS + c], dvs[j * kAS + c + 1]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv,
           long long in_sb, long long in_sh, long long in_sn,
           long long do_sb, long long do_sh, long long do_sn,
           long long out_sb, long long out_sh, long long out_sn,
           int b, int h, int n, float scale, float dq_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(h, b);
  attention_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      in_sb, in_sh, in_sn, do_sb, do_sh, do_sn, out_sb, out_sh, out_sn, n,
      scale, dq_scale);
  return (int)cudaGetLastError();
}

// The bf16 design on the tensor cores (see the head of this file).
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;             // rows of a chunk in the ring
// smem row stride (elements), an odd count of 16-byte units: 144 B at Dh
// 64, 176 B at 72.
constexpr int kRow = kD / 8 % 2 == 0 ? kD + 8 : kD + 16;
constexpr int kStage = kRows * kRow;  // elements of one chunk of one tensor
constexpr int kC8 = kD / 8;           // 16-byte pieces of a row
// k16 steps over Dh (S and dP); the last one's dims past kD are zero.
constexpr int kK16 = (kD + 15) / 16;
static_assert(kK16 * 16 - kD <= 8 && kK16 * 16 <= kRow, "one zero piece a row pads Dh");
constexpr int kRowWarps = 4;          // row kernel: 16 query rows each
constexpr int kColWarps = 4;          // column kernel: 16 key rows each
constexpr int kRowBlock = 32 * kRowWarps;
constexpr int kColBlock = 32 * kColWarps;
constexpr float kLog2e = 1.4426950408889634f;
// Row kernel: K and V, two stages each: 36,864 B at every N (Dh 64),
// 45,056 B (72).
constexpr size_t kRowSmemBytes = 4 * (size_t)kStage * sizeof(bf16);
// Column kernel: q and dO, two stages each, and each stage's rows' m
// log2(e), 1 / l and delta (fp32): 38,400 B at every N (Dh 64), 46,592 B
// (72).
constexpr size_t kColSmemBytes =
    2 * (2 * (size_t)kStage * sizeof(bf16) + 3 * (size_t)kRows * sizeof(float));
static_assert(kRowSmemBytes <= 48 * 1024 && kColSmemBytes <= 48 * 1024,
              "launched without opting into more shared memory");
// Blocks an SM: the flash backward's bounds (flash_bwd.cu), whose
// spill-free alternatives were slower on an H100 (PERF.md §6).
constexpr int kRowMinBlocks = 4;
constexpr int kColMinBlocks = 3;

// Element strides of the (B, H, N, Dh) operands.
struct Strides {
  long long in_sb, in_sh, in_sn;    // q, k, v
  long long do_sb, do_sh, do_sn;    // dO
  long long out_sb, out_sh, out_sn; // dq, dk, dv
};

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

// B operands of two n-tiles (n0.., n0 + 8..) x k16, from B^T as [n][kRow]:
// r[0], r[1] the first tile's, r[2], r[3] the second's.
__device__ __forceinline__ void load_b(unsigned (&r)[4], const bf16* base, int n0, int k0,
                                       int lane) {
  ldsm_x4(r, base + (n0 + lane % 8 + (lane / 16) * 8) * kRow + k0 + ((lane / 8) % 2) * 8);
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

// Rows r0.. (chunk c) of two (N, Dh) slices with row stride sa, sb into
// the ring stages a, b: the block's threads split the chunk's pieces.
template <int kBlock>
__device__ __forceinline__ void stage_chunk(bf16* a, bf16* b, const bf16* ga, const bf16* gb,
                                            long long sa, long long sb, int r0, int n,
                                            bool aligned) {
  constexpr int kPieces = kRows * kC8;
#pragma unroll
  for (int u = 0; u < (kPieces + kBlock - 1) / kBlock; ++u) {
    const int i = threadIdx.x + u * kBlock;
    if (kPieces % kBlock == 0 || i < kPieces) {
      const int r = i / kC8, col = i % kC8 * 8, row = r0 + r;
      const long long rr = min(row, n - 1);
      stage_piece(a + r * kRow + col, ga + rr * sa + col, row < n, aligned);
      stage_piece(b + r * kRow + col, gb + rr * sb + col, row < n, aligned);
    }
  }
}

// Row kernel: dQ of kRowWarps warps x 16 query rows and each row's
// statistics into the workspace ws (three (B, H, N) planes: m log2(e),
// 1 / l, delta); K and V stream through the ring twice (passes A and B).
__global__ void __launch_bounds__(kRowBlock, kRowMinBlocks)
attention_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            bf16* __restrict__ dq, float* __restrict__ ws, Strides st, int h,
                            int n, float scale, int aligned, float dq_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][kRows][kRow]
  bf16* vs = ks + 2 * kStage;                // [2][kRows][kRow]
  zero_pad(ks, 4 * kRows);                   // K and V: both are read over Dh

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);  // accumulator row, column pair
  const long long in_base = blockIdx.z * st.in_sb + blockIdx.y * st.in_sh;
  const bf16* kg = k + in_base;
  const bf16* vg = v + in_base;
  // This warp's rows: q0 + g (accumulator elements 0, 1) and q0 + g + 8 (2, 3).
  const int q0 = (blockIdx.x * kRowWarps + warp) * 16;
  const bool active = q0 < n;  // warp-uniform; idle warps still stage K and V

  // q * scale (rounded) and dO as A operands.
  unsigned qa[kK16][4], da[kK16][4];
  load_a(qa, q + in_base, st.in_sn, q0, n, scale, lane);
  load_a(da, dout + blockIdx.z * st.do_sb + blockIdx.y * st.do_sh, st.do_sn, q0, n, 1.f, lane);

  // Step s stages key chunk s % nc of K and V into stage s % 2 of the
  // ring: pass A takes steps 0..nc-1, pass B nc..2nc-1.
  const int nc = (n + kRows - 1) / kRows, steps = 2 * nc;
  auto issue = [&](int step) {
    const int stg = step % 2;
    stage_chunk<kRowBlock>(ks + stg * kStage, vs + stg * kStage, kg, vg, st.in_sn, st.in_sn,
                           step % nc * kRows, n, aligned);
    cp_async_commit();
  };
  // Issue the next step's copies, then wait for this step's.
  auto advance = [&](int step) {
    if (step + 1 < steps) {
      issue(step + 1);  // into the stage the previous step read
    } else {
      cp_async_commit();  // an empty group, so one wait fits every step
    }
    cp_async_wait_one();
    __syncthreads();
  };
  // S and dP of 16 rows x 16 keys (keys 16 u.. of the chunk), two n-tiles each.
  auto products = [&](const bf16* kst, const bf16* vst, int u, float (&s)[2][4],
                      float (&dp)[2][4]) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK16; ++kk) {
      unsigned b[4];
      load_b(b, kst, 16 * u, kk * 16, lane);
      mma(s[0], qa[kk], b[0], b[1]);
      mma(s[1], qa[kk], b[2], b[3]);
      load_b(b, vst, 16 * u, kk * 16, lane);
      mma(dp[0], da[kk], b[0], b[1]);
      mma(dp[1], da[kk], b[2], b[3]);
    }
  };

  // Pass A: the row max m; l = sum exp(S - m) and t = sum exp(S - m) dP,
  // this thread's shares, rescaled whenever m grows.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
  issue(0);
  for (int c = 0; c < nc; ++c) {
    advance(c);
    const int j0 = c * kRows;
    const int groups = min(kRows / 16, (n - j0 + 15) / 16);  // 16-key groups with a key < n
    const bf16* kst = ks + c % 2 * kStage;
    const bf16* vst = vs + c % 2 * kStage;
    if (active) {
      // S of the chunk (n-tile j: keys 8 j..); groups past n stay 0, masked below.
      float s[kRows / 8][4];
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK16; ++kk)
#pragma unroll
        for (int u = 0; u < kRows / 16; ++u)
          if (u < groups) {
            unsigned b[4];
            load_b(b, kst, 16 * u, kk * 16, lane);
            mma(s[2 * u], qa[kk], b[0], b[1]);
            mma(s[2 * u + 1], qa[kk], b[2], b[3]);
          }
      float ml[2];  // the new max, times log2(e)
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
        const float mn = fmaxf(m[half], bm);
        ml[half] = mn * kLog2e;
        const float alpha = exp2f(fmaf(m[half], kLog2e, -ml[half]));  // 0 at the first chunk
        l[half] *= alpha;
        t[half] *= alpha;
        m[half] = mn;
      }
#pragma unroll
      for (int u = 0; u < kRows / 16; ++u) {
        if (u >= groups) break;
        float dp[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kK16; ++kk) {
          unsigned b[4];
          load_b(b, vst, 16 * u, kk * 16, lane);
          mma(dp[0], da[kk], b[0], b[1]);
          mma(dp[1], da[kk], b[2], b[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = exp2f(fmaf(s[2 * u + j][e], kLog2e, -ml[e / 2]));
            l[e / 2] += x;
            t[e / 2] = fmaf(x, dp[j][e], t[e / 2]);
          }
      }
    }
    __syncthreads();  // the next step's copies overwrite this stage
  }

  // The rows' statistics over the quad: m log2(e), 1 / l, delta = t / l.
  const long long plane = (long long)gridDim.z * h * n;
  float* wg = ws + ((long long)blockIdx.z * h + blockIdx.y) * n;
  float m2[2], il[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sl = l[half], stt = t[half];
    sl += __shfl_xor_sync(0xffffffffu, sl, 1);
    sl += __shfl_xor_sync(0xffffffffu, sl, 2);
    stt += __shfl_xor_sync(0xffffffffu, stt, 1);
    stt += __shfl_xor_sync(0xffffffffu, stt, 2);
    m2[half] = m[half] * kLog2e;
    il[half] = 1.f / sl;
    delta[half] = stt / sl;
    const int row = q0 + g + half * 8;
    if (t2 == 0 && row < n) {
      wg[row] = m2[half];
      wg[plane + row] = il[half];
      wg[2 * plane + row] = delta[half];
    }
  }

  // Pass B: dQ += dS K, dS = P (dP - delta) rounded, P = exp(S - m) (1 / l).
  float acc[kD / 8][4];  // dQ / dq_scale: n-tile j holds dims 8 j..
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
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
        // dS, rounded; two n-tiles are one A operand (16 rows x 16 keys).
        unsigned dsa[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float x[2];
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const float p = j0 + 16 * u + 8 * j + t2 + cc < n
                                  ? exp2f(fmaf(s[j][2 * half + cc], kLog2e, -m2[half])) *
                                        il[half]
                                  : 0.f;
              x[cc] = p * (dp[j][2 * half + cc] - delta[half]);
            }
            dsa[2 * j + half] = pack(x[0], x[1]);
          }
        // dQ += dS K: K as [key][dim] is B (k = key, n = dim) through .trans.
        // Pairs of n8 tiles over Dh, a constant trip count: a loop on
        // j + 1 < kD / 8 put K1's accumulators in local memory at Dh 72.
#pragma unroll
        for (int j = 0; j < kD / 16 * 2; j += 2) {
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
    __syncthreads();  // the next step's copies overwrite this stage
  }

  bf16* dqg = dq + blockIdx.z * st.out_sb + blockIdx.y * st.out_sh;
  // At Dh 64 s_q and the fp32 Dh^-1/2 are both 2^-3.
  const float dqs = kPow2Scale ? scale : dq_scale;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + g + half * 8;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqg + r * st.out_sn + j * 8 + t2) =
          __floats2bfloat162_rn(acc[j][2 * half] * dqs, acc[j][2 * half + 1] * dqs);
  }
}

// Column kernel: dK and dV of kColWarps warps x 16 key rows; q, dO and the
// rows' statistics from the row kernel stream through the ring.
__global__ void __launch_bounds__(kColBlock, kColMinBlocks)
attention_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ ws, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, Strides st, int h, int n, float scale,
                             int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);                   // [2][kRows][kRow]
  bf16* dos = qs + 2 * kStage;                                // [2][kRows][kRow]
  float* stats = reinterpret_cast<float*>(dos + 2 * kStage);  // [2][3][kRows]
  zero_pad(qs, 4 * kRows);                                    // q and dO: read over Dh

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);  // accumulator row (key), column pair
  const long long in_base = blockIdx.z * st.in_sb + blockIdx.y * st.in_sh;
  const bf16* qg = q + in_base;
  const bf16* dog = dout + blockIdx.z * st.do_sb + blockIdx.y * st.do_sh;
  const long long plane = (long long)gridDim.z * h * n;
  const float* wg = ws + ((long long)blockIdx.z * h + blockIdx.y) * n;
  // This warp's key rows: k0 + g (accumulator elements 0, 1) and k0 + g + 8 (2, 3).
  const int k0 = (blockIdx.x * kColWarps + warp) * 16;
  const bool active = k0 < n;  // warp-uniform; idle warps still stage the ring

  unsigned ka[kK16][4], va[kK16][4];
  load_a(ka, k + in_base, st.in_sn, k0, n, 1.f, lane);
  load_a(va, v + in_base, st.in_sn, k0, n, 1.f, lane);
  // S^T = scale (K q^T), exact where scale = 2^-3; else S^T = K qs^T, the
  // ring's q scaled in place.
  const float sl2e = kPow2Scale ? scale * kLog2e : kLog2e;

  // Chunk c of q, dO and the rows' three statistics into stage c % 2 of the
  // ring; rows past n get m = +inf and 1 / l = delta = 0 (P = 0 there).
  const int nc = (n + kRows - 1) / kRows;
  auto issue = [&](int c) {
    const int stg = c % 2;
    stage_chunk<kColBlock>(qs + stg * kStage, dos + stg * kStage, qg, dog, st.in_sn, st.do_sn,
                           c * kRows, n, aligned);
    for (int i = tid; i < 3 * kRows; i += kColBlock) {
      const int which = i / kRows, row = c * kRows + i % kRows;
      float* dst = stats + stg * 3 * kRows + i;
      if (row < n) {
        cp_async4(dst, wg + which * plane + row);
      } else {
        *dst = which == 0 ? INFINITY : 0.f;
      }
    }
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
    if (!kPow2Scale) {
      // qs = q * scale rounded to bf16, in place (rows past n stay 0).
      bf16* qw = qs + stg * kStage;
      for (int i = tid; i < kRows * kD / 2; i += kColBlock) {
        __nv_bfloat162* x =
            reinterpret_cast<__nv_bfloat162*>(qw + i / (kD / 2) * kRow + i % (kD / 2) * 2);
        const float2 f = __bfloat1622float2(*x);
        *x = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      __syncthreads();
    }
    const bf16* qst = qs + stg * kStage;
    const bf16* dost = dos + stg * kStage;
    const float* ms = stats + stg * 3 * kRows;  // m log2(e), then 1 / l, then delta
    const int groups = min(kRows / 16, (n - c0 + 15) / 16);  // 16-query groups with a row < n
    if (active) {
#pragma unroll
      for (int u = 0; u < kRows / 16; ++u) {
        if (u >= groups) break;
        // S^T and dP^T of 16 keys x 16 queries (two n-tiles each).
        float s[2][4], dp[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kK16; ++kk) {
          unsigned b[4];
          load_b(b, qst, 16 * u, kk * 16, lane);
          mma(s[0], ka[kk], b[0], b[1]);
          mma(s[1], ka[kk], b[2], b[3]);
          load_b(b, dost, 16 * u, kk * 16, lane);
          mma(dp[0], va[kk], b[0], b[1]);
          mma(dp[1], va[kk], b[2], b[3]);
        }
        // P^T and dS^T = P^T (dP^T - delta), rounded; two n-tiles are one A
        // operand (16 keys x 16 queries).
        unsigned pa[4], dsa[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qi = 16 * u + 8 * j + t2;
          const float2 m2 = *reinterpret_cast<const float2*>(ms + qi);
          const float2 il = *reinterpret_cast<const float2*>(ms + kRows + qi);
          const float2 de = *reinterpret_cast<const float2*>(ms + 2 * kRows + qi);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float p0 = exp2f(fmaf(s[j][2 * half], sl2e, -m2.x)) * il.x;
            const float p1 = exp2f(fmaf(s[j][2 * half + 1], sl2e, -m2.y)) * il.y;
            pa[2 * j + half] = pack(p0, p1);
            dsa[2 * j + half] =
                pack(p0 * (dp[j][2 * half] - de.x), p1 * (dp[j][2 * half + 1] - de.y));
          }
        }
        // dV += round(P^T) dO, dK += dS^T q: dO and q as [query][dim] are B
        // (k = query, n = dim) through .trans. Pairs of n8 tiles over Dh, a
        // constant trip count (see the row kernel).
#pragma unroll
        for (int j = 0; j < kD / 16 * 2; j += 2) {
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

// cp.async copies 16 bytes: the rows of q, k, v and dO must start on 16
// bytes, else the ring is staged by 4-byte loads.
bool aligned16(const void* q, const void* k, const void* v, const void* dout,
               const Strides& st) {
  return (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0 &&
         (st.in_sb | st.in_sh | st.in_sn | st.do_sb | st.do_sh | st.do_sn) % 8 == 0;
}

// The row kernel, then the column kernel, on one stream.
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, float* ws, const Strides& st, int b, int h, int n, float scale,
           float dq_scale, cudaStream_t stream) {
  const int al = aligned16(q, k, v, dout, st) ? 1 : 0;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* dob = static_cast<const bf16*>(dout);
  const dim3 rows((n + 16 * kRowWarps - 1) / (16 * kRowWarps), h, b);
  attention_bwd_dq_mma_kernel<<<rows, kRowBlock, kRowSmemBytes, stream>>>(
      qb, kb, vb, dob, static_cast<bf16*>(dq), ws, st, h, n, scale, al, dq_scale);
  if (const cudaError_t err = cudaGetLastError()) return (int)err;
  const dim3 cols((n + 16 * kColWarps - 1) / (16 * kColWarps), h, b);
  attention_bwd_dkv_mma_kernel<<<cols, kColBlock, kColSmemBytes, stream>>>(
      qb, kb, vb, dob, ws, static_cast<bf16*>(dk), static_cast<bf16*>(dv), st, h, n, scale,
      al);
  return (int)cudaGetLastError();
}

}  // namespace tc

// The fp32 streaming instance (namespace stream): what the scalar kernel
// computes, at every N, split as the bf16 design is split, with scalar fp32
// FMAs (mma.sync takes fp32 only as TF32) and nothing in shared memory that
// grows with N. One call is two kernels joined by the same fp32 (3, B, H,
// N) workspace, here each row's m, l and delta.
// - Row kernel: one block per (batch, head, 32 queries), 128 threads. The
//   tile's q * scale and dO sit in shared memory; K and V stream through in
//   chunks of 64 keys (rows of Dh + 2 floats). Pass A: S = qs K^T (keys past
//   N at -inf) and dP = dO V^T; the row max m, l = sum exp(S - m) and t =
//   sum exp(S - m) dP online (l and t rescaled by exp(m_old - m_new)), so
//   delta = t / l = rowsum(dP * P). Pass B: S and dP again, P = exp(S - m) /
//   l, dS = P (dP - delta) through a 32 x 64 chunk of shared memory, dQ +=
//   dS K in registers, times the fp32 dq_scale at the store. 59,008 B a
//   block at Dh 64, 65,152 B at 72.
// - Column kernel: one block per (batch, head, 32 keys), 128 threads, its K
//   and V rows staged once. q * scale, dO and the rows' statistics stream
//   through in chunks of 32 queries: S^T and dP^T (the row kernel's FMAs in
//   its order, so P has its bits), P and dS through two 32 x 32 chunks of
//   shared memory, and dV += P^T dO, dK += dS^T qs in registers. 42,624 B a
//   block at Dh 64, 46,720 B at 72.
// A thread owns 4 rows (keys) x 4 (2) columns of each product chunk and
// its rows' column pairs of the outputs, as the scalar kernel's threads do.
// Each output element has one owning accumulator and the chunks run in a
// fixed order: two calls are bit-equal.
namespace stream {

constexpr int kTQ = 32;             // query rows a row-kernel block, a column-kernel chunk
constexpr int kKB = 64;             // keys a row-kernel chunk
constexpr int kTK = 32;             // keys a column-kernel block
constexpr int kThreads = 128;       // 8 row groups x 16 column groups
constexpr int kS = kD + 2;          // smem row stride (floats) of q, dO, K and V
constexpr int kPS = kKB + 1;        // row kernel: row stride of the dS chunk
constexpr int kCS = kTQ + 1;        // column kernel: row stride of the P and dS chunks
constexpr int kCols = kKB / 16;     // row kernel: keys of a chunk a thread owns
constexpr int kQCols = kTQ / 16;    // column kernel: queries of a chunk a thread owns
constexpr size_t kRowSmemBytes =
    (2 * (size_t)kTQ * kS + 2 * (size_t)kKB * kS + (size_t)kTQ * kPS) * sizeof(float);
constexpr size_t kColSmemBytes =
    (2 * (size_t)kTK * kS + 2 * (size_t)kTQ * kS + 3 * kTQ + 2 * (size_t)kTK * kCS) *
    sizeof(float);

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

// a . b over Dh, in pairs of dims: the one order both kernels use.
__device__ __forceinline__ float dot_pairs(const float* a, const float* b, float acc,
                                           int d) {
  const float2 x = *reinterpret_cast<const float2*>(a + d);
  const float2 y = *reinterpret_cast<const float2*>(b + d);
  return fmaf(x.y, y.y, fmaf(x.x, y.x, acc));
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

// s = qs K^T and dp = dO V^T for rows rg 4 + i and keys cg + 16 c of a chunk.
__device__ __forceinline__ void row_products(float (&s)[4][kCols], float (&dp)[4][kCols],
                                             const float* qs, const float* dos,
                                             const float* ks, const float* vs, int rg,
                                             int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kD; d += 2)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = cg + 16 * c;
        s[i][c] = dot_pairs(qs + (rg * 4 + i) * kS, ks + j * kS, s[i][c], d);
        dp[i][c] = dot_pairs(dos + (rg * 4 + i) * kS, vs + j * kS, dp[i][c], d);
      }
}

__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_streaming_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ dout,
                                  float* __restrict__ dq, float* __restrict__ ws,
                                  long long in_sb, long long in_sh, long long in_sn,
                                  long long do_sb, long long do_sh, long long do_sn,
                                  long long out_sb, long long out_sh, long long out_sn,
                                  int hn, int n, float scale, float dq_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kTQ][kS]
  float* dos = qs + kTQ * kS;                  // [kTQ][kS]
  float* ks = dos + kTQ * kS;                  // [kKB][kS]
  float* vs = ks + kKB * kS;                   // [kKB][kS]
  float* dss = vs + kKB * kS;                  // [kTQ][kPS]

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int q0 = blockIdx.x * kTQ;
  const long long in_base = blockIdx.z * in_sb + blockIdx.y * in_sh;
  stage(qs, q + in_base, in_sn, q0, kTQ, n, scale);
  stage(dos, dout + blockIdx.z * do_sb + blockIdx.y * do_sh, do_sn, q0, kTQ, n, 1.f);

  float m[4], l[4], t[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = t[i] = 0.f;
  float s[4][kCols], dp[4][kCols];
  // Pass A: m, l and t, online.
  for (int j0 = 0; j0 < n; j0 += kKB) {
    __syncthreads();
    stage(ks, k + in_base, in_sn, j0, kKB, n, 1.f);
    stage(vs, v + in_base, in_sn, j0, kKB, n, 1.f);
    __syncthreads();
    row_products(s, dp, qs, dos, ks, vs, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float bm = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (j0 + cg + 16 * c >= n) s[i][c] = -INFINITY, dp[i][c] = 0.f;
        bm = fmaxf(bm, s[i][c]);
      }
      const float mn = fmaxf(m[i], group_max(bm));
      float pl = 0.f, pt = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float e = expf(s[i][c] - mn);
        pl += e;
        pt = fmaf(e, dp[i][c], pt);
      }
      const float r = expf(m[i] - mn);
      l[i] = l[i] * r + group_sum(pl);
      t[i] = t[i] * r + group_sum(pt);
      m[i] = mn;
    }
  }
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) delta[i] = t[i] / l[i];

  // Pass B: dS = P (dP - delta) and dQ += dS K.
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
    row_products(s, dp, qs, dos, ks, vs, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        dss[(rg * 4 + i) * kPS + cg + 16 * c] =
            j0 + cg + 16 * c < n ? expf(s[i][c] - m[i]) / l[i] * (dp[i][c] - delta[i]) : 0.f;
    __syncthreads();
    const int keys = min(kKB, n - j0);
    for (int j = 0; j < keys; ++j) {
      float2 kv[kCP];
#pragma unroll
      for (int p = 0; p < kCP; ++p)
        kv[p] = owns_pair(cg, p)
                    ? *reinterpret_cast<const float2*>(ks + j * kS + 2 * (cg + 16 * p))
                    : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dss[(rg * 4 + i) * kPS + j];
#pragma unroll
        for (int p = 0; p < kCP; ++p) {
          acc[i][2 * p] = fmaf(ds, kv[p].x, acc[i][2 * p]);
          acc[i][2 * p + 1] = fmaf(ds, kv[p].y, acc[i][2 * p + 1]);
        }
      }
    }
  }
  const long long out_base = blockIdx.z * out_sb + blockIdx.y * out_sh;
  const long long plane = (long long)gridDim.z * hn;  // B H N
  const long long row0 = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r < n) {
#pragma unroll
      for (int p = 0; p < kCP; ++p)
        if (owns_pair(cg, p))
          store_pair(dq + out_base + r * out_sn + 2 * (cg + 16 * p), acc[i][2 * p] * dq_scale,
                     acc[i][2 * p + 1] * dq_scale);
      if (cg == 0) {
        ws[row0 + r] = m[i];
        ws[plane + row0 + r] = l[i];
        ws[2 * plane + row0 + r] = delta[i];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_streaming_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   const float* __restrict__ dout,
                                   const float* __restrict__ ws, float* __restrict__ dk,
                                   float* __restrict__ dv, long long in_sb, long long in_sh,
                                   long long in_sn, long long do_sb, long long do_sh,
                                   long long do_sn, long long out_sb, long long out_sh,
                                   long long out_sn, int hn, int n, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [kTK][kS]
  float* vs = ks + kTK * kS;                   // [kTK][kS]
  float* qs = vs + kTK * kS;                   // [kTQ][kS]
  float* dos = qs + kTQ * kS;                  // [kTQ][kS]
  float* st = dos + kTQ * kS;                  // [3][kTQ]: m, l, delta
  float* ps = st + 3 * kTQ;                    // [kTK][kCS]
  float* dss = ps + kTK * kCS;                 // [kTK][kCS]

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int j0 = blockIdx.x * kTK;
  const long long in_base = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const float* dog = dout + blockIdx.z * do_sb + blockIdx.y * do_sh;
  const long long plane = (long long)gridDim.z * hn;
  const float* wsr = ws + ((long long)blockIdx.z * gridDim.y + blockIdx.y) * n;
  stage(ks, k + in_base, in_sn, j0, kTK, n, 1.f);
  stage(vs, v + in_base, in_sn, j0, kTK, n, 1.f);

  float av[4][2 * kCP], ak[4][2 * kCP];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 2 * kCP; ++c) av[r][c] = ak[r][c] = 0.f;
  for (int q0 = 0; q0 < n; q0 += kTQ) {
    __syncthreads();  // K, V staged; the previous chunk's readers done
    stage(qs, q + in_base, in_sn, q0, kTQ, n, scale);
    stage(dos, dog, do_sn, q0, kTQ, n, 1.f);
    if (tid < kTQ) {
      const bool in = q0 + tid < n;
      st[tid] = in ? wsr[q0 + tid] : 0.f;
      st[kTQ + tid] = in ? wsr[plane + q0 + tid] : 1.f;
      st[2 * kTQ + tid] = in ? wsr[2 * plane + q0 + tid] : 0.f;
    }
    __syncthreads();
    // S^T and dP^T for keys rg 4 + r and queries cg + 16 c, each dot in the
    // row kernel's order (q, dO first).
    float s[4][kQCols], dp[4][kQCols];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kQCols; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kD; d += 2)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kQCols; ++c) {
          const int i = cg + 16 * c;
          s[r][c] = dot_pairs(qs + i * kS, ks + (rg * 4 + r) * kS, s[r][c], d);
          dp[r][c] = dot_pairs(dos + i * kS, vs + (rg * 4 + r) * kS, dp[r][c], d);
        }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kQCols; ++c) {
        const int i = cg + 16 * c;
        const float p = q0 + i < n ? expf(s[r][c] - st[i]) / st[kTQ + i] : 0.f;
        ps[(rg * 4 + r) * kCS + i] = p;
        dss[(rg * 4 + r) * kCS + i] = p * (dp[r][c] - st[2 * kTQ + i]);
      }
    __syncthreads();
    const int rows = min(kTQ, n - q0);
    for (int i = 0; i < rows; ++i) {
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
      for (int r = 0; r < 4; ++r) {
        const float p = ps[(rg * 4 + r) * kCS + i], ds = dss[(rg * 4 + r) * kCS + i];
#pragma unroll
        for (int c = 0; c < kCP; ++c) {
          av[r][2 * c] = fmaf(p, gv[c].x, av[r][2 * c]);
          av[r][2 * c + 1] = fmaf(p, gv[c].y, av[r][2 * c + 1]);
          ak[r][2 * c] = fmaf(ds, xv[c].x, ak[r][2 * c]);
          ak[r][2 * c + 1] = fmaf(ds, xv[c].y, ak[r][2 * c + 1]);
        }
      }
    }
  }
  const long long out_base = blockIdx.z * out_sb + blockIdx.y * out_sh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + rg * 4 + r;
    if (j < n) {
#pragma unroll
      for (int p = 0; p < kCP; ++p)
        if (owns_pair(cg, p)) {
          const int c = 2 * (cg + 16 * p);
          store_pair(dv + out_base + j * out_sn + c, av[r][2 * p], av[r][2 * p + 1]);
          store_pair(dk + out_base + j * out_sn + c, ak[r][2 * p], ak[r][2 * p + 1]);
        }
    }
  }
}

// The row kernel, then the column kernel, on one stream.
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, float* ws, long long in_sb, long long in_sh, long long in_sn,
           long long do_sb, long long do_sh, long long do_sn, long long out_sb,
           long long out_sh, long long out_sn, int b, int h, int n, float scale,
           float dq_scale, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_streaming_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kRowSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  const dim3 rows((n + kTQ - 1) / kTQ, h, b);
  attention_bwd_dq_streaming_kernel<<<rows, kThreads, kRowSmemBytes, stream>>>(
      qf, kf, vf, dof, static_cast<float*>(dq), ws, in_sb, in_sh, in_sn, do_sb, do_sh, do_sn,
      out_sb, out_sh, out_sn, h * n, n, scale, dq_scale);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  const dim3 cols((n + kTK - 1) / kTK, h, b);
  attention_bwd_dkv_streaming_kernel<<<cols, kThreads, kColSmemBytes, stream>>>(
      qf, kf, vf, dof, ws, static_cast<float*>(dk), static_cast<float*>(dv), in_sb, in_sh,
      in_sn, do_sb, do_sh, do_sn, out_sb, out_sh, out_sn, h * n, n, scale);
  return (int)cudaGetLastError();
}

static_assert(kColSmemBytes <= 48 * 1024, "the column kernel opts into no more shared memory");

}  // namespace stream

}  // namespace

extern "C" {

// The head dim this library was built for (HEAD_DIM).
int k2_attention_bwd_head_dim() { return kD; }

// Shared memory one block needs for sequence length n and element size.
// bf16: the larger of the two tensor-core kernels' rings (any N); fp32:
// the scalar kernel's.
size_t k2_attention_bwd_smem_bytes(int n, int elem_bytes) {
  if (elem_bytes == (int)sizeof(__nv_bfloat16))
    return tc::kRowSmemBytes > tc::kColSmemBytes ? tc::kRowSmemBytes : tc::kColSmemBytes;
  return smem_bytes(n, (size_t)elem_bytes);
}

// q, k, v share the element strides (in_sb, in_sh, in_sn), dout has its
// own (do_*), dq, dk, dv share (out_*); every last dim is contiguous and kD
// long. ws: bf16 only, a contiguous float32 (3, b, h, n) workspace the
// call overwrites (the fp32 kernel takes none). scale is q's factor s_q
// (Dh^-1/2 rounded to the input type), dq_scale dQ's, the fp32 Dh^-1/2.
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launches (0 on success).
int k2_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, void* dq, void* dk, void* dv, void* ws,
                     long long in_sb, long long in_sh, long long in_sn,
                     long long do_sb, long long do_sh, long long do_sn,
                     long long out_sb, long long out_sh, long long out_sn,
                     int b, int h, int n, float scale, float dq_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, dout, dq, dk, dv, in_sb, in_sh, in_sn,
                         do_sb, do_sh, do_sn, out_sb, out_sh, out_sn, b, h, n,
                         scale, dq_scale, s);
  if (dtype == 1) {
    const tc::Strides st{in_sb, in_sh, in_sn, do_sb, do_sh, do_sn, out_sb, out_sh, out_sn};
    return tc::launch(q, k, v, dout, dq, dk, dv, static_cast<float*>(ws), st, b, h, n, scale,
                      dq_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The fp32 streaming instance's shared memory per block, the larger of its
// two kernels' (any N).
size_t k2_attention_bwd_streaming_smem_bytes() {
  return stream::kRowSmemBytes > stream::kColSmemBytes ? stream::kRowSmemBytes
                                                       : stream::kColSmemBytes;
}

// As k2_attention_bwd, on the fp32 streaming instance, which takes every N:
// dtype must be 0 (float32), and ws is a contiguous float32 (3, b, h, n)
// workspace the call overwrites.
int k2_attention_bwd_streaming(int dtype, const void* q, const void* k, const void* v,
                               const void* dout, void* dq, void* dk, void* dv, void* ws,
                               long long in_sb, long long in_sh, long long in_sn,
                               long long do_sb, long long do_sh, long long do_sn,
                               long long out_sb, long long out_sh, long long out_sn,
                               int b, int h, int n, float scale, float dq_scale,
                               void* stream) {
  if (dtype != 0 || ws == nullptr) return (int)cudaErrorInvalidValue;
  return stream::launch(q, k, v, dout, dq, dk, dv, static_cast<float*>(ws), in_sb, in_sh,
                        in_sn, do_sb, do_sh, do_sn, out_sb, out_sh, out_sn, b, h, n, scale,
                        dq_scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
