// K3: the whole attention sublayer (qkv projection, multi-head attention,
// output projection), written for Hopper (sm_90a).
//
// Replaces jpdvt_mt_ntnu_tpu/ops/attention.py:_attn_block_kernel, the Pallas
// kernel behind fused_attention_block (model.attn_impl="block"). Same
// arithmetic and rounding points, per (item, head h):
//   q = T(x Wq_h + bq_h) * Dh^-1/2 (the scale applied in T; exact for Dh = 64),
//   k = T(x Wk_h + bk_h), v = T(x Wv_h + bv_h), products in fp32, fp32 biases;
//   S = q k^T in fp32, P = exp(S - rowmax) / rowsum in fp32, o_h = T(T(P) v);
//   out = T(sum_h o_h Wp_h + bp), the sum over heads in fp32, in head order.
// T is the input type (bf16 on the solve, fp32 in tests).
//
// Design. The TPU kernel keeps all of a program's weights (4.7 MB in bf16 at
// D = 768, H = 12) in VMEM; a Hopper block has 227 KB of shared memory, and
// the fp32 (N, D) accumulator alone is 442 KB at N = 144. So two launches:
//   A.1, grid (H, B): one block per (head, item). It projects x onto that
//     head's q, k and v by streaming 32-wide K-chunks of x and of the three
//     weight slices through shared memory, 48 rows of x at a time (6 x 6
//     fp32 accumulators a thread), and keeps q, k, v whole in shared memory
//     (3 N (Dh + 2) elements: 55 KB at N = 144, 158 KB at N = 400 in bf16).
//     Attention then runs as K1 does, on 32-row query tiles with whole fp32
//     score rows (no online softmax, so P is normalised before it is
//     rounded, as in the TPU kernel). o_h goes, in T, into a (B, N, H Dh)
//     buffer: the layout K1's output has.
//   A.2, grid (B N / 64, D / 64): out = o Wp + bp as one product over the
//     H Dh inner dimension, which runs through the heads in order; each
//     output element has one owning thread, so the sum over heads is
//     deterministic (no atomics): faithful-250 and fast solves stay bit-equal.
// The products are scalar fp32 FMAs from shared memory on register tiles, as
// in K1; tensor cores (wmma / wgmma), TMA, and a cluster of H blocks that
// reduces over heads in distributed shared memory (no bf16 o round trip)
// are work for a later change.
//
// Bound on an H100 SXM at the solve's B = 32, N = 144, D = 768, H = 12, Dh =
// 64, bf16: the products are 2 B N D 4D + 4 B H N^2 Dh = 23.8 GFLOP, 24 us at
// 989 TFLOP/s; x and out once plus the weights once are 18.9 MB, 5.6 us at
// 3.35 TB/s. So the bound is the operations. The fast solve launches this
// pair once per DiT block (12 per microbatch), faithful-250 3,000 times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr int kD = 64;          // head dim; the Python wrapper checks it
constexpr int kThreads = 256;
constexpr int kS = kD + 2;      // smem row stride of q, k, v (elements)
// A.1, the projections: 48 rows of x (8 row groups x 6) by q|k|v (192
// columns, 32 column groups x 6), over K-chunks of 32.
constexpr int kPR = 48;
constexpr int kKC = 32;
constexpr int kXS = kKC + 1;    // smem row stride of the x chunk (floats)
constexpr int kPC = 3 * kD;
// A.1, attention: 32 query rows (8 row groups x 4), key columns in chunks of
// 64 (32 column groups x 2).
constexpr int kTQ = 32;
constexpr int kCT = 2;
constexpr int kChunk = 32 * kCT;
// A.2, the output projection: 64 x 64 output tiles (16 row groups x 4 rows,
// 16 column groups x 4 columns), K-chunks of 32.
constexpr int kOM = 64;
constexpr int kON = 64;
constexpr int kOK = 32;

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };

__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// Round to T and back: the casts to the input type in the TPU kernel.
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

// A.1's shared memory: q, k, v, then one area used first by the projection's
// staged chunks and then by a query tile's fp32 score rows.
size_t smem_bytes(int n, size_t elem) {
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

  // q|k|v (n x 192) = x (n x hidden) [Wq_h | Wk_h | Wv_h], 48 rows at a time.
  for (int r0 = 0; r0 < n; r0 += kPR) {
    float acc[6][6];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) acc[i][j] = 0.f;
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
        float xv[6], wv[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) xv[i] = xs[(rg * 6 + i) * kXS + kk];
#pragma unroll
        for (int j = 0; j < 6; ++j) wv[j] = ws[kk * kPC + cg + 32 * j];
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = 0; j < 6; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
    // The fp32 bias, then T; q scaled in T.
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int r = r0 + rg * 6 + i;
      if (r < n) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const int which = j / 2, cc = cg + 32 * (j % 2);
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

    // o = P v in fp32: this thread's four rows, columns 2 cg and 2 cg + 1.
    // A warp reads only the score rows it normalised.
    float oacc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[i][0] = oacc[i][1] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float2 vv = to_float2(*reinterpret_cast<const T2*>(vs + j * kS + 2 * cg));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ss[(rg * 4 + i) * sst + j];
        oacc[i][0] = fmaf(p, vv.x, oacc[i][0]);
        oacc[i][1] = fmaf(p, vv.y, oacc[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + rg * 4 + i;
      if (r < n) store_pair(og + (long long)r * heads * kD + 2 * cg, oacc[i][0], oacc[i][1]);
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

}  // namespace

extern "C" {

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

// x (b, n, hidden); wqkv (3 heads, hidden, kD); bqkv (3 heads, kD) fp32;
// wproj (heads kD, hidden); bproj (hidden) fp32; o (b, n, heads kD) scratch;
// out (b, n, hidden); all contiguous. hidden is a multiple of 64. dtype: 0 =
// float32, 1 = bfloat16. Returns the cudaError_t of the launches (0 on
// success).
int k3_attention_block(int dtype, const void* x, const void* wqkv,
                       const void* bqkv, const void* wproj, const void* bproj,
                       void* o, void* out, int b, int n, int heads, int hidden,
                       float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, wqkv, bqkv, wproj, bproj, o, out, b, n, heads,
                         hidden, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wqkv, bqkv, wproj, bproj, o, out, b, n,
                                 heads, hidden, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
