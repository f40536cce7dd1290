// K2: whole-row multi-head attention backward, written for Hopper (sm_90a).
//
// Replaces jpdvt_mt_ntnu_tpu/ops/attention.py:_attn_bwd_kernel, the Pallas
// kernel behind the custom VJP of _attention_pallas. Same arithmetic:
// q * Dh^-1/2 rounded to the input type; S = Q K^T and the softmax P in
// fp32 (recomputed, nothing saved from the forward but q, k, v);
// dV = round(P)^T dO; dP = dO V^T; dS = P * (dP - rowsum(dP * P)) with the
// fp32 P; dS rounded to the q type; dQ = dS K * scale; dK = dS^T (q * scale).
// Every product accumulates in fp32; the outputs are stored in the input
// type. No masking, no dropout.
//
// Design. dK and dV are sums over all query rows of a (batch, head), and
// blocks run in no order, so one block owns one (batch, head) and walks its
// query rows in tiles of 32: K and V stay staged in shared memory, and the
// fp32 dK and dV accumulators live there too (at N = 144 in bf16: 2 x 19 KB
// of K/V and 2 x 38 KB of accumulators, plus the tile's q, dO and fp32
// P/dP rows, 163 KB in all). No floating-point atomics: each accumulator
// element has one owning thread, so the result is deterministic. dQ rows
// are complete within a tile and go straight to device memory. The kernel
// takes element strides, so it reads q/k/v out of the saved fused
// (B, N, 3*H*Dh) projection and dO out of the (B, N, H*Dh) upstream
// gradient, and writes dq/dk/dv into one (B, N, 3, H, Dh) gradient buffer:
// no transposes and no concatenation around it. The products are scalar
// fp32 FMAs from shared memory on small register tiles, as in K1; tensor
// cores are work for a later change.
//
// Bound on an H100 SXM at the flagship's train step, B = 96, H = 12,
// N = 144, Dh = 64, bf16: q, k, v, dO read once and dq, dk, dv written once
// is 7 * B * H * N * Dh * 2 B = 148.6 MB, 44.4 us at 3.35 TB/s; the five
// products are 10 * B * H * N^2 * Dh = 15.3 GFLOP, 15.5 us at 989 TFLOP/s
// bf16. So the bound is the memory traffic. The train step launches this
// kernel once per DiT block: 12 launches per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr int kD = 64;           // head dim; the Python wrapper checks it
constexpr int kTQ = 32;          // query rows per tile
constexpr int kThreads = 256;
constexpr int kKS = kD + 2;      // smem row stride of K and V (elements)
constexpr int kAS = kD + 2;      // smem row stride of the fp32 rows of
                                 // dK, dV, the q tile and the dO tile
constexpr int kCT = 3;           // key columns per thread in one chunk
constexpr int kChunk = 16 * kCT; // key columns per chunk (two chunks at once)
constexpr int kJR = 4;           // key rows per thread in the dK/dV update

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
                     int n, float scale) {
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
  // chunk and head-dim columns 2dg, 2dg+1, 2dg+32, 2dg+33.
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

    // dQ = dS K * scale for the tile's rows; warp w owns rows 4w.. and
    // lane l columns 2l, 2l+1.
    {
      float acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
      for (int j = 0; j < n; ++j) {
        const float2 kv = to_float2(*reinterpret_cast<const T2*>(ks + j * kKS + 2 * lane));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = dss[(warp * 4 + i) * sst + j];
          acc[i][0] = fmaf(s, kv.x, acc[i][0]);
          acc[i][1] = fmaf(s, kv.y, acc[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp * 4 + i;
        if (r < rows)
          store_pair(dq + out_base + (q0 + r) * out_sn + 2 * lane,
                     acc[i][0] * scale, acc[i][1] * scale);
      }
    }

    // dV += round(P)^T dO and dK += dS^T (q * scale) over the tile's rows.
    for (int j0 = 0; j0 < n; j0 += 16 * kJR) {
      float av[kJR][4], ak[kJR][4];
      int jr[kJR];
#pragma unroll
      for (int r = 0; r < kJR; ++r) {
        jr[r] = min(j0 + jg + 16 * r, n - 1);
#pragma unroll
        for (int c = 0; c < 4; ++c) av[r][c] = ak[r][c] = 0.f;
      }
      for (int i = 0; i < rows; ++i) {
        const float2 g0 = *reinterpret_cast<const float2*>(dos + i * kAS + 2 * dg);
        const float2 g1 =
            *reinterpret_cast<const float2*>(dos + i * kAS + 2 * dg + kD / 2);
        const float2 x0 = *reinterpret_cast<const float2*>(qs + i * kAS + 2 * dg);
        const float2 x1 =
            *reinterpret_cast<const float2*>(qs + i * kAS + 2 * dg + kD / 2);
#pragma unroll
        for (int r = 0; r < kJR; ++r) {
          const float p = round_as(ps[i * sst + jr[r]], v);
          const float s = dss[i * sst + jr[r]];
          av[r][0] = fmaf(p, g0.x, av[r][0]);
          av[r][1] = fmaf(p, g0.y, av[r][1]);
          av[r][2] = fmaf(p, g1.x, av[r][2]);
          av[r][3] = fmaf(p, g1.y, av[r][3]);
          ak[r][0] = fmaf(s, x0.x, ak[r][0]);
          ak[r][1] = fmaf(s, x0.y, ak[r][1]);
          ak[r][2] = fmaf(s, x1.x, ak[r][2]);
          ak[r][3] = fmaf(s, x1.y, ak[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kJR; ++r) {
        const int j = j0 + jg + 16 * r;
        if (j < n) {
          float* a = dvs + j * kAS + 2 * dg;
          a[0] += av[r][0];
          a[1] += av[r][1];
          a[kD / 2] += av[r][2];
          a[kD / 2 + 1] += av[r][3];
          float* b = dks + j * kAS + 2 * dg;
          b[0] += ak[r][0];
          b[1] += ak[r][1];
          b[kD / 2] += ak[r][2];
          b[kD / 2 + 1] += ak[r][3];
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
           int b, int h, int n, float scale, cudaStream_t stream) {
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
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs for sequence length n and element size.
size_t k2_attention_bwd_smem_bytes(int n, int elem_bytes) {
  return smem_bytes(n, (size_t)elem_bytes);
}

// q, k, v share the element strides (in_sb, in_sh, in_sn), dout has its
// own (do_*), dq, dk, dv share (out_*); every last dim is contiguous and kD
// long. dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch (0 on success).
int k2_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, void* dq, void* dk, void* dv,
                     long long in_sb, long long in_sh, long long in_sn,
                     long long do_sb, long long do_sh, long long do_sn,
                     long long out_sb, long long out_sh, long long out_sn,
                     int b, int h, int n, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, dout, dq, dk, dv, in_sb, in_sh, in_sn,
                         do_sb, do_sh, do_sn, out_sb, out_sh, out_sn, b, h, n,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, in_sb, in_sh,
                                 in_sn, do_sb, do_sh, do_sn, out_sb, out_sh,
                                 out_sn, b, h, n, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
