// K1: whole-row multi-head attention forward, written for Hopper (sm_90a).
//
// Replaces jpdvt_mt_ntnu_tpu/ops/attention.py:_attn_kernel, the Pallas
// kernel behind _attention_pallas_fwd_only and fused_qkv_attention. Same
// arithmetic: q * Dh^-1/2 rounded to the input type, S = Q K^T in fp32, a
// max-subtracted softmax in fp32, P rounded to the V type, O = P V
// accumulated in fp32 and stored in the input type. No masking, no dropout.
//
// Design. One block per (batch, head, tile of 32 query rows). K and V of
// that (batch, head) are staged whole in shared memory (144 x 64 bf16 x 2 =
// 36 KB at the flagship's N = 144), the tile's fp32 score rows too, so the
// softmax sees whole rows and needs no online rescaling. The kernel takes
// element strides for batch, head and token, so it reads q/k/v straight out
// of the fused (B, N, 3*H*Dh) projection and writes (B, N, H*Dh): the
// transposes that the TPU route needed around its kernel are gone. Padded
// shared-memory rows (Dh + 2) keep the column reads free of bank conflicts.
// The products are scalar fp32 FMAs from shared memory on 4 x 3 and 4 x 4
// register tiles; moving them onto the tensor cores (mma / wgmma) is work
// for a later change.
//
// Bound on an H100 SXM at the flagship's B = 16, H = 12, N = 144, Dh = 64:
// q, k, v read once and o written once is 4 * 16 * 12 * 144 * 64 * 2 B =
// 14.2 MB, 4.2 us at 3.35 TB/s; the two products are 4 * B * H * N^2 * Dh =
// 1.0 GFLOP, 1.0 us at 989 TFLOP/s bf16. So the bound is the memory traffic.
// The faithful 250-step solve launches this kernel once per DiT block per
// step: 12 x 250 = 3,000 launches per microbatch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr int kD = 64;           // head dim; the Python wrapper checks it
constexpr int kTQ = 32;          // query rows per block
constexpr int kThreads = 128;    // 8 row groups x 16 column groups
constexpr int kKS = kD + 2;      // smem row stride of K and V (elements)
constexpr int kQS = kD + 2;      // smem row stride of the query tile (floats)
constexpr int kCT = 3;           // key columns per thread in one score chunk
constexpr int kChunk = 16 * kCT; // key columns per score chunk

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

  // O = P V, fp32; this thread owns rows rg*4.. and columns 2cg, 2cg+1,
  // 2cg+32, 2cg+33.
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float2 v0 = to_float2(*reinterpret_cast<const T2*>(vs + j * kKS + 2 * cg));
    const float2 v1 =
        to_float2(*reinterpret_cast<const T2*>(vs + j * kKS + 2 * cg + kD / 2));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = ss[(rg * 4 + i) * sst + j];
      acc[i][0] = fmaf(p, v0.x, acc[i][0]);
      acc[i][1] = fmaf(p, v0.y, acc[i][1]);
      acc[i][2] = fmaf(p, v1.x, acc[i][2]);
      acc[i][3] = fmaf(p, v1.y, acc[i][3]);
    }
  }
  T* og = o + blockIdx.z * out_sb + blockIdx.y * out_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r < n) {
      store_pair(og + r * out_sn + 2 * cg, acc[i][0], acc[i][1]);
      store_pair(og + r * out_sn + 2 * cg + kD / 2, acc[i][2], acc[i][3]);
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

}  // namespace

extern "C" {

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
// contiguous and kD long. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 on success).
int k1_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                     void* o, long long in_sb, long long in_sh, long long in_sn,
                     long long out_sb, long long out_sh, long long out_sn,
                     int b, int h, int n, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, in_sb, in_sh, in_sn, out_sb, out_sh,
                         out_sn, b, h, n, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, in_sb, in_sh, in_sn, out_sb,
                                 out_sh, out_sn, b, h, n, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
