// K4: flash (KV-streaming) multi-head attention forward, written for Hopper
// (sm_90a).
//
// Replaces jpdvt_mt_ntnu_tpu/ops/flash_attention.py:_fwd_kernel, the Pallas
// kernel behind _flash_fwd and fused_qkv_flash_attention. Same arithmetic:
// q * Dh^-1/2 rounded to the input type; per key tile S = Q K^T in fp32,
// padded key columns at -inf; the online softmax m' = max(m, rowmax S),
// alpha = exp(m - m'), E = exp(S - m'), l' = l alpha + rowsum E (fp32 E),
// acc' = acc alpha + round(E) V with E rounded to the V type and the
// product accumulated in fp32; at the end O = acc / l in the input type and
// LSE = m + log l in fp32 (the backward's only residual besides O).
//
// Design. One block per (batch, head, tile of 64 query rows), looping over
// tiles of 64 key rows: the Pallas grid's sequential KV axis becomes that
// loop, and m, l and the fp32 accumulator stay in the block (m, l in shared
// memory, the 64 x 64 accumulator in registers, 4 x 4 per thread). Shared
// memory holds the fp32 query tile, one K and one V tile and the tile's
// fp32 scores: 51 KB in bf16, 68 KB in fp32, whatever N is, so no sequence
// length is refused (K1's fp32 path stages whole rows and stops at N = 341;
// its bf16 path streams K and V and has no limit of N).
// The ragged last key tile is zero-filled and its columns set to -inf; the
// ragged last query tile computes zero rows that are never stored. The
// kernel takes element strides, so it reads q/k/v straight out of the
// fused (B, N, 3*H*Dh) projection and writes O as (B, N, H*Dh); LSE is a
// contiguous (B, H, N) fp32 tensor. Padded shared-memory rows (Dh + 2,
// 64 + 1) keep column reads free of bank conflicts. The products are
// scalar fp32 FMAs from shared memory, as in K1's fp32 path; tensor cores
// (mma / wgmma) are work for a later change.
//
// Bound on an H100 SXM at the grid-20 train step, B = 96, H = 12, N = 400,
// Dh = 64, bf16: q, k, v read once, O written once and the LSE written
// once is 4 * 59.0 MB + 1.8 MB = 237.8 MB, 71 us at 3.35 TB/s; the two
// products are 4 * B * H * N^2 * Dh = 47.2 GFLOP, 48 us at 989 TFLOP/s
// bf16. So the bound is the memory traffic; the scalar FMAs (67 TFLOP/s of
// fp32 at best) keep the kernel far above it. The train step launches
// this kernel once per DiT block: 12 launches per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr int kD = 64;         // head dim; the Python wrapper checks it
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile (BLOCK_K in flash_attention.py)
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kS = kD + 2;     // smem row stride of q, K, V (elements)
constexpr int kPS = kBK + 1;   // smem row stride of the score tile (floats)

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

__device__ __forceinline__ float2 zero_pair(const float*) {
  return make_float2(0.f, 0.f);
}
__device__ __forceinline__ __nv_bfloat162 zero_pair(const __nv_bfloat16*) {
  return __floats2bfloat162_rn(0.f, 0.f);
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
  // acc[i][0..3]: row rg*4+i, head-dim columns 2cg, 2cg+1, 2cg+32, 2cg+33.
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

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
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float2 v0 = to_float2(*reinterpret_cast<const T2*>(vs + j * kS + 2 * cg));
      const float2 v1 =
          to_float2(*reinterpret_cast<const T2*>(vs + j * kS + 2 * cg + kD / 2));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(rg * 4 + i) * kPS + j];
        acc[i][0] = fmaf(p, v0.x, acc[i][0]);
        acc[i][1] = fmaf(p, v0.y, acc[i][1]);
        acc[i][2] = fmaf(p, v1.x, acc[i][2]);
        acc[i][3] = fmaf(p, v1.y, acc[i][3]);
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
      store_pair(og + r * out_sn + 2 * cg, acc[i][0] / l, acc[i][1] / l);
      store_pair(og + r * out_sn + 2 * cg + kD / 2, acc[i][2] / l, acc[i][3] / l);
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

}  // namespace

extern "C" {

// Shared memory one block needs for the element size (any sequence length).
size_t k4_flash_fwd_smem_bytes(int elem_bytes) {
  return smem_bytes((size_t)elem_bytes);
}

// q, k, v share the element strides (in_sb, in_sh, in_sn); o has
// (out_sb, out_sh, out_sn); the last dim of each is contiguous and kD long.
// lse is contiguous (b, h, n) float32. dtype: 0 = float32, 1 = bfloat16.
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
    return launch<__nv_bfloat16>(q, k, v, o, l, in_sb, in_sh, in_sn, out_sb,
                                 out_sh, out_sn, b, h, n, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
