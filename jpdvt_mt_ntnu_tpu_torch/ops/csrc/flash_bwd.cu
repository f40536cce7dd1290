// K5 and K6: flash (KV-streaming) multi-head attention backward, written for
// Hopper (sm_90a).
//
// K5 replaces jpdvt_mt_ntnu_tpu/ops/flash_attention.py:_dq_kernel and K6
// replaces _dkv_kernel, the two Pallas kernels of _flash_bwd, the
// FlashAttention-2 recomputation. Same arithmetic: q * Dh^-1/2 rounded to
// the input type; S = Q K^T in fp32, padded key columns out; P = exp(S -
// LSE) in fp32 from the forward's LSE; dP = dO V^T; delta = rowsum(dO * O)
// from the saved output O in the input type; dS = P (dP - delta) rounded
// to the input type. K5: dQ = sum over key tiles of (dS K) * scale. K6:
// dV = sum over query tiles of round(P)^T dO with P rounded to the dO type,
// dK = sum over query tiles of dS^T (q * scale). Every product accumulates
// in fp32; the outputs are stored in the input type.
//
// Design. K5: one block per (batch, head, tile of 64 query rows), looping
// over tiles of 64 key rows; the fp32 dQ tile lives in registers (4 x 4 per
// thread). K6: one block per (batch, head, tile of 64 key rows), looping
// over tiles of 64 query rows; the fp32 dK and dV tiles live in registers
// (2 x 4 x 4 per thread). Each output element has one owning thread of one
// block, so there are no atomics and the result is deterministic: a run
// resumed from a checkpoint repeats the uninterrupted one bit for bit.
// Shared memory holds one K and one V tile, the fp32 q and dO tiles, the
// rows' LSE and delta, and the fp32 P and dS tiles: 68 KB (K5) and 85 KB
// (K6) in bf16, whatever N is (K2 keeps whole rows and fp32 dK/dV and
// stops at N = 205 in bf16). Ragged tiles are zero-filled; padded key
// columns and padded query rows get P = 0, so they add exactly 0. The
// kernels take element strides: q/k/v are read out of the saved fused
// (B, N, 3*H*Dh) projection, O and dO out of (B, N, H*Dh) buffers, and
// dq/dk/dv are written into one (B, N, 3, H, Dh) gradient buffer. The
// products are scalar fp32 FMAs from shared memory, as in K1 and K2;
// tensor cores are work for a later change.
//
// Bound on an H100 SXM at the grid-20 train step, B = 96, H = 12, N = 400,
// Dh = 64, bf16 (one (B, H, N, Dh) tensor is 59.0 MB, the LSE 1.8 MB):
// K5 reads q, k, v, O, dO and the LSE and writes dQ, 355.7 MB, 106 us at
// 3.35 TB/s, against 6 * B * H * N^2 * Dh = 70.8 GFLOP, 72 us at 989
// TFLOP/s bf16; K6 reads the same and writes dK and dV, 414.7 MB, 124 us,
// against 8 * B * H * N^2 * Dh = 94.4 GFLOP, 95 us. Both are bound by the
// memory traffic; the scalar FMAs keep them far above it. The train step
// launches each once per DiT block: 12 + 12 launches per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr int kD = 64;         // head dim; the Python wrapper checks it
constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kS = kD + 2;     // smem row stride of q, dO, K, V (elements)
constexpr int kPS = kBK + 1;   // smem row stride of the P and dS tiles (floats)

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };

__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// Round to T and back: the casts to the input type in the TPU kernels.
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
                T* __restrict__ dq, Strides st, int h, int n, float scale) {
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
  // acc[i][0..3]: dQ row rg*4+i, head-dim columns 2cg, 2cg+1, 2cg+32, 2cg+33.
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

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
    // dQ += (dS K) * scale, the tile's product scaled before it is added.
    float t[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) t[i][c] = 0.f;
    using T2 = typename Pair<T>::type;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float2 k0v = to_float2(*reinterpret_cast<const T2*>(ks + j * kS + 2 * cg));
      const float2 k1v =
          to_float2(*reinterpret_cast<const T2*>(ks + j * kS + 2 * cg + kD / 2));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g = dss[(rg * 4 + i) * kPS + j];
        t[i][0] = fmaf(g, k0v.x, t[i][0]);
        t[i][1] = fmaf(g, k0v.y, t[i][1]);
        t[i][2] = fmaf(g, k1v.x, t[i][2]);
        t[i][3] = fmaf(g, k1v.y, t[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] += t[i][c] * scale;
  }

  T* dqg = dq + blockIdx.z * st.out_sb + blockIdx.y * st.out_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r < n) {
      store_pair(dqg + r * st.out_sn + 2 * cg, acc[i][0], acc[i][1]);
      store_pair(dqg + r * st.out_sn + 2 * cg + kD / 2, acc[i][2], acc[i][3]);
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
  // dk/dv[j][0..3]: key row rg*4+j, head-dim columns 2cg, 2cg+1, 2cg+32, 2cg+33.
  float dka[4][4], dva[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[j][c] = dva[j][c] = 0.f;

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
      const float2 g0 = *reinterpret_cast<const float2*>(dos + i * kS + 2 * cg);
      const float2 g1 = *reinterpret_cast<const float2*>(dos + i * kS + 2 * cg + kD / 2);
      const float2 x0 = *reinterpret_cast<const float2*>(qs + i * kS + 2 * cg);
      const float2 x1 = *reinterpret_cast<const float2*>(qs + i * kS + 2 * cg + kD / 2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = pcs[i * kPS + rg * 4 + j];
        const float g = dss[i * kPS + rg * 4 + j];
        dva[j][0] = fmaf(p, g0.x, dva[j][0]);
        dva[j][1] = fmaf(p, g0.y, dva[j][1]);
        dva[j][2] = fmaf(p, g1.x, dva[j][2]);
        dva[j][3] = fmaf(p, g1.y, dva[j][3]);
        dka[j][0] = fmaf(g, x0.x, dka[j][0]);
        dka[j][1] = fmaf(g, x0.y, dka[j][1]);
        dka[j][2] = fmaf(g, x1.x, dka[j][2]);
        dka[j][3] = fmaf(g, x1.y, dka[j][3]);
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
      store_pair(kr + 2 * cg, dka[j][0], dka[j][1]);
      store_pair(kr + 2 * cg + kD / 2, dka[j][2], dka[j][3]);
      store_pair(vr + 2 * cg, dva[j][0], dva[j][1]);
      store_pair(vr + 2 * cg + kD / 2, dva[j][2], dva[j][3]);
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
              int b, int h, int n, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(sizeof(T));
  if (const int err = set_smem(flash_dq_kernel<T>, smem)) return err;
  const dim3 grid((n + kBQ - 1) / kBQ, h, b);
  flash_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse,
      static_cast<T*>(dq), st, h, n, scale);
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

}  // namespace

extern "C" {

// Shared memory one block of K5 / K6 needs for the element size (any N).
size_t k5_flash_dq_smem_bytes(int elem_bytes) {
  return dq_smem_bytes((size_t)elem_bytes);
}
size_t k6_flash_dkv_smem_bytes(int elem_bytes) {
  return dkv_smem_bytes((size_t)elem_bytes);
}

// q, k, v share the element strides (in_*); O, dO and dq have their own;
// the last dim of each is contiguous and kD long; lse is contiguous
// (b, h, n) float32. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 on success).
int k5_flash_dq(int dtype, const void* q, const void* k, const void* v,
                const void* o, const void* dout, const void* lse, void* dq,
                long long in_sb, long long in_sh, long long in_sn,
                long long o_sb, long long o_sh, long long o_sn,
                long long do_sb, long long do_sh, long long do_sn,
                long long out_sb, long long out_sh, long long out_sn,
                int b, int h, int n, float scale, void* stream) {
  const Strides st{in_sb, in_sh, in_sn, o_sb, o_sh, o_sn,
                   do_sb, do_sh, do_sn, out_sb, out_sh, out_sn};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (dtype == 0) return launch_dq<float>(q, k, v, o, dout, l, dq, st, b, h, n, scale, s);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(q, k, v, o, dout, l, dq, st, b, h, n, scale, s);
  return (int)cudaErrorInvalidValue;
}

// As k5_flash_dq; dk and dv share the strides (out_*).
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
    return launch_dkv<__nv_bfloat16>(q, k, v, o, dout, l, dk, dv, st, b, h, n, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
