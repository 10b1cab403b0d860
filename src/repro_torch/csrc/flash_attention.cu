// Flash attention forward (online softmax over KV tiles), for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas` (`_kernel`): causal or full softmax attention
// with GQA, float32 statistics and accumulator, NEG_INF = -1e30 for masked
// scores, the final `acc / max(l, 1e-30)`, output in the input's dtype.
//
// The TPU kernel walks KV blocks on a sequential third grid axis and keeps
// (m, l, acc) in VMEM scratch between grid steps. Blocks on Hopper run in
// no order, so here one CTA owns one (query tile, batch*head) pair and
// loops over the KV tiles itself, keeping m, l and acc in registers:
//
//   grid (ceil(Sq / BQ), B*Hq), 256 threads, BQ = BK = 64.
//   Dynamic shared memory (opted in above 48 KB): the query tile, the
//   current K and V tiles, all converted to float32, rows padded by 4
//   floats so the K reads of a quarter-warp hit distinct banks, and the
//   64 x 64 probability tile. 118,784 B at D = 128; 217,088 B at D = 256.
//   Thread (ty, tx) owns rows 4*ty..4*ty+3 of the tile: scores at columns
//   tx + 16*j (j < 4), output at columns 4*tx + 64*c (c < NC). A row's
//   max and sum reduce over its 16 threads with shuffles.
//   KV head of query row block bh is bh / q_per_kv (GQA without copying
//   K/V). Tiles entirely above the causal diagonal are skipped with the
//   reference's test: run tile j iff q0 + q_offset + BQ - 1 >= j * BK,
//   q_offset = Skv - Sq. Tile 0 always runs for every query at a
//   position >= 0 and holds key 0 unmasked, so no row meets exp(s - m)
//   with m = -1e30 once it has a real key.
//   Scores are (q . k) * (1 / sqrt(D)), as the TPU kernel writes them.
//   Query tiles are issued heaviest first (the causal tail).
//
// Bound on the H100: at the serving path's shapes (Hq 32, Hkv 8, D 128,
// S <= 512) the tensor-core bound on the causal FLOPs and the byte bound
// (q, k, v read once, o written once) are both microseconds. This first
// kernel computes in float32 on the CUDA cores (FMAs from shared memory,
// a 4 x 4 register tile per thread), so it is bound by the CUDA cores'
// float32 rate and shared-memory bandwidth, far above the tensor-core
// bound; wgmma, TMA and mma.sync are later work.
//
// Built with --fmad=false (for B1's parity): every FMA here is written as
// __fmaf_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kPad = 4;
constexpr int kLdP = BK + kPad;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Rows [row0, row0 + R) of a (rows, d) matrix into shared memory as float32
// with leading dimension ld; rows past the end are zero.
template <typename T, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int d, int ld) {
  const int vecs = d >> 2;
  for (int e = threadIdx.x; e < R * vecs; e += kThreads) {
    const int r = e / vecs;
    const int c = (e - r * vecs) << 2;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) x = load4(src + (long)(row0 + r) * d + c);
    store4(dst + r * ld + c, x);
  }
}

__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q,  // (BHq, Sq, D)
                 const T* __restrict__ k,  // (BHkv, Skv, D)
                 const T* __restrict__ v,  // (BHkv, Skv, D)
                 T* __restrict__ o,        // (BHq, Sq, D)
                 int sq, int skv, int d, int q_per_kv, int causal, float scale) {
  extern __shared__ float4 smem4[];
  const int ld = d + kPad;
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * ld;
  float* sV = sK + BK * ld;
  float* sP = sV + BK * ld;

  const int qi = gridDim.x - 1 - blockIdx.x;
  const long bh = blockIdx.y;
  const long bkv = bh / q_per_kv;
  const int q0 = qi * BQ;
  const int q_offset = skv - sq;
  const T* qg = q + bh * sq * (long)d;
  const T* kg = k + bkv * skv * (long)d;
  const T* vg = v + bkv * skv * (long)d;

  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int r0 = ty * 4;

  load_tile<T, BQ>(sQ, qg, q0, sq, d, ld);

  float m[4], l[4], acc[4][NC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (skv + BK - 1) / BK;
  if (causal) {
    const int last = q0 + q_offset + BQ - 1;  // largest query position here
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, BK>(sK, kg, k0, skv, d, ld);
    load_tile<T, BK>(sV, vg, k0, skv, d, ld);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int c = 0; c < d; c += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load4(sQ + (r0 + i) * ld + c);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kb[jj] = load4(sK + (tx + 16 * jj) * ld + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fma4(qa[i], kb[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        float x = s[i][jj] * scale;
        if (kpos >= skv || (causal && kpos > qpos)) x = kNegInf;
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        sP[(r0 + i) * kLdP + tx + 16 * jj] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // the probability tile is complete

    for (int kk = 0; kk < BK; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sP[(r0 + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx * 4 + 64 * c;
        if (col < d) {
          const float4 vv = load4(sV + kk * ld + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c * 4 + 0] = __fmaf_rn(pr[i], vv.x, acc[i][c * 4 + 0]);
            acc[i][c * 4 + 1] = __fmaf_rn(pr[i], vv.y, acc[i][c * 4 + 1]);
            acc[i][c * 4 + 2] = __fmaf_rn(pr[i], vv.z, acc[i][c * 4 + 2]);
            acc[i][c * 4 + 3] = __fmaf_rn(pr[i], vv.w, acc[i][c * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * sq + row) * (long)d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * 4 + 64 * c;
      if (col < d)
        store4(orow + col, make_float4(acc[i][c * 4 + 0] / den, acc[i][c * 4 + 1] / den,
                                       acc[i][c * 4 + 2] / den, acc[i][c * 4 + 3] / den));
    }
  }
}

size_t smem_bytes(int d) {
  return ((size_t)(BQ + 2 * BK) * (d + kPad) + (size_t)BQ * kLdP) * sizeof(float);
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq,
           int skv, int d, int q_per_kv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, skv, d, q_per_kv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int bh, int sq,
             int skv, int d, int q_per_kv, int causal, float scale, cudaStream_t st) {
  switch ((d + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, o, bh, sq, skv, d, q_per_kv, causal, scale, st);
    case 2: return launch<T, 2>(q, k, v, o, bh, sq, skv, d, q_per_kv, causal, scale, st);
    case 3: return launch<T, 3>(q, k, v, o, bh, sq, skv, d, q_per_kv, causal, scale, st);
    default: return launch<T, 4>(q, k, v, o, bh, sq, skv, d, q_per_kv, causal, scale, st);
  }
}

}  // namespace

// q (bh, sq, d); k, v (bh / q_per_kv, skv, d); o (bh, sq, d); all contiguous.
// dtype: 0 = float32, 1 = bfloat16. d a multiple of 8 in [8, 256].
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int bh, int sq, int skv, int d,
                                      int q_per_kv, int causal, float scale,
                                      int dtype, void* stream) {
  if (d < 8 || d > 256 || d % 8 != 0 || bh <= 0 || bh > 65535 || sq <= 0 ||
      skv <= 0 || q_per_kv <= 0 || bh % q_per_kv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_d<float>(q, k, v, o, bh, sq, skv, d, q_per_kv, causal, scale, st);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, bh, sq, skv, d, q_per_kv, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
