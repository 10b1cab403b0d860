// Fused proportional back-projection + DSI voting + store, for Hopper (sm_90a).
//
// Replaces the vote-and-store half of the TPU kernel
// `repro/kernels/backproject_vote/kernel.py::backproject_vote_pallas`
// (`_kernel`, the P(Z0 -> Zi) multiply-add, the Table-1 int8 plane-coord
// quantization, the sanitize, the nearest/bilinear vote and the int16
// saturating store). The depth max/argmax that the TPU kernel folds into
// the same pass runs as a second launch over the stored DSI
// (`local_max.cu`).
//
// Layout: one CTA per (depth plane, segment). The CTA zeroes an h*w float
// accumulator in dynamic shared memory (DAVIS240: 172,800 B of the
// 232,448 B opt-in), strides over the segment's F*E events, projects each
// onto its plane, and adds the vote with a shared-memory atomic. After a
// barrier it writes the plane once (int16 clamp-then-truncate, or f32).
// No state crosses CTAs, so blocks may run in any order.
//
// Exactness: nearest votes are 0/1 weights, so every partial sum is an
// integer below 2^24 and the f32 atomics are exact in any order. Bilinear
// weights are fractional, so their sums depend on the atomic order.
//
// Bound on the H100: the store. A 128 x 180 x 240 int16 plane stack is
// 11.06 MB per segment; the events (F*E*12 B) are read once from device
// memory and then served from L2 to every plane's CTA.
//
// Arithmetic follows the reference op for op. Built with --fmad=false, so
// the only contraction is the explicit __fmaf_rn below, which is the FMA
// XLA:CPU forms for `alpha * (x0 - cx) + beta`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

// jnp.sign(x) * floor(|x| + 0.5): sign(0) = 0, sign(NaN) = NaN.
__device__ __forceinline__ float round_half_away(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
  return s * floorf(fabsf(x) + 0.5f);
}

// EMVSQuantPolicy.quantize_plane_coord_values for the INT8 format:
// out-of-range coords park at 255 (the miss judgement drops them); in range,
// round half away and clamp to [0, 255]. NaN fails both range tests and
// converts to 0, as XLA's float->int32 conversion does.
__device__ __forceinline__ float quantize_plane_coord(float c) {
  if (c < -0.5f || c > 255.5f) return 255.f;
  const float q = round_half_away(c);
  if (isnan(q)) return 0.f;
  return fminf(fmaxf(q, 0.f), 255.f);
}

// Non-finite -> -1e6, then clamp to +-1e6 (voting._sanitize).
__device__ __forceinline__ float sanitize(float c) {
  const float v = isfinite(c) ? c : -1e6f;
  return fminf(fmaxf(v, -1e6f), 1e6f);
}

__global__ void __launch_bounds__(kThreads)
backproject_vote_kernel(const float* __restrict__ x0,     // (S, F, E)
                        const float* __restrict__ y0,     // (S, F, E)
                        const float* __restrict__ valid,  // (S, F, E)
                        const float* __restrict__ phi,    // (S, F, Nz, 3)
                        void* __restrict__ dsi,           // (S, Nz, h, w)
                        int F, int E, int nz, int w, int h, float cx,
                        float cy, int bilinear, int quantized) {
  extern __shared__ float acc[];
  const int z = blockIdx.x;
  const int s = blockIdx.y;
  const int hw = h * w;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const long base = (long)s * F * E;
  const float* phi_z = phi + ((long)s * F * nz + z) * 3;
  const float wmax = (float)(w - 1);
  const float hmax = (float)(h - 1);
  const int n = F * E;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = valid[base + i];
    if (v == 0.f) continue;  // a zero weight adds nothing
    const float* p = phi_z + (long)(i / E) * nz * 3;
    const float alpha = p[0];
    float xi = __fmaf_rn(alpha, x0[base + i] - cx, p[1]) + cx;
    float yi = __fmaf_rn(alpha, y0[base + i] - cy, p[2]) + cy;
    if (quantized && !bilinear) {
      xi = quantize_plane_coord(xi);
      yi = quantize_plane_coord(yi);
    }
    xi = sanitize(xi);
    yi = sanitize(yi);
    if (!bilinear) {
      const float xr = floorf(xi + 0.5f);
      const float yr = floorf(yi + 0.5f);
      if (xr >= 0.f && xr <= wmax && yr >= 0.f && yr <= hmax)
        atomicAdd(&acc[(int)yr * w + (int)xr], v);
    } else {
      const float xf = floorf(xi);
      const float yf = floorf(yi);
      if (xf >= 0.f && xf + 1.f <= wmax && yf >= 0.f && yf + 1.f <= hmax) {
        const float fx = xi - xf;
        const float fy = yi - yf;
        // the reference's separable rows: ox = (1-fx, fx) * wt, oy = (1-fy, fy)
        const float ox0 = (1.f - fx) * v;
        const float ox1 = fx * v;
        const float oy0 = 1.f - fy;
        const int o = (int)yf * w + (int)xf;
        atomicAdd(&acc[o], oy0 * ox0);
        atomicAdd(&acc[o + 1], oy0 * ox1);
        atomicAdd(&acc[o + w], fy * ox0);
        atomicAdd(&acc[o + w + 1], fy * ox1);
      }
    }
  }
  __syncthreads();

  const long out = ((long)s * nz + z) * hw;
  if (quantized) {
    // clip to the int16 range, then truncate (XLA's float->int16 convert)
    int16_t* d = static_cast<int16_t*>(dsi) + out;
    for (int i = threadIdx.x; i < hw; i += blockDim.x)
      d[i] = (int16_t)__float2int_rz(fminf(fmaxf(acc[i], -32768.f), 32767.f));
  } else {
    float* d = static_cast<float*>(dsi) + out;
    for (int i = threadIdx.x; i < hw; i += blockDim.x) d[i] = acc[i];
  }
}

}  // namespace

extern "C" int backproject_vote_launch(const float* x0, const float* y0,
                                       const float* valid, const float* phi,
                                       void* dsi, int S, int F, int E, int nz,
                                       int w, int h, float cx, float cy,
                                       int bilinear, int quantized,
                                       void* stream) {
  const int smem = h * w * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      backproject_vote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nz, S);
  backproject_vote_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x0, y0, valid, phi, dsi, F, E, nz, w, h, cx, cy, bilinear, quantized);
  return (int)cudaGetLastError();
}
