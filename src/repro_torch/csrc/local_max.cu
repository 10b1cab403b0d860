// Depth max/argmax with sub-voxel parabola refinement, for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/local_max/kernel.py::
// depth_argmax_pallas` (`_kernel`), and serves as the detection half of
// `backproject_vote_pallas`'s fused pass, run here as a second launch over
// the stored DSI.
//
// Layout: one thread per pixel, pixels of one segment coalesced along w,
// segments on grid.y. Each thread walks z upward with the streaming
// capture rules of the reference (first max wins on `cur > best`; c[z*-1]
// taken at the new best, c[z*+1] one step later), then fits the parabola
// with the reference's clamped-index edge conventions.
//
// Bound on the H100: reading the DSI once (Nz*h*w elements per segment)
// plus writing conf and zf (8 B a pixel). Built with --fmad=false, so every
// expression rounds as the reference writes it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
depth_argmax_kernel(const T* __restrict__ dsi,  // (S, Nz, hw)
                    float* __restrict__ conf,   // (S, hw)
                    float* __restrict__ zf,     // (S, hw)
                    int nz, int hw) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const long s = blockIdx.y;
  const T* col = dsi + s * nz * hw + p;
  float best = -1.f;  // DSI scores are >= 0: z = 0 always sets a best
  float zbest = 0.f, c_prev = 0.f, c_next = 0.f, prev = 0.f;
  bool prev_was_best = false;
  for (int z = 0; z < nz; ++z) {
    const float cur = (float)col[(long)z * hw];
    if (prev_was_best) c_next = cur;
    const bool is_new_best = cur > best;
    if (is_new_best) {
      c_prev = prev;
      zbest = (float)z;
      best = cur;
      c_next = 0.f;  // z*+1 not seen yet
    }
    prev_was_best = is_new_best;
    prev = cur;
  }
  const float cm = zbest == 0.f ? best : c_prev;
  const float cp = zbest == (float)(nz - 1) ? best : c_next;
  const float denom = cm - 2.f * best + cp;
  float offset = fabsf(denom) > 1e-6f ? 0.5f * (cm - cp) / denom : 0.f;
  offset = fminf(fmaxf(offset, -0.5f), 0.5f);
  conf[s * hw + p] = best;
  zf[s * hw + p] = zbest + offset;
}

template <typename T>
int launch(const void* dsi, float* conf, float* zf, int S, int nz, int hw,
           cudaStream_t stream) {
  const dim3 grid((hw + kThreads - 1) / kThreads, S);
  depth_argmax_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dsi), conf, zf, nz, hw);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = int16, 2 = int32.
extern "C" int depth_argmax_launch(const void* dsi, float* conf, float* zf,
                                   int S, int nz, int hw, int dtype,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(dsi, conf, zf, S, nz, hw, st);
    case 1: return launch<int16_t>(dsi, conf, zf, S, nz, hw, st);
    case 2: return launch<int32_t>(dsi, conf, zf, S, nz, hw, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
