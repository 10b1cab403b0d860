// Pose interpolation for aggregated event frames in one launch, for Hopper
// (sm_90a): the pose half of the paper's Event Aggregation stage. For each
// frame's mid-time, the bracketing trajectory samples, the translation lerp
// and the rotation by axis-angle (R = exp(frac * log(R1 R0^T)) R0).
//
// Replaces no TPU kernel: the reference interpolates poses as plain JAX
// (`repro/events/trajectory_stream.py::pose_at_times`). The port's eager
// chain (`events/trajectory_stream.py::pose_at_times`, about 70 launches a
// call on the card) is the CPU path (`kernels/frame_poses/ref.py`) and the
// semantics this kernel is held to bit for bit on the card: out-of-span
// queries clamp to the end samples, a zero-length interval divides by 1e-9,
// and so3_log's |sin| < 1e-8 and so3_exp's theta < 1e-8 branches.
//
// Bound on the H100: the launch. A frame reads its time, a binary search
// over the trajectory's times and two samples (96 B), and writes 48 B.
//
// Layout: one thread per frame, a few hundred dependent operations each.
//
// Rounding: every operation of the eager chain, in its order, with one
// rounding each, except where the eager code calls `torch.addcmul`, which
// the card evaluates as one fused multiply-add: a 3x3 product entry is
// fma(a2, b2, fma(a1, b1, a0 * b0)). The axis-angle norm sums the squares as
// the card's eager reduction does, (w0^2 + w2^2) + w1^2. acosf, sinf, cosf
// and sqrtf are the CUDA math library's, as eager PyTorch calls them; min and
// max as its clamps do, NaN passed through. Built with --fmad=false, so
// nothing else fuses; the intrinsics say so anyway.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

// torch.clamp on the card: NaN passes, else min(max(v, lo), hi)
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
frame_poses_kernel(const float* __restrict__ times, const float* __restrict__ R,
                   const float* __restrict__ t, const float* __restrict__ t_query,
                   float* __restrict__ R_out, float* __restrict__ t_out, long n, long F) {
  const long f = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const float q = t_query[f];

  // searchsorted(times, q, right=True) - 1, clamped to [0, n - 2]
  long lo = 0, hi = n;
  while (lo < hi) {
    const long mid = lo + ((hi - lo) >> 1);
    if (!(times[mid] > q))
      lo = mid + 1;
    else
      hi = mid;
  }
  long k = lo - 1;
  k = k < 0 ? 0 : (k > n - 2 ? n - 2 : k);
  const float t0 = times[k], t1 = times[k + 1];
  const float gap = __fsub_rn(t1, t0);
  const float span = isnan(gap) ? gap : fmaxf(gap, 1e-9f);
  const float frac = clamp(__fdiv_rn(__fsub_rn(q, t0), span), 0.0f, 1.0f);

  const float* R0 = R + k * 9;
  const float* R1 = R0 + 9;
  const float* p0 = t + k * 3;
  const float* p1 = p0 + 3;
  for (int i = 0; i < 3; ++i)
    t_out[f * 3 + i] = __fadd_rn(p0[i], __fmul_rn(frac, __fsub_rn(p1[i], p0[i])));

  // so3_log(R1 R0^T)
  float dR[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      dR[i * 3 + j] = dot3(R1[i * 3], R0[j * 3], R1[i * 3 + 1], R0[j * 3 + 1],
                           R1[i * 3 + 2], R0[j * 3 + 2]);
  const float trace = __fadd_rn(__fadd_rn(dR[0], dR[4]), dR[8]);
  const float cos_theta = clamp(__fmul_rn(__fsub_rn(trace, 1.0f), 0.5f), -1.0f, 1.0f);
  const float theta = acosf(cos_theta);
  const float sin_theta = sinf(theta);
  const float scale = fabsf(sin_theta) < 1e-8f
                          ? 0.5f
                          : __fdiv_rn(theta, __fadd_rn(__fmul_rn(2.0f, sin_theta), 1e-30f));
  float w[3] = {__fsub_rn(dR[7], dR[5]), __fsub_rn(dR[2], dR[6]), __fsub_rn(dR[3], dR[1])};
  for (int i = 0; i < 3; ++i) w[i] = __fmul_rn(__fmul_rn(w[i], scale), frac);

  // so3_exp(w)
  const float norm = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(w[0], w[0]), __fmul_rn(w[2], w[2])),
                                          __fmul_rn(w[1], w[1])));
  const bool small = norm < 1e-8f;
  const float safe = small ? 1.0f : norm;
  const float K[9] = {__fdiv_rn(0.0f, safe), __fdiv_rn(-w[2], safe), __fdiv_rn(w[1], safe),
                      __fdiv_rn(w[2], safe), __fdiv_rn(0.0f, safe), __fdiv_rn(-w[0], safe),
                      __fdiv_rn(-w[1], safe), __fdiv_rn(w[0], safe), __fdiv_rn(0.0f, safe)};
  const float s = sinf(norm);
  const float one_c = __fsub_rn(1.0f, cosf(norm));
  float E[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      const float kk = dot3(K[i * 3], K[j], K[i * 3 + 1], K[3 + j], K[i * 3 + 2], K[6 + j]);
      E[i * 3 + j] =
          small ? eye : __fadd_rn(__fadd_rn(eye, __fmul_rn(s, K[i * 3 + j])), __fmul_rn(one_c, kk));
    }

  // R = exp(w) R0
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R_out[f * 9 + i * 3 + j] =
          dot3(E[i * 3], R0[j], E[i * 3 + 1], R0[3 + j], E[i * 3 + 2], R0[6 + j]);
}

}  // namespace

// Every array is contiguous float32: times (n,) non-decreasing, R (n, 3, 3),
// t (n, 3), t_query (F,); R_out (F, 3, 3) and t_out (F, 3). n >= 2.
extern "C" int frame_poses_launch(const float* times, const float* R, const float* t,
                                  const float* t_query, float* R_out, float* t_out, long n,
                                  long F, void* stream) {
  if (n < 2 || F <= 0) return (int)cudaErrorInvalidValue;
  const long blocks = (F + kThreads - 1) / kThreads;
  frame_poses_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      times, R, t, t_query, R_out, t_out, n, F);
  return (int)cudaGetLastError();
}
