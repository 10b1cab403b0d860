// The sweep's front end in one launch, for Hopper (sm_90a): the paper's
// Canonical Projection Module. Per frame, the pose relative to the key
// frame, the canonical homography H_Z0 and the plane-sweep coefficients phi;
// under Table 1, the Q9.7 event coordinates, H and phi in Q11.21 and the
// Q9.7 canonical coordinates; then the homography on every event and the
// frame mask on its validity.
//
// Replaces no TPU kernel: the reference computes this as plain JAX
// (`repro/core/backproject.py::frame_geometry`, the Table-1 steps of
// `repro/kernels/backproject_vote/ops.py`), which XLA fuses. The port's eager
// PyTorch chain (`kernels/canonical_project/ref.py`: `frame_geometry`, then
// `kernels/backproject_vote/ops.py::canonical_inputs`), about a hundred
// launches a bucket on the card, is the CPU path and the semantics this
// kernel is held to bit for bit. Its outputs are what the sweep kernel B1
// reads: xy0 (S, C, E, 2) float32, valid (S, C, E) bool, phi (S, C, Nz, 3)
// float32.
//
// Bound on the H100: bytes, and far below the launch. Each event reads 9 B
// (coordinates, validity) and writes 9 B; each frame reads its two poses and
// writes 12 B a plane.
//
// Layout: one CTA per (segment, frame). Thread 0 works out the frame's
// relative pose and H into shared memory (a few hundred dependent operations,
// as the eager code does them on 3x3 tensors); then each thread takes planes
// (phi) and events (the homography) in strides of the block.
//
// Rounding: every operation of the eager code, in its order, with one
// rounding each, except where the eager code calls `torch.addcmul`, which
// the CPU evaluates as one fused multiply-add: a 3x3 product row is
// fma(a2, b2, fma(a1, b1, a0 * b0)), a homography row fma(h0, x, h1 * y) + h2.
// Built with --fmad=false, so nothing else fuses; the intrinsics say so
// anyway. Table 1's conversion saturates as `quant/fixed_point.py` does:
// round half away from zero in float32, the clamp in double to the format's
// integer bounds, NaN to 0.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

// Q9.7 (event and canonical coordinates) and Q11.21 (H, phi)
constexpr float kQ97Scale = 128.0f;
constexpr double kQ97Lo = -32768.0, kQ97Hi = 32767.0;
constexpr float kQ1121Scale = 2097152.0f;
constexpr double kQ1121Lo = -2147483648.0, kQ1121Hi = 2147483647.0;

// host floats passed by value: K and K^-1 row-major (float32); fx is K[0],
// fy is K[4]
struct Intrinsics {
  float K[9];
  float K_inv[9];
};

__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

// float -> stored integer -> float: x * scale, sign(q) * floor(|q| + 0.5),
// clamped in double to [lo, hi], NaN to 0, back to float32 over the scale
__device__ __forceinline__ float roundtrip(float x, float scale, double lo, double hi) {
  const float q = __fmul_rn(x, scale);
  const float sign = (float)((0.0f < q) - (q < 0.0f));
  const float r = __fmul_rn(sign, floorf(__fadd_rn(fabsf(q), 0.5f)));
  int stored = 0;
  if (!isnan(r)) {
    const double d = (double)r;
    stored = (int)(d < lo ? lo : (d > hi ? hi : d));
  }
  return __fdiv_rn(__int2float_rn(stored), scale);
}

template <bool kQuantized>
__global__ void __launch_bounds__(kThreads)
canonical_project_kernel(const float* __restrict__ xy, const bool* __restrict__ valid,
                         const bool* __restrict__ frame_valid,
                         const float* __restrict__ poses_R, const float* __restrict__ poses_t,
                         const float* __restrict__ ref_R, const float* __restrict__ ref_t,
                         const float* __restrict__ planes, const float* __restrict__ z0_ptr,
                         Intrinsics in, float* __restrict__ xy0, bool* __restrict__ valid_out,
                         float* __restrict__ phi, int C, long E, int nz) {
  __shared__ float sH[9];
  __shared__ float sT[3];
  const long frame = blockIdx.x;  // s * C + c
  const long seg = frame / C;
  const float z0 = *z0_ptr;

  if (threadIdx.x == 0) {
    const float* Rr = ref_R + seg * 9;
    const float* tr = ref_t + seg * 3;
    const float* Rc = poses_R + frame * 9;
    const float* tc = poses_t + frame * 3;
    // the key frame's inverse: R^T and -(R^T t)
    float Ri[9], ti[3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Ri[i * 3 + j] = Rr[j * 3 + i];
    for (int i = 0; i < 3; ++i)
      ti[i] = -dot3(Ri[i * 3], tr[0], Ri[i * 3 + 1], tr[1], Ri[i * 3 + 2], tr[2]);
    // T_ref_cam = inverse o T_w_cam
    float R[9], t[3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        R[i * 3 + j] = dot3(Ri[i * 3], Rc[j], Ri[i * 3 + 1], Rc[3 + j], Ri[i * 3 + 2],
                            Rc[6 + j]);
    for (int i = 0; i < 3; ++i)
      t[i] = __fadd_rn(dot3(Ri[i * 3], tc[0], Ri[i * 3 + 1], tc[1], Ri[i * 3 + 2], tc[2]),
                       ti[i]);
    // H = K (R + t n^T / d) K^-1 with n = R^T e_z, d = z0 - e_z . t, over H[2][2]
    float n[3];
    for (int j = 0; j < 3; ++j) n[j] = dot3(R[j], 0.0f, R[3 + j], 0.0f, R[6 + j], 1.0f);
    const float d = __fsub_rn(z0, dot3(t[0], 0.0f, t[1], 0.0f, t[2], 1.0f));
    float Hm[9], KH[9], H[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Hm[i * 3 + j] = __fadd_rn(R[i * 3 + j], __fdiv_rn(__fmul_rn(t[i], n[j]), d));
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        KH[i * 3 + j] = dot3(in.K[i * 3], Hm[j], in.K[i * 3 + 1], Hm[3 + j],
                             in.K[i * 3 + 2], Hm[6 + j]);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        H[i * 3 + j] = dot3(KH[i * 3], in.K_inv[j], KH[i * 3 + 1], in.K_inv[3 + j],
                            KH[i * 3 + 2], in.K_inv[6 + j]);
    const float h22 = H[8];
    for (int k = 0; k < 9; ++k) {
      const float h = __fdiv_rn(H[k], h22);
      sH[k] = kQuantized ? roundtrip(h, kQ1121Scale, kQ1121Lo, kQ1121Hi) : h;
    }
    for (int i = 0; i < 3; ++i) sT[i] = t[i];
  }
  __syncthreads();

  // phi: s = (z_i - c_z) / (z0 - c_z), alpha = s z0 / z_i,
  // beta = f c (1 - s) / z_i, c the camera centre in the key frame
  const float cz = sT[2];
  const float z0_cz = __fsub_rn(z0, cz);
  const float fcx = __fmul_rn(in.K[0], sT[0]);
  const float fcy = __fmul_rn(in.K[4], sT[1]);
  float* phi_f = phi + frame * nz * 3;
  for (int k = threadIdx.x; k < nz; k += blockDim.x) {
    const float p = planes[k];
    const float s = __fdiv_rn(__fsub_rn(p, cz), z0_cz);
    const float one_s = __fsub_rn(1.0f, s);
    float alpha = __fdiv_rn(__fmul_rn(s, z0), p);
    float beta_x = __fdiv_rn(__fmul_rn(fcx, one_s), p);
    float beta_y = __fdiv_rn(__fmul_rn(fcy, one_s), p);
    if (kQuantized) {
      alpha = roundtrip(alpha, kQ1121Scale, kQ1121Lo, kQ1121Hi);
      beta_x = roundtrip(beta_x, kQ1121Scale, kQ1121Lo, kQ1121Hi);
      beta_y = roundtrip(beta_y, kQ1121Scale, kQ1121Lo, kQ1121Hi);
    }
    phi_f[3 * k] = alpha;
    phi_f[3 * k + 1] = beta_x;
    phi_f[3 * k + 2] = beta_y;
  }

  // the events: (Table 1), the homography, (Table 1), the frame mask
  const float h00 = sH[0], h01 = sH[1], h02 = sH[2];
  const float h10 = sH[3], h11 = sH[4], h12 = sH[5];
  const float h20 = sH[6], h21 = sH[7], h22 = sH[8];
  const bool fv = frame_valid[frame];
  const long base = frame * E;
  for (long e = threadIdx.x; e < E; e += blockDim.x) {
    float x = xy[2 * (base + e)];
    float y = xy[2 * (base + e) + 1];
    if (kQuantized) {
      x = roundtrip(x, kQ97Scale, kQ97Lo, kQ97Hi);
      y = roundtrip(y, kQ97Scale, kQ97Lo, kQ97Hi);
    }
    const float den = __fadd_rn(__fmaf_rn(h20, x, __fmul_rn(h21, y)), h22);
    float u = __fdiv_rn(__fadd_rn(__fmaf_rn(h00, x, __fmul_rn(h01, y)), h02), den);
    float v = __fdiv_rn(__fadd_rn(__fmaf_rn(h10, x, __fmul_rn(h11, y)), h12), den);
    if (kQuantized) {
      u = roundtrip(u, kQ97Scale, kQ97Lo, kQ97Hi);
      v = roundtrip(v, kQ97Scale, kQ97Lo, kQ97Hi);
    }
    xy0[2 * (base + e)] = u;
    xy0[2 * (base + e) + 1] = v;
    valid_out[base + e] = valid[base + e] && fv;
  }
}

}  // namespace

// K, K_inv: 9 host floats each (row-major), passed to the kernel by value.
// Every array is contiguous: xy (S, C, E, 2), valid (S, C, E), frame_valid
// (S, C), poses_R (S, C, 3, 3), poses_t (S, C, 3), ref_R (S, 3, 3), ref_t
// (S, 3), planes (nz,), z0 one float; the outputs as the header says.
extern "C" int canonical_project_launch(
    const float* xy, const bool* valid, const bool* frame_valid, const float* poses_R,
    const float* poses_t, const float* ref_R, const float* ref_t, const float* planes,
    const float* z0, const float* K, const float* K_inv, float* xy0,
    bool* valid_out, float* phi, int S, int C, long E, int nz, int quantized,
    void* stream) {
  const long frames = (long)S * C;
  if (S <= 0 || C <= 0 || E < 0 || nz < 0 || frames > INT_MAX)
    return (int)cudaErrorInvalidValue;
  Intrinsics in = {};
  for (int k = 0; k < 9; ++k) {
    in.K[k] = K[k];
    in.K_inv[k] = K_inv[k];
  }
  const dim3 grid((unsigned)frames);
  if (quantized)
    canonical_project_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        xy, valid, frame_valid, poses_R, poses_t, ref_R, ref_t, planes, z0, in, xy0,
        valid_out, phi, C, E, nz);
  else
    canonical_project_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        xy, valid, frame_valid, poses_R, poses_t, ref_R, ref_t, planes, z0, in, xy0,
        valid_out, phi, C, E, nz);
  return (int)cudaGetLastError();
}
