// The detection tail in one launch, for Hopper (sm_90a): adaptive Gaussian
// threshold, mask, piecewise-linear depth interpolation and the optional
// 3x3 median over kept neighbours, from a depth reduction (conf, zf).
//
// Replaces no TPU kernel: the reference runs this tail as plain JAX
// (`repro/core/detection.py::detect_and_filter`), which XLA fuses. The
// port's eager PyTorch tail (`repro_torch/core/detection.py`), about a
// hundred launches a call on the card, is the CPU path and the semantics
// this kernel is held to bit for bit.
//
// Bound on the H100: bytes. Each pixel reads conf and zf (8 B) and writes
// depth and mask (5 B); the blur's 2 x (2r+1) multiply-adds a pixel are far
// below the card's float32 rate. The launch, not the card, is what a call
// costs at the sizes EMVS uses.
//
// Layout: one CTA per (segment, TH x TW output tile). The tile's conf plus a
// halo of radius + 1 is loaded into shared memory with edge-clamped
// coordinates (the blur's edge padding). The vertical pass runs over the
// halo's columns for the tile's rows and a ring of one, the horizontal pass
// gives the local mean, mask and depth of every tile pixel and ring pixel,
// and the median reads the ring. The ring's coordinates wrap around, as the
// reference's `roll` does: a ring pixel outside the image stands for the
// pixel on the opposite edge, whose blur is computed from global memory with
// the same clamped neighbourhood and the same order of operations.
//
// Rounding: the vertical pass first, then the horizontal one, each in
// ascending tap order: the first tap is one multiply, each later tap one
// fused multiply-add (one rounding per term). Depth is
// fma(planes[hi], frac, planes[lo] * (1 - frac)). Built with --fmad=false,
// so nothing else fuses.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kMaxRadius = 8;
constexpr int kTaps = 2 * kMaxRadius + 1;
// the tile, a ring of one, and the blur's halo of `radius` around that
constexpr int kWinW = kTileW + 2 + 2 * kMaxRadius;
constexpr int kWinH = kTileH + 2 + 2 * kMaxRadius;
constexpr int kExtW = kTileW + 2;
constexpr int kExtH = kTileH + 2;

struct Taps {
  float k[kTaps];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int wrap(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// sum_j k[j] * x[j * stride], ascending j, one rounding per term
__device__ __forceinline__ float taps_sum(const float* x, int stride, const float* k,
                                          int n_taps) {
  float acc = __fmul_rn(x[0], k[0]);
  for (int j = 1; j < n_taps; ++j) acc = __fmaf_rn(x[j * stride], k[j], acc);
  return acc;
}

// The local mean at (y, x) from global memory: the vertical pass at each of
// the 2r+1 clamped columns, then the horizontal pass over them.
__device__ float local_mean_global(const float* conf, int h, int w, int y, int x,
                                   int radius, const float* k) {
  const int n_taps = 2 * radius + 1;
  float col[kTaps];
  for (int i = 0; i < n_taps; ++i) {
    const int xc = clampi(x + i - radius, 0, w - 1);
    float acc = __fmul_rn(conf[(long)clampi(y - radius, 0, h - 1) * w + xc], k[0]);
    for (int j = 1; j < n_taps; ++j) {
      const int yc = clampi(y + j - radius, 0, h - 1);
      acc = __fmaf_rn(conf[(long)yc * w + xc], k[j], acc);
    }
    col[i] = acc;
  }
  return taps_sum(col, 1, k, n_taps);
}

__device__ __forceinline__ void cmp_swap(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

__global__ void __launch_bounds__(kThreads)
detect_filter_kernel(const float* __restrict__ conf,    // (S, h, w)
                     const float* __restrict__ zf,      // (S, h, w)
                     const float* __restrict__ planes,  // (nz,)
                     float* __restrict__ depth_out,     // (S, h, w)
                     bool* __restrict__ mask_out,       // (S, h, w)
                     int h, int w, int nz, int radius, Taps taps,
                     float threshold_c, float min_votes, int median) {
  __shared__ float win[kWinH * kWinW];  // conf, clamped
  __shared__ float vert[kExtH * kWinW];  // vertical pass of the ring's rows
  __shared__ float ext_depth[kExtH * kExtW];
  __shared__ bool ext_mask[kExtH * kExtW];
  __shared__ float k[kTaps];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const long plane = (long)h * w;
  const float* c_s = conf + blockIdx.z * plane;
  const float* z_s = zf + blockIdx.z * plane;
  const int n_taps = 2 * radius + 1;
  const int win_w = kExtW + 2 * radius;
  const int win_h = kExtH + 2 * radius;
  if (tid < n_taps) k[tid] = taps.k[tid];

  // window pixel (wy, wx) is conf at the clamped (y0-1-r+wy, x0-1-r+wx)
  for (int i = tid; i < win_h * win_w; i += kThreads) {
    const int wy = i / win_w, wx = i - wy * win_w;
    const int gy = clampi(y0 - 1 - radius + wy, 0, h - 1);
    const int gx = clampi(x0 - 1 - radius + wx, 0, w - 1);
    win[wy * kWinW + wx] = c_s[(long)gy * w + gx];
  }
  __syncthreads();

  for (int i = tid; i < kExtH * win_w; i += kThreads) {
    const int ey = i / win_w, wx = i - ey * win_w;
    vert[ey * kWinW + wx] = taps_sum(&win[ey * kWinW + wx], kWinW, k, n_taps);
  }
  __syncthreads();

  // mask and depth of the tile and its ring; ring pixel (uy, ux) outside the
  // image is the wrapped pixel, blurred from global memory
  for (int i = tid; i < kExtH * kExtW; i += kThreads) {
    const int ey = i / kExtW, ex = i - ey * kExtW;
    const int uy = y0 - 1 + ey, ux = x0 - 1 + ex;
    if (uy > h || ux > w) continue;  // no output pixel reads it
    const bool inside = uy >= 0 && uy < h && ux >= 0 && ux < w;
    const int y = inside ? uy : wrap(uy, h);
    const int x = inside ? ux : wrap(ux, w);
    float c, mean;
    if (inside) {
      c = win[(ey + radius) * kWinW + ex + radius];
      mean = taps_sum(&vert[ey * kWinW + ex], 1, k, n_taps);
    } else {
      c = c_s[(long)y * w + x];
      mean = local_mean_global(c_s, h, w, y, x, radius, k);
    }
    ext_mask[i] = c > __fadd_rn(mean, threshold_c) && c >= min_votes;

    const float z = z_s[(long)y * w + x];
    const long long zl_raw = (long long)floorf(z);
    const int zl = (int)(zl_raw < 0 ? 0 : (zl_raw > nz - 1 ? nz - 1 : zl_raw));
    const int zh = zl + 1 > nz - 1 ? nz - 1 : zl + 1;
    const float frac = __fsub_rn(z, (float)zl);
    ext_depth[i] = __fmaf_rn(planes[zh], frac,
                             __fmul_rn(planes[zl], __fsub_rn(1.f, frac)));
  }
  __syncthreads();

  const int ty = tid / kTileW, tx = tid - ty * kTileW;
  const int y = y0 + ty, x = x0 + tx;
  if (y >= h || x >= w) return;
  const int centre = (ty + 1) * kExtW + tx + 1;
  const bool m = ext_mask[centre];
  float d = ext_depth[centre];
  if (median) {
    float v[9];
    int count = 0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int e = (ty + dy) * kExtW + tx + dx;
        const float cand = ext_mask[e] ? ext_depth[e] : INFINITY;
        v[dy * 3 + dx] = cand;
        count += cand < INFINITY;
      }
    }
    // a 25-comparator sorting network for 9 inputs, 7 layers deep
    cmp_swap(v[0], v[3]); cmp_swap(v[1], v[7]); cmp_swap(v[2], v[5]); cmp_swap(v[4], v[8]);
    cmp_swap(v[0], v[7]); cmp_swap(v[2], v[4]); cmp_swap(v[3], v[8]); cmp_swap(v[5], v[6]);
    cmp_swap(v[0], v[2]); cmp_swap(v[1], v[3]); cmp_swap(v[4], v[5]); cmp_swap(v[7], v[8]);
    cmp_swap(v[1], v[4]); cmp_swap(v[3], v[6]); cmp_swap(v[5], v[7]);
    cmp_swap(v[0], v[1]); cmp_swap(v[2], v[4]); cmp_swap(v[3], v[5]); cmp_swap(v[6], v[8]);
    cmp_swap(v[2], v[3]); cmp_swap(v[4], v[5]); cmp_swap(v[6], v[7]);
    cmp_swap(v[1], v[2]); cmp_swap(v[3], v[4]); cmp_swap(v[5], v[6]);
    const int mid = count > 0 ? (count - 1) >> 1 : 0;  // 0..4
    float med = v[0];
#pragma unroll
    for (int k = 1; k < 5; ++k) med = mid == k ? v[k] : med;
    if (m && count > 0) d = med;
  }
  const long o = blockIdx.z * plane + (long)y * w + x;
  depth_out[o] = d;
  mask_out[o] = m;
}

}  // namespace

// taps: 2*radius+1 host floats, passed to the kernel by value.
extern "C" int detect_filter_launch(const float* conf, const float* zf,
                                    const float* planes, float* depth, bool* mask,
                                    int S, int h, int w, int nz, int radius,
                                    const float* taps, float threshold_c,
                                    float min_votes, int median, void* stream) {
  if (radius < 0 || radius > kMaxRadius || S > 65535) return (int)cudaErrorInvalidValue;
  Taps t = {};
  for (int j = 0; j < 2 * radius + 1; ++j) t.k[j] = taps[j];
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, S);
  detect_filter_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      conf, zf, planes, depth, mask, h, w, nz, radius, t, threshold_c, min_votes,
      median);
  return (int)cudaGetLastError();
}
