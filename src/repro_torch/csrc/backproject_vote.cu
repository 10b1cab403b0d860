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
// Layout: one CTA per (depth plane, segment, row band), the band's
// accumulator in dynamic shared memory. The wrapper's band plan
// (`kernel.py::band_plan`) takes the fewest bands that fit beside the
// ring: DAVIS240's whole 240x180 plane is one band (172,800 B), DAVIS346's
// 346x260 two bands of 130 rows. Every band CTA of a segment streams all of
// its F*E events through its own ring and keeps only the votes that land in
// its rows, so n_bands bands cost n_bands times the event reads and
// projections. Every plane of a segment reads the same events, so the
// events are streamed, not loaded per thread:
//
//   * warp 31 is the producer: one lane streams the segment's flat x0 and
//     y0 (float32) and validity (one byte, 0/1) through a two-stage ring
//     in shared memory (1,984 events, 17.4 KB a stage) with 1-D bulk copies
//     (cp.async.bulk ... mbarrier::complete_tx::bytes), each stage
//     completed on its own "full" mbarrier. The consumer warps release a
//     stage on its "empty" mbarrier, which the producer waits on before it
//     overwrites that stage;
//   * warps 0-30 consume, two adjacent events of every stage per thread
//     (8-byte loads), so no warp waits on another's extra events and each
//     thread has two independent projections in flight. A frame cursor
//     per thread keeps the pair's (alpha, beta_x, beta_y) for this plane
//     in registers, advanced by a compare and an add, never a division
//     per event; they come from a window of phi staged once in shared
//     memory (512 frames; restaged only past that). Nearest votes are
//     int32 counts added with integer shared atomics (an f32 shared
//     atomicAdd is a compare-and-swap loop on sm_90, ATOMS.CAST.SPIN);
//     bilinear adds f32;
//   * the consumers zero the band while the first stages arrive; after
//     the vote every thread stores one element at a time (int16
//     clamp-then-truncate, or f32).
//
// Bands: the column bounds test stays on the logical w; the row test is
// "in this band", which implies the logical 0 <= y < h since the bands
// tile [0, h). A nearest vote lands at (y - r0) * w + x. A bilinear vote
// passes the full w/h bounds test first, then adds its row-yf pair and
// its row-yf+1 pair each only when that row is in the band, so a vote
// that straddles two bands is split between their CTAs.
//
// No state crosses CTAs, so the CTAs may run in any order.
//
// The wrapper pads each frame's events to a multiple of 16 as invalid
// events, so every copy is 16-byte aligned and sized; an invalid event is
// skipped and votes nothing. The last stage of a segment is shorter.
//
// Exactness: validity is the wrapper's bool mask (the reference's weights
// are exact 0/1), so a nearest vote adds 1 to an int32 count, exact in any
// order, which converts to the same f32 or int16 store as the reference's
// f32 sums. Bilinear splits a vote of weight 1 into fractional weights, so
// its sums depend on the atomic order.
//
// Bound on the H100: the DSI store (11.06 MB of int16 per segment at 128 x
// 180 x 240) and the events' one read from device memory. What holds it
// today is the vote's instruction stream, about 70 instructions an event
// (PERF.md).
//
// Arithmetic follows the reference op for op, except `quantized_pixel`,
// which folds the int8 plane-coord rule, the sanitize and the rounding
// into one exact form (see there). Built with --fmad=false, so the only
// contraction is the explicit __fmaf_rn below, which is the FMA XLA:CPU
// forms for `alpha * (x0 - cx) + beta`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kConsumers = kThreads - 32;  // warps 0-30; warp 31 produces
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kStage = 2 * kConsumers;  // events a ring stage holds: a pair per consumer
constexpr int kStages = 2;
constexpr int kSlotBytes = 9 * kStage;               // x0, y0 (4 B), valid (1 B)
constexpr int kRingBytes = kStages * kSlotBytes;      // 35,712
constexpr int kPhiFrames = 512;                        // frames of phi staged at once
constexpr int kPhiBytes = kPhiFrames * 3 * 4;          // 6,144
constexpr int kBarBytes = 2 * kStages * 8;             // full[], empty[]
constexpr int kFixedBytes = kRingBytes + kPhiBytes + kBarBytes;
// E is a multiple of 16, so a stage spans at most kStage / 16 + 1 frames
static_assert(kPhiFrames >= kStage / 16 + 1, "a stage's frames must fit the phi window");
static_assert(kStage % 16 == 0, "stages must be whole 16-byte granules of validity");

// ------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrive once and add `bytes` to the transactions the current phase awaits.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global to this CTA's shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Named barrier 1 over the consumer warps only.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ------------------------------------------------------------- arithmetic

// Non-finite -> -1e6, then clamp to +-1e6 (voting._sanitize).
__device__ __forceinline__ float sanitize(float c) {
  const float v = isfinite(c) ? c : -1e6f;
  return fminf(fmaxf(v, -1e6f), 1e6f);
}

// The quantized nearest vote's pixel coordinate: the Table-1 INT8
// plane-coord rule (EMVSQuantPolicy.quantize_plane_coord_values: out of
// [-0.5, 255.5] parks at 255, which the bounds test drops; in range, round
// half away from zero and clamp to [0, 255]; NaN converts to 0, as XLA's
// float->int32 does), then sanitize and floor(x + 0.5). The quantized
// coordinate is an integer in [0, 255], so the last two are identities;
// in [0, 255.5] rounding half away is floor(c + 0.5), and [-0.5, 0)
// rounds to -0 or -1, which clamps to 0.
__device__ __forceinline__ int quantized_pixel(float c) {
  const int in_range = c >= 0.f ? min(__float2int_rd(c + 0.5f), 255) : 0;
  return (c < -0.5f || c > 255.5f) ? 255 : in_range;
}

// The band pixel ((y - r0) * w + x) a nearest vote lands on, or -1 off
// the plane or outside rows [r0, r0 + rows): floor(x + 0.5) of the
// sanitized coordinate (|x| <= 1e6), converted once.
template <bool kQuantized>
__device__ __forceinline__ int nearest_pixel(float xi, float yi, int w, int r0, int rows) {
  int x, y;
  if (kQuantized) {
    x = quantized_pixel(xi);
    y = quantized_pixel(yi);
  } else {
    x = __float2int_rd(sanitize(xi) + 0.5f);
    y = __float2int_rd(sanitize(yi) + 0.5f);
  }
  y -= r0;
  return ((unsigned)x < (unsigned)w && (unsigned)y < (unsigned)rows) ? y * w + x : -1;
}

// The bilinear vote of weight 1 at (xi, yi): four f32 shared atomics, of
// which those in rows [r0, r0 + rows) land in this band.
__device__ __forceinline__ void bilinear_vote(float* acc, float xi, float yi, float wmax,
                                              float hmax, int w, int r0, int rows) {
  xi = sanitize(xi);
  yi = sanitize(yi);
  const float xf = floorf(xi);
  const float yf = floorf(yi);
  if (xf >= 0.f && xf + 1.f <= wmax && yf >= 0.f && yf + 1.f <= hmax) {
    const float fx = xi - xf;
    const float fy = yi - yf;
    // the reference's separable rows: ox = (1-fx, fx) * wt (wt = 1, exact),
    // oy = (1-fy, fy)
    const float ox0 = 1.f - fx;
    const float ox1 = fx;
    const float oy0 = 1.f - fy;
    const int y = (int)yf - r0;
    const int o = y * w + (int)xf;
    if ((unsigned)y < (unsigned)rows) {
      atomicAdd(&acc[o], oy0 * ox0);
      atomicAdd(&acc[o + 1], oy0 * ox1);
    }
    if ((unsigned)(y + 1) < (unsigned)rows) {
      atomicAdd(&acc[o + w], fy * ox0);
      atomicAdd(&acc[o + w + 1], fy * ox1);
    }
  }
}

// clip to the int16 range, then truncate (XLA's float->int16 convert)
__device__ __forceinline__ int16_t store_i16(float a) {
  return (int16_t)__float2int_rz(fminf(fmaxf(a, -32768.f), 32767.f));
}

// an integer vote count, clipped to the int16 range
__device__ __forceinline__ int16_t clamp_i16(int c) {
  return (int16_t)min(max(c, -32768), 32767);
}

// phi[s, f, z, :] for frames [lo, lo + kPhiFrames) into sphi, by `n` threads.
__device__ __forceinline__ void stage_phi(float* sphi, const float* __restrict__ phi, int s,
                                          int F, int nz, int z, int lo, int t, int n) {
  const int count = 3 * min(kPhiFrames, F - lo);
  for (int q = t; q < count; q += n) {
    const int f = lo + q / 3;
    sphi[q] = phi[(((long)s * F + f) * nz + z) * 3 + q % 3];
  }
}

// kBilinear: the bilinear vote, else nearest; kQuantized: the Table-1 plane
// coords (nearest) and the int16 store, else the f32 store.
template <bool kBilinear, bool kQuantized>
__global__ void __launch_bounds__(kThreads, 1)
backproject_vote_kernel(const float* __restrict__ x0,     // (S, F, E)
                        const float* __restrict__ y0,     // (S, F, E)
                        const uint8_t* __restrict__ valid,  // (S, F, E) 0/1
                        const float* __restrict__ phi,    // (S, F, Nz, 3)
                        void* __restrict__ dsi,           // (S, Nz, h, w)
                        int F, int E, int nz, int w, int h, int band_rows, float cx,
                        float cy) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* sphi = reinterpret_cast<float*>(smem + kRingBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kRingBytes + kPhiBytes);
  float* acc = reinterpret_cast<float*>(smem + kFixedBytes);
  int* iacc = reinterpret_cast<int*>(acc);

  const int z = blockIdx.x;
  const int s = blockIdx.y;
  const int r0 = blockIdx.z * band_rows;     // the band's first row
  const int rows = min(band_rows, h - r0);  // and its height
  const int tid = threadIdx.x;
  const int hw = rows * w;  // the band's pixels
  const int n_ev = F * E;  // E is a multiple of 16
  const int n_stages = (n_ev + kStage - 1) / kStage;
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[kStages]);

  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) {
      mbar_init(full0 + 8 * k, 1);
      mbar_init(empty0 + 8 * k, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers, before any copy or arrive reaches them

  if (tid >= kConsumers) {
    // ---- producer: one lane keeps the ring full
    if (tid == kConsumers) {
      const long base = (long)s * n_ev;
      for (int t = 0; t < n_stages; ++t) {
        const int slot = t % kStages;
        const uint32_t full = full0 + 8 * slot;
        const int c0 = t * kStage;
        const uint32_t n = min(kStage, n_ev - c0);  // a multiple of 16
        // the consumers have released the slot's last round
        if (t >= kStages) mbar_wait(empty0 + 8 * slot, ((t / kStages) + 1) & 1);
        mbar_expect_tx(full, 9 * n);
        const uint32_t dst = smem_u32(ring + slot * kSlotBytes);
        bulk_load(dst, x0 + base + c0, 4 * n, full);
        bulk_load(dst + 4 * kStage, y0 + base + c0, 4 * n, full);
        bulk_load(dst + 8 * kStage, valid + base + c0, n, full);
      }
    }
  } else {
    // ---- consumers: zero the band and stage phi while the first stages
    // arrive, then vote events c0 + 2 tid and c0 + 2 tid + 1 of every stage.
    // E is even, so a pair never straddles two frames; a frame
    // cursor keeps the pair's (alpha, beta_x, beta_y) in registers
    for (int i = tid; i < hw; i += kConsumers) acc[i] = 0.f;
    stage_phi(sphi, phi, s, F, nz, z, 0, tid, kConsumers);
    consumer_sync();
    const float wmax = (float)(w - 1);  // the bilinear bounds
    const float hmax = (float)(h - 1);
    int phi_lo = 0;  // first frame of the staged phi window
    long long phi_end = min((long long)kPhiFrames * E, (long long)n_ev);  // first event past it
    int f = 0;          // frame of this thread's last pair,
    int f_end = E;      // which ends before event f_end
    bool stale = true;  // alpha, beta_x, beta_y not loaded for f yet
    float alpha = 0.f, beta_x = 0.f, beta_y = 0.f;
    for (int t = 0; t < n_stages; ++t) {
      const int slot = t % kStages;
      const int c0 = t * kStage;
      const int n = min(kStage, n_ev - c0);
      if (c0 + n > phi_end) {  // move the window to the stage's frames
        consumer_sync();
        phi_lo = c0 / E;
        phi_end = min((long long)(phi_lo + kPhiFrames) * E, (long long)n_ev);
        stage_phi(sphi, phi, s, F, nz, z, phi_lo, tid, kConsumers);
        consumer_sync();
        stale = true;
      }
      mbar_wait(full0 + 8 * slot, (t / kStages) & 1);
      // the stage's x0, y0 and valid, as pairs
      const float2* ex = reinterpret_cast<const float2*>(ring + slot * kSlotBytes);
      const float2* ey = ex + kStage / 2;
      const uchar2* ev = reinterpret_cast<const uchar2*>(ey + kStage / 2);
      const uchar2 m = 2 * tid < n ? ev[tid] : make_uchar2(0, 0);
      int pix0 = -1, pix1 = -1;
      if (m.x | m.y) {  // an invalid event adds nothing
        const int g = c0 + 2 * tid;
        if (g >= f_end || stale) {
          while (g >= f_end) {
            ++f;
            f_end += E;
          }
          alpha = sphi[3 * (f - phi_lo)];
          beta_x = sphi[3 * (f - phi_lo) + 1];
          beta_y = sphi[3 * (f - phi_lo) + 2];
          stale = false;
        }
        const float2 x = ex[tid];
        const float2 y = ey[tid];
        const float xi0 = __fmaf_rn(alpha, x.x - cx, beta_x) + cx;
        const float yi0 = __fmaf_rn(alpha, y.x - cy, beta_y) + cy;
        const float xi1 = __fmaf_rn(alpha, x.y - cx, beta_x) + cx;
        const float yi1 = __fmaf_rn(alpha, y.y - cy, beta_y) + cy;
        if (kBilinear) {
          if (m.x) bilinear_vote(acc, xi0, yi0, wmax, hmax, w, r0, rows);
          if (m.y) bilinear_vote(acc, xi1, yi1, wmax, hmax, w, r0, rows);
        } else {
          pix0 = m.x ? nearest_pixel<kQuantized>(xi0, yi0, w, r0, rows) : -1;
          pix1 = m.y ? nearest_pixel<kQuantized>(xi1, yi1, w, r0, rows) : -1;
        }
      }
      if (pix0 >= 0) atomicAdd(&iacc[pix0], 1);
      if (pix1 >= 0) atomicAdd(&iacc[pix1], 1);
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(empty0 + 8 * slot);
    }
  }
  __syncthreads();  // every vote of this band is in

  // one element a thread: the store is bound by the card's write rate, not
  // by its instructions (16-byte stores measured no faster, PERF.md)
  const long out = (((long)s * nz + z) * h + r0) * w;
  if (kQuantized) {
    int16_t* d = static_cast<int16_t*>(dsi) + out;
    for (int i = tid; i < hw; i += kThreads)
      d[i] = kBilinear ? store_i16(acc[i]) : clamp_i16(iacc[i]);
  } else {
    float* d = static_cast<float*>(dsi) + out;
    for (int i = tid; i < hw; i += kThreads) d[i] = kBilinear ? acc[i] : (float)iacc[i];
  }
}

using KernelFn = void (*)(const float*, const float*, const uint8_t*, const float*, void*, int,
                         int, int, int, int, int, float, float);

KernelFn pick_kernel(int bilinear, int quantized) {
  if (bilinear)
    return quantized ? backproject_vote_kernel<true, true> : backproject_vote_kernel<true, false>;
  return quantized ? backproject_vote_kernel<false, true> : backproject_vote_kernel<false, false>;
}

int smem_bytes(int w, int rows) { return kFixedBytes + (rows * w * 4 + 15) / 16 * 16; }

}  // namespace

// Dynamic shared memory one CTA takes for a band of `rows` rows of a w-wide plane.
extern "C" int backproject_vote_smem_bytes(int w, int rows) { return smem_bytes(w, rows); }

extern "C" int backproject_vote_launch(const float* x0, const float* y0,
                                       const uint8_t* valid, const float* phi,
                                       void* dsi, int S, int F, int E, int nz,
                                       int w, int h, int band_rows, float cx, float cy,
                                       int bilinear, int quantized, void* stream) {
  const KernelFn kernel = pick_kernel(bilinear, quantized);
  const int smem = smem_bytes(w, band_rows);
  const int n_bands = (h + band_rows - 1) / band_rows;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(nz, S, n_bands), kThreads, smem, (cudaStream_t)stream>>>(
      x0, y0, valid, phi, dsi, F, E, nz, w, h, band_rows, cx, cy);
  return (int)cudaGetLastError();
}
