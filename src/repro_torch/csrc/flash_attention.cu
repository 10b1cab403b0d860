// Flash attention forward (online softmax over KV tiles), for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas` (`_kernel`): causal or full softmax attention
// with GQA, float32 statistics and accumulator, scores (q . k) * (1/sqrt(D)),
// NEG_INF = -1e30 for masked scores, causal alignment q_offset = Skv - Sq,
// the final `acc / max(l, 1e-30)`, output in the input's dtype.
//
// The TPU kernel walks KV blocks on a sequential third grid axis and keeps
// (m, l, acc) in VMEM scratch between grid steps. Blocks on Hopper run in
// no order, so here one CTA owns one (64-row query tile, batch x head) pair
// and loops over the KV tiles itself, keeping m, l and acc in registers.
// Tiles entirely above the causal diagonal are skipped with the reference's
// test: run tile j iff q0 + q_offset + BQ - 1 >= j * BK. Tile 0 always runs
// for every query at a position >= 0 and holds key 0 unmasked, so no row
// meets exp(s - m) with m = -1e30 once it has a real key. The KV head of
// query head h is h / q_per_kv (GQA without copying K/V). Query tiles are
// issued heaviest first (the causal tail): the tile index is the slow grid
// axis, counted down.
//
// Operands are read in any dense layout with a unit innermost stride: the
// caller passes (batch, head, seq) strides in elements for q, k, v and o,
// so the (B, S, H, D) views that the model's attention passes need no
// copies, and o is written in q's layout.
//
// Bound on the H100 at the serving path's prefill shapes (bf16, Hq 32,
// Hkv 8, D 128, causal): bytes. At S = 512, q, k and v read once and o
// written once are 10.5 MB, 3.13 us at 3.35 TB/s; the causal FLOPs of both
// products are 2.15 GFLOP, 2.2 us at 989 TFLOP/s. Two routes, chosen by
// the launcher from dtype and D alone:
//
// * Tensor cores (`flash_tc_kernel`): bf16, D a multiple of 16 up to 256.
//   160 threads: one consumer warpgroup owns the 64 query rows; one
//   producer warp issues TMA copies. Q (64 x D) is loaded once; K and V
//   tiles of 64 keys arrive in a two-stage ring guarded by full/empty
//   mbarriers. Operands stay bf16 in shared memory, in 64-column boxes
//   with the 128-byte swizzle that both TMA and wgmma understand (D is
//   rounded up to a multiple of 64 by the copies' zero fill): 16 KB + 2 x
//   32 KB at D = 128, so two CTAs share an SM; 160 KB at D = 256.
//   S = Q K^T is wgmma m64n64k16 with both operands K-major in shared
//   memory (D/16 steps). The online softmax runs on the accumulator
//   fragments in registers (row max over the 4 threads of a row by
//   shuffles, exp2 with log2(e) folded into the scale as one explicit
//   FMA); only tiles on the diagonal or the ragged end are masked.
//   O += P V is wgmma m64n64k16 per 64 output columns with A = P from
//   registers (the S accumulator rounded pairwise to bf16, whose fragment
//   layout is the register-A layout of each 16-key slice) and B = the V
//   tile, MN-major (the transpose bit). P is rounded to bf16 before the
//   product, as FlashAttention does; l sums the float32 P.
// * CUDA cores (`flash_fma_kernel`): float32 (tensor-core products would
//   be TF32, about three digits, against a 2e-5 tolerance) and bf16 with
//   D % 16 != 0. 256 threads, q/k/v tiles converted to float32 in shared
//   memory, a 4 x 4 register tile per thread, float32 FMAs.
//
// Built with --fmad=false (for B1's parity): every FMA here is written as
// __fmaf_rn.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;  // elements; the innermost (D) stride is 1
};

// ------------------------------------------------------------------ CUDA cores

constexpr int kFmaThreads = 256;
constexpr int kPad = 4;
constexpr int kLdP = BK + kPad;

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

// Rows [row0, row0 + R) of a (rows, d) matrix with row stride `rs` into
// shared memory as float32 with leading dimension ld; rows past the end
// are zero.
template <typename T, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long rs, int row0,
                                          int rows, int d, int ld) {
  const int vecs = d >> 2;
  for (int e = threadIdx.x; e < R * vecs; e += kFmaThreads) {
    const int r = e / vecs;
    const int c = (e - r * vecs) << 2;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) x = load4(src + (row0 + r) * rs + c);
    store4(dst + r * ld + c, x);
  }
}

__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

// grid (B * Hq, ceil(Sq / BQ)), 256 threads. Dynamic shared memory: the
// query tile, the current K and V tiles (float32, rows padded by 4 floats
// so a quarter-warp's K reads hit distinct banks) and the 64 x 64
// probability tile. Thread (ty, tx) owns rows 4*ty..4*ty+3: scores at
// columns tx + 16*j (j < 4), output at columns 4*tx + 64*c (c < NC).
template <typename T, int NC>
__global__ void __launch_bounds__(kFmaThreads)
flash_fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int hq,
                 int sq, int skv, int d, int q_per_kv, int causal, float scale) {
  extern __shared__ float4 smem4[];
  const int ld = d + kPad;
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * ld;
  float* sV = sK + BK * ld;
  float* sP = sV + BK * ld;

  const int b = blockIdx.x / hq;
  const int h = blockIdx.x - b * hq;
  const int hk = h / q_per_kv;
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int q0 = qi * BQ;
  const int q_offset = skv - sq;
  const T* qg = q + b * qs.b + h * qs.h;
  const T* kg = k + b * ks.b + hk * ks.h;
  const T* vg = v + b * vs.b + hk * vs.h;

  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int r0 = ty * 4;

  load_tile<T, BQ>(sQ, qg, qs.s, q0, sq, d, ld);

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
    load_tile<T, BK>(sK, kg, ks.s, k0, skv, d, ld);
    load_tile<T, BK>(sV, vg, vs.s, k0, skv, d, ld);
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
    T* orow = o + b * os.b + h * os.h + row * os.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * 4 + 64 * c;
      if (col < d)
        store4(orow + col, make_float4(acc[i][c * 4 + 0] / den, acc[i][c * 4 + 1] / den,
                                       acc[i][c * 4 + 2] / den, acc[i][c * 4 + 3] / den));
    }
  }
}

// ---------------------------------------------------------------- tensor cores

constexpr int kStages = 2;
constexpr int kConsumers = 128;                 // one warpgroup
constexpr int kTcThreads = kConsumers + 32;     // + one producer warp
constexpr int kAtomCols = 64;                   // bf16 columns in a 128-byte swizzle row
constexpr uint32_t kAtomBytes = 64 * 128;       // one 64-row x 64-column swizzled box
constexpr uint32_t kSwizzleGroup = 8 * 128;     // 8 rows of 128 bytes: the swizzle period

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

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

// One (64-column, 64-row) box of a 4-D (D, S, H, B) tensor map into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
// Every operand here spans one swizzle atom along its contiguous dimension
// (64 bf16), so only the stride between 8-row groups (1024 B) matters; it
// is written in both offset fields.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  constexpr uint64_t off = kSwizzleGroup >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (off << 16) | (off << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous region between a wgmma's issue and its wait.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) = A (64 x 16) B (16 x 64) + scale_d * d; A and B bf16
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64); B bf16
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr size_t tc_smem_bytes(int na) {
  // Q, kStages x (K, V), 2 x kStages + 1 barriers, slack to align to 1024
  return (size_t)(1 + 2 * kStages) * na * kAtomBytes + 8 * (2 * kStages + 1) + 1024;
}

// grid (B * Hq, ceil(Sq / BQ)), kTcThreads threads, NA = ceil(D / 64)
// 64-column boxes per tile. Shared memory (1024-aligned): Q | K0 V0 | K1 V1
// | full[2] empty[2] q barriers. Accumulator fragment of wgmma m64n64 for
// thread t of the warpgroup: rows r = 16 * (t / 32) + (t % 32) / 4 (and
// r + 8), columns c = 2 * (t % 4) + 8 * g (and c + 1), g < 8; register
// 4g + 0/1 is (r, c/c+1), 4g + 2/3 is (r + 8, c/c+1).
template <int NA>
__global__ void __launch_bounds__(kTcThreads, NA <= 2 ? 2 : 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                Strides os, int hq, int sq, int skv, int d, int q_per_kv, int causal,
                float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t kTile = NA * kAtomBytes;
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = sQ + (1 + 2 * kStages) * kTile;
  const uint32_t q_bar = bars + 8 * 2 * kStages;

  const int b = blockIdx.x / hq;
  const int h = blockIdx.x - b * hq;
  const int hk = h / q_per_kv;
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int q0 = qi * BQ;
  const int q_offset = skv - sq;
  int n_tiles = (skv + BK - 1) / BK;
  if (causal) {
    const int last = q0 + q_offset + BQ - 1;  // largest query position here
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                        // full: the producer's arrival
      mbar_init(bars + 8 * (kStages + s), kConsumers);   // empty: every consumer thread
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warp: one thread keeps the ring full.
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_bar, kTile);
#pragma unroll
      for (int a = 0; a < NA; ++a) tma_load(sQ + a * kAtomBytes, &tq, q_bar, a * kAtomCols, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(bars + 8 * (kStages + st), ((j / kStages) - 1) & 1);
        const uint32_t full = bars + 8 * st;
        const uint32_t sK = sQ + (1 + 2 * st) * kTile;
        const uint32_t sV = sK + kTile;
        mbar_expect_tx(full, 2 * kTile);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tma_load(sK + a * kAtomBytes, &tk, full, a * kAtomCols, j * BK, hk, b);
          tma_load(sV + a * kAtomBytes, &tv, full, a * kAtomCols, j * BK, hk, b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup.
  const int t = threadIdx.x;
  const int r_lo = 16 * (t >> 5) + ((t & 31) >> 2);
  const int c_lo = 2 * (t & 3);
  const int qpos_lo = q0 + r_lo + q_offset;
  const int qpos_hi = qpos_lo + 8;

  float acc[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;  // row maxima, in log2 units of the scaled score
  float l_lo = 0.f, l_hi = 0.f;          // this thread's share of the row sums

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t sK = sQ + (1 + 2 * st) * kTile;
    const uint32_t sV = sK + kTile;
    mbar_wait(bars + 8 * st, (j / kStages) & 1);

    // S = Q K^T, raw (unscaled) scores
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NA; ++kk) {
      const uint32_t off = (kk >> 2) * kAtomBytes + (kk & 3) * 32;
      wgmma_ss(s, sw128_desc(sQ + off), sw128_desc(sK + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int k0 = j * BK;
    if (k0 + BK > skv || (causal && k0 + BK - 1 > q0 + q_offset)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kpos = k0 + c_lo + 8 * (i >> 2) + (i & 1);
        const int qpos = (i & 2) ? qpos_hi : qpos_lo;
        if (kpos >= skv || (causal && kpos > qpos)) s[i] = kNegInf;
      }
    }
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx_hi = fmaxf(mx_hi, s[i]);
      else mx_lo = fmaxf(mx_lo, s[i]);
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo) * scale_log2);
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi) * scale_log2);
    const float corr_lo = exp2f(m_lo - mn_lo);
    const float corr_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      // exp((q.k) / sqrt(D) - m) as exp2 of one FMA
      const float p = exp2f(__fmaf_rn(s[i], scale_log2, (i & 2) ? -mn_hi : -mn_lo));
      s[i] = p;
      if (i & 2) sum_hi += p;
      else sum_lo += p;
    }
    l_lo = __fmaf_rn(l_lo, corr_lo, sum_lo);
    l_hi = __fmaf_rn(l_hi, corr_hi, sum_hi);

    // P as the register A operand, one 16-key slice per kk
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int a = 0; a < NA; ++a) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] *= (i & 2) ? corr_hi : corr_lo;
      fence_regs(acc[a]);
    }

    // O += P V: 16 keys (2048 B of the V box) per k-step, 64 columns per box
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < NA; ++a)
        wgmma_rs(acc[a], pa[kk], sw128_desc(sV + a * kAtomBytes + kk * 2 * kSwizzleGroup));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
    mbar_arrive(bars + 8 * (kStages + st));  // this stage may be refilled
  }

  const float den_lo = fmaxf(quad_sum(l_lo), 1e-30f);
  const float den_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  const int row_lo = q0 + r_lo;
  const int row_hi = row_lo + 8;
  __nv_bfloat16* o_lo = o + b * os.b + h * os.h + row_lo * os.s;
  __nv_bfloat16* o_hi = o_lo + 8 * os.s;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int col = a * kAtomCols + 8 * g + c_lo;
      if (col >= d) continue;
      if (row_lo < sq)
        *reinterpret_cast<uint32_t*>(o_lo + col) =
            pack_bf16(acc[a][4 * g + 0] / den_lo, acc[a][4 * g + 1] / den_lo);
      if (row_hi < sq)
        *reinterpret_cast<uint32_t*>(o_hi + col) =
            pack_bf16(acc[a][4 * g + 2] / den_hi, acc[a][4 * g + 3] / den_hi);
    }
}

// ------------------------------------------------------------------- launchers

struct Args {
  const void *q, *k, *v;
  void* o;
  Strides qs, ks, vs, os;
  int b, hq, hkv, sq, skv, d, causal;
  float scale;
};

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kTensorMapErrorBase = 100000;  // returned as kTensorMapErrorBase + CUresult

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library links no -lcuda.
int encode_tiled(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return (int)cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  *out = fn;
  return 0;
}

// A 4-D (D, S, H, B) bf16 map with byte strides, read in (64, 64, 1, 1)
// boxes with the 128-byte swizzle; out-of-bounds elements read as zero.
int make_map(CUtensorMap* map, const void* ptr, int d, int s, int h, int b, Strides st) {
  EncodeTiledFn encode;
  int err = encode_tiled(&encode);
  if (err) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {kAtomCols, BK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapErrorBase + (int)r;
}

template <int NA>
int launch_tc(const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, a.q, a.d, a.sq, a.hq, a.b, a.qs);
  if (!err) err = make_map(&mk, a.k, a.d, a.skv, a.hkv, a.b, a.ks);
  if (!err) err = make_map(&mv, a.v, a.d, a.skv, a.hkv, a.b, a.vs);
  if (err) return err;
  constexpr size_t smem = tc_smem_bytes(NA);
  cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<NA>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.b * a.hq, (a.sq + BQ - 1) / BQ);
  flash_tc_kernel<NA><<<grid, kTcThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(a.o), a.os, a.hq, a.sq, a.skv, a.d,
      a.hq / a.hkv, a.causal, a.scale * kLog2e);
  return (int)cudaGetLastError();
}

size_t fma_smem_bytes(int d) {
  return ((size_t)(BQ + 2 * BK) * (d + kPad) + (size_t)BQ * kLdP) * sizeof(float);
}

template <typename T, int NC>
int launch_fma(const Args& a, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(a.d);
  cudaError_t err = cudaFuncSetAttribute(flash_fma_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.b * a.hq, (a.sq + BQ - 1) / BQ);
  flash_fma_kernel<T, NC><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.qs, a.ks, a.vs, a.os, a.hq, a.sq, a.skv, a.d, a.hq / a.hkv,
      a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fma_d(const Args& a, cudaStream_t st) {
  switch ((a.d + 63) / 64) {
    case 1: return launch_fma<T, 1>(a, st);
    case 2: return launch_fma<T, 2>(a, st);
    case 3: return launch_fma<T, 3>(a, st);
    default: return launch_fma<T, 4>(a, st);
  }
}

int launch_tc_d(const Args& a, cudaStream_t st) {
  switch ((a.d + 63) / 64) {
    case 1: return launch_tc<1>(a, st);
    case 2: return launch_tc<2>(a, st);
    case 3: return launch_tc<3>(a, st);
    default: return launch_tc<4>(a, st);
  }
}

}  // namespace

// q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D); o (B, Hq, Sq, D), each with a
// unit innermost stride and (batch, head, seq) strides in elements in
// `strides` (q, k, v, o: 12 values), all multiples of 16 bytes.
// dtype: 0 = float32, 1 = bfloat16. route: 0 = CUDA cores (D a multiple
// of 8 in [8, 256]), 1 = tensor cores (bfloat16, D a multiple of 16 in
// [16, 256]). Returns a cudaError_t, or 100000 + a CUresult when a tensor
// map cannot be encoded.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int b, int hq, int hkv, int sq, int skv, int d,
                                      const long long* strides, int causal, float scale,
                                      int dtype, int route, void* stream) {
  if (d < 8 || d > 256 || d % 8 != 0 || b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 ||
      (long long)b * hq > 0x7fffffffLL || sq <= 0 || skv <= 0 || (sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.qs = {strides[0], strides[1], strides[2]};
  a.ks = {strides[3], strides[4], strides[5]};
  a.vs = {strides[6], strides[7], strides[8]};
  a.os = {strides[9], strides[10], strides[11]};
  a.b = b; a.hq = hq; a.hkv = hkv; a.sq = sq; a.skv = skv; a.d = d;
  a.causal = causal;
  a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 1) {
    if (dtype != 1 || d % 16 != 0) return (int)cudaErrorInvalidValue;
    return launch_tc_d(a, st);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch_fma_d<float>(a, st);
    case 1: return launch_fma_d<__nv_bfloat16>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
