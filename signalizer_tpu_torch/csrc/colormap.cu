// The spectrogram's colour map (the gradient walk, the pair blend and the
// RGBA8 quantize) in one launch, for sm_90a.
//
// Replaces the plain path of kernels/colormap.py (spectrogram_columns_plain:
// gradient_map, blend_pairs, quantize_rgba8, some thirty torch operations a
// call, whose host dispatch paced the spectrogram's step). The JAX package's
// counterpart, signalizer_tpu/kernels/colormap.py, is plain jnp with no
// Pallas kernel, so this replaces no TPU kernel. (ref: SpectrumDSP.cpp:110-206
// blendAndDispatchSpectrums.)
//
// Layout: x [pairs, T, P] f32 at any element strides (the spectrogram hands
// the [:, :, 0, 0, :] view of kernel B's output); colours [pairs, S, 3] f32,
// or one [S, 3] table for every pair; bounds [S] f32, the running sum of the
// ratios (non-decreasing, bounds[0] == 0); out [T, P, 4] u8. Per pixel and
// pair, in pair order:
//   x   = clamp(v, 0, 1)                       (a NaN passes, as in torch.clamp)
//   seg = #{i : !(bounds[i] >= x)} clamped to [1, S - 1]
//                                              (searchsorted, right=False)
//   mix = (x - lo) / max(hi - lo, 1e-20) where hi > lo, else 1
//   c   = c_lo * (1 - mix) + c_hi * mix; the last stop where x >= 0.999;
//         black where v < 0
//   acc = acc * (1 - c)                        (acc from 1)
// then out = trunc(clamp(1 - acc, 0, 1) * 255) and alpha 255. Each operation
// is rounded on its own, as torch's separate launches round it (__fsub_rn,
// __fmul_rn, __fadd_rn, __fdiv_rn: nvcc at -O3 would contract a product and a
// sum into an FMA), so one pair gives the plain path's bytes exactly; with
// more pairs the product runs in pair order, which torch's reduction need
// not keep (an ulp of a colour, a byte by one).
//
// What bounds it on the H100: each intensity is read once and each pixel
// written once: at the spectrogram's 512 x 1024 pixels of one pair, 2 MiB in
// and 2 MiB out, 1.25 us at 3.35 TB/s. The arithmetic, some 50 operations a
// pixel and pair, is far below the card's issue rate.
//
// Design: a thread takes a run of kRun = 4 adjacent pixels of the output
// (flat over T x P: 16 bytes, one store), loads their intensities with one
// 16-byte load where the view allows it (P a multiple of 4, unit pixel
// stride, row and pair strides multiples of 4, an aligned base), else one by
// one, and walks the pairs in order. The segment search compares against
// the bounds held in registers (padded with +inf to kMaxStops, so a NaN
// counts past the last stop, as in searchsorted); a segment's ends and
// colours are read from shared memory, where the block stages the bounds and
// up to kStagedPairs pairs' tables at a time.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxStops = 16;     // gradient stops the kernel holds (the program uses 6)
constexpr int kRun = 4;           // pixels a thread: one 16-byte store
constexpr int kThreads = 256;     // threads a block
constexpr int kStagedPairs = 64;  // pairs' tables in shared memory at a time

struct Args {
  const float* x;
  long long sx_pair, sx_t, sx_p;  // element strides of x
  const float* colours;
  int tables;  // 1: one table for every pair; else a table a pair
  const float* bounds;
  uint32_t* out;  // a pixel's four bytes as one word
  long long n;    // T * P
  int pairs, P, S;
};

// torch.clamp(v, 0, 1): a NaN passes (fminf and fmaxf would drop it)
__device__ __forceinline__ float clamp01(float v) { return v < 0.f ? 0.f : (v > 1.f ? 1.f : v); }

// One pixel of one pair: its colour c, multiplied as (1 - c) into acc.
__device__ __forceinline__ void blend(float v, const float (&b)[kMaxStops], const float* bounds,
                                      const float* tab, int S, float (&acc)[3]) {
  const float x = clamp01(v);
  int seg = 0;
#pragma unroll
  for (int i = 0; i < kMaxStops; ++i) seg += !(b[i] >= x);
  seg = seg < 1 ? 1 : (seg > S - 1 ? S - 1 : seg);
  const float lo = bounds[seg - 1], hi = bounds[seg];
  const float width = __fsub_rn(hi, lo);
  const float q = __fdiv_rn(__fsub_rn(x, lo), width > 1e-20f ? width : 1e-20f);
  const float mix = hi > lo ? q : 1.f;
  const float keep = __fsub_rn(1.f, mix);
  const float* c_lo = tab + 3 * (seg - 1);
  const float* c_hi = tab + 3 * seg;
  const float* last = tab + 3 * (S - 1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float rgb = __fadd_rn(__fmul_rn(c_lo[c], keep), __fmul_rn(c_hi[c], mix));
    rgb = x >= 0.999f ? last[c] : rgb;
    rgb = v < 0.f ? 0.f : rgb;
    acc[c] = __fmul_rn(acc[c], __fsub_rn(1.f, rgb));
  }
}

// 1 - acc, clamped, times 255, truncated; alpha 255 in the top byte
__device__ __forceinline__ uint32_t rgba8(const float (&acc)[3]) {
  uint32_t px = 0xff000000u;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float y = clamp01(__fsub_rn(1.f, acc[c]));
    px |= (__float2uint_rz(__fmul_rn(y, 255.f)) & 0xffu) << (8 * c);
  }
  return px;
}

// Grid: one thread a run of kRun output pixels. kVec: the run's intensities
// are one aligned float4 of each pair.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) colormap_kernel(Args a) {
  __shared__ float s_bounds[kMaxStops];
  __shared__ float s_tab[kStagedPairs * kMaxStops * 3];
  const int S = a.S;
  if (threadIdx.x < kMaxStops) s_bounds[threadIdx.x] = threadIdx.x < S ? a.bounds[threadIdx.x] : CUDART_INF_F;
  float b[kMaxStops];
#pragma unroll
  for (int i = 0; i < kMaxStops; ++i) b[i] = i < S ? __ldg(a.bounds + i) : CUDART_INF_F;

  const long long first = ((long long)blockIdx.x * kThreads + threadIdx.x) * kRun;
  const int count = first < a.n ? (int)min((long long)kRun, a.n - first) : 0;
  // each pixel's offset within a pair's intensities (kVec: the run's first)
  long long off[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const long long i = first + (j < count ? j : 0);
    const long long t = i / a.P;
    off[j] = t * a.sx_t + (i - t * a.P) * a.sx_p;
    if (kVec) break;
  }
  float acc[kRun][3];
#pragma unroll
  for (int j = 0; j < kRun; ++j) acc[j][0] = acc[j][1] = acc[j][2] = 1.f;

  for (int p0 = 0; p0 < a.pairs; p0 += kStagedPairs) {
    const int np = min(kStagedPairs, a.pairs - p0);
    if (p0 == 0 || a.tables > 1) {
      __syncthreads();  // the stage before is read (and, first, the bounds are written)
      const int floats = (a.tables > 1 ? np : 1) * S * 3;
      const float* src = a.colours + (a.tables > 1 ? (long long)p0 * S * 3 : 0);
      for (int i = threadIdx.x; i < floats; i += kThreads) s_tab[i] = src[i];
      __syncthreads();
    }
    if (count == 0) continue;
    for (int q = 0; q < np; ++q) {
      const float* tab = s_tab + (a.tables > 1 ? q * S * 3 : 0);
      const float* xq = a.x + (long long)(p0 + q) * a.sx_pair;
      float v[kRun];
      if (kVec) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(xq + off[0]));
        v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
      } else {
#pragma unroll
        for (int j = 0; j < kRun; ++j) v[j] = j < count ? __ldg(xq + off[j]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRun; ++j) blend(v[j], b, s_bounds, tab, S, acc[j]);
    }
  }
  if (count == kRun) {
    *reinterpret_cast<uint4*>(a.out + first) = make_uint4(rgba8(acc[0]), rgba8(acc[1]), rgba8(acc[2]), rgba8(acc[3]));
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (j < count) a.out[first + j] = rgba8(acc[j]);
    }
  }
}

}  // namespace

// The colour map of x [pairs, T, P] f32 (element strides sx_pair, sx_t,
// sx_p) through colours (tables = 1: one [S, 3] table; tables = pairs: [pairs,
// S, 3], contiguous) and bounds [S] into out [T, P, 4] u8, 16-byte aligned.
// 2 <= S <= 16; pairs may be 0 (black).
extern "C" int sig_colormap(const float* x, long long sx_pair, long long sx_t, long long sx_p,
                            const float* colours, int tables, const float* bounds, unsigned char* out,
                            int pairs, int T, int P, int S, void* stream) {
  if (pairs < 0 || T < 1 || P < 1 || S < 2 || S > kMaxStops || (tables != 1 && tables != pairs) ||
      ((uintptr_t)out & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)T * P;
  const long long blocks = (n + (long long)kThreads * kRun - 1) / ((long long)kThreads * kRun);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a = {x, sx_pair, sx_t, sx_p, colours, tables, bounds, reinterpret_cast<uint32_t*>(out), n, pairs, P, S};
  const bool vec = P % kRun == 0 && sx_p == 1 && sx_t % kRun == 0 && (pairs <= 1 || sx_pair % kRun == 0) &&
                   ((uintptr_t)x & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    colormap_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  } else {
    colormap_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
