// Kernel C: Lanczos / linear / nearest resample of history rows at
// fractional positions that all rows of a pair share, for sm_90a.
//
// Replaces the TPU kernel
// signalizer_tpu/kernels/pallas_resample.py::fused_banded_resample with the
// function it computes: for each pair b, pixel p and row r,
//   out[b, r, p] = sum_j w(pos[b, p] - i_j) * x[b, r, clamp(i_j, 0, W-1)]
// over the 2a taps i_j = floor(pos) - a + 1 + j, j = 0..2a-1, with
//   lanczos: w(t) = a sin(pi t) sin(pi t / a) / (pi^2 t^2), 1 at |t| < 1e-6,
//            0 at |t| >= a (sinpif: exact argument reduction, no __sinf);
//   linear:  w(t) = max(0, 1 - |t|);
//   nearest: the sample at clamp(floor(pos + 0.5), 0, W-1).
// Clamping the tap index is the edge padding of pallas_resample.py:212-225.
// With `near` non-null one pass also writes the nearest pick at the same
// positions (the oscilloscope step's envelope source, pallas_resample.py
// :159-176).
//
// Layout: x [B, R, W] f32, pos [B, P] f32, out and near [B, R, P] f32, all
// contiguous. Grid: one 128-thread block per (pair, 128-pixel block), one
// thread per pixel; a tail block is masked, so any P works.
//
// What bounds it on the H100: at the oscilloscope's cfg3 geometry
// (16 pairs x 2 rows x 8192 px, a = 10) the whole call is 5.2 M FMAs,
// 2.1 MB read and 2.1 MB (4.2 MB with the nearest pick) written, ~2 us of
// HBM time: the kernel is bound by its launch and its per-thread latency
// (20 sinpif pairs per pixel), not by the device. The TPU kernel evaluated a
// dense [128 px, 256 src] weight grid and contracted it on the MXU because
// the TPU cannot gather cheaply; Hopper can, so each thread evaluates only
// its own 2a weights, once, and reuses them for all R rows (positions are
// shared by the rows). The block's tap span [min floor(pos) - a + 1,
// max floor(pos) + a] is staged once in shared memory for all R rows with
// coalesced loads when it fits kSmemFloats; a wider span (deep zoom-out, a
// 16384-sample window over 1024 px spans ~2 K samples per block) reads the
// taps from global memory through L1 in the same kernel. Sums are f32, in
// tap order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxA = 16;  // taps per pixel <= 2 * kMaxA
constexpr int kSmemFloats = 3072;  // 12 KB: the staged span, all rows
constexpr float kPi2 = 9.869604401089358f;

enum Kind { kLanczos = 0, kLinear = 1, kNearest = 2 };

__device__ __forceinline__ float tap_weight(int kind, float t, int a) {
  const float at = fabsf(t);
  if (kind == kLinear) return fmaxf(0.f, 1.f - at);
  if (at < 1e-6f) return 1.f;
  if (at >= (float)a) return 0.f;
  return (float)a * sinpif(t) * sinpif(t / (float)a) / (kPi2 * t * t);
}

// positions are clipped by the callers to a kernel radius outside the
// frame; the bound here only keeps the integer arithmetic defined
__device__ __forceinline__ int floor_index(float q) {
  return (int)floorf(fminf(fmaxf(q, -1.0e7f), 1.0e7f));
}

// One row's taps, from the staged span or from global memory.
template <bool kStaged>
__device__ __forceinline__ float fetch(const float* tile, const float* xrow,
                                      int r, int span, int lo, int i, int W) {
  if (kStaged) return tile[r * span + (i - lo)];
  return __ldg(xrow + min(max(i, 0), W - 1));
}

template <bool kStaged>
__device__ __forceinline__ void resample_rows(
    const float* tile, const float* xb, float* ob, float* nb, int R, int W,
    int P, int p, int span, int lo, int first, int inear, int taps, int kind,
    const float* wts) {
  for (int r = 0; r < R; ++r) {
    const float* xrow = xb + (size_t)r * W;
    float acc;
    if (kind == kNearest) {
      acc = fetch<kStaged>(tile, xrow, r, span, lo, inear, W);
    } else {
      acc = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * kMaxA; ++j) {
        if (j < taps) {
          acc = fmaf(wts[j], fetch<kStaged>(tile, xrow, r, span, lo, first + j, W), acc);
        }
      }
    }
    ob[(size_t)r * P + p] = acc;
    if (nb != nullptr) {
      nb[(size_t)r * P + p] = fetch<kStaged>(tile, xrow, r, span, lo, inear, W);
    }
  }
}

__global__ void banded_resample_kernel(const float* __restrict__ x,
                                       const float* __restrict__ pos,
                                       float* __restrict__ out,
                                       float* __restrict__ near, int R, int W,
                                       int P, int a, int kind, int nblk) {
  __shared__ float tile[kSmemFloats];
  __shared__ int s_lo, s_hi;

  const int b = blockIdx.x / nblk;
  const int p = (blockIdx.x % nblk) * kThreads + threadIdx.x;
  const bool active = p < P;
  const int taps = 2 * a;

  float q = 0.f;
  int i0 = 0, inear = 0;
  if (active) {
    q = pos[(size_t)b * P + p];
    i0 = floor_index(q);
    inear = floor_index(q + 0.5f);
  }

  // the block's tap span
  if (threadIdx.x == 0) {
    s_lo = 2147483647;
    s_hi = -2147483647;
  }
  __syncthreads();
  if (active) {
    atomicMin(&s_lo, i0);
    atomicMax(&s_hi, i0);
  }
  __syncthreads();
  const int lo = s_lo - a + 1;
  const int span = s_hi + a - lo + 1;
  const bool staged = (long long)R * span <= kSmemFloats;

  const float* xb = x + (size_t)b * R * W;
  if (staged) {
    for (int k = threadIdx.x; k < R * span; k += kThreads) {
      const int r = k / span;
      const int i = lo + (k - r * span);
      tile[k] = __ldg(xb + (size_t)r * W + min(max(i, 0), W - 1));
    }
    __syncthreads();
  }
  if (!active) return;

  // this pixel's weights, once for all rows
  const int first = i0 - a + 1;
  float wts[2 * kMaxA];
  if (kind != kNearest) {
#pragma unroll
    for (int j = 0; j < 2 * kMaxA; ++j) {
      if (j < taps) wts[j] = tap_weight(kind, q - (float)(first + j), a);
    }
  }

  float* ob = out + (size_t)b * R * P;
  float* nb = near == nullptr ? nullptr : near + (size_t)b * R * P;
  if (staged) {
    resample_rows<true>(tile, xb, ob, nb, R, W, P, p, span, lo, first, inear,
                        taps, kind, wts);
  } else {
    resample_rows<false>(tile, xb, ob, nb, R, W, P, p, span, lo, first, inear,
                         taps, kind, wts);
  }
}

}  // namespace

extern "C" int sig_banded_resample(const float* x, const float* pos,
                                   float* out, float* near, int B, int R,
                                   int W, int P, int a, int kind,
                                   void* stream) {
  if (B < 1 || R < 1 || W < 1 || P < 1 || a < 1 || a > kMaxA || kind < 0 ||
      kind > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int nblk = (P + kThreads - 1) / kThreads;
  if ((long long)nblk * B > 2147483647LL) return (int)cudaErrorInvalidValue;
  banded_resample_kernel<<<nblk * B, kThreads, 0, (cudaStream_t)stream>>>(
      x, pos, out, near, R, W, P, a, kind, nblk);
  return (int)cudaGetLastError();
}
