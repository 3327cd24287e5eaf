// Kernel C: Lanczos / linear / nearest resample of history rows at
// fractional positions that all rows of a pair share, for sm_90a.
//
// Replaces the TPU kernel
// signalizer_tpu/kernels/pallas_resample.py::fused_banded_resample with the
// function it computes: for each pair b, pixel p and row r,
//   out[b, r, p] = sum_j w(pos[b, p] - i_j) * x[b, r, clamp(i_j, 0, W-1)]
// over the 2a taps i_j = floor(pos) - a + 1 + j, j = 0..2a-1, with
//   lanczos: w(t) = a sin(pi t) sin(pi t / a) / (pi^2 t^2), 1 at |t| < 1e-6,
//            0 at |t| >= a;
//   linear:  x[i0] (1 - frac) + x[i0 + 1] frac, i0 = floor(pos);
//   nearest: the sample at clamp(floor(pos + 0.5), 0, W-1).
// Clamping the tap index is the edge padding of pallas_resample.py:212-225.
// With `near` non-null one pass also writes the nearest pick at the same
// positions (the oscilloscope step's envelope source, pallas_resample.py
// :159-176). Positions come from a tensor pos [B, P], or are formed here as
// clamp(fma(p, step, start[b]), lo, hi) with one step for every pair (the
// oscilloscope step's: its window is a host number): one rounding, as a
// compiler that contracts start + p * step rounds it, and no position
// tensor in memory.
//
// Layout: x [B, R, W] f32, out and near [B, R, P] f32, all contiguous.
// Grid: one 128-thread block per (128-pixel block, pair), one thread per
// pixel; a tail block is masked, so any P works.
//
// The Lanczos weights take three trigonometric calls a pixel, not 4a. With
// n = the sample nearest to pos and d = pos - n (exact in f32, |d| <= 0.5),
// the 2a + 1 samples n + m, |m| <= a, are at t_m = d - m, and
//   sin(pi t_m)     = (-1)^m sin(pi d)                          (one sinpif)
//   sin(pi t_m / a) = sin(pi d / a) cos(pi m / a)
//                     - cos(pi d / a) sin(pi m / a)             (one sincospif)
// with cos(pi m / a), sin(pi m / a) rounded from float64 on the host and
// passed by value, so the unrolled a = 10 form reads them as constant
// operands. The rotation's absolute error (~1e-7) would be a large relative
// error of a sine near zero: that is why d is taken about the nearest
// sample. Only m = 0 can have a small |t|, and its sine is sin(pi d / a)
// itself; every other tap has |t| >= 0.5. Each tap then costs a
// multiply-add pair, a correctly rounded reciprocal of t^2 (no __sinf, no
// __fdividef) and two multiplies. Of the 2a + 1 candidates the plain
// version's 2a taps are all but m = -a (d >= 0) or m = +a (d < 0); that
// one has weight 0 by the |t| >= a rule and is predicated off, so exactly
// the plain version's samples are read, in its order.
//
// What bounds it on the H100: at the oscilloscope's cfg3 geometry
// (16 pairs x 2 rows x 8192 px, a = 10) the call moves 2.1 MB in and 2.1 MB
// out (1.25 us of HBM time; 1.4 us with a position tensor) and its
// arithmetic is smaller still (~340 operations a pixel, 0.7 us at the
// card's f32 rate), so what it takes is
// a launch's own few microseconds plus the issue slots it fills: with the
// weights replaced by constants the kernel takes as long as a bare nearest
// pick of the same outputs, and the weights add their ~300 issue slots a
// pixel over the card's 528 schedulers. So the design issues little and
// keeps every block resident at once: a, the kind and the
// second output are template parameters (the a = 10 weights live in 21
// registers, loops are unrolled without predicates), __launch_bounds__ asks
// for 8 blocks an SM (64 registers; a few weights spill, which costs less
// than the second wave of blocks that 80 registers would bring), and
// pixels whose taps lie inside the row skip the index clamps and read at
// constant offsets from one address. The taps are read straight through
// L1: a warp's 32 pixels share most of their taps at an upsample. The first
// revision staged each block's tap span in shared memory behind two
// atomics a thread and three barriers; with the weights this cheap there is
// nothing left for a tile to save.
//
// Not used, and why: wgmma (the TPU's dense [128 px, 256 src] x [256, R]
// product has R = 2-6 columns and would evaluate 256 weights a pixel where
// 20 are non-zero); TMA or cp.async.bulk (a pixel block's taps are ~300
// bytes with clamped edges, less than one bulk copy's set-up is worth).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxA = 16;  // taps per pixel <= 2 * kMaxA
constexpr int kMaxGridY = 65535;
constexpr float kInvPi2 = 0.10132118364233778f;  // 1 / pi^2

enum Kind { kLanczos = 0, kLinear = 1, kNearest = 2 };

// cos(pi m / a) and sin(pi m / a), m = 0..a
struct Rotation {
  float c[kMaxA + 1];
  float s[kMaxA + 1];
};

struct Args {
  const float* x;
  const float* pos;    // [B, P], or null: positions from start and step
  const float* start;  // [B]
  float step, lo, hi;
  float* out;
  float* near;
  int B, R, W, P, a;
};

__device__ __forceinline__ int clamp_index(int i, int W) {
  return min(max(i, 0), W - 1);
}

__device__ __forceinline__ float position(const Args& g, int b, int p) {
  float q;
  if (g.pos != nullptr) {
    q = g.pos[(size_t)b * g.P + p];
  } else {
    q = fminf(fmaxf(fmaf((float)p, g.step, g.start[b]), g.lo), g.hi);
  }
  // the callers clip positions to a kernel radius outside the frame; this
  // bound only keeps the integer arithmetic defined
  return fminf(fmaxf(q, -1.0e7f), 1.0e7f);
}

// The weights of the 2a + 1 samples n - a .. n + a about the nearest sample
// n = q - d; A is a at compile time, or 0 for the run-time a.
template <int A>
__device__ __forceinline__ void lanczos_weights(float d, int a_rt,
                                                const Rotation& rot, float* w) {
  const int a = A ? A : a_rt;
  const float fa = (float)a;
  const float s1 = sinpif(d);
  float sd, cd;
  sincospif(d / fa, &sd, &cd);
  const float k = fa * kInvPi2 * s1;
#pragma unroll
  for (int j = 0; j < 2 * a + 1; ++j) {
    const int m = j - a;
    const int am = m < 0 ? -m : m;
    const float t = d - (float)m;
    const float sm = m < 0 ? -rot.s[am] : rot.s[am];
    const float s2 = fmaf(sd, rot.c[am], -(cd * sm));  // sd itself at m = 0
    float wj = ((m & 1) ? -k : k) * s2 * __frcp_rn(t * t);
    if (m == 0) wj = fabsf(t) < 1e-6f ? 1.f : wj;
    if (am == a) wj = fabsf(t) >= fa ? 0.f : wj;
    w[j] = wj;
  }
}

// sum_j w[j] x[n - a + j] in tap order over the plain version's 2a taps:
// j = 0 belongs to them only where d < 0 (`low`), j = 2a only where d >= 0.
template <int A, bool kClamp>
__device__ __forceinline__ float weighted_sum(const float* xrow, int n, int W,
                                              int a_rt, bool low,
                                              const float* w) {
  const int a = A ? A : a_rt;
  const float* xn = xrow + (kClamp ? 0 : n);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * a + 1; ++j) {
    const int m = j - a;
    if (j == 0 ? low : (j == 2 * a ? !low : true)) {
      const float v = kClamp ? __ldg(xn + clamp_index(n + m, W)) : __ldg(xn + m);
      acc = fmaf(w[j], v, acc);
    }
  }
  return acc;
}

template <int A, bool kNear, bool kClamp>
__device__ __forceinline__ void lanczos_rows(const Args& g, const float* xb,
                                             float* ob, float* nb, int n,
                                             int inear, bool low,
                                             const float* w) {
  for (int r = 0; r < g.R; ++r) {
    const float* xrow = xb + (size_t)r * g.W;
    ob[(size_t)r * g.P] = weighted_sum<A, kClamp>(xrow, n, g.W, g.a, low, w);
    if (kNear) nb[(size_t)r * g.P] = __ldg(xrow + inear);
  }
}

template <int kKind, int A, bool kNear>
__global__ void __launch_bounds__(kThreads, 8)
banded_resample_kernel(const __grid_constant__ Args g,
                       const __grid_constant__ Rotation rot) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= g.P) return;
  for (int b = blockIdx.y; b < g.B; b += gridDim.y) {
    const float q = position(g, b, p);
    const float* xb = g.x + (size_t)b * g.R * g.W;
    float* ob = g.out + (size_t)b * g.R * g.P + p;
    float* nb = kNear ? g.near + (size_t)b * g.R * g.P + p : nullptr;
    const int inear = clamp_index((int)floorf(q + 0.5f), g.W);

    if (kKind == kLanczos) {
      const int a = A ? A : g.a;
      const float fn = rintf(q);
      const float d = q - fn;
      const int n = (int)fn;
      float w[2 * (A ? A : kMaxA) + 1];
      lanczos_weights<A>(d, g.a, rot, w);
      const bool low = d < 0.f;  // n = floor(q) + 1: the taps start at n - a
      if (n - a >= 0 && n + a < g.W) {
        lanczos_rows<A, kNear, false>(g, xb, ob, nb, n, inear, low, w);
      } else {
        lanczos_rows<A, kNear, true>(g, xb, ob, nb, n, inear, low, w);
      }
    } else {
      const float f0 = floorf(q);
      const float frac = q - f0;
      const int i0 = clamp_index((int)f0, g.W);
      const int i1 = clamp_index((int)f0 + 1, g.W);
      for (int r = 0; r < g.R; ++r) {
        const float* xrow = xb + (size_t)r * g.W;
        const float pick = __ldg(xrow + inear);
        ob[(size_t)r * g.P] =
            kKind == kNearest
                ? pick
                : fmaf(__ldg(xrow + i1), frac, __ldg(xrow + i0) * (1.f - frac));
        if (kNear) nb[(size_t)r * g.P] = pick;
      }
    }
  }
}

template <int kKind, int A>
void launch(const Args& g, const Rotation& rot, cudaStream_t stream) {
  const dim3 grid((g.P + kThreads - 1) / kThreads, min(g.B, kMaxGridY));
  if (g.near != nullptr) {
    banded_resample_kernel<kKind, A, true><<<grid, kThreads, 0, stream>>>(g, rot);
  } else {
    banded_resample_kernel<kKind, A, false><<<grid, kThreads, 0, stream>>>(g, rot);
  }
}

// `rotation` is a host array: cos(pi m / a), m = 0..a, then sin(pi m / a),
// m = 0..a (read for lanczos only).
int run(const Args& g, int kind, const float* rotation, void* stream) {
  if (g.B < 1 || g.R < 1 || g.W < 1 || g.P < 1 || g.a < 1 || g.a > kMaxA ||
      kind < 0 || kind > 2 || (kind == kLanczos && rotation == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Rotation rot = {};
  if (kind == kLanczos) {
    for (int m = 0; m <= g.a; ++m) {
      rot.c[m] = rotation[m];
      rot.s[m] = rotation[g.a + 1 + m];
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == kLanczos && g.a == 10) {
    launch<kLanczos, 10>(g, rot, s);
  } else if (kind == kLanczos) {
    launch<kLanczos, 0>(g, rot, s);
  } else if (kind == kLinear) {
    launch<kLinear, 1>(g, rot, s);
  } else {
    launch<kNearest, 1>(g, rot, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sig_banded_resample(const float* x, const float* pos,
                                   float* out, float* near, int B, int R,
                                   int W, int P, int a, int kind,
                                   const float* rotation, void* stream) {
  if (pos == nullptr) return (int)cudaErrorInvalidValue;
  const Args g = {x, pos, nullptr, 0.f, 0.f, 0.f, out, near, B, R, W, P, a};
  return run(g, kind, rotation, stream);
}

// Positions clamp(fma(p, step, start[b]), lo, hi), p = 0..P-1, formed in the
// kernel with one step for every pair.
extern "C" int sig_banded_resample_affine(const float* x, const float* start,
                                          float step, float lo, float hi,
                                          float* out, float* near, int B,
                                          int R, int W, int P, int a,
                                          int kind, const float* rotation,
                                          void* stream) {
  if (start == nullptr) return (int)cudaErrorInvalidValue;
  const Args g = {x, nullptr, start, step, lo, hi, out, near, B, R, W, P, a};
  return run(g, kind, rotation, stream);
}
