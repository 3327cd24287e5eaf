// Kernel D: the envelope-hold trigger's scan, for sm_90a.
//
// Replaces the lax.scan of
// signalizer_tpu/kernels/oscilloscope.py::peak_hold_triggers (ref:
// PeakHoldProcessor, StreamPreprocessing.h:270-312) with the recurrence it
// computes. For each row of x [rows, W] f32, over the consumed samples i
// (i >= first, and valid[i] where a mask is given), in order:
//   s       = x[i] * x[i]
//   delta   = s - st
//   falling = delta < 0
//   fire[i] = falling & hold
//   hold    = !falling & (hold | delta > hysteresis * st)
//   st      = falling ? max(thr^2, st * decay) : s
// A sample that is not consumed leaves st and hold as they are and does not
// fire. The output is the fire shifted back by one sample (the event is
// the sample before the first one that no longer qualifies):
//   out[j] = fire[j + 1], j < W - 1;  out[W - 1] = 0;  out[0] |= fire[0]
// (a fall at sample 0 is clamped to sample 0). The carried st and hold go
// in and come out, one a row.
//
// Every operation is one f32 operation as the plain PyTorch loop takes it:
// __fmul_rn / __fsub_rn keep nvcc from contracting x * x - st into a fused
// multiply-add, and the max propagates a NaN in either operand, as
// torch.maximum does (fmaxf alone would drop it), by a select, not a branch.
//
// What bounds it on the H100: not bytes (cfg3's 16 rows x 8192 samples are
// 0.5 MB in and 0.13 MB out, ~0.2 us of HBM time) but the serial chain: a
// row's W steps each wait on the last one's st (a subtract, a compare and
// a select, ~12-20 cycles), tens of microseconds at W = 8192 and ~10 us at
// a live tick's 1600 samples, however many rows run beside it. So the
// design keeps the chain's operands close: one block a row, its 128 threads
// staging the consumed span, a tile at a time, into shared memory with
// coalesced loads (the squares taken there), one thread walking the tile
// with st and hold in registers and writing a fire byte a sample to shared
// memory, then all threads storing the shifted fires, coalesced. Rows run
// in parallel, one block each. Samples before `first` are never loaded:
// their fires are stored as zeros. The walker reads 8 samples (and their
// mask bytes) into registers before it steps through them, so no step waits
// on a shared-memory load, and every step is branch-free (selects and
// bitwise logic): the loop carries only the subtract, compare and select of
// the chain. (On an H100 the first revision, a shared-memory load a step,
// took 121 us at cfg3's tick, ~150 cycles a sample; with the loads ahead
// and short-circuit logic, 95 us.)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 4096;  // samples a tile: 16 KB of squares, 8 KB of bytes
constexpr int kUnroll = 8;  // samples read into registers ahead of the chain

// torch.maximum's NaN rule (a NaN in either operand is the result), as a
// select: a + b is NaN when either is
__device__ __forceinline__ float max_nan(float a, float b) {
  const float m = fmaxf(a, b);
  return (isnan(a) | isnan(b)) ? a + b : m;
}

// One sample of the recurrence; returns the fire (before the shift). Every
// value is computed and the logic is bitwise (& and |, not && and ||), so
// that nothing is a branch.
template <bool kMask>
__device__ __forceinline__ bool step(float s, bool use, float& st, bool& hold,
                                     float thr2, float hyst, float decay) {
  const float delta = __fsub_rn(s, st);
  const bool falling = delta < 0.f;
  const bool jump = delta > __fmul_rn(hyst, st);
  const float lowered = max_nan(thr2, __fmul_rn(st, decay));
  const bool held = !falling & (hold | jump);
  const float next = falling ? lowered : s;
  const bool fire = falling & hold;
  if (kMask) {
    hold = use ? held : hold;
    st = use ? next : st;
    return fire & use;
  }
  hold = held;
  st = next;
  return fire;
}

// The walker's pass over a staged tile of n samples.
template <bool kMask>
__device__ __forceinline__ void walk(const float* s_sq, const bool* s_valid,
                                     bool* s_fire, int n, float& st,
                                     bool& hold, float thr2, float hyst,
                                     float decay) {
  int k = 0;
  for (; k + kUnroll <= n; k += kUnroll) {
    float v[kUnroll];
    bool u[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      v[j] = s_sq[k + j];
      u[j] = kMask ? s_valid[k + j] : true;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      s_fire[k + j] = step<kMask>(v[j], u[j], st, hold, thr2, hyst, decay);
    }
  }
  for (; k < n; ++k) {
    s_fire[k] = step<kMask>(s_sq[k], kMask ? s_valid[k] : true, st, hold, thr2, hyst, decay);
  }
}

__global__ void __launch_bounds__(kThreads) peak_hold_kernel(
    const float* __restrict__ x, long long row_stride,
    const bool* __restrict__ valid, const float* __restrict__ state_in,
    const bool* __restrict__ holding_in, const float* __restrict__ threshold,
    const float* __restrict__ hysteresis, float thr2_value, float hyst_value,
    float decay, float* __restrict__ state_out, bool* __restrict__ holding_out,
    bool* __restrict__ fires, int w, int first) {
  __shared__ float s_sq[kTile];
  __shared__ bool s_valid[kTile];
  __shared__ bool s_fire[kTile];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xr = x + (long long)row * row_stride;
  bool* out = fires + (long long)row * w;

  // thread 0 walks; the others only load and store
  float st = 0.f, thr2 = 0.f, hyst = 0.f;
  bool hold = false, fire0 = false;
  if (tid == 0) {
    st = state_in[row];
    hold = holding_in[row];
    thr2 = threshold != nullptr ? __fmul_rn(*threshold, *threshold) : thr2_value;
    hyst = hysteresis != nullptr ? *hysteresis : hyst_value;
  }
  // nothing consumed before `first`: out[j] = fire[j + 1] = 0 for j < first - 1
  const int zeros = min(first - 1, w - 1);
  for (int j = tid; j < zeros; j += kThreads) out[j] = false;

  for (int t0 = first; t0 < w; t0 += kTile) {
    const int n = min(kTile, w - t0);
    __syncthreads();  // the last tile's stores have read s_fire
    for (int k = tid; k < n; k += kThreads) {
      const float v = xr[t0 + k];
      s_sq[k] = __fmul_rn(v, v);
      if (valid != nullptr) s_valid[k] = valid[t0 + k];
    }
    __syncthreads();
    if (tid == 0) {
      if (valid != nullptr) {
        walk<true>(s_sq, s_valid, s_fire, n, st, hold, thr2, hyst, decay);
      } else {
        walk<false>(s_sq, s_valid, s_fire, n, st, hold, thr2, hyst, decay);
      }
      if (t0 == 0) fire0 = s_fire[0];
    }
    __syncthreads();
    for (int k = tid; k < n; k += kThreads) {
      const int j = t0 + k - 1;
      if (j >= 0) out[j] = s_fire[k] || (j == 0 && t0 == 0 && s_fire[0]);
    }
  }
  if (tid == 0) {
    // the last sample has no later fire; with W = 1 it is sample 0 itself
    out[w - 1] = w == 1 && fire0;
    state_out[row] = st;
    holding_out[row] = hold;
  }
}

}  // namespace

// x [rows, W] f32 with rows `row_stride` floats apart (unit stride within a
// row); valid [W] bool or null; state_in/out [rows] f32; holding_in/out
// [rows] bool; fires [rows, W] bool, contiguous. The threshold and the
// hysteresis are read from device scalars where those are given (the
// square taken here), else taken by value (thr2_value already squared).
extern "C" int sig_peak_hold(const float* x, long long row_stride,
                             const bool* valid, const float* state_in,
                             const bool* holding_in, const float* threshold,
                             const float* hysteresis, float thr2_value,
                             float hyst_value, float decay, float* state_out,
                             bool* holding_out, bool* fires, int rows, int w,
                             int first, void* stream) {
  if (rows < 1 || w < 1 || first < 0 || row_stride < w) {
    return (int)cudaErrorInvalidValue;
  }
  peak_hold_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      x, row_stride, valid, state_in, holding_in, threshold, hysteresis,
      thr2_value, hyst_value, decay, state_out, holding_out, fires, w, first);
  return (int)cudaGetLastError();
}
