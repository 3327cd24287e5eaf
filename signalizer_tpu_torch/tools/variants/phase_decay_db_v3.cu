// Kernel G, third design (kept for kernel_variants: --kernels g --named
// phase_decay_db_v3; the entry and arguments it had): R helper threads a
// pixel of a line graph, each walking the whole recurrence and mapping
// every R-th frame, a branch-free ring of 8 frames in flight a thread.
//
// Kernel G: the Spectrum's PHASE display tail (the mid row's peak decay, the
// one-pole phase smoothing, the dB map of both rows) over T frames and K
// line graphs in one launch, for sm_90a.
//
// Replaces the compiled loops of post_process's PHASE branch,
// signalizer_tpu/kernels/spectrum.py:551-584: peak_decay_scan (a
// lax.associative_scan, signalizer_tpu/kernels/peak_decay.py:93) on the mid
// row and the lax.scan of the phase smoothing (:575); no Pallas kernel.
// (ref: TransformDSP.inl:1336-1341 peak filter, :1395-1419 phase smoothing.)
//
// Layout: vals [pairs, T, 2, P] f32 (row 0 the mid magnitude, row 1 the
// cancellation in [0, 1]); slope_map [P]; decay_poles [K] and phase_poles
// [K] (the decay poles to the power 0.3, computed by torch on the device so
// that the pow's rounding is the plain version's); scalars [4] = inv_size,
// lower, 1/log(upper/lower), clip_db; valid [T] f32 (nonzero: valid) or
// null; magnitude [pairs, K, rows, P] f32, of which only row 0 is read and
// written; phase [pairs, K, P] f32, updated in place; out [pairs, T, K, 2,
// P] f32. Per pixel, line graph k and frame t, when valid[t]:
//   m   = mid * 0.5
//   s   = max(pole_k * s, m)            (torch.maximum: NaN propagates)
//   tgt = cancel * m
//   ph  = tgt + pp_k * (ph - tgt)
// then out = (db(s), db(ph)), db the map of display_decay_db.cu. Each
// product, difference and sum is rounded on its own, as torch's separate
// launches round it (__fmul_rn, __fsub_rn, __fadd_rn: nvcc would contract
// a product and a sum into an FMA), so the states are the plain loop's bit
// for bit.
//
// What bounds it on the H100: each value is read once and each output
// written once (16.8 MB + 33.5 MB at the Spectrum headline, 16 pairs x 128
// frames x 1024 px x 2 line graphs: 15.0 us at 3.35 TB/s); the states and
// the slope are 0.4 MB more. Each output also costs an IEEE division and an
// accurate logf, some 40 instructions: 8.4 M outputs are ~10 M warp
// instructions, ~20 us of the card's issue slots at the headline.
//
// Design: the recurrence is a few operations a frame, the dB map of its two
// outputs some 80 instructions. So a pixel of a line graph is walked by R
// threads (R = 1, 2, 4 or 8 "helpers", the wrapper's choice by the grid's
// size: more helpers where the grid is small, as at the spectrogram's
// 1 pair x 512 frames), each running the whole recurrence itself and
// mapping to dB and storing only the frames t with t % R == its helper
// index. A warp is 32 neighbouring pixels of one helper index: its loads
// and stores are 128 contiguous bytes a row, and the R warps of a block
// read the same values (the later ones from L1). A thread keeps kAhead
// frames' loads (both rows and the valid flag) in flight: the load of frame
// t + kAhead is issued as frame t is consumed, with no branch in a ring of
// kAhead frames, so that their dB maps interleave. The outputs are stored
// evict-first. The threads are independent: no shared memory, no barrier.
// Splitting T across blocks (kernel B's chunk plan) is left for later.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // pixels a block: one warp's worth
constexpr int kAhead = 8;   // frames whose loads a thread keeps in flight (a multiple of every R)

struct Args {
  const float* vals;
  const float* slope_map;
  const float* decay_poles;
  const float* phase_poles;
  const float* scalars;
  const float* valid;
  float* magnitude;
  float* phase;
  float* out;
  int pairs, T, K, rows, P;
};

// torch.maximum: a NaN in either operand is the result (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// The normalized dB map, a copy of display_decay_db.cu's db() (kernel B's
// decay-and-dB entry), so that both tails map a value alike.
__device__ __forceinline__ float db(float slope, float s, float lower, float dyr,
                                    float clip_db) {
  const float x = slope * s / lower;
  return x > 0.f ? logf(fmaxf(x, 1e-38f)) * dyr : clip_db;
}

// One frame of a thread's walk: the recurrence in torch's order, each
// operation rounded on its own (when the frame is valid), then, when the
// frame is this thread's, the dB map of both rows stored evict-first. With
// one thread a pixel every frame is its own: the maps are computed
// unconditionally (only the stores of a lane past the row's end are
// skipped), so that the maps of a ring's frames interleave.
template <int kR>
__device__ __forceinline__ void frame(float mid, float cancel, bool valid, bool mine, float pole,
                                      float pp, float slope, float lower, float dyr, float clip_db,
                                      float& s, float& ph, float* o, int P) {
  const float m = __fmul_rn(mid, 0.5f);
  const float tgt = __fmul_rn(cancel, m);
  const float s_new = max_nan(__fmul_rn(pole, s), m);
  const float ph_new = __fadd_rn(tgt, __fmul_rn(pp, __fsub_rn(ph, tgt)));
  s = valid ? s_new : s;
  ph = valid ? ph_new : ph;
  if (kR == 1) {
    const float d0 = db(slope, s, lower, dyr, clip_db);
    const float d1 = db(slope, ph, lower, dyr, clip_db);
    if (mine) {
      __stcs(o, d0);
      __stcs(o + P, d1);
    }
  } else if (mine) {
    __stcs(o, db(slope, s, lower, dyr, clip_db));
    __stcs(o + P, db(slope, ph, lower, dyr, clip_db));
  }
}

// block (32 pixels, line graph k, pair) of kR warps; warp h of it maps the
// frames t with t % kR == h. A lane past the row's end (the last tile of a
// ragged P) walks its row's last pixel and stores nothing. kMasked: a valid
// mask is given.
template <int kR, bool kMasked>
__global__ void __launch_bounds__(kLanes * kR) phase_decay_db_kernel(Args a) {
  const int P = a.P;
  const int lane_p = blockIdx.x * kLanes + (threadIdx.x & (kLanes - 1));
  const bool active = lane_p < P;
  const int p = active ? lane_p : P - 1;
  const int h = kR == 1 ? 0 : threadIdx.x / kLanes;
  const int k = blockIdx.y;
  const int pair = blockIdx.z;
  const int T = a.T;
  const int K = a.K;
  const float pole = a.decay_poles[k];
  const float pp = a.phase_poles[k];
  const float lower = a.scalars[1];
  const float dyr = a.scalars[2];
  const float clip_db = a.scalars[3];
  const float slope = a.slope_map[p];

  float* mag = a.magnitude + ((size_t)pair * K + k) * a.rows * P + p;  // row 0
  float* ph_at = a.phase + ((size_t)pair * K + k) * P + p;
  float s = *mag;
  float ph = *ph_at;
  if (kR > 1) __syncthreads();  // every warp has read the states before warp 0 may write them

  const size_t plane = (size_t)2 * P;  // a frame's [2, P] of vals; a line graph's of out
  const float* src = a.vals + (size_t)pair * T * plane + p;
  float* dst = a.out + ((size_t)pair * T * K + k) * plane + p;
  const size_t out_frame = (size_t)K * plane;

  // the ring of frames in flight: frame t sits in slot t % kAhead. A load
  // past the last frame reads the last frame again (unused), so that the
  // walk over whole rings has no branch and its frames' dB maps interleave.
  float mid[kAhead], can[kAhead];
  bool ok[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const int t = i < T ? i : T - 1;
    mid[i] = src[(size_t)t * plane];
    can[i] = src[(size_t)t * plane + P];
    ok[i] = !kMasked || a.valid[t] != 0.f;
  }
  int t0 = 0;
  for (; t0 + kAhead <= T; t0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const float m = mid[i], c = can[i];
      const bool v = ok[i];
      const int next = min(t0 + i + kAhead, T - 1);
      mid[i] = src[(size_t)next * plane];
      can[i] = src[(size_t)next * plane + P];
      ok[i] = !kMasked || a.valid[next] != 0.f;
      frame<kR>(m, c, v, active && (kR == 1 || (i & (kR - 1)) == h), pole, pp, slope, lower, dyr, clip_db,
                s, ph, dst + (size_t)(t0 + i) * out_frame, P);
    }
  }
  // the last, partial ring: its frames are already loaded
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (t0 + i < T) {
      frame<kR>(mid[i], can[i], ok[i], active && (kR == 1 || (i & (kR - 1)) == h), pole, pp, slope,
                lower, dyr, clip_db, s, ph, dst + (size_t)(t0 + i) * out_frame, P);
    }
  }
  if (active && h == 0) {
    *mag = s;
    *ph_at = ph;
  }
}

typedef void (*KernelFn)(Args);

template <int kR>
KernelFn pick(bool masked) {
  return masked ? phase_decay_db_kernel<kR, true> : phase_decay_db_kernel<kR, false>;
}

}  // namespace

// The PHASE tail: vals [pairs, T, 2, P], magnitude [pairs, K, rows, P]
// (row 0 updated in place), phase [pairs, K, P] (updated in place), out
// [pairs, T, K, 2, P]; valid [T] f32 or null; helpers (R) 1, 2, 4 or 8
// threads a pixel.
extern "C" int sig_phase_decay_db(
    const float* vals, const float* slope_map, const float* decay_poles,
    const float* phase_poles, const float* scalars, const float* valid,
    float* magnitude, float* phase, float* out, int pairs, int T, int K, int rows,
    int P, int helpers, void* stream) {
  if (pairs < 1 || pairs > 65535 || T < 1 || K < 1 || K > 65535 || rows < 1 || P < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = {vals, slope_map, decay_poles, phase_poles, scalars, valid, magnitude, phase, out,
            pairs, T, K, rows, P};
  const dim3 grid((P + kLanes - 1) / kLanes, K, pairs);
  cudaStream_t s = (cudaStream_t)stream;
  KernelFn fn;
  switch (helpers) {
    case 1: fn = pick<1>(valid != nullptr); break;
    case 2: fn = pick<2>(valid != nullptr); break;
    case 4: fn = pick<4>(valid != nullptr); break;
    case 8: fn = pick<8>(valid != nullptr); break;
    default: return (int)cudaErrorInvalidValue;
  }
  fn<<<grid, kLanes * helpers, 0, s>>>(a);
  return (int)cudaGetLastError();
}
