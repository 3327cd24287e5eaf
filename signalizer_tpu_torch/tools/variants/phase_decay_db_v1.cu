// Kernel G, first design (kept for kernel_variants, entry
// sig_phase_decay_db_v1: a thread per 4 pixels of a line graph walks T and
// maps every frame to dB itself): the Spectrum's PHASE display tail (the
// mid row's peak decay, the one-pole phase smoothing, the dB map of both
// rows) over T frames and K line graphs in one launch, for sm_90a.
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
// accurate logf.
//
// Design: a thread owns 4 consecutive pixels of one line graph of one pair
// (16-byte loads and stores; a scalar form where P or a pointer is not
// 16-byte aligned) and walks T in order, keeping kAhead frames' loads (both
// rows and the valid flag) in flight: the load of frame t + kAhead is
// issued as frame t is consumed. The outputs are stored evict-first. The
// threads are independent: no shared memory, no barrier. At few pixels and
// long T (the spectrogram's 1 pair x 512 frames) the grid is a few blocks
// and each thread's walk is long; splitting T across blocks (kernel B's
// chunk plan) is left for later.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // threads a block: more blocks on few pixels
constexpr int kAhead = 8;     // frames whose loads a thread keeps in flight

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

// 4 consecutive floats at p of a row of P: one 16-byte access (kVec) or
// four masked ones.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* row, int p, int P) {
  if (kVec) return *reinterpret_cast<const float4*>(row + p);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p < P) v.x = row[p];
  if (p + 1 < P) v.y = row[p + 1];
  if (p + 2 < P) v.z = row[p + 2];
  if (p + 3 < P) v.w = row[p + 3];
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* row, int p, int P, float4 v) {
  if (kVec) {
    *reinterpret_cast<float4*>(row + p) = v;
    return;
  }
  if (p < P) row[p] = v.x;
  if (p + 1 < P) row[p + 1] = v.y;
  if (p + 2 < P) row[p + 2] = v.z;
  if (p + 3 < P) row[p + 3] = v.w;
}

template <bool kVec>
__device__ __forceinline__ void stream4(float* row, int p, int P, float4 v) {
  if (kVec) {
    __stcs(reinterpret_cast<float4*>(row + p), v);
  } else {
    store4<false>(row, p, P, v);
  }
}

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

// One pixel's frame: the decay and the smoothing (when valid), in torch's
// order, each operation rounded on its own.
__device__ __forceinline__ void step(float mid, float cancel, bool ok, float pole, float pp,
                                     float& s, float& ph) {
  const float m = __fmul_rn(mid, 0.5f);
  const float tgt = __fmul_rn(cancel, m);
  const float s_new = max_nan(__fmul_rn(pole, s), m);
  const float ph_new = __fadd_rn(tgt, __fmul_rn(pp, __fsub_rn(ph, tgt)));
  if (ok) {
    s = s_new;
    ph = ph_new;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) phase_decay_db_kernel(Args a) {
  const int P = a.P;
  const int p = (blockIdx.x * kThreads + threadIdx.x) * 4;
  const int k = blockIdx.y;
  const int pair = blockIdx.z;
  if (p >= P) return;
  const int T = a.T;
  const int K = a.K;
  const float pole = a.decay_poles[k];
  const float pp = a.phase_poles[k];
  const float lower = a.scalars[1];
  const float dyr = a.scalars[2];
  const float clip_db = a.scalars[3];
  const float4 slope = load4<kVec>(a.slope_map, p, P);

  float* mag_row = a.magnitude + ((size_t)pair * K + k) * a.rows * P;  // row 0
  float* ph_row = a.phase + ((size_t)pair * K + k) * P;
  float4 s = load4<kVec>(mag_row, p, P);
  float4 ph = load4<kVec>(ph_row, p, P);

  const float* src = a.vals + (size_t)pair * T * 2 * P;
  const size_t plane = (size_t)2 * P;  // one line graph's [2, P] of out
  float* dst = a.out + ((size_t)pair * T * K + k) * plane;

  // the ring of frames in flight: frame t sits in slot t % kAhead
  float4 mid[kAhead], can[kAhead];
  bool ok[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (i < T) {
      mid[i] = load4<kVec>(src + (size_t)i * plane, p, P);
      can[i] = load4<kVec>(src + (size_t)i * plane + P, p, P);
      ok[i] = a.valid == nullptr || a.valid[i] != 0.f;
    }
  }
  for (int t0 = 0; t0 < T; t0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int t = t0 + i;
      if (t < T) {
        const float4 m = mid[i], c = can[i];
        const bool v = ok[i];
        const int next = t + kAhead;
        if (next < T) {
          mid[i] = load4<kVec>(src + (size_t)next * plane, p, P);
          can[i] = load4<kVec>(src + (size_t)next * plane + P, p, P);
          ok[i] = a.valid == nullptr || a.valid[next] != 0.f;
        }
        step(m.x, c.x, v, pole, pp, s.x, ph.x);
        step(m.y, c.y, v, pole, pp, s.y, ph.y);
        step(m.z, c.z, v, pole, pp, s.z, ph.z);
        step(m.w, c.w, v, pole, pp, s.w, ph.w);
        float* o = dst + (size_t)t * K * plane;
        stream4<kVec>(o, p, P,
                      make_float4(db(slope.x, s.x, lower, dyr, clip_db), db(slope.y, s.y, lower, dyr, clip_db),
                                  db(slope.z, s.z, lower, dyr, clip_db), db(slope.w, s.w, lower, dyr, clip_db)));
        stream4<kVec>(o + P, p, P,
                      make_float4(db(slope.x, ph.x, lower, dyr, clip_db), db(slope.y, ph.y, lower, dyr, clip_db),
                                  db(slope.z, ph.z, lower, dyr, clip_db), db(slope.w, ph.w, lower, dyr, clip_db)));
      }
    }
  }
  store4<kVec>(mag_row, p, P, s);
  store4<kVec>(ph_row, p, P, ph);
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

}  // namespace

// The PHASE tail: vals [pairs, T, 2, P], magnitude [pairs, K, rows, P]
// (row 0 updated in place), phase [pairs, K, P] (updated in place), out
// [pairs, T, K, 2, P]; valid [T] f32 or null.
extern "C" int sig_phase_decay_db_v1(
    const float* vals, const float* slope_map, const float* decay_poles,
    const float* phase_poles, const float* scalars, const float* valid,
    float* magnitude, float* phase, float* out, int pairs, int T, int K, int rows,
    int P, void* stream) {
  if (pairs < 1 || pairs > 65535 || T < 1 || K < 1 || K > 65535 || rows < 1 || P < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = {vals, slope_map, decay_poles, phase_poles, scalars, valid, magnitude, phase, out,
            pairs, T, K, rows, P};
  const bool vec = P % 4 == 0 && aligned16(vals) && aligned16(slope_map) && aligned16(magnitude) &&
                   aligned16(phase) && aligned16(out);
  const int quads = (P + 3) / 4;
  const dim3 grid((quads + kThreads - 1) / kThreads, K, pairs);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    phase_decay_db_kernel<true><<<grid, kThreads, 0, s>>>(a);
  } else {
    phase_decay_db_kernel<false><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
