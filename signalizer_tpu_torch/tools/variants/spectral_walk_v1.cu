// Kernel F, first design (kept for kernel_variants: --kernels f --named
// spectral_walk_v1; the entry and arguments it had): the walk reads the
// rfft's magnitudes and quadratic offsets, which torch operations formed
// in launches of their own, 16 bins a thread in registers, the new
// incumbent's value and offset read back from device memory every pass,
// the median filter on one thread after the walk. One switch at a time
// leaves a part out, to time what it costs (the outputs are then wrong):
//   SIG_LOAD_ONLY   the scalars and bins loaded, bin 1 written as the
//                   record, no pass;
//   SIG_ONE_PASS    at most one pass.
//
// Kernel F: the Oscilloscope's spectral trigger walk, for sm_90a.
//
// Replaces the lax.while_loop of
// signalizer_tpu/kernels/oscilloscope.py::spectral_fundamental (:259-280;
// ref: calculateFundamentalPeriod, OscilloscopeDSP.inl:134-184) and, in its
// second entry, median_record_filter (:287-311; ref: OscilloscopeDSP.inl:
// 187-213). For each row of mags and offsets [rows, >= m + 2] f32 (the
// rfft's magnitudes and quadratic offsets), the incumbent starts at bin 1
// (value max(threshold * n / 6, mags[1]), offset offsets[1]); each pass
// tests every candidate bin j = 2 .. m + 1 above the incumbent's index
// against the incumbent, in f32, as kernels/spectral_walk.py's plain loop
// does:
//   vastly_better = inv_h * v > value * 2
//   mo            = omega > 0 ? omega : 1        (omega = index + offset)
//   factor        = omega_j / mo                 (omega_j = j + offsets[j])
//   sensitivity   = v / max(value, 1e-30)
//   accept        = vastly_better & (omega > 0 ? inv_h * sensitivity > 20
//                     | |1 - factor| < iq | inv_h * |factor - floor(factor
//                     + 0.5)| > qs : true)
// (inv_h = 1 - hysteresis; qs the quarter semitone 2^(1/48) - 1; iq the
// plain code's inv_h * qs), and the first accepted bin becomes the
// incumbent. A row that accepts nothing in a pass accepts nothing later,
// so the row is done: per row the same as the plain loop's global
// any(active) test. At most 280 passes (> the 277 doublings float32's
// range allows), as both loops. The second entry then runs the 8-deep
// median filter on one thread a row: the upper-middle element of the
// history before the new omega goes in (torch.sort's order: NaN last),
// skipped while it is negative (the -1 sentinel), replaces an omega more
// than half a bin away; the history shifts the new omega in.
//
// Every operation is one f32 operation as the plain PyTorch code on the
// card takes it (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nvcc contracts
// nothing into a fused multiply-add, and the divisions are IEEE), so the
// kernel is bit-equal to the plain loop run on the card. The floor
// threshold * n / 6 is a product with the f32 reciprocal of 6, as torch on
// CUDA divides by a host scalar.
//
// What bounds it on the H100: not bytes (16 rows x 4094 bins are 0.52 MB
// in) but the chain of passes, each a test, a block-wide reduction and a
// broadcast. One block a row: 16 bins a thread held in registers (their
// values and omegas; thread t of T holds bins t, t + T, t + 2T, ..., so
// that the loads coalesce), loaded once. A pass tests only the bins above
// the incumbent, skips the two divisions of a bin that is not vastly better
// (most bins, once the incumbent has grown), stops at the thread's first
// accepted bin (while the incumbent is small, most bins are vastly better
// and that is the first), and takes the block's first accepted bin by a
// warp reduction (__reduce_min_sync), one word a warp in shared memory (two
// buffers, so one barrier a pass) and a second warp reduction. The new
// incumbent's value and offset are read back from the row (L1-resident).
// No host sync: the block stops itself.

#include <cuda_runtime.h>

namespace {

constexpr int kPer = 16;                        // candidate bins a thread
constexpr int kMaxThreads = 512;
constexpr int kMaxBins = kPer * kMaxThreads;    // 8192 candidates: n <= 16389
#if defined(SIG_LOAD_ONLY)
constexpr int kMaxPasses = 0;
#elif defined(SIG_ONE_PASS)
constexpr int kMaxPasses = 1;
#else
constexpr int kMaxPasses = 280;                 // MAX_WALK_ITERATIONS
#endif
constexpr int kHistory = 8;                     // MEDIAN_FILTER_SIZE
constexpr unsigned kNone = 0xffffffffu;

struct Params {
  const float* mags;
  long long mags_stride;
  const float* offsets;
  long long offs_stride;
  const float* threshold;   // device scalar or null (then thr)
  const float* hysteresis;  // device scalar or null (then inv_h, iq)
  float thr, inv_h, iq, qs, n_f;
  int m;  // candidate bins 2 .. m + 1
  const float* hist_in;  // [rows, 8] (the filtered entry) or null
  float* hist_out;
  int* index;
  float* value;
  float* offset;
  int* passes;
};

// torch.maximum / torch.clamp's NaN rule: a NaN in either operand is the result
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// torch.sort's ascending order: NaN above every number
__device__ __forceinline__ bool sort_less(float a, float b) { return a < b || (!isnan(a) && isnan(b)); }

template <bool kFiltered>
__global__ void __launch_bounds__(kMaxThreads) spectral_walk_kernel(const Params p) {
  __shared__ unsigned s_best[2][kMaxThreads / 32];
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int warps = blockDim.x >> 5;
  const float* mrow = p.mags + row * p.mags_stride;
  const float* orow = p.offsets + row * p.offs_stride;
  const float* vals = mrow + 2;
  const float* offs = orow + 2;

  // device scalars as the plain code forms them from 0-d tensors:
  // 1 - h, (1 - h) * f32(qs), (thr * n) * f32(1 / 6)
  float inv_h = p.inv_h, iq = p.iq, thr = p.thr;
  if (p.hysteresis != nullptr) {
    inv_h = __fsub_rn(1.0f, *p.hysteresis);
    iq = __fmul_rn(inv_h, p.qs);
  }
  if (p.threshold != nullptr) thr = *p.threshold;
  const float floor_v = __fmul_rn(__fmul_rn(thr, p.n_f), 1.0f / 6.0f);

  // this thread's bins, t + k * blockDim.x (index j + 2): each load a warp
  // makes reads 32 neighbouring floats
  const int stride = blockDim.x;
  float v[kPer], om[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = t + k * stride;
    v[k] = j < p.m ? vals[j] : 0.0f;
    om[k] = j < p.m ? __fadd_rn((float)(j + 2), offs[j]) : 0.0f;
  }

#ifdef SIG_LOAD_ONLY
  // keep the loads: a sum of the bins, stored only if it hits a value no
  // input gives
  float keep = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) keep += v[k] + om[k];
  if (keep == 1.2345e-30f) p.value[row] = keep;
#endif
  int rec_idx = 1;
  float rec_val = max_nan(floor_v, mrow[1]);
  float rec_off = orow[1];
  int passes = 0;
  int parity = 0;
  while (passes < kMaxPasses) {
    ++passes;
    const float max_omega = __fadd_rn((float)rec_idx, rec_off);
    const bool positive = max_omega > 0.0f;
    const float mo = positive ? max_omega : 1.0f;
    const float two_v = __fmul_rn(rec_val, 2.0f);
    const float clamped = max_nan(rec_val, 1e-30f);
    unsigned best = kNone;
    if (t + (kPer - 1) * stride + 2 > rec_idx) {  // a bin of this thread lies above the incumbent
#pragma unroll
      for (int k = 0; k < kPer; ++k) {  // the thread's first accepted bin ends its test
        const int j = t + k * stride;
        if (j < p.m && j + 2 > rec_idx && __fmul_rn(inv_h, v[k]) > two_v) {
          bool accept = true;
          if (positive) {
            const float factor = __fdiv_rn(om[k], mo);
            const float sensitivity = __fdiv_rn(v[k], clamped);
            const bool twenty_x = __fmul_rn(inv_h, sensitivity) > 20.0f;
            const bool same_partial = fabsf(__fsub_rn(1.0f, factor)) < iq;
            const float mult_dev = fabsf(__fsub_rn(factor, floorf(__fadd_rn(factor, 0.5f))));
            const bool not_harmonic = __fmul_rn(inv_h, mult_dev) > p.qs;
            accept = twenty_x || same_partial || not_harmonic;
          }
          if (accept) {
            best = (unsigned)j;
            break;
          }
        }
      }
    }
    best = __reduce_min_sync(0xffffffffu, best);
    if (lane == 0) s_best[parity][warp] = best;
    __syncthreads();
    best = __reduce_min_sync(0xffffffffu, lane < warps ? s_best[parity][lane] : kNone);
    parity ^= 1;
    if (best == kNone) break;
    rec_idx = (int)best + 2;
    rec_val = vals[best];
    rec_off = offs[best];
  }
  if (t != 0) return;
  p.passes[row] = passes;
  if (!kFiltered) {
    p.index[row] = rec_idx;
    p.value[row] = rec_val;
    p.offset[row] = rec_off;
    return;
  }
  const float omega = __fadd_rn((float)rec_idx, rec_off);
  const float* h = p.hist_in + row * kHistory;
  float hist[kHistory];
#pragma unroll
  for (int i = 0; i < kHistory; ++i) hist[i] = h[i];
  // the element of rank kHistory / 2 in torch.sort's order (ties by position)
  float med = 0.0f;
#pragma unroll
  for (int i = 0; i < kHistory; ++i) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < kHistory; ++j) {
      rank += sort_less(hist[j], hist[i]) || (j < i && !sort_less(hist[i], hist[j]));
    }
    if (rank == kHistory / 2) med = hist[i];
  }
  float* out = p.hist_out + row * kHistory;
#pragma unroll
  for (int i = 0; i < kHistory - 1; ++i) out[i] = hist[i + 1];
  out[kHistory - 1] = omega;
  const bool use_median = med >= 0.0f && fabsf(__fsub_rn(omega, med)) > 0.5f;
  const float filtered = use_median ? med : omega;
  const float whole = floorf(filtered);
  p.index[row] = (int)whole;  // cvt.rzi.s32.f32, as torch's .to(torch.int32)
  p.value[row] = rec_val;
  p.offset[row] = __fsub_rn(filtered, whole);
}

}  // namespace

// The walk of rows of mags and offsets (row strides mags_stride,
// offs_stride; candidate bins 2 .. m + 1, bin 1 the first incumbent) and,
// with hist_in [rows, 8] f32 given, the median filter (hist_out [rows, 8]).
// threshold and hysteresis: device scalars, or null and then the host
// values thr_value (f32(threshold)), inv_h_value (f32(1 - hysteresis)) and
// iq_value (f32((1 - hysteresis) * qs)), each formed in float64 and rounded
// once, as the plain code forms them from host numbers. qs = f32(2^(1/48) -
// 1), n_f = the transform length n. Outputs index [rows] i32, value and
// offset [rows] f32 (the filtered record with hist_in), passes [rows] i32
// (the passes each row took, the last one accepting nothing unless it was
// the 280th).
extern "C" int sig_spectral_walk(const float* mags, long long mags_stride,
                                 const float* offsets, long long offs_stride,
                                 const float* threshold, const float* hysteresis,
                                 float thr_value, float inv_h_value, float iq_value,
                                 float qs, float n_f, const float* hist_in,
                                 int* index, float* value, float* offset,
                                 float* hist_out, int* passes, int rows, int m,
                                 void* stream) {
  if (rows < 1 || m < 0 || m > kMaxBins || mags_stride < m + 2 || offs_stride < m + 2) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{};
  p.mags = mags;
  p.mags_stride = mags_stride;
  p.offsets = offsets;
  p.offs_stride = offs_stride;
  p.threshold = threshold;
  p.hysteresis = hysteresis;
  p.thr = thr_value;
  p.inv_h = inv_h_value;
  p.iq = iq_value;
  p.qs = qs;
  p.n_f = n_f;
  p.m = m;
  p.hist_in = hist_in;
  p.hist_out = hist_out;
  p.index = index;
  p.value = value;
  p.offset = offset;
  p.passes = passes;
  int threads = ((m + kPer - 1) / kPer + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads;
  if (hist_in != nullptr) {
    spectral_walk_kernel<true><<<rows, threads, 0, (cudaStream_t)stream>>>(p);
  } else {
    spectral_walk_kernel<false><<<rows, threads, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
