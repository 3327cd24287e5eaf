// Kernel F: the Oscilloscope's spectral trigger walk, for sm_90a.
//
// Replaces the lax.while_loop of
// signalizer_tpu/kernels/oscilloscope.py::spectral_fundamental (:259-280;
// ref: calculateFundamentalPeriod, OscilloscopeDSP.inl:134-184), the two
// per-bin functions that feed it (jnp.abs(spec) and _quad_delta, :174-184),
// and, in the filtered entries, median_record_filter (:287-311; ref:
// OscilloscopeDSP.inl:187-213). Two load stages feed one walk:
//   * the spectrum stage reads the rfft's half spectrum [rows, >= n/2 + 1]
//     complex64 and forms each bin's |X| and quadratic offset itself, bit
//     for bit as torch's spec.abs() and _quad_delta(spec) on the card;
//   * the bins stage reads magnitudes and offsets [rows, >= m + 2] f32 that
//     the caller formed.
// The incumbent starts at bin 1 (value max(threshold * n / 6, |X1|), offset
// offset(1)); each pass tests every candidate bin j = 2 .. m + 1 above the
// incumbent's index against the incumbent, in f32, as kernels/
// spectral_walk.py's plain loop does:
//   vastly_better = inv_h * v > value * 2
//   mo            = omega > 0 ? omega : 1        (omega = index + offset)
//   factor        = omega_j / mo                 (omega_j = j + offset(j))
//   sensitivity   = v / max(value, 1e-30)
//   accept        = vastly_better & (omega > 0 ? inv_h * sensitivity > 20
//                     | |1 - factor| < iq | inv_h * |factor - floor(factor
//                     + 0.5)| > qs : true)
// (inv_h = 1 - hysteresis; qs the quarter semitone 2^(1/48) - 1; iq the
// plain code's inv_h * qs), and the first accepted bin becomes the
// incumbent. A row that accepts nothing in a pass accepts nothing later,
// so the row is done: per row the same as the plain loop's global
// any(active) test. At most 280 passes (> the 277 doublings float32's
// range allows), as both loops. The filtered entries then apply the 8-deep
// median filter: the upper-middle element of the history before the new
// omega goes in (torch.sort's order: NaN last), skipped while it is
// negative (the -1 sentinel), replaces an omega more than half a bin away;
// the history shifts the new omega in.
//
// Every operation is one f32 operation as torch on the card takes it
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fmaf_rn where torch's
// binary fuses; no fast math), so each entry is bit-equal to its plain
// version run on the card. A complex a - b is torch's add with alpha -1,
// a + (-1 + 0i) * b, so a non-finite part of b spreads NaN to the other
// part; spec * 2 is a complex product with 2 + 0i; a / b is c10's scaled
// division (torch/headeronly/util/complex.h). The floor threshold * n / 6
// is a product with the f32 reciprocal of 6, as torch on CUDA divides by a
// host scalar.
//
// What bounds it on the H100: not bytes (16 rows x 4097 complex bins are
// 0.52 MB in) but latency: the launch, one load of the row, |X| of 4097
// bins on one SM, then a chain of passes, each a test, a block-wide
// reduction and a broadcast. A block a row; the design keeps the chain short:
//   * prologue: the device scalars, the history, bin 1's neighbours (its
//     offset, on thread 0) and the row's loads are issued together; the
//     spectrum stage's threads (1024 at n = 8192) load 16 bytes each from
//     the 16-byte boundary at or below the row's start (an odd row of a
//     [rows, 4097] complex64 tensor starts 8 bytes past one: entry e lies
//     at staged slot e + s, s = 1), chunks c = t, t + T, ..., three in
//     flight a thread, form |X| of each bin they hold (hypotf, as
//     thrust::abs) and stage the chunks and |X| in shared memory; eight
//     lanes of warp 0 meanwhile rank the history's entries, one a lane, for
//     the median;
//   * the walk: the first `walkers` threads (256 at n = 8192) hold 16
//     candidate bins each, bin 2 + t + k * walkers in slot k, as
//     inv_h * |X| in registers. A pass marks, a predicated bit a slot, the
//     slots above the incumbent (a suffix) that are vastly better, then
//     runs the accept test (one copy of its code, so that the unrolled scan
//     stays a few instructions a slot: a copy a slot made the loop too
//     large for the instruction cache) on each in order until one passes,
//     forming a bin's offset from its three staged neighbours only there;
//     the accepted bin's thread stages its offset, and the block's first
//     accepted bin is one shared atomicMin (three words, so one barrier a
//     pass among the walkers); every walker then reads the new incumbent's
//     |X| and offset from shared memory: nothing on the chain touches
//     device memory;
//   * epilogue: the median, ranked in the prologue, is compared with the
//     new omega; lanes 0-7 store the shifted history.
// No host sync: the block stops itself.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxBins = 8192;     // candidates 2 .. m + 1: n <= 16389
constexpr int kMaxPasses = 280;    // MAX_WALK_ITERATIONS
constexpr int kHistory = 8;        // MEDIAN_FILTER_SIZE
constexpr int kSlots = 16;         // candidate bins a walker holds
constexpr int kLoadChunks = 5;     // 16-byte chunks a thread stages, at most
constexpr int kLoadBatch = 3;      // of which in flight together
constexpr unsigned kNone = 0xffffffffu;
constexpr int kMaxDevices = 64;
// the plan's kMaxThreads threads stage the largest row (m = kMaxBins)
static_assert(kLoadChunks * kMaxThreads >= (kMaxBins + 3 + 2) / 2, "kLoadChunks too small");

struct Params {
  const float2* spec;       // spectrum stage: [rows, >= m + 3] complex
  long long spec_stride;    // in complex entries
  const float* mags;        // bins stage: [rows, >= m + 2] each
  long long mags_stride;
  const float* offsets;
  long long offs_stride;
  const float* threshold;   // device scalar or null (then thr)
  const float* hysteresis;  // device scalar or null (then inv_h, iq)
  float thr, inv_h, iq, qs, n_f;
  int m;        // candidate bins 2 .. m + 1
  int entries;  // entries the walk reads: 0 .. entries - 1
  int walkers;  // threads that walk, a power of two
  int log2_walkers;
  const float* hist_in;  // [rows, 8] (the filtered entries) or null
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
__device__ __forceinline__ bool sort_less(float a, float b) { return (a < b) | ((a == a) & (b != b)); }

// a - b as torch computes it on complex64: a + (-1 + 0i) * b
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  const float re = __fsub_rn(__fmul_rn(-1.0f, b.x), __fmul_rn(0.0f, b.y));
  const float im = __fadd_rn(__fmul_rn(-1.0f, b.y), __fmul_rn(0.0f, b.x));
  return make_float2(__fadd_rn(a.x, re), __fadd_rn(a.y, im));
}

// Re(a / b) by c10's scaled division: with |c| >= |d| (b = c + di)
// rat = d / c, scl = 1 / (c + d * rat), re = (a.x + a.y * rat) * scl, else
// the mirror; the products feeding a sum are fused as torch's binary fuses
// them (a non-finite c or d takes the mirror branch, as c10's comparison)
__device__ __forceinline__ float cdiv_real(float2 a, float2 b) {
  const float c = b.x, d = b.y;
  const float abs_c = fabsf(c), abs_d = fabsf(d);
  if (abs_c >= abs_d) {
    if (abs_c == 0.0f && abs_d == 0.0f) return __fdiv_rn(a.x, abs_c);
    const float rat = __fdiv_rn(d, c);
    const float scl = __fdiv_rn(1.0f, __fmaf_rn(d, rat, c));
    return __fmul_rn(__fmaf_rn(a.y, rat, a.x), scl);
  }
  const float rat = __fdiv_rn(c, d);
  const float scl = __fdiv_rn(1.0f, __fmaf_rn(c, rat, d));
  return __fmul_rn(__fmaf_rn(a.x, rat, a.y), scl);
}

// _quad_delta at a bin from its staged neighbours: Re((X[j-1] - X[j+1]) /
// (X[j] * 2 - X[j-1] - X[j+1])) where (denom.re + denom.im) != 0, else 0
__device__ __forceinline__ float quad_offset(float2 xm, float2 x0, float2 xp) {
  const float2 twice = make_float2(__fsub_rn(__fmul_rn(x0.x, 2.0f), __fmul_rn(x0.y, 0.0f)),
                                   __fadd_rn(__fmul_rn(x0.x, 0.0f), __fmul_rn(x0.y, 2.0f)));
  const float2 denom = csub(csub(twice, xm), xp);
  if (!(__fadd_rn(denom.x, denom.y) != 0.0f)) return 0.0f;
  return cdiv_real(csub(xm, xp), denom);
}

// The walk of one row. kSpectrum: the spectrum stage (else the bins
// stage); kFiltered: the median filter after it. The block's threads
// stage the row; its first `walkers` threads (a power of two) then walk
// it, kSlots candidate bins each.
template <bool kSpectrum, bool kFiltered>
__global__ void __launch_bounds__(kMaxThreads) spectral_walk_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the pass's first accepted bin, three buffers: one a pass is written,
  // the last one read, the next one reset
  __shared__ unsigned s_first[3];
  __shared__ float s_off1;
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int T = blockDim.x;
  const int last = p.m + 1;  // the last candidate bin

  // --- prologue: everything that does not depend on the walk ---------------
  float inv_h = p.inv_h, iq = p.iq, thr = p.thr;
  if (p.hysteresis != nullptr) {
    inv_h = __fsub_rn(1.0f, __ldg(p.hysteresis));
    iq = __fmul_rn(inv_h, p.qs);
  }
  if (p.threshold != nullptr) thr = __ldg(p.threshold);
  float h = 0.0f;  // warp 0: lane i < 8 holds history entry i
  if (kFiltered && t < kHistory) h = __ldg(p.hist_in + row * kHistory + t);
  if (t == 0) {
    // bin 1's offset, the first incumbent's, from its neighbours in device
    // memory, off the chain
    if (kSpectrum) {
      const float2* srow = p.spec + row * p.spec_stride;
      s_off1 = quad_offset(__ldg(srow), __ldg(srow + 1), __ldg(srow + 2));
    } else {
      s_off1 = __ldg(p.offsets + row * p.offs_stride + 1);
    }
    s_first[0] = s_first[1] = kNone;
  }

  // the staged row: the spectrum stage's chunks (slot e + s holds entry e);
  // then |X| and offsets by entry (the bins stage stages the caller's
  // offsets; the spectrum stage, the offset of each bin a walker accepts)
  float2* sx = reinterpret_cast<float2*>(smem);
  const int staged = kSpectrum ? 2 * ((p.entries + 2) / 2) : 0;  // slots, even
  float* smag = reinterpret_cast<float*>(smem) + (kSpectrum ? 2 * staged : 0);
  float* soff = smag + p.entries;
  int s = 0;
  if (kSpectrum) {
    const float2* srow = p.spec + row * p.spec_stride;
    s = (int)((reinterpret_cast<uintptr_t>(srow) >> 3) & 1);
    const float4* base = reinterpret_cast<const float4*>(srow - s);
    const int chunks = (p.entries + s + 1) >> 1;
    for (int b = 0; b < kLoadChunks && t + b * T < chunks; b += kLoadBatch) {
      float4 q[kLoadBatch];  // a batch's loads in flight together
#pragma unroll
      for (int i = 0; i < kLoadBatch; ++i) {
        const int c = t + (b + i) * T;
        if (c < chunks) q[i] = __ldg(base + c);
      }
#pragma unroll
      for (int i = 0; i < kLoadBatch; ++i) {
        const int c = t + (b + i) * T;
        if (c < chunks) {
          reinterpret_cast<float4*>(sx)[c] = q[i];
          const int e = 2 * c - s;  // the chunk's first entry
          if (e >= 1 && e <= last) smag[e] = hypotf(q[i].x, q[i].y);
          if (e + 1 >= 1 && e + 1 <= last) smag[e + 1] = hypotf(q[i].z, q[i].w);
        }
      }
    }
  } else {
    const float* mrow = p.mags + row * p.mags_stride;
    const float* orow = p.offsets + row * p.offs_stride;
#pragma unroll 4
    for (int e = t; e < p.entries; e += T) {
      smag[e] = __ldg(mrow + e);
      soff[e] = __ldg(orow + e);
    }
  }
  auto offset_of = [&](int j) {
    if (kSpectrum) return quad_offset(sx[j - 1 + s], sx[j + s], sx[j + 1 + s]);
    return soff[j];
  };

  // the median of the history before the new omega goes in: lane i of warp
  // 0 ranks entry i (torch.sort's order, ties by position), the lane of
  // rank 4 holds it
  float med = 0.0f, h_next = 0.0f;
  if (kFiltered && t < 32) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < kHistory; ++j) {
      const float hj = __shfl_sync(0xffffffffu, h, j);
      rank += (int)(sort_less(hj, h) | ((j < lane) & !sort_less(h, hj)));
    }
    const unsigned at = __ballot_sync(0xffffffffu, (lane < kHistory) & (rank == kHistory / 2));
    med = __shfl_sync(0xffffffffu, h, __ffs(at) - 1);
    h_next = __shfl_down_sync(0xffffffffu, h, 1);
  }
  __syncthreads();

  // device scalars as the plain code forms them from 0-d tensors:
  // 1 - h, (1 - h) * f32(qs), (thr * n) * f32(1 / 6)
  const float floor_v = __fmul_rn(__fmul_rn(thr, p.n_f), 1.0f / 6.0f);

  // --- the walk: the first `walkers` threads; slot k holds bin 2 + t + k
  // * walkers --------------------------------------------------------------
  const int walkers = p.walkers;
  if (t >= walkers) return;
  float w[kSlots];  // inv_h * |X|: the vastly-better test's left side
  unsigned cand = 0;  // the slots that hold a candidate bin
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int j = 2 + t + k * walkers;
    w[k] = j <= last ? __fmul_rn(inv_h, smag[j]) : 0.0f;
    cand |= (unsigned)(j <= last) << k;
  }
  int rec_idx = 1;
  float rec_val = max_nan(floor_v, smag[1]);
  float rec_off = s_off1;
  int passes = 0;
  int cur = 0;
  while (passes < kMaxPasses) {
    ++passes;
    const float max_omega = __fadd_rn((float)rec_idx, rec_off);
    const bool positive = max_omega > 0.0f;
    const float mo = positive ? max_omega : 1.0f;
    const float two_v = __fmul_rn(rec_val, 2.0f);
    const float clamped = max_nan(rec_val, 1e-30f);
    // the slots above the incumbent (a suffix: bins rise along the slots)
    // whose bin is vastly better, a predicated bit a slot; then the accept
    // test of each in order (one copy of it: a pass costs the SM two or
    // three instructions a bin of the row)
    const int below = rec_idx - 2 - t;
    const int cut = below < 0 ? 0 : (below >> p.log2_walkers) + 1;
    unsigned even = 0, odd = 0;  // two chains of predicated ors
#pragma unroll
    for (int k = 0; k < kSlots; k += 2) {
      if (w[k] > two_v) even |= 1u << k;
      if (w[k + 1] > two_v) odd |= 2u << k;
    }
    unsigned vastly = (even | odd) & cand & (cut >= kSlots ? 0u : ~0u << cut);
    unsigned best = kNone;  // this thread's first accepted bin
    while (vastly != 0) {
      const int k = __ffs(vastly) - 1;
      vastly &= vastly - 1;
      const int j = 2 + t + k * walkers;
      bool accept = true;
      // the offset is formed beside the division that may make it moot
      const float off = offset_of(j);
      if (positive && !(__fmul_rn(inv_h, __fdiv_rn(smag[j], clamped)) > 20.0f)) {
        const float factor = __fdiv_rn(__fadd_rn((float)j, off), mo);
        const bool same_partial = fabsf(__fsub_rn(1.0f, factor)) < iq;
        const float mult_dev = fabsf(__fsub_rn(factor, floorf(__fadd_rn(factor, 0.5f))));
        accept = same_partial || __fmul_rn(inv_h, mult_dev) > p.qs;
      }
      if (accept) {
        best = (unsigned)j;
        if (kSpectrum) soff[j] = off;  // for every thread, should it win
        break;
      }
    }
    // the block's first accepted bin
    if (best != kNone) atomicMin(&s_first[cur], best);
    const int next = cur == 2 ? 0 : cur + 1;
    if (t == 0) s_first[next] = kNone;  // last read two passes ago
    asm volatile("bar.sync 1, %0;" ::"r"(walkers) : "memory");
    const unsigned first = s_first[cur];
    if (first == kNone) break;
    rec_idx = (int)first;
    rec_val = smag[rec_idx];
    rec_off = soff[rec_idx];
    cur = next;
  }

  if (!kFiltered) {
    if (t == 0) {
      p.passes[row] = passes;
      p.index[row] = rec_idx;
      p.value[row] = rec_val;
      p.offset[row] = rec_off;
    }
    return;
  }
  if (t >= 32) return;
  const float omega = __fadd_rn((float)rec_idx, rec_off);
  if (lane < kHistory) p.hist_out[row * kHistory + lane] = lane < kHistory - 1 ? h_next : omega;
  if (lane != 0) return;
  const bool use_median = med >= 0.0f && fabsf(__fsub_rn(omega, med)) > 0.5f;
  const float filtered = use_median ? med : omega;
  const float whole = floorf(filtered);
  p.passes[row] = passes;
  p.index[row] = (int)whole;  // cvt.rzi.s32.f32, as torch's .to(torch.int32)
  p.value[row] = rec_val;
  p.offset[row] = __fsub_rn(filtered, whole);
}

// shared memory a block stages: the spectrum stage's slots (16 bytes a
// chunk), then |X| and the offsets
int staged_bytes(bool spectrum, int entries) {
  return (spectrum ? 16 * ((entries + 2) / 2) : 0) + 8 * entries;
}

int next_pow2(int v) {
  int r = 1;
  while (r < v) r <<= 1;
  return r;
}

// The walkers a row: the fewest (a power of two, a warp at least) that hold
// the m candidate bins, kSlots each (256 at n = 8192).
int plan_walkers(int m) {
  const int w = next_pow2((m + kSlots - 1) / kSlots);
  return w < 32 ? 32 : w;
}

// A block's threads: `threads` within [walkers, kMaxThreads].
int clamp_threads(int threads, int walkers) {
  return threads < walkers ? walkers : threads > kMaxThreads ? kMaxThreads : threads;
}

// Launch one instantiation with `threads` threads, `walkers` of them
// walking, opting in to more than 48 KB of dynamic shared memory once a
// device.
template <bool kSpectrum, bool kFiltered>
int launch(Params p, int rows, int threads, int walkers, cudaStream_t stream) {
  static std::atomic<unsigned long long> opted{0};
  const int bytes = staged_bytes(kSpectrum, p.entries);
  auto kernel = spectral_walk_kernel<kSpectrum, kFiltered>;
  if (bytes > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const unsigned long long bit = 1ull << (dev % kMaxDevices);
    if (!(opted.load() & bit)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 staged_bytes(kSpectrum, kMaxBins + 3));
      if (err != cudaSuccess) return (int)err;
      opted.fetch_or(bit);
    }
  }
  p.walkers = walkers;
  p.log2_walkers = __builtin_ctz((unsigned)walkers);
  kernel<<<rows, threads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
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
  p.entries = m + 2;
  p.hist_in = hist_in;
  p.hist_out = hist_out;
  p.index = index;
  p.value = value;
  p.offset = offset;
  p.passes = passes;
  const int walkers = plan_walkers(m);
  const int threads = clamp_threads(next_pow2((p.entries + 3) / 4), walkers);
  const cudaStream_t s = (cudaStream_t)stream;
  return hist_in != nullptr ? launch<false, true>(p, rows, threads, walkers, s)
                            : launch<false, false>(p, rows, threads, walkers, s);
}

// The same walk on the rfft's half spectrum spec [rows, >= m + 3] complex64
// (interleaved float pairs, row stride spec_stride entries): each bin's |X|
// and quadratic offset formed in the kernel, bit for bit as torch's
// spec.abs() and _quad_delta(spec), a thread for two 16-byte chunks of the
// row (1024 at n = 8192, at most kLoadChunks chunks a thread at the largest
// n). The other arguments and the outputs are sig_spectral_walk's.
extern "C" int sig_spectral_walk_spectrum(const float* spec, long long spec_stride,
                                          const float* threshold, const float* hysteresis,
                                          float thr_value, float inv_h_value, float iq_value,
                                          float qs, float n_f, const float* hist_in,
                                          int* index, float* value, float* offset,
                                          float* hist_out, int* passes, int rows, int m,
                                          void* stream) {
  if (rows < 1 || m < 0 || m > kMaxBins || spec_stride < m + 3 ||
      (reinterpret_cast<uintptr_t>(spec) & 7) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{};
  p.spec = reinterpret_cast<const float2*>(spec);
  p.spec_stride = spec_stride;
  p.threshold = threshold;
  p.hysteresis = hysteresis;
  p.thr = thr_value;
  p.inv_h = inv_h_value;
  p.iq = iq_value;
  p.qs = qs;
  p.n_f = n_f;
  p.m = m;
  p.entries = m + 3;
  p.hist_in = hist_in;
  p.hist_out = hist_out;
  p.index = index;
  p.value = value;
  p.offset = offset;
  p.passes = passes;
  const int chunks = (p.entries + 2) / 2;  // 16-byte chunks a row, at most
  const int walkers = plan_walkers(m);
  const int threads = clamp_threads(next_pow2((chunks + 1) / 2), walkers);
  const cudaStream_t s = (cudaStream_t)stream;
  return hist_in != nullptr ? launch<true, true>(p, rows, threads, walkers, s)
                            : launch<true, false>(p, rows, threads, walkers, s);
}
