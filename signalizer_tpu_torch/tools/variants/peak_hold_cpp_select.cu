// Kernel D (csrc/peak_hold.cu) with its step written as a C++ select, one
// sample at a time, in place of the package's blocks of PTX (st_step,
// st_pair). Kept to show what the blocks of PTX are for: nvcc makes the
// select a branch and then a multiply predicated on the compare, so the
// compare (and a reload of decay from the constant bank) joins the chain.
// Measured on an H100: see PERF.md, kernel D. Built and timed by
// `python -m signalizer_tpu_torch.tools.kernel_variants --kernels h
// --named peak_hold_cpp_select`.
// Otherwise the package's kernel as it is: see its source for the design.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kHelpers = kThreads - 32;  // warps 1-3
constexpr int kPer = 8;                  // samples a helper loads a tile
constexpr int kTile = kHelpers * kPer;   // 768 samples: 24 words, one a lane of a warp
constexpr int kWords = kTile / 32;
constexpr int kQueue = 8;  // the fire-age queue (views/oscilloscope.py PEAK_QUEUE_SIZE)
constexpr float kAgeNone = 1.0e9f;
static_assert(kWords <= 32, "the hold scan takes one word a lane");

struct Params {
  const float* x;
  long long row_stride;
  const bool* valid;  // [W] or null
  const float* state_in;
  const bool* holding_in;
  const float* threshold;   // device scalar or null (then thr2)
  const float* hysteresis;  // device scalar or null (then hyst)
  float thr2, hyst, decay;
  float* state_out;
  bool* holding_out;
  bool* fires;  // function entry: [rows, W]
  // fused entry
  const float* ages_in;  // [rows, 8]
  float* ages_out;       // [rows, 8]
  bool* found;           // [rows]
  float* start;          // [rows]
  float new_samples, half_m1, hf, hf_m1, half_w, hf_minus_w;
  int w, first;
};

// torch.maximum / torch.clamp's NaN rule: a NaN in either operand is the result
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// warps 1-3 meet here; warp 0 does not wait
__device__ __forceinline__ void helpers_sync() { asm volatile("bar.sync 1, %0;" ::"n"(kHelpers) : "memory"); }

__device__ __forceinline__ void load32(float (&v)[32], const float* src) {
#pragma unroll
  for (int j = 0; j < 32; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(src + j);
    v[j] = q.x;
    v[j + 1] = q.y;
    v[j + 2] = q.z;
    v[j + 3] = q.w;
  }
}

// 32 samples of st; before[j] is the st sample j starts from. With kUse,
// only the samples whose bit is set in `use` are consumed (a step at a
// time); without, two steps at a time.
template <bool kUse>
__device__ __forceinline__ void walk32(const float (&v)[32], unsigned use, float& st, float* before,
                                       float thr2, float decay) {
  float b[33];
  b[0] = st;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float next = v[j] < b[j] ? max_nan(thr2, __fmul_rn(b[j], decay)) : v[j];
    b[j + 1] = (!kUse || ((use >> j) & 1u)) ? next : b[j];
  }
#pragma unroll
  for (int j = 0; j < 32; j += 4) {
    *reinterpret_cast<float4*>(before + j) = make_float4(b[j], b[j + 1], b[j + 2], b[j + 3]);
  }
  st = b[32];
}

// The walker's pass over a staged tile of n samples.
template <bool kMask>
__device__ __forceinline__ void walk_tile(const float* sq, const unsigned* use, float* before, int n,
                                          float& st, float thr2, float decay) {
  const int full = n >> 5;
  const int tail = n & 31;
  float a[32], b[32];
  load32(a, sq);
  int k = 0;
  // two words an iteration, each word's squares loaded during the other's
  // walk (the tile has 32 floats of slack for the last load)
  for (; k + 2 <= full; k += 2) {
    load32(b, sq + 32 * (k + 1));
    walk32<kMask>(a, kMask ? use[k] : ~0u, st, before + 32 * k, thr2, decay);
    load32(a, sq + 32 * (k + 2));
    walk32<kMask>(b, kMask ? use[k + 1] : ~0u, st, before + 32 * (k + 1), thr2, decay);
  }
  if (k < full) {
    walk32<kMask>(a, kMask ? use[k] : ~0u, st, before + 32 * k, thr2, decay);
    ++k;
    load32(a, sq + 32 * k);
  }
  if (tail) {
    walk32<true>(a, (kMask ? use[k] : ~0u) & ((1u << tail) - 1u), st, before + 32 * k, thr2, decay);
  }
}

// Ascending order with NaN last (torch.topk's order); only values move.
__device__ __forceinline__ bool precedes(float a, float b) {
  return a < b || (b != b && a == a);
}

__device__ __forceinline__ void order(float& a, float& b) {
  const bool swap = precedes(b, a);
  const float lo = swap ? b : a;
  b = swap ? a : b;
  a = lo;
}

// sorts 8 values ascending (Batcher's odd-even merge network, 19 exchanges)
__device__ __forceinline__ void sort8(float (&v)[kQueue]) {
  order(v[0], v[1]); order(v[2], v[3]); order(v[4], v[5]); order(v[6], v[7]);
  order(v[0], v[2]); order(v[1], v[3]); order(v[4], v[6]); order(v[5], v[7]);
  order(v[1], v[2]); order(v[5], v[6]);
  order(v[0], v[4]); order(v[1], v[5]); order(v[2], v[6]); order(v[3], v[7]);
  order(v[2], v[4]); order(v[3], v[5]);
  order(v[1], v[2]); order(v[3], v[4]); order(v[5], v[6]);
}

// The carried ages, older by new_samples, capped at the empty sentinel,
// ascending (one thread; a helper forms them while tile 0 is walked).
__device__ __forceinline__ void carried_ages(const Params& p, int row, float* sorted) {
  float old[kQueue];
  const float* in = p.ages_in + (long long)row * kQueue;
#pragma unroll
  for (int q = 0; q < kQueue; ++q) old[q] = min_nan(__fadd_rn(in[q], p.new_samples), kAgeNone);
  sort8(old);
#pragma unroll
  for (int q = 0; q < kQueue; ++q) sorted[q] = old[q];
}

// The fused entry's epilogue (one thread): the queue merge and the window
// start of views/oscilloscope.py's ENVELOPE_HOLD branch. pos[0..count) are
// the newest fires' bit positions in the consumed span, newest first;
// old[] the carried ages, ascending.
__device__ void queue_and_start(const Params& p, int row, const int* pos, int count, const float* old,
                                int consumed) {
  // age = consumed - position: the shifted event's age relative to the row's end
  float fresh[kQueue];
#pragma unroll
  for (int q = 0; q < kQueue; ++q) fresh[q] = q < count ? (float)(consumed - pos[q]) : kAgeNone;
  // the 8 smallest of both ascending lists (a bitonic sequence), sorted
  float v[kQueue];
#pragma unroll
  for (int q = 0; q < kQueue; ++q) {
    const float a = fresh[q], b = old[kQueue - 1 - q];
    v[q] = precedes(b, a) ? b : a;
  }
  order(v[0], v[4]); order(v[1], v[5]); order(v[2], v[6]); order(v[3], v[7]);
  order(v[0], v[2]); order(v[1], v[3]); order(v[4], v[6]); order(v[5], v[7]);
  order(v[0], v[1]); order(v[2], v[3]); order(v[4], v[5]); order(v[6], v[7]);
  // the newest fire with its half window complete, still inside the history
  float sel = kAgeNone;
  float* out = p.ages_out + (long long)row * kQueue;
#pragma unroll
  for (int q = 0; q < kQueue; ++q) {
    out[q] = v[q];
    const bool mature = (v[q] >= p.half_m1) & (v[q] < p.hf);
    sel = fminf(sel, mature ? v[q] : kAgeNone);
  }
  const bool found = sel < kAgeNone;
  const float at = __fsub_rn(p.hf_m1, found ? sel : 0.f);
  // centred on the trigger, clamped into the history (max, then min)
  const float start = min_nan(max_nan(__fsub_rn(at, p.half_w), 0.f), p.hf_minus_w);
  p.found[row] = found;
  p.start[row] = found ? start : p.hf_minus_w;
}

template <bool kFused, bool kMask>
__global__ void __launch_bounds__(kThreads) peak_hold_kernel(const Params p) {
  __shared__ __align__(16) float s_sq[3][kTile + 32];  // squares: staged, walked, turned into fires
  __shared__ __align__(16) float s_st[2][kTile];       // the st each sample starts from
  __shared__ unsigned s_use[3][kWords];                // mask route: consumed bits a word
  __shared__ unsigned s_fall[kWords], s_rise[kWords];  // a tile's resets and sets of hold
  __shared__ unsigned s_fw[kWords];                    // a tile's fire words (fused entry)
  __shared__ int s_hold_in[kWords];                    // hold before each word
  __shared__ int s_hold;                               // hold before the next tile
  __shared__ int s_fire0;                              // fire[0], for W == 1
  __shared__ int s_pos[kQueue], s_count;               // the newest fires (fused entry)
  __shared__ float s_old[kQueue];                      // the carried ages, sorted (fused entry)
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int w = p.w;
  const int first = min(p.first, w);
  const int consumed = w - first;
  const int tiles = (consumed + kTile - 1) / kTile;
  const float* xr = p.x + (long long)row * p.row_stride + first;
  bool* out = kFused ? nullptr : p.fires + (long long)row * w;
  const float hyst = p.hysteresis != nullptr ? *p.hysteresis : p.hyst;

  if (!kFused) {
    // nothing is consumed before `first`: out[j] = fire[j + 1] = 0 there
    for (int j = tid; j < first - 1; j += kThreads) out[j] = false;
  }
  float st = 0.f, thr2 = 0.f;
  if (tid == 0) {
    st = p.state_in[row];
    thr2 = p.threshold != nullptr ? __fmul_rn(*p.threshold, *p.threshold) : p.thr2;
    s_hold = p.holding_in[row];
    s_fire0 = 0;
    s_count = 0;
  }

  // helpers: load tile t's samples (and mask bits) into registers ...
  float v[kPer];
  bool u[kPer];
  auto load = [&](int t) {
    const int base = t * kTile;
    const int n = min(kTile, consumed - base);
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int k = m * kHelpers + tid - 32;
      v[m] = k < n ? xr[base + k] : 0.f;
      u[m] = kMask && k < n && p.valid[first + base + k];
    }
  };
  // ... and store their squares (and mask words) into buffer t % 3
  auto store = [&](int t) {
    const int n = min(kTile, consumed - t * kTile);
    float* sq = s_sq[t % 3];
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int k = m * kHelpers + tid - 32;
      if (k < n) sq[k] = __fmul_rn(v[m], v[m]);
      if (kMask) {
        const unsigned bits = __ballot_sync(0xffffffffu, u[m]);
        if (lane == 0 && k < n) s_use[t % 3][k >> 5] = bits;
      }
    }
  };
  // helpers: tile t's fires from the squares and the states they met
  auto fires = [&](int t) {
    const int base = t * kTile;
    const int n = min(kTile, consumed - base);
    const int words = (n + 31) >> 5;
    const float* sq = s_sq[t % 3];
    const float* st_before = s_st[t % 2];
    // each word's falls (reset hold) and arming rises (set hold), a helper
    // warp's words unrolled so that their loads are in flight together
#pragma unroll
    for (int q = 0; q < kWords / 3; ++q) {
      const int k = 3 * q + warp - 1;
      if (k >= words) break;
      const int j = 32 * k + lane;
      const bool in = j < n && (!kMask || ((s_use[t % 3][k] >> lane) & 1u));
      const float s = sq[j], sp = st_before[j];
      const bool falling = s < sp;
      const bool jump = __fsub_rn(s, sp) > __fmul_rn(hyst, sp);
      const unsigned fall = __ballot_sync(0xffffffffu, in & falling);
      const unsigned rise = __ballot_sync(0xffffffffu, in & !falling & jump);
      if (lane == 0) {
        s_fall[k] = fall;
        s_rise[k] = rise;
      }
    }
    helpers_sync();
    // hold before each word: the last event of the words before it, by an
    // inclusive scan of (has an event, its value) over the lanes of warp 1
    if (warp == 1) {
      const unsigned rise = lane < words ? s_rise[lane] : 0u;
      const unsigned ev = rise | (lane < words ? s_fall[lane] : 0u);
      bool has = ev != 0u;
      bool val = has && ((rise >> (31 - __clz(ev))) & 1u);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const bool h = __shfl_up_sync(0xffffffffu, has, off);
        const bool x = __shfl_up_sync(0xffffffffu, val, off);
        if (lane >= off && !has) {
          has = h;
          val = x;
        }
      }
      const bool carry = s_hold;
      const bool after = has ? val : carry;
      const bool prior = __shfl_up_sync(0xffffffffu, after, 1);
      if (lane < words) s_hold_in[lane] = lane == 0 ? carry : prior;
      __syncwarp();
      if (lane == words - 1) s_hold = after;
    }
    helpers_sync();
    // each sample's fire: a fall with hold set before it (the highest event
    // below it in the word, else the word's hold)
#pragma unroll
    for (int q = 0; q < kWords / 3; ++q) {
      const int k = 3 * q + warp - 1;
      if (k >= words) break;
      const unsigned fall = s_fall[k], rise = s_rise[k];
      const unsigned below = (fall | rise) & ((1u << lane) - 1u);
      const bool held = below ? (rise >> (31 - __clz(below))) & 1u : s_hold_in[k] != 0;
      unsigned word = __ballot_sync(0xffffffffu, ((fall >> lane) & 1u) && held);
      const int r = base + 32 * k;  // the word's first bit in the consumed span
      if (first == 0 && r == 0) {
        // the sample-0 clamp: a fall at sample 0 is the event at sample 0,
        // as one at sample 1 is (bit 1 is out[0])
        if (lane == 0) s_fire0 = word & 1u;
        word = (word & ~1u) | ((word & 1u) << 1);
      }
      if (kFused) {
        if (lane == 0) s_fw[k] = word;
      } else {
        const int i = first + r + lane;  // out[i - 1] = fire[i]
        if (i >= 1 && 32 * k + lane < n) out[i - 1] = (word >> lane) & 1u;
      }
    }
    if (kFused) {
      // the newest fires: this tile's, newest first, before the earlier ones
      helpers_sync();
      if (warp == 1) {
        unsigned nz = __ballot_sync(0xffffffffu, lane < words && s_fw[lane] != 0u);
        if (lane == 0) {
          int got[kQueue];
          int m = 0;
          while (nz != 0u && m < kQueue) {
            const int k = 31 - __clz(nz);
            nz &= ~(1u << k);
            unsigned word = s_fw[k];
            while (word != 0u && m < kQueue) {
              const int bit = 31 - __clz(word);
              word &= ~(1u << bit);
              got[m++] = base + 32 * k + bit;
            }
          }
          if (m > 0) {
            for (int q = kQueue - 1; q >= m; --q) s_pos[q] = s_pos[q - m];
            for (int q = 0; q < m; ++q) s_pos[q] = got[q];
            s_count = min(s_count + m, kQueue);
          }
        }
      }
    }
  };

  if (tiles > 0 && warp > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  // tile t is walked while tile t + 1 is staged and tile t - 1 turned into fires
  for (int t = 0; t <= tiles && tiles > 0; ++t) {
    if (tid == 0) {
      if (t < tiles) {
        walk_tile<kMask>(s_sq[t % 3], s_use[t % 3], s_st[t % 2], min(kTile, consumed - t * kTile), st, thr2,
                         p.decay);
      }
    } else if (warp > 0) {
      if (t + 1 < tiles) load(t + 1);
      if (kFused && t == 0 && tid == 32) carried_ages(p, row, s_old);
      if (t > 0) fires(t - 1);
      if (t + 1 < tiles) store(t + 1);
    }
    __syncthreads();
  }
  if (tid == 0) {
    // the last sample has no later fire; with W = 1 it is sample 0 itself
    if (!kFused) out[w - 1] = w == 1 && first == 0 && s_fire0;
    p.state_out[row] = st;
    p.holding_out[row] = s_hold;
    if (kFused) {
      if (tiles == 0) carried_ages(p, row, s_old);
      queue_and_start(p, row, s_pos, s_count, s_old, consumed);
    }
  }
}

template <bool kFused, bool kMask>
int launch(const Params& p, int rows, void* stream) {
  peak_hold_kernel<kFused, kMask><<<rows, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
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
  Params p{};
  p.x = x;
  p.row_stride = row_stride;
  p.valid = valid;
  p.state_in = state_in;
  p.holding_in = holding_in;
  p.threshold = threshold;
  p.hysteresis = hysteresis;
  p.thr2 = thr2_value;
  p.hyst = hyst_value;
  p.decay = decay;
  p.state_out = state_out;
  p.holding_out = holding_out;
  p.fires = fires;
  p.w = w;
  p.first = first;
  return valid != nullptr ? launch<false, true>(p, rows, stream) : launch<false, false>(p, rows, stream);
}

// The ENVELOPE_HOLD trigger of the oscilloscope step in one launch. x, the
// state, the threshold and the hysteresis as for sig_peak_hold (W = the
// trigger chunk, no mask); ages_in/out [rows, 8] f32 (the fire-age queue);
// found [rows] bool; start [rows] f32. Host numbers, each an f32 value
// formed as the plain code forms it: new_samples; half_m1 = window * 0.5 -
// 1; hf (the history length); hf_m1 = hf - 1; half_w = (window - 1) * 0.5;
// hf_minus_w = hf - window.
extern "C" int sig_envelope_hold(const float* x, long long row_stride,
                                 const float* state_in, const bool* holding_in,
                                 const float* ages_in, const float* threshold,
                                 const float* hysteresis, float thr2_value,
                                 float hyst_value, float decay,
                                 float new_samples, float half_m1, float hf,
                                 float hf_m1, float half_w, float hf_minus_w,
                                 float* state_out, bool* holding_out,
                                 float* ages_out, bool* found, float* start,
                                 int rows, int w, int first, void* stream) {
  if (rows < 1 || w < 1 || first < 0 || row_stride < w) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{};
  p.x = x;
  p.row_stride = row_stride;
  p.state_in = state_in;
  p.holding_in = holding_in;
  p.threshold = threshold;
  p.hysteresis = hysteresis;
  p.thr2 = thr2_value;
  p.hyst = hyst_value;
  p.decay = decay;
  p.state_out = state_out;
  p.holding_out = holding_out;
  p.ages_in = ages_in;
  p.ages_out = ages_out;
  p.found = found;
  p.start = start;
  p.new_samples = new_samples;
  p.half_m1 = half_m1;
  p.hf = hf;
  p.hf_m1 = hf_m1;
  p.half_w = half_w;
  p.hf_minus_w = hf_minus_w;
  p.w = w;
  p.first = first;
  return launch<true, false>(p, rows, stream);
}
