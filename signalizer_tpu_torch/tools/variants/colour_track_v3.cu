// Kernel E, third design (kept for kernel_variants: --kernels e --named
// colour_v3; the entries and arguments it had): one block of 512 threads a
// row, walking the row in tiles of 8192 samples, five block scans a tile.
//
// Kernel E: the Oscilloscope's colour track, for sm_90a.
//
// Replaces the associative scans of the JAX package's colour track:
// signalizer_tpu/kernels/filters.py::three_band_split (eight biquads, each
// solved by _recurrence_scan) and ::onepole_smooth, as
// signalizer_tpu/kernels/oscilloscope.py::spectral_colour_track calls them.
// For each row of x [B, W] f32 (ref: cpl LinkwitzRileyNetwork<T,3> tuned at
// 300 and 3000 Hz, OscilloscopeDSP.inl:440-494):
//   - the LR4 network, each section a TDF2 biquad with its state in and out
//     (z [B, 8, 2]): lp_lo twice -> low; hp_lo twice -> rest; lp_hi twice on
//     rest -> mid; hp_hi twice on rest -> high;
//   - the three band energies band^2 smoothed by one one-pole each, with the
//     state in and out (smooth [B, 3]);
//   - rgb = sum_b s_b * band_colour_b, divided by max(r, g, b) where that max
//     is above 0 (else 0), then lerped toward the row's key colour by blend.
// A TDF2 biquad is the 2-state recurrence s[n] = A s[n-1] + bv x[n] with
// y[n] = s_0[n-1] + b0 x[n] and A = [[-a1, 1], [-a2, 0]]; the one-pole is
// s[n] = p s[n-1] + (1 - p) u[n].
//
// Three modes of one templated kernel, behind two C entries:
// - sig_colour_split: x -> the bands [B, 3, W] and z (three_band_split);
// - sig_colour_track: x -> the colours [B, 3, W] channel-major, z and the
//   smoothing state (the oscilloscope step's whole colour track), or, with
//   bands_in, bands [B, 3, W] -> the colours and the smoothing state
//   (spectral_colour_track on bands it is given).
//
// What bounds it on the H100: not bytes (cfg3's 32 rows of 16384 samples
// are 2.1 MB in and 6.3 MB out, 2.5 us at 3.35 TB/s) but eleven recurrences
// over every sample, each a chain of dependent operations. Each is solved as
// a chunked scan in one block a row: each thread holds a contiguous chunk of
// kChunk samples in registers, runs it from a zero state (thread 0 from the
// carried state), and the chunks' end states are combined by a scan over the
// block (lanes by shuffles with the powers A^(kChunk d), warps through
// shared memory with A^(32 kChunk d)); each sample is then fixed up with
// A^(j+1) times the state its chunk starts from, and handed to the next
// recurrence still in registers. The block's barriers and shuffles are the
// latency to hide, so independent recurrences share a scan: the low chain
// beside the rest's, then mid beside high (four rounds of two sections), then
// the three smoothers in one round: five block scans a tile, not eleven.
// The block walks the row in tiles of kThreads * kChunk samples, every
// recurrence's state carried from tile to tile. Every power is formed
// on the host in float64 from the float32 coefficients the plain code uses
// and rounded once to float32 (kernels/colour_track.py::host_table); the
// arithmetic is float32 FMAs, no tensor cores and no fast math, so
// denormals survive (a silent row is exactly the plain path's). Loads and
// stores go through a padded shared tile, coalesced in device memory and
// free of bank conflicts.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;                  // samples a thread holds
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLogWarps = 4;
constexpr int kTile = kChunk * kThreads;    // 8192 samples a tile
constexpr int kStage = kTile + kTile / 32;  // one pad word every 32
constexpr int kSections = 8;
constexpr int kBands = 3;
// the host table (kernels/colour_track.py::host_table): four coefficient
// sets (lp_lo, hp_lo, lp_hi, hp_hi), each [a00, a01, a10, a11, bv0, bv1, b0,
// 0] then A^1..A^kChunk, A^(kChunk k) for k = 0..31 and A^(32 kChunk 2^k)
// for k < kLogWarps (2x2, row-major); then the pole block [p, 1 - p, 0, 0]
// with p^1..p^kChunk, p^(kChunk k) and p^(32 kChunk 2^k)
constexpr int kSet = 8 + 4 * kChunk + 4 * 32 + 4 * kLogWarps;
constexpr int kPole = 4 + kChunk + 32 + kLogWarps;
constexpr int kTable = 4 * kSet + kPole;
static_assert((1 << kLogWarps) == kWarps, "the warp scan takes a power of two warps");
static_assert(kSet % 4 == 0, "each set starts 16-byte aligned");

enum Mode { kSplit = 0, kTrack = 1, kTrackBands = 2 };

struct Params {
  const float* x;          // rows of x (kSplit, kTrack) or of bands [B, 3, W] (kTrackBands)
  long long row_stride;    // floats between rows
  const float* table;      // [kTable]
  const float* z_in;       // [B, 8, 2]
  float* z_out;
  const float* smooth_in;  // [B, 3]
  float* smooth_out;
  const float* band_colours;  // [3, 3]
  const float* key;           // row b's at key + (b / rows_per_pair) * key_pair_stride + (b % rows_per_pair) * key_row_stride
  long long key_pair_stride, key_row_stride;
  int rows_per_pair;
  const float* blend;  // device scalar or null (then blend_value)
  float blend_value;
  float* out;          // [B, 3, W]
  int w;
};

struct Shared {
  float stage[kStage];
  __align__(16) float table[kTable];
  float warp_total[kWarps][4];   // up to four recurrence states scanned together
  float warp_prefix[kWarps][4];
  float2 carry[kSections + kBands];  // each recurrence's state entering the tile
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// the row's tile [base, base + kTile) of src (zero past w) into v, thread
// t taking samples t kChunk .. t kChunk + kChunk - 1
__device__ __forceinline__ void load_tile(Shared& sm, const float* src, int base, int w, float (&v)[kChunk]) {
  __syncthreads();  // nobody still reads the stage
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int n = base + i;
    sm.stage[pad(i)] = n < w ? src[n] : 0.f;
  }
  __syncthreads();
  const int c0 = threadIdx.x * kChunk;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) v[j] = sm.stage[pad(c0 + j)];
}

__device__ __forceinline__ void store_tile(Shared& sm, float* dst, int base, int w, const float (&v)[kChunk]) {
  __syncthreads();
  const int c0 = threadIdx.x * kChunk;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) sm.stage[pad(c0 + j)] = v[j];
  __syncthreads();
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    if (base + i < w) dst[base + i] = sm.stage[pad(i)];
  }
}

// v += M o, M a row-major D x D matrix (D = 2: a biquad; D = 1: a one-pole)
template <int D>
__device__ __forceinline__ void madd(const float* m, const float (&o)[D], float (&v)[D]) {
  if constexpr (D == 1) {
    v[0] = fmaf(m[0], o[0], v[0]);
  } else {
    const float n0 = fmaf(m[0], o[0], fmaf(m[1], o[1], v[0]));
    v[1] = fmaf(m[2], o[0], fmaf(m[3], o[1], v[1]));
    v[0] = n0;
  }
}

// K independent recurrences of D states, scanned together so that their
// latencies overlap. e[r]: recurrence r's state at the end of this thread's
// chunk when run from a zero start (thread 0: from the tile's carry);
// lanes[r]: its powers A^(kChunk m), m = 0..31, then the warp steps
// A^(32 kChunk 2^k). Returns in c[r] the state this thread's chunk starts
// from, and stores the tile's end state as the carry of slot[r].
template <int K, int D>
__device__ __forceinline__ void scan(float (&e)[K][D], const float* const (&lanes)[K], Shared& sm,
                                     const int (&slot)[K], float (&c)[K][D]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int d = 1 << k;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      float o[D];
#pragma unroll
      for (int i = 0; i < D; ++i) o[i] = __shfl_up_sync(0xffffffffu, e[r][i], d);
      if (lane >= d) madd<D>(lanes[r] + D * D * d, o, e[r]);
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
#pragma unroll
      for (int i = 0; i < D; ++i) sm.warp_total[warp][r * D + i] = e[r][i];
    }
  }
  __syncthreads();
  if (warp == 0) {
    float q[K][D];
#pragma unroll
    for (int r = 0; r < K; ++r) {
#pragma unroll
      for (int i = 0; i < D; ++i) q[r][i] = lane < kWarps ? sm.warp_total[lane][r * D + i] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kLogWarps; ++k) {
      const int d = 1 << k;
#pragma unroll
      for (int r = 0; r < K; ++r) {
        float o[D];
#pragma unroll
        for (int i = 0; i < D; ++i) o[i] = __shfl_up_sync(0xffffffffu, q[r][i], d);
        if (lane >= d) madd<D>(lanes[r] + D * D * (32 + k), o, q[r]);
      }
    }
    if (lane < kWarps) {
#pragma unroll
      for (int r = 0; r < K; ++r) {
#pragma unroll
        for (int i = 0; i < D; ++i) sm.warp_prefix[lane][r * D + i] = q[r][i];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < K; ++r) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float p = __shfl_up_sync(0xffffffffu, e[r][i], 1);
      c[r][i] = lane == 0 ? 0.f : p;
    }
    if (warp > 0) {
      float q[D];
#pragma unroll
      for (int i = 0; i < D; ++i) q[i] = sm.warp_prefix[warp - 1][r * D + i];
      madd<D>(lanes[r] + D * D * lane, q, c[r]);
    }
    if (threadIdx.x == 0) {
      sm.carry[slot[r]].x = sm.warp_prefix[kWarps - 1][r * D];
      if constexpr (D == 2) sm.carry[slot[r]].y = sm.warp_prefix[kWarps - 1][r * D + 1];
    }
  }
}

// A biquad section's run over this thread's chunk, in place, from a zero
// state (thread 0: from the tile's carry): v holds the input and gets the
// output of the local run; e the end state, at the state after sample je
// (the row's last sample, where this chunk holds it).
__device__ __forceinline__ void local_section(float (&v)[kChunk], const float* set, const Shared& sm, int sec,
                                              int je, float (&e)[2], float (&at)[2]) {
  const float a00 = set[0], a10 = set[2], bv0 = set[4], bv1 = set[5], b0 = set[6];
  float s0 = 0.f, s1 = 0.f;
  if (threadIdx.x == 0) {
    s0 = sm.carry[sec].x;
    s1 = sm.carry[sec].y;
  }
  at[0] = 0.f;
  at[1] = 0.f;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const float x = v[j];
    v[j] = fmaf(b0, x, s0);  // y[j] = s_0[j - 1] + b0 x[j]
    const float n0 = fmaf(a00, s0, fmaf(bv0, x, s1));
    s1 = fmaf(a10, s0, bv1 * x);
    s0 = n0;
    if (j == je) {
      at[0] = s0;
      at[1] = s1;
    }
  }
  e[0] = s0;
  e[1] = s1;
}

// the fix-up: the state before sample j is the local one plus A^j c; the
// row's end state (after sample je) the local one plus A^(je + 1) c, into z
__device__ __forceinline__ void fix_section(float (&v)[kChunk], const float* set, const float (&c)[2], int sec,
                                            int je, float (&at)[2], float* z) {
  const float* pw = set + 8;  // A^(j + 1) at pw + 4 j
  v[0] += c[0];
#pragma unroll
  for (int j = 1; j < kChunk; ++j) v[j] = fmaf(pw[4 * (j - 1)], c[0], fmaf(pw[4 * (j - 1) + 1], c[1], v[j]));
  if (je >= 0 && je < kChunk) {
    madd<2>(pw + 4 * je, c, at);
    z[2 * sec] = at[0];
    z[2 * sec + 1] = at[1];
  }
}

// Two biquad sections on two independent signals (va through set a as
// section sa, vb through set b as sb), their scans together.
__device__ __forceinline__ void section_pair(float (&va)[kChunk], float (&vb)[kChunk], const float* set_a,
                                             const float* set_b, Shared& sm, int sa, int sb, int je, float* z) {
  float e[2][2], at_a[2], at_b[2], c[2][2];
  local_section(va, set_a, sm, sa, je, e[0], at_a);
  local_section(vb, set_b, sm, sb, je, e[1], at_b);
  const float* const lanes[2] = {set_a + 8 + 4 * kChunk, set_b + 8 + 4 * kChunk};
  const int slot[2] = {sa, sb};
  scan<2, 2>(e, lanes, sm, slot, c);
  fix_section(va, set_a, c[0], sa, je, at_a, z);
  fix_section(vb, set_b, c[1], sb, je, at_b, z);
}

// one band's energy through the one-pole over this thread's chunk, from a
// zero state (thread 0: the tile's carry), in place; returns the end state
__device__ __forceinline__ float local_smooth(float (&v)[kChunk], const float* pole, const Shared& sm, int band) {
  const float p = pole[0], q = pole[1];
  float s = threadIdx.x == 0 ? sm.carry[kSections + band].x : 0.f;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const float u = __fmul_rn(__fmul_rn(v[j], v[j]), q);  // (band^2) (1 - p), as the plain code rounds it
    s = fmaf(p, s, u);
    v[j] = s;
  }
  return s;
}

__device__ __forceinline__ void fix_smooth(float (&v)[kChunk], const float* pole, float c, int band, int je,
                                           float* smooth_out) {
  const float* pw = pole + 4;  // p^(j + 1) at pw[j]
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    v[j] = fmaf(pw[j], c, v[j]);
    if (j == je) smooth_out[band] = v[j];
  }
}

// The three bands' energies smoothed, in place (each band's v gets its
// smoothed square), their scans together; the end states into smooth_out.
__device__ __forceinline__ void smooth3(float (&lo)[kChunk], float (&mid)[kChunk], float (&hi)[kChunk],
                                        const float* pole, Shared& sm, int je, float* smooth_out) {
  float e[3][1], c[3][1];
  e[0][0] = local_smooth(lo, pole, sm, 0);
  e[1][0] = local_smooth(mid, pole, sm, 1);
  e[2][0] = local_smooth(hi, pole, sm, 2);
  const float* lanes_p = pole + 4 + kChunk;
  const float* const lanes[3] = {lanes_p, lanes_p, lanes_p};
  const int slot[3] = {kSections, kSections + 1, kSections + 2};
  scan<3, 1>(e, lanes, sm, slot, c);
  fix_smooth(lo, pole, c[0][0], 0, je, smooth_out);
  fix_smooth(mid, pole, c[1][0], 1, je, smooth_out);
  fix_smooth(hi, pole, c[2][0], 2, je, smooth_out);
}

// rgb from the smoothed energies (in place: lo -> r, mid -> g, hi -> b),
// normalised by its largest channel, lerped toward the key colour: the
// plain code's operations one by one (__fmul_rn / __fadd_rn: nothing is
// contracted), but for the normalisation, one reciprocal and three
// products in place of three divisions (within two ulps of them; the
// divisions cost a tenth of the kernel's time). An unlit sample (a silent
// row) is exactly the plain path's.
__device__ __forceinline__ void mix(float (&lo)[kChunk], float (&mid)[kChunk], float (&hi)[kChunk],
                                    const float* bc, const float* key, float blend) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    float rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      rgb[c] = __fadd_rn(__fadd_rn(__fmul_rn(lo[j], bc[c]), __fmul_rn(mid[j], bc[3 + c])), __fmul_rn(hi[j], bc[6 + c]));
    }
    // torch.amax propagates a NaN, and where(peak > 0) then gives 0
    const bool nan = rgb[0] != rgb[0] || rgb[1] != rgb[1] || rgb[2] != rgb[2];
    const float peak = fmaxf(fmaxf(rgb[0], rgb[1]), rgb[2]);
    const bool lit = !nan && peak > 0.f;
    const float inv = __frcp_rn(fmaxf(peak, 1e-20f));  // 1 / clamp(peak, min=1e-20)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float n = lit ? __fmul_rn(rgb[c], inv) : 0.f;
      rgb[c] = __fadd_rn(key[c], __fmul_rn(__fsub_rn(n, key[c]), blend));
    }
    lo[j] = rgb[0];
    mid[j] = rgb[1];
    hi[j] = rgb[2];
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) colour_track_kernel(const Params p) {
  __shared__ Shared sm;
  const int b = blockIdx.x;
  const int w = p.w;
  for (int i = threadIdx.x; i < kTable; i += kThreads) sm.table[i] = p.table[i];
  if (kMode != kTrackBands && threadIdx.x < kSections) {
    sm.carry[threadIdx.x] = make_float2(p.z_in[(long long)b * 16 + 2 * threadIdx.x],
                                        p.z_in[(long long)b * 16 + 2 * threadIdx.x + 1]);
  }
  if (kMode != kSplit && threadIdx.x < kBands) {
    sm.carry[kSections + threadIdx.x] = make_float2(p.smooth_in[(long long)b * 3 + threadIdx.x], 0.f);
  }
  // __syncthreads() in the first load_tile publishes the table and carries
  const float* src = p.x + (long long)b * p.row_stride;
  float* out = p.out + (long long)b * 3 * w;
  float* z = kMode != kTrackBands ? p.z_out + (long long)b * 16 : nullptr;
  float* smooth_out = kMode != kSplit ? p.smooth_out + (long long)b * 3 : nullptr;
  const float* sets = sm.table;
  const float* pole = sm.table + 4 * kSet;
  for (int base = 0; base < w; base += kTile) {
    const int je = w - 1 - base - (int)threadIdx.x * kChunk;
    float x[kChunk], lo[kChunk], mid[kChunk];
    if (kMode == kTrackBands) {
      load_tile(sm, src, base, w, lo);
      load_tile(sm, src + w, base, w, mid);
      load_tile(sm, src + 2 * w, base, w, x);
    } else {
      // the low chain and the rest beside it, then mid and high beside each
      // other: four rounds of two sections
      load_tile(sm, src, base, w, x);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) lo[j] = x[j];
      section_pair(lo, x, sets, sets + kSet, sm, 0, 2, je, z);
      section_pair(lo, x, sets, sets + kSet, sm, 1, 3, je, z);  // x is now the rest
      if (kMode == kSplit) store_tile(sm, out, base, w, lo);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) mid[j] = x[j];
      section_pair(mid, x, sets + 2 * kSet, sets + 3 * kSet, sm, 4, 6, je, z);
      section_pair(mid, x, sets + 2 * kSet, sets + 3 * kSet, sm, 5, 7, je, z);
      if (kMode == kSplit) {
        store_tile(sm, out + w, base, w, mid);
        store_tile(sm, out + 2 * w, base, w, x);
      }
    }
    if (kMode != kSplit) {
      smooth3(lo, mid, x, pole, sm, je, smooth_out);
      float bc[9], key[3];
      const long long row = b % p.rows_per_pair, pair = b / p.rows_per_pair;
#pragma unroll
      for (int i = 0; i < 9; ++i) bc[i] = p.band_colours[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) key[c] = p.key[pair * p.key_pair_stride + row * p.key_row_stride + c];
      mix(lo, mid, x, bc, key, p.blend != nullptr ? *p.blend : p.blend_value);
      store_tile(sm, out, base, w, lo);
      store_tile(sm, out + w, base, w, mid);
      store_tile(sm, out + 2 * w, base, w, x);
    }
  }
}

template <int kMode>
int launch(const Params& p, int rows, void* stream) {
  colour_track_kernel<kMode><<<rows, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

bool geometry_ok(int rows, int w, int chunk, int threads) {
  return rows >= 1 && w >= 1 && chunk == kChunk && threads == kThreads;
}

}  // namespace

// The 3-band split alone. x [rows, W] f32, rows row_stride floats apart
// (unit stride within a row); table [kTable] for this sample rate and
// crossover (kernels/colour_track.py::host_table, built for chunk and
// threads, which must be this build's); z_in/z_out [rows, 8, 2]; bands
// [rows, 3, W] (low, mid, high), contiguous.
extern "C" int sig_colour_split(const float* x, long long row_stride, const float* table, const float* z_in,
                                float* z_out, float* bands, int rows, int w, int chunk, int threads, void* stream) {
  if (!geometry_ok(rows, w, chunk, threads) || row_stride < w) return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.row_stride = row_stride;
  p.table = table;
  p.z_in = z_in;
  p.z_out = z_out;
  p.out = bands;
  p.w = w;
  return launch<kSplit>(p, rows, stream);
}

// The colour track. bands_in == 0: x [rows, W] as for sig_colour_split, the
// crossover state z_in/z_out [rows, 8, 2]; bands_in != 0: x is bands [rows,
// 3, W] contiguous (row_stride 3 W) and z is not touched (may be null).
// smooth_in/out [rows, 3]; band_colours [3, 3] rgb rows for low/mid/high;
// row b's key colour (3 floats) at key + (b / rows_per_pair) *
// key_pair_stride + (b % rows_per_pair) * key_row_stride; blend a device
// scalar, or null and then blend_value; colours [rows, 3, W] (r, g, b),
// contiguous.
extern "C" int sig_colour_track(const float* x, long long row_stride, int bands_in, const float* table,
                                const float* z_in, float* z_out, const float* smooth_in, float* smooth_out,
                                const float* band_colours, const float* key, long long key_pair_stride,
                                long long key_row_stride, int rows_per_pair, const float* blend, float blend_value,
                                float* colours, int rows, int w, int chunk, int threads, void* stream) {
  if (!geometry_ok(rows, w, chunk, threads) || rows_per_pair < 1) return (int)cudaErrorInvalidValue;
  if (bands_in ? row_stride < 3LL * w : row_stride < w) return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.row_stride = row_stride;
  p.table = table;
  p.z_in = z_in;
  p.z_out = z_out;
  p.smooth_in = smooth_in;
  p.smooth_out = smooth_out;
  p.band_colours = band_colours;
  p.key = key;
  p.key_pair_stride = key_pair_stride;
  p.key_row_stride = key_row_stride;
  p.rows_per_pair = rows_per_pair;
  p.blend = blend;
  p.blend_value = blend_value;
  p.out = colours;
  p.w = w;
  return bands_in ? launch<kTrackBands>(p, rows, stream) : launch<kTrack>(p, rows, stream);
}
