// Kernel E's first design (design 1 of its bring-up): one block scan a
// recurrence, eleven scans a tile, the mix dividing three times a sample.
// Kept for signalizer_tpu_torch/tools/kernel_variants.py (--kernels e
// --named colour_v1). The package's kernel is
// signalizer_tpu_torch/csrc/colour_track.cu.

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
  float2 warp_total[kWarps];
  float2 warp_prefix[kWarps];
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

// v + M (o0, o1), M a row-major 2x2
__device__ __forceinline__ float2 madd(const float* m, float o0, float o1, float2 v) {
  return make_float2(fmaf(m[0], o0, fmaf(m[1], o1, v.x)), fmaf(m[2], o0, fmaf(m[3], o1, v.y)));
}

// The state each thread's chunk starts from, given e, the state its chunk
// ends in when run from a zero start (thread 0: from the tile's carry).
// lanes: A^(kChunk k), k = 0..31, then the warp steps. Stores the tile's end
// state as the carry of recurrence `slot`.
__device__ __forceinline__ float2 scan2(float2 e, const float* lanes, Shared& sm, int slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int d = 1 << k;
    const float o0 = __shfl_up_sync(0xffffffffu, e.x, d);
    const float o1 = __shfl_up_sync(0xffffffffu, e.y, d);
    if (lane >= d) e = madd(lanes + 4 * d, o0, o1, e);
  }
  if (lane == 31) sm.warp_total[warp] = e;
  __syncthreads();
  if (warp == 0) {
    float2 q = lane < kWarps ? sm.warp_total[lane] : make_float2(0.f, 0.f);
    const float* steps = lanes + 4 * 32;
#pragma unroll
    for (int k = 0; k < kLogWarps; ++k) {
      const int d = 1 << k;
      const float o0 = __shfl_up_sync(0xffffffffu, q.x, d);
      const float o1 = __shfl_up_sync(0xffffffffu, q.y, d);
      if (lane >= d) q = madd(steps + 4 * k, o0, o1, q);
    }
    if (lane < kWarps) sm.warp_prefix[lane] = q;
  }
  __syncthreads();
  const float p0 = __shfl_up_sync(0xffffffffu, e.x, 1);
  const float p1 = __shfl_up_sync(0xffffffffu, e.y, 1);
  float2 c = lane == 0 ? make_float2(0.f, 0.f) : make_float2(p0, p1);
  if (warp > 0) {
    const float2 q = sm.warp_prefix[warp - 1];
    c = madd(lanes + 4 * lane, q.x, q.y, c);
  }
  if (threadIdx.x == 0) sm.carry[slot] = sm.warp_prefix[kWarps - 1];
  return c;
}

// scan2 for the one-pole: scalar powers
__device__ __forceinline__ float scan1(float e, const float* lanes, Shared& sm, int slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int d = 1 << k;
    const float o = __shfl_up_sync(0xffffffffu, e, d);
    if (lane >= d) e = fmaf(lanes[d], o, e);
  }
  if (lane == 31) sm.warp_total[warp].x = e;
  __syncthreads();
  if (warp == 0) {
    float q = lane < kWarps ? sm.warp_total[lane].x : 0.f;
    const float* steps = lanes + 32;
#pragma unroll
    for (int k = 0; k < kLogWarps; ++k) {
      const int d = 1 << k;
      const float o = __shfl_up_sync(0xffffffffu, q, d);
      if (lane >= d) q = fmaf(steps[k], o, q);
    }
    if (lane < kWarps) sm.warp_prefix[lane].x = q;
  }
  __syncthreads();
  const float p = __shfl_up_sync(0xffffffffu, e, 1);
  float c = lane == 0 ? 0.f : p;
  if (warp > 0) c = fmaf(lanes[lane], sm.warp_prefix[warp - 1].x, c);
  if (threadIdx.x == 0) sm.carry[slot].x = sm.warp_prefix[kWarps - 1].x;
  return c;
}

// One biquad section over the tile, in place: v holds its input and gets
// its output. je: this thread's index of the row's last sample (outside
// [0, kChunk) unless the chunk holds it); there the section's end state is
// written to z (the row's [8, 2]).
__device__ __forceinline__ void section(float (&v)[kChunk], const float* set, Shared& sm, int sec, int je,
                                        float* z) {
  const float a00 = set[0], a10 = set[2], bv0 = set[4], bv1 = set[5], b0 = set[6];
  float s0 = 0.f, s1 = 0.f;
  if (threadIdx.x == 0) {
    s0 = sm.carry[sec].x;
    s1 = sm.carry[sec].y;
  }
  float e0 = 0.f, e1 = 0.f;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const float x = v[j];
    v[j] = fmaf(b0, x, s0);  // y[j] = s_0[j - 1] + b0 x[j]
    const float n0 = fmaf(a00, s0, fmaf(bv0, x, s1));
    s1 = fmaf(a10, s0, bv1 * x);
    s0 = n0;
    if (j == je) {
      e0 = s0;
      e1 = s1;
    }
  }
  const float* pw = set + 8;  // A^(j + 1) at pw + 4 j
  const float2 c = scan2(make_float2(s0, s1), pw + 4 * kChunk, sm, sec);
  // the state before sample j is the local one plus A^j c
  v[0] += c.x;
#pragma unroll
  for (int j = 1; j < kChunk; ++j) v[j] = fmaf(pw[4 * (j - 1)], c.x, fmaf(pw[4 * (j - 1) + 1], c.y, v[j]));
  if (je >= 0 && je < kChunk) {
    const float* m = pw + 4 * je;
    z[2 * sec] = fmaf(m[0], c.x, fmaf(m[1], c.y, e0));
    z[2 * sec + 1] = fmaf(m[2], c.x, fmaf(m[3], c.y, e1));
  }
}

// The band's energy smoothed, in place: v holds the band and gets the
// smoothed square; the end state at je into smooth (the row's [3]).
__device__ __forceinline__ void smooth(float (&v)[kChunk], const float* pole, Shared& sm, int band, int je,
                                       float* smooth_out) {
  const float p = pole[0], q = pole[1];
  float s = threadIdx.x == 0 ? sm.carry[kSections + band].x : 0.f;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const float u = __fmul_rn(__fmul_rn(v[j], v[j]), q);  // (band^2) (1 - p), as the plain code rounds it
    s = fmaf(p, s, u);
    v[j] = s;
  }
  const float* pw = pole + 4;  // p^(j + 1) at pw[j]
  const float c = scan1(s, pw + kChunk, sm, kSections + band);
#pragma unroll
  for (int j = 0; j < kChunk; ++j) v[j] = fmaf(pw[j], c, v[j]);
  if (je >= 0 && je < kChunk) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j == je) smooth_out[band] = v[j];
    }
  }
}

// rgb from the smoothed energies (in place: lo -> r, mid -> g, hi -> b),
// normalised by its largest channel, lerped toward the key colour
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
    const float den = fmaxf(peak, 1e-20f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float n = lit ? __fdiv_rn(rgb[c], den) : 0.f;
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
      smooth(lo, pole, sm, 0, je, smooth_out);
      load_tile(sm, src + w, base, w, mid);
      smooth(mid, pole, sm, 1, je, smooth_out);
      load_tile(sm, src + 2 * w, base, w, x);
      smooth(x, pole, sm, 2, je, smooth_out);
    } else {
      load_tile(sm, src, base, w, x);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) lo[j] = x[j];
      section(lo, sets, sm, 0, je, z);
      section(lo, sets, sm, 1, je, z);
      if (kMode == kSplit) {
        store_tile(sm, out, base, w, lo);
      } else {
        smooth(lo, pole, sm, 0, je, smooth_out);
      }
      section(x, sets + kSet, sm, 2, je, z);
      section(x, sets + kSet, sm, 3, je, z);  // x is now the rest
#pragma unroll
      for (int j = 0; j < kChunk; ++j) mid[j] = x[j];
      section(mid, sets + 2 * kSet, sm, 4, je, z);
      section(mid, sets + 2 * kSet, sm, 5, je, z);
      if (kMode == kSplit) {
        store_tile(sm, out + w, base, w, mid);
      } else {
        smooth(mid, pole, sm, 1, je, smooth_out);
      }
      section(x, sets + 3 * kSet, sm, 6, je, z);
      section(x, sets + 3 * kSet, sm, 7, je, z);
      if (kMode == kSplit) {
        store_tile(sm, out + 2 * w, base, w, x);
      } else {
        smooth(x, pole, sm, 2, je, smooth_out);
      }
    }
    if (kMode != kSplit) {
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
