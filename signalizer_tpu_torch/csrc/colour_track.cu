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
// a chunked scan, a row split across a thread-block cluster: each block of
// the cluster owns a contiguous segment of the row (threads x kChunk
// samples), each thread a contiguous chunk of kChunk samples in registers,
// run from a zero state (the cluster's first thread from the carried
// state); the chunks' end states are combined by a scan over lanes by
// shuffles with the powers A^(kChunk d), then, after one barrier (a
// cluster's), by a scan over the cluster's warps (at most 32, one a lane)
// with A^(32 kChunk 2^k), each warp reading every warp's end from its
// block's shared memory through distributed shared memory. Each sample is
// then fixed up with A^(j+1) times the state its chunk starts from, and
// handed to the next recurrence still in registers. The barriers and
// shuffles are the latency to hide, so independent recurrences share a
// scan: the low chain beside the rest's, then mid beside high (four rounds
// of two sections), then the three smoothers in one round: five scans a
// segment, not eleven. The wrapper's plan (kernels/colour_track.py::
// colour_plan) picks the cluster's size and the block's threads from the
// rows, W and the card's multiprocessors, so that few long rows still
// spread over many SMs (a row within one block's segment takes one block);
// a row longer than the cluster's span is walked in tiles of
// that span, every recurrence's state carried from tile to tile. Every
// power is formed on the host in float64 from the float32 coefficients the
// plain code uses and rounded once to float32 (kernels/colour_track.py::
// host_table); the arithmetic is float32 FMAs, no tensor cores and no fast
// math, so denormals survive (a silent row is exactly the plain path's).
// Loads and stores go through a padded shared stage, coalesced in device
// memory and free of bank conflicts.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 16;                  // samples a thread holds
constexpr int kThreads = 512;               // threads a block, at most (a power of two, 32 or more)
constexpr int kMaxCluster = 16;             // blocks a row, at most (above 8: a non-portable cluster)
constexpr int kClusterWarps = 32;           // warps a cluster, at most: one a lane of the cluster scan
constexpr int kSteps = 5;                   // the cluster scan's steps, A^(32 kChunk 2^k)
constexpr int kSections = 8;
constexpr int kBands = 3;
// the host table (kernels/colour_track.py::host_table): four coefficient
// sets (lp_lo, hp_lo, lp_hi, hp_hi), each [a00, a01, a10, a11, bv0, bv1, b0,
// 0] then A^1..A^kChunk, A^(kChunk l) for l = 0..31 and A^(32 kChunk 2^k)
// for k < kSteps (2x2, row-major); then the pole block [p, 1 - p, 0, 0]
// with p's powers likewise
constexpr int kPowers = kChunk + 32 + kSteps;
constexpr int kSet = 8 + 4 * kPowers;
constexpr int kPole = 4 + kPowers;
constexpr int kTable = 4 * kSet + kPole;
constexpr int kStepPowers = 32;  // after the lane powers: A^(32 kChunk 2^k)
static_assert((1 << kSteps) == kClusterWarps, "the cluster scan's steps cover its warps");
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
  int cluster;         // blocks a row: a cluster
};

struct Shared {
  __align__(16) float table[kTable];
  float warp_total[2][kThreads / 32][4];  // up to four recurrence states scanned together, by round parity
  float2 carry[kSections + kBands];  // each recurrence's state entering the tile
};

// Where a block sits: its rank in the row's cluster, the cluster's size,
// its warps (a power of two) and their log2, the steps of a scan over the
// cluster's warps (ceil(log2(cluster x warps))), the scans run so far;
// first: the thread whose chunk starts the tile (rank 0, thread 0)
struct Geo {
  int rank, cluster, warps, log_warps, steps, round;
  bool first;
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// the segment [base, base + blockDim.x kChunk) of src (zero past w) into v,
// thread t taking samples t kChunk .. t kChunk + kChunk - 1; each thread's
// kChunk loads are issued together
__device__ __forceinline__ void load_tile(float* stage, const float* src, int base, int w, float (&v)[kChunk]) {
  float in[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int at = base + threadIdx.x + j * blockDim.x;
    in[j] = at < w ? src[at] : 0.f;
  }
  __syncthreads();  // nobody still reads the stage
#pragma unroll
  for (int j = 0; j < kChunk; ++j) stage[pad(threadIdx.x + j * blockDim.x)] = in[j];
  __syncthreads();
  const int c0 = threadIdx.x * kChunk;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) v[j] = stage[pad(c0 + j)];
}

__device__ __forceinline__ void store_tile(float* stage, float* dst, int base, int w, const float (&v)[kChunk]) {
  __syncthreads();
  const int c0 = threadIdx.x * kChunk;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) stage[pad(c0 + j)] = v[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (base + i < w) dst[base + i] = stage[pad(i)];
  }
}

// the table into shared memory, every copy in flight at once (cp.async)
__device__ __forceinline__ void load_table(float* table, const float* src) {
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(table + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src + i) : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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
// chunk when run from a zero start (the tile's first thread: from the
// carry); lanes[r]: its powers A^(kChunk l), l = 0..31, then A^(32 kChunk
// 2^k). Lanes scan by shuffles; each warp's end goes to its block's shared
// memory, and after one barrier (a cluster's, with more than one block)
// every warp reads the ends of all the cluster's warps, one a lane (at
// most 32: the plan's bound), through distributed shared memory and scans
// them, so that each has the state entering it with no other barrier.
// Returns in c[r] the state this thread's chunk starts from, and stores
// the tile's end state as the carry of slot[r].
template <int K, int D>
__device__ __forceinline__ void scan(float (&e)[K][D], const float* const (&lanes)[K], Shared& sm,
                                     const int (&slot)[K], float (&c)[K][D], Geo& g) {
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
  float* total = &sm.warp_total[g.round & 1][0][0];
  if (lane == 31) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
#pragma unroll
      for (int i = 0; i < D; ++i) total[warp * 4 + r * D + i] = e[r][i];
    }
  }
  if (g.cluster > 1) {
    cg::this_cluster().sync();  // every warp's end is in its block's shared memory
  } else {
    __syncthreads();
  }
  ++g.round;  // the next round writes the other buffer: no barrier before it
  // q: the state at the end of the cluster's warp `lane` (block lane /
  // warps, its warp lane % warps) from the tile's start
  float q[K][D];
#pragma unroll
  for (int r = 0; r < K; ++r) {
#pragma unroll
    for (int i = 0; i < D; ++i) q[r][i] = 0.f;
  }
  if (lane < g.cluster * g.warps) {
    const float* from = g.cluster > 1 ? cg::this_cluster().map_shared_rank(total, lane >> g.log_warps) : total;
    const int w = lane & (g.warps - 1);
#pragma unroll
    for (int r = 0; r < K; ++r) {
#pragma unroll
      for (int i = 0; i < D; ++i) q[r][i] = from[w * 4 + r * D + i];
    }
  }
  for (int k = 0; k < g.steps; ++k) {
    const int d = 1 << k;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      float o[D];
#pragma unroll
      for (int i = 0; i < D; ++i) o[i] = __shfl_up_sync(0xffffffffu, q[r][i], d);
      if (lane >= d) madd<D>(lanes[r] + D * D * (kStepPowers + k), o, q[r]);
    }
  }
  const int before = g.rank * g.warps + warp - 1;  // the cluster's warp before this one (-1: none)
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float p[D];  // the state entering this warp
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float end = __shfl_sync(0xffffffffu, q[r][i], g.cluster * g.warps - 1);
      if (threadIdx.x == 0) (i == 0 ? sm.carry[slot[r]].x : sm.carry[slot[r]].y) = end;
      const float at = __shfl_sync(0xffffffffu, q[r][i], before > 0 ? before : 0);
      p[i] = before >= 0 ? at : 0.f;
      const float up = __shfl_up_sync(0xffffffffu, e[r][i], 1);
      c[r][i] = lane == 0 ? 0.f : up;
    }
    madd<D>(lanes[r] + D * D * lane, p, c[r]);
  }
}

template <bool kEnds>
__device__ __forceinline__ void run_section(float (&v)[kChunk], const float* set, float s0, float s1, int je,
                                            float (&e)[2], float (&at)[2]) {
  const float a00 = set[0], a10 = set[2], bv0 = set[4], bv1 = set[5], b0 = set[6];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const float x = v[j];
    v[j] = fmaf(b0, x, s0);  // y[j] = s_0[j - 1] + b0 x[j]
    const float n0 = fmaf(a00, s0, fmaf(bv0, x, s1));
    s1 = fmaf(a10, s0, bv1 * x);
    s0 = n0;
    if (kEnds && j == je) {
      at[0] = s0;
      at[1] = s1;
    }
  }
  e[0] = s0;
  e[1] = s1;
}

__device__ __forceinline__ void local_section(float (&v)[kChunk], const float* set, const Shared& sm, int sec,
                                              int je, float (&e)[2], float (&at)[2], const Geo& g) {
  const float s0 = g.first ? sm.carry[sec].x : 0.f, s1 = g.first ? sm.carry[sec].y : 0.f;
  at[0] = 0.f;
  at[1] = 0.f;
  if (je >= 0 && je < kChunk) {  // the chunk that holds the row's last sample (one warp's branch)
    run_section<true>(v, set, s0, s1, je, e, at);
  } else {
    run_section<false>(v, set, s0, s1, je, e, at);
  }
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
                                             const float* set_b, Shared& sm, int sa, int sb, int je, float* z,
                                             Geo& g) {
  float e[2][2], at_a[2], at_b[2], c[2][2];
  local_section(va, set_a, sm, sa, je, e[0], at_a, g);
  local_section(vb, set_b, sm, sb, je, e[1], at_b, g);
  const float* const lanes[2] = {set_a + 8 + 4 * kChunk, set_b + 8 + 4 * kChunk};
  const int slot[2] = {sa, sb};
  scan<2, 2>(e, lanes, sm, slot, c, g);
  fix_section(va, set_a, c[0], sa, je, at_a, z);
  fix_section(vb, set_b, c[1], sb, je, at_b, z);
}

// one band's energy through the one-pole over this thread's chunk, from a
// zero state (the tile's first thread: its carry), in place; returns the end state
__device__ __forceinline__ float local_smooth(float (&v)[kChunk], const float* pole, const Shared& sm, int band,
                                              const Geo& g) {
  const float p = pole[0], q = pole[1];
  float s = g.first ? sm.carry[kSections + band].x : 0.f;
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
  for (int j = 0; j < kChunk; ++j) v[j] = fmaf(pw[j], c, v[j]);
  if (je >= 0 && je < kChunk) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j == je) smooth_out[band] = v[j];
    }
  }
}

// The three bands' energies smoothed, in place (each band's v gets its
// smoothed square), their scans together; the end states into smooth_out.
__device__ __forceinline__ void smooth3(float (&lo)[kChunk], float (&mid)[kChunk], float (&hi)[kChunk],
                                        const float* pole, Shared& sm, int je, float* smooth_out, Geo& g) {
  float e[3][1], c[3][1];
  e[0][0] = local_smooth(lo, pole, sm, 0, g);
  e[1][0] = local_smooth(mid, pole, sm, 1, g);
  e[2][0] = local_smooth(hi, pole, sm, 2, g);
  const float* lanes_p = pole + 4 + kChunk;
  const float* const lanes[3] = {lanes_p, lanes_p, lanes_p};
  const int slot[3] = {kSections, kSections + 1, kSections + 2};
  scan<3, 1>(e, lanes, sm, slot, c, g);
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

// Grid: rows x cluster blocks in clusters of `cluster`, a power of two
// threads (32 to kThreads) a block, threads x (kChunk + kChunk / 32) floats
// of dynamic shared memory (the stage).
template <int kMode>
__global__ void __launch_bounds__(kThreads) colour_track_kernel(const Params p) {
  __shared__ Shared sm;
  extern __shared__ float stage[];
  Geo g;
  g.cluster = p.cluster;
  g.rank = p.cluster > 1 ? (int)cg::this_cluster().block_rank() : 0;
  g.warps = blockDim.x >> 5;
  g.log_warps = __ffs(g.warps) - 1;
  g.steps = 32 - __clz(p.cluster * g.warps - 1);
  g.first = g.rank == 0 && threadIdx.x == 0;
  g.round = 0;
  const int b = blockIdx.x / p.cluster;
  const int w = p.w;
  const int segment = blockDim.x * kChunk;
  load_table(sm.table, p.table);
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
  for (int tile_base = 0; tile_base < w; tile_base += segment * p.cluster) {
    const int base = tile_base + g.rank * segment;
    const int je = w - 1 - base - (int)threadIdx.x * kChunk;
    float x[kChunk], lo[kChunk], mid[kChunk];
    if (kMode == kTrackBands) {
      load_tile(stage, src, base, w, lo);
      load_tile(stage, src + w, base, w, mid);
      load_tile(stage, src + 2 * w, base, w, x);
    } else {
      // the low chain and the rest beside it, then mid and high beside each
      // other: four rounds of two sections
      load_tile(stage, src, base, w, x);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) lo[j] = x[j];
      section_pair(lo, x, sets, sets + kSet, sm, 0, 2, je, z, g);
      section_pair(lo, x, sets, sets + kSet, sm, 1, 3, je, z, g);  // x is now the rest
      if (kMode == kSplit) store_tile(stage, out, base, w, lo);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) mid[j] = x[j];
      section_pair(mid, x, sets + 2 * kSet, sets + 3 * kSet, sm, 4, 6, je, z, g);
      section_pair(mid, x, sets + 2 * kSet, sets + 3 * kSet, sm, 5, 7, je, z, g);
      if (kMode == kSplit) {
        store_tile(stage, out + w, base, w, mid);
        store_tile(stage, out + 2 * w, base, w, x);
      }
    }
    if (kMode != kSplit) {
      smooth3(lo, mid, x, pole, sm, je, smooth_out, g);
      float bc[9], key[3];
      const long long row = b % p.rows_per_pair, pair = b / p.rows_per_pair;
#pragma unroll
      for (int i = 0; i < 9; ++i) bc[i] = p.band_colours[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) key[c] = p.key[pair * p.key_pair_stride + row * p.key_row_stride + c];
      mix(lo, mid, x, bc, key, p.blend != nullptr ? *p.blend : p.blend_value);
      store_tile(stage, out, base, w, lo);
      store_tile(stage, out + w, base, w, mid);
      store_tile(stage, out + 2 * w, base, w, x);
    }
  }
  if (p.cluster > 1) cg::this_cluster().sync();  // no block leaves while a peer may read its shared memory
}

// One launch of rows x cluster blocks of `threads` on `stream`: above 8
// blocks a cluster the non-portable opt-in, and a check that such a
// cluster fits the card, each once per mode, threads and cluster size; then
// the launch's own error.
template <int kMode>
int launch(const Params& p, int rows, int threads, void* stream) {
  const auto kernel = colour_track_kernel<kMode>;
  static bool checked[6][kMaxCluster + 1] = {};  // by log2(threads / 32) and cluster
  const int log_w = __builtin_ctz(threads / 32);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * p.cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(float) * (threads * kChunk + threads * kChunk / 32);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!checked[log_w][p.cluster]) {
    if (p.cluster > 8) {
      const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    checked[log_w][p.cluster] = true;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool geometry_ok(int rows, int w, int chunk, int threads, int cluster) {
  return rows >= 1 && w >= 1 && chunk == kChunk && threads >= 32 && threads <= kThreads &&
         (threads & (threads - 1)) == 0 && cluster >= 1 && cluster <= kMaxCluster &&
         cluster * (threads / 32) <= kClusterWarps && (long long)rows * cluster <= 0x7fffffffLL;
}

}  // namespace

// The 3-band split alone. x [rows, W] f32, rows row_stride floats apart
// (unit stride within a row); table [kTable] for this sample rate and
// crossover (kernels/colour_track.py::host_table, built for chunk, which
// must be this build's kChunk); z_in/z_out [rows, 8, 2]; bands [rows, 3, W]
// (low, mid, high), contiguous. A row is split across a cluster of
// `cluster` blocks (1 to kMaxCluster) of `threads` threads (a power of two,
// 32 to kThreads), at most kClusterWarps warps a cluster; a cluster that
// does not fit the card is refused.
extern "C" int sig_colour_split(const float* x, long long row_stride, const float* table, const float* z_in,
                                float* z_out, float* bands, int rows, int w, int chunk, int threads, int cluster,
                                void* stream) {
  if (!geometry_ok(rows, w, chunk, threads, cluster) || row_stride < w) return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.row_stride = row_stride;
  p.table = table;
  p.z_in = z_in;
  p.z_out = z_out;
  p.out = bands;
  p.w = w;
  p.cluster = cluster;
  return launch<kSplit>(p, rows, threads, stream);
}

// The colour track. bands_in == 0: x [rows, W] as for sig_colour_split, the
// crossover state z_in/z_out [rows, 8, 2]; bands_in != 0: x is bands [rows,
// 3, W] contiguous (row_stride 3 W) and z is not touched (may be null).
// smooth_in/out [rows, 3]; band_colours [3, 3] rgb rows for low/mid/high;
// row b's key colour (3 floats) at key + (b / rows_per_pair) *
// key_pair_stride + (b % rows_per_pair) * key_row_stride; blend a device
// scalar, or null and then blend_value; colours [rows, 3, W] (r, g, b),
// contiguous; chunk, threads and cluster as for sig_colour_split.
extern "C" int sig_colour_track(const float* x, long long row_stride, int bands_in, const float* table,
                                const float* z_in, float* z_out, const float* smooth_in, float* smooth_out,
                                const float* band_colours, const float* key, long long key_pair_stride,
                                long long key_row_stride, int rows_per_pair, const float* blend, float blend_value,
                                float* colours, int rows, int w, int chunk, int threads, int cluster,
                                void* stream) {
  if (!geometry_ok(rows, w, chunk, threads, cluster) || rows_per_pair < 1) return (int)cudaErrorInvalidValue;
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
  p.cluster = cluster;
  return bands_in ? launch<kTrackBands>(p, rows, threads, stream) : launch<kTrack>(p, rows, threads, stream);
}
