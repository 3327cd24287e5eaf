// Kernel B's decay-and-dB entry: peak decay -> normalized dB over T frames
// and K line graphs, for values that are already display values (the
// resonator's readout; post_process), for sm_90a.
//
// Replaces, with display_map.cu (the fused remap, decay and dB), the TPU
// kernel tools/pallas_display_map.py::fused_display_map, whose tail this is:
// post_process in signalizer_tpu/kernels/spectrum.py:518-598, linear decay.
//
// Layout: vals [pairs, T, rows, P] f32; slope_map [P]; decay_poles [K]
// (>= 0); scalars [4] = inv_size, lower, 1/log(upper/lower), clip_db; valid
// [T] bool or null; state [pairs, K, rows, P] f32, updated in place; out
// [pairs, T, K, rows, P] f32. Scratch the wrapper allocates: starts
// [pairs, groups, K, rows, P] f32 when T takes more than one group of
// frames, ends [chunks, pairs, K, rows, P] f32 when it takes more than one
// chunk. Per pixel, frame t, line graph k:
//   if valid[t]: s_k = max(pole_k * s_k, v)
//   out = x > 0 ? log(max(x, 1e-38)) * dyr : clip_db,  x = slope*s_k/lower
// the fused kernel's arithmetic, so that remap then decay-and-dB is the
// fused entry bit for bit.
//
// What bounds it on the H100: each value is read once and each output
// written once (16.8 MB + 33.5 MB at the headline, 16 pairs x 128 frames x
// 2 rows x 1024 px x 2 line graphs: ~15 us at 3.35 TB/s), and each output
// also costs an IEEE division and an accurate logf (no fast math: the
// values are displayed down to -96 dB): some 8 us of instruction slots at
// the headline. A kernel that folds the decay across its threads between its
// loads and its stores (a block barrier) runs its reads, its fold and its
// writes one after the other on every SM, since the grid is one wave; the
// fused kernel's layout took 42 us so, and a block of 16 frame groups with
// 16-byte accesses 34. So the fold is a pass of its own:
//
// * A thread owns 4 consecutive pixels (16-byte loads and stores; a scalar
//   form where P or a pointer is not 16-byte aligned, the P tail masked)
//   and G = 8 consecutive frames, a group (G = 1 for T <= 8, the per-tick
//   call's T = 1 among them). A warp is 32 such quads of one group (128
//   pixels, 512 contiguous bytes a frame). A thread's G loads are
//   independent and all in flight before the first is used.
// * The fold pass (display_decay_db_fold_kernel), the split decay, exact:
//   a block is up to 16 warps, the consecutive groups of one chunk of
//   frames. From an empty state (-inf) each group scans its frames to its
//   end value. One thread per (quad, line graph) then walks the chunk's
//   groups in order from the chunk's start state: the group's start state
//   is written to `starts`, then s <- pole * s once per valid frame of the
//   group (the same chain of single multiplies) and s <- max(s, end).
//   Rounding a product with a non-negative pole is monotone, so
//   fl(pole * max(a, b)) = max(fl(pole * a), fl(pole * b)) and this gives
//   the sequential recurrence's state bit for bit; the last chunk's walk
//   ends on the carried state. It reads the values and writes 1/G of the
//   outputs' bytes per line graph.
// * The output pass (display_decay_db_kernel): every thread on its own, no
//   shared memory and no barrier, a block per line graph (twice the
//   threads at K = 2, so that the grid is two waves and one warp's loads
//   overlap another's dB map and stores): the group's start state from
//   `starts` (from `state` when one group is all of T, which the thread
//   then carries), the values (again: the fold pass left them in the 50 MB
//   L2), the plain recurrence and the dB map, the outputs stored
//   evict-first.
// * Chunks. The wrapper picks groups a fold block so that the fold's grid
//   covers the card; when T then takes more than one chunk (few pixels and
//   rows, long T: the spectrogram's 1 x 512 frames), a first launch writes
//   each chunk's end value from an empty state (the same walk from -inf)
//   to `ends` and a copy of the state to its last slot, and the fold pass
//   starts chunk c from that copy folded through chunks 0..c-1's ends in
//   order, exactly as the groups are folded.
// * Line graphs are a loop over scalars (at most 8 a launch; the wrapper
//   launches groups of 8 beyond that); a fold block's walks of its line
//   graphs run side by side, group g's threads taking line graphs g,
//   g + groups, ...

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// The wrapper plans the layout (kernels/display_map.py::decay_db_plan) from
// Python copies of these constants, named in each comment; a change here
// changes that copy too.
constexpr int kFrames = 8;       // frames a group above T = 8: DECAY_FRAMES
constexpr int kWarp = 32;        // quads a group, 4 * kWarp pixels: DECAY_WARP_PIXELS
constexpr int kMaxGroups = 16;   // groups a fold block, 512 threads: DECAY_MAX_GROUPS
constexpr int kOutGroups = 8;    // groups an output block: 256 threads
constexpr int kMaxK = 8;         // line graphs a launch: MAX_LINE_GRAPHS
constexpr int kMaxGroupsK = 64;  // groups * K a fold block, 32 KB of shared memory: DECAY_MAX_GROUPS_K

struct Args {
  const float* vals;
  const float* slope_map;
  const float* decay_poles;
  const float* scalars;
  const bool* valid;
  float* state;
  float* out;
  float* starts;  // [pairs, groups in T, K, rows, P]
  float* ends;    // [chunks, pairs, K, rows, P]: end values, the state's copy last
  int pairs, T, K, rows, P;
  int groups, tiles, chunks;  // groups a fold block (a chunk), tiles of 128 px a row
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

__device__ __forceinline__ float4 decay4(float pole, float4 s, float4 v) {
  return make_float4(fmaxf(pole * s.x, v.x), fmaxf(pole * s.y, v.y),
                     fmaxf(pole * s.z, v.z), fmaxf(pole * s.w, v.w));
}

__device__ __forceinline__ float4 scale4(float pole, float4 s) {
  return make_float4(pole * s.x, pole * s.y, pole * s.z, pole * s.w);
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}

__device__ __forceinline__ float db(float slope, float s, float lower, float dyr,
                                    float clip_db) {
  const float x = slope * s / lower;
  return x > 0.f ? logf(fmaxf(x, 1e-38f)) * dyr : clip_db;
}

__device__ __forceinline__ int valid_count(const bool* valid, int t0, int n) {
  if (valid == nullptr) return n;
  int c = 0;
  for (int i = 0; i < n; ++i) c += valid[t0 + i] ? 1 : 0;
  return c;
}

__device__ __forceinline__ int clamp_count(int left, int most) {
  return left < 0 ? 0 : (left > most ? most : left);
}

// A thread's group: frames [t0, t0 + count) of the quad at pixel p. Loads
// its values, every load in flight before the first use; returns the
// frames that update the state (bit i: frame t0 + i).
template <int kG, bool kVec>
__device__ __forceinline__ unsigned load_group(const Args& a, int pair, int r, int p,
                                               int t0, int count, float4 (&v)[kG]) {
  const size_t frame_stride = (size_t)a.rows * a.P;
  const float* src = a.vals + ((size_t)pair * a.T * a.rows + r) * a.P;
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < count && p < a.P) v[i] = load4<kVec>(src + (size_t)(t0 + i) * frame_stride, p, a.P);
  }
  unsigned steps = 0;
  for (int i = 0; i < count; ++i) {
    steps |= (a.valid == nullptr || a.valid[t0 + i]) ? 1u << i : 0u;
  }
  return steps;
}

// The fold pass: block (tile, chunk) of row r of pair `pair`, a.groups
// groups of kG frames. kEnds: write the chunk's end value from an empty
// state to `ends`, chunk 0 also the state's copy (grid x: tiles * (chunks -
// 1)); otherwise each group's start state to `starts` and, in the last
// chunk, the carried state (grid x: tiles * chunks).
template <int kG, bool kVec, bool kEnds>
__global__ void __launch_bounds__(kWarp * kMaxGroups) display_decay_db_fold_kernel(Args a) {
  // [groups][K][kWarp] float4: each group's end value
  extern __shared__ float4 sm[];
  int* counts = reinterpret_cast<int*>(sm + a.groups * a.K * kWarp);
  const int q = threadIdx.x & (kWarp - 1);
  const int g = threadIdx.x / kWarp;
  const int tile = blockIdx.x % a.tiles;
  const int chunk = blockIdx.x / a.tiles;
  const int r = blockIdx.y;
  const int pair = blockIdx.z;
  const int p = (tile * kWarp + q) * 4;
  const int P = a.P;
  const int K = a.K;
  const bool active = p < P;
  const int chunk_frames = a.groups * kG;
  const int t0 = chunk * chunk_frames + g * kG;

  float4 v[kG];
  const unsigned steps = load_group<kG, kVec>(a, pair, r, p, t0, clamp_count(a.T - t0, kG), v);

  // this group's end values from an empty state, published to the block
  for (int k = 0; k < K; ++k) {
    const float pole = a.decay_poles[k];
    const float inf = -CUDART_INF_F;
    float4 l = make_float4(inf, inf, inf, inf);
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      if (steps & (1u << i)) l = decay4(pole, l, v[i]);
    }
    sm[(g * K + k) * kWarp + q] = l;
  }
  if (q == 0) counts[g] = __popc(steps);
  __syncthreads();

  // the walk: one thread per (quad, line graph) folds the chunk's groups in
  // order from the chunk's start state
  const size_t plane = (size_t)a.rows * P;  // one line graph's [rows, P]
  const int all_groups = (a.T + kG - 1) / kG;
  for (int k = g; k < K; k += a.groups) {
    const float pole = a.decay_poles[k];
    // the state's own slots, or its copy in ends (more than one chunk)
    const size_t own = ((size_t)pair * K + k) * plane + (size_t)r * P;
    const size_t copy = (((size_t)(a.chunks - 1) * a.pairs + pair) * K + k) * plane + (size_t)r * P;
    float4 s;
    if (kEnds) {
      const float inf = -CUDART_INF_F;
      s = make_float4(inf, inf, inf, inf);
      if (chunk == 0 && active) store4<kVec>(a.ends + copy, p, P, load4<kVec>(a.state + own, p, P));
    } else {
      s = make_float4(0.f, 0.f, 0.f, 0.f);
      if (active) s = load4<kVec>(a.chunks > 1 ? a.ends + copy : a.state + own, p, P);
      // the chunks before this one, through their end values
      for (int c = 0; c < chunk; ++c) {
        const int n = valid_count(a.valid, c * chunk_frames, chunk_frames);
        for (int i = 0; i < n; ++i) s = scale4(pole, s);
        float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
        if (active) e = load4<kVec>(a.ends + (((size_t)c * a.pairs + pair) * K + k) * plane + (size_t)r * P, p, P);
        s = max4(s, e);
      }
    }
    for (int h = 0; h < a.groups; ++h) {
      const int group = chunk * a.groups + h;
      if (!kEnds && active && group < all_groups) {
        store4<kVec>(a.starts + (((size_t)pair * all_groups + group) * K + k) * plane + (size_t)r * P, p, P, s);
      }
      for (int i = counts[h]; i > 0; --i) s = scale4(pole, s);
      s = max4(s, sm[(h * K + k) * kWarp + q]);
    }
    if (active) {
      if (kEnds) {
        store4<kVec>(a.ends + (((size_t)chunk * a.pairs + pair) * K + k) * plane + (size_t)r * P, p, P, s);
      } else if (chunk == a.chunks - 1) {  // the carried state
        store4<kVec>(a.state + own, p, P, s);
      }
    }
  }
}

// The output pass: block (tile, kOutGroups groups) of line graph k of row r
// of pair `pair`, a thread a (quad, group): its group's start state (from
// `starts`, or the state itself when one group is all of T, which it then
// carries), the recurrence over its frames and the dB map. The outputs are
// stored evict-first: nothing reads them again soon, and the values (read
// again by the other line graphs' blocks) stay in L2.
template <int kG, bool kVec>
__global__ void __launch_bounds__(kWarp * kOutGroups) display_decay_db_kernel(Args a) {
  const int q = threadIdx.x & (kWarp - 1);
  const int tile = blockIdx.x % a.tiles;
  const int group = blockIdx.x / a.tiles * kOutGroups + threadIdx.x / kWarp;
  const int K = a.K;
  const int k = blockIdx.y % K;
  const int r = blockIdx.y / K;
  const int pair = blockIdx.z;
  const int p = (tile * kWarp + q) * 4;
  const int P = a.P;
  const int t0 = group * kG;
  if (p >= P || t0 >= a.T) return;
  const int count = clamp_count(a.T - t0, kG);
  float4 v[kG];
  const unsigned steps = load_group<kG, kVec>(a, pair, r, p, t0, count, v);

  const float lower = a.scalars[1];
  const float dyr = a.scalars[2];
  const float clip_db = a.scalars[3];
  const float pole = a.decay_poles[k];
  const float4 slope = load4<kVec>(a.slope_map, p, P);
  const size_t plane = (size_t)a.rows * P;
  const bool alone = a.T <= kG;  // one group: no fold pass ran
  const int all_groups = (a.T + kG - 1) / kG;
  float* st = alone ? a.state + ((size_t)pair * K + k) * plane + (size_t)r * P
                    : a.starts + (((size_t)pair * all_groups + group) * K + k) * plane + (size_t)r * P;
  float4 s = load4<kVec>(st, p, P);
  float* o = a.out + (((size_t)pair * a.T + t0) * K + k) * plane + (size_t)r * P;
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    if (i < count) {
      if (steps & (1u << i)) s = decay4(pole, s, v[i]);
      const float4 d = make_float4(db(slope.x, s.x, lower, dyr, clip_db),
                                   db(slope.y, s.y, lower, dyr, clip_db),
                                   db(slope.z, s.z, lower, dyr, clip_db),
                                   db(slope.w, s.w, lower, dyr, clip_db));
      float* row = o + (size_t)i * K * plane;
      if (kVec) {
        __stcs(reinterpret_cast<float4*>(row + p), d);
      } else {
        store4<kVec>(row, p, P, d);
      }
    }
  }
  if (alone) store4<kVec>(st, p, P, s);
}

typedef void (*KernelFn)(Args);

template <int kG>
KernelFn pick_fold(bool vec, bool ends) {
  if (vec) return ends ? display_decay_db_fold_kernel<kG, true, true> : display_decay_db_fold_kernel<kG, true, false>;
  return ends ? display_decay_db_fold_kernel<kG, false, true> : display_decay_db_fold_kernel<kG, false, false>;
}

template <int kG>
KernelFn pick_out(bool vec) {
  return vec ? display_decay_db_kernel<kG, true> : display_decay_db_kernel<kG, false>;
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

}  // namespace

// Decay and dB alone: vals [pairs, T, rows, P] display values, state
// [pairs, K, rows, P] updated in place, out [pairs, T, K, rows, P]. As the
// wrapper planned them: frames_a_group 1 or kFrames, groups a fold block
// (<= kMaxGroups, groups * K <= kMaxGroupsK); starts [pairs, ceil(T / frames_a_group), K,
// rows, P] (null when that is 1 group), ends [chunks, pairs, K, rows, P]
// (null for one chunk), chunks = ceil(T / (groups * frames_a_group)).
extern "C" int sig_display_decay_db(
    const float* vals, const float* slope_map, const float* decay_poles,
    const float* scalars, const bool* valid, float* state, float* out,
    float* starts, float* ends, int pairs, int T, int K, int rows, int P,
    int frames_a_group, int groups, void* stream) {
  if (K < 1 || K > kMaxK || rows < 1 || P < 1 || T < 1 || pairs < 1 ||
      pairs > 65535 || rows * K > 65535 || groups < 1 || groups > kMaxGroups ||
      groups * K > kMaxGroupsK || (frames_a_group != 1 && frames_a_group != kFrames)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long all_groups = (T + frames_a_group - 1) / frames_a_group;
  const long long chunks = (all_groups + groups - 1) / groups;
  if ((all_groups > 1 && starts == nullptr) || (chunks > 1 && ends == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = {vals, slope_map, decay_poles, scalars, valid, state, out, starts, ends,
            pairs, T, K, rows, P, groups, (P + 4 * kWarp - 1) / (4 * kWarp), (int)chunks};
  if ((long long)a.tiles * all_groups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = P % 4 == 0 && aligned16(vals) && aligned16(state) && aligned16(out) &&
                   aligned16(slope_map) && (all_groups == 1 || aligned16(starts)) &&
                   (chunks == 1 || aligned16(ends));
  const bool eight = frames_a_group == kFrames;
  cudaStream_t s = (cudaStream_t)stream;
  if (all_groups > 1) {
    const size_t smem = sizeof(float4) * groups * K * kWarp + sizeof(int) * groups;
    for (int ends_pass = chunks > 1 ? 1 : 0; ends_pass >= 0; --ends_pass) {
      const KernelFn fn = eight ? pick_fold<kFrames>(vec, ends_pass) : pick_fold<1>(vec, ends_pass);
      const long long blocks = a.tiles * (ends_pass ? chunks - 1 : chunks);
      fn<<<dim3((unsigned)blocks, rows, pairs), groups * kWarp, smem, s>>>(a);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  const long long out_groups = all_groups < kOutGroups ? all_groups : kOutGroups;
  const long long blocks = a.tiles * ((all_groups + kOutGroups - 1) / kOutGroups);
  const KernelFn fn = eight ? pick_out<kFrames>(vec) : pick_out<1>(vec);
  fn<<<dim3((unsigned)blocks, rows * K, pairs), (unsigned)(out_groups * kWarp), 0, s>>>(a);
  return (int)cudaGetLastError();
}
