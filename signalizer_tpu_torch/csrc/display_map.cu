// Kernel B: pixel remap -> peak decay -> normalized dB over T frames and K
// line graphs, for sm_90a.
//
// Replaces the TPU kernel tools/pallas_display_map.py::fused_display_map
// (one frame, one line graph, dense [n_values, P] interpolation and
// end-select matrices on the MXU, a bf16 chunk max) with the function of
// the production tail it stood for: _remap_mag + post_process in
// signalizer_tpu/kernels/spectrum.py:286-291, :518-598, linear decay.
//
// Layout: mags [pairs, T, rows, nv] f32; plan tables per pixel
// (interp_indices/weights [P, taps], interp_mask, single_mask, single_bin,
// chunk_lo, chunk_len [P]); slope_map [P]; decay_poles [K] (>= 0);
// scalars [4] = inv_size, lower, 1/log(upper/lower), clip_db (f32, computed
// on the device exactly as the dB map computes them); valid [T] bool or
// null; state [pairs, K, rows, P] f32, updated in place; out [pairs, T, K,
// rows, P] f32. Per pixel, frame t and line graph k:
//   v = inv_size * (interp ? |sum w*m[idx]| : single ? m[bin] : max m[lo..lo+len))
//   if valid[t]: s_k = max(pole_k * s_k, v)
//   out = x > 0 ? log(max(x, 1e-38)) * dyr : clip_db,  x = slope*s_k/lower
//
// What bounds it on the H100: HBM traffic sets the floor — each magnitude
// is read once and each output written once (34 MB + 34 MB at the headline,
// ~20 us at 3.35 TB/s) — but what the kernel spends is instruction slots:
// an IEEE division and a logf per output (no fast math: the values are
// displayed down to -96 dB) and the frames' dependent loads. One thread per
// pixel walking all T frames in order left the card a tenth full, so the
// design splits T, keeps the recurrence exact, and executes nothing it
// does not need:
//
// * Groups. A block is up to eight warps; warp g maps the block's 32 pixels
//   for its own kGroup = 8 consecutive frames (a chunk of 8 * 8 frames a
//   block; longer T runs chunk after chunk in the same block): 262 K
//   threads at the headline instead of 32 K, and a thread's 8 frames are
//   independent loads the card can overlap. (Measured at the headline: 4,
//   8 and 16 frames a group take 64, 60 and 68 us.)
// * The split decay. From an empty state (-inf) a group scans its own
//   frames, l_t = max(pole * l_{t-1}, v_t) at valid frames, and publishes
//   its end value and its count of valid frames. The state a group starts
//   from is then the fold, in order, of the groups before it: s <- pole * s
//   once per valid frame of that group (the same chain of single
//   multiplies), then s <- max(s, l_end). Rounding a product with a
//   non-negative pole is monotone, so fl(pole * max(a, b)) = max(fl(pole *
//   a), fl(pole * b)) and the fold gives the sequential recurrence's state
//   bit for bit. Each group then runs the plain recurrence over its
//   frames (kept in registers) from that state and stores the dB values.
//   The fold is at most T multiplies per line graph, all in registers; one
//   block barrier per chunk.
// * Line graphs are an outer loop over scalars, not arrays unrolled to the
//   most the kernel takes, and the tap count is a template parameter (1 and
//   2 taps live in registers; other counts read their table through L1):
//   with both unrolled to their limits and predicated, three quarters of
//   the instructions executed for the headline's 2 line graphs and 2 taps did
//   nothing, and the kernel was no faster than the one it replaced.
// * Magnitudes are read from device memory through L1, not staged: a warp's
//   32 pixels read one short range of a frame's row, and staging that range
//   with cp.async (16-byte pieces, a per-warp double buffer) measured no
//   faster at the headline than reading it directly, in every variant
//   tried, at the price of shared memory, warp barriers and a bound on the
//   range.
// * Short calls (T <= 8, the per-tick call's T = 1 among them) run the
//   kernel's one-frame-a-group instantiation: a warp per frame, nothing
//   unrolled over frames that are not there, and for T = 1 an empty fold.
// * The same split one level up, across the blocks of a thread-block
//   cluster, where the pixel tiles alone leave the card empty (the
//   spectrogram: 1 pair x 1 row x 32 tiles of T = 512 frames, 32 blocks on
//   132 SMs, each walking 8 chunks in turn; the wrapper's display_map_plan
//   picks the cluster's size). Block b of a tile's cluster takes its share
//   [b T / n, (b + 1) T / n) of the frames and walks it twice. The first
//   walk keeps only the span's end values from an empty state and its count
//   of valid frames, in shared memory. After one cluster barrier, the block
//   folds the carried state, in rank order, through the spans of the blocks
//   before it, read through distributed shared memory, with the groups'
//   rule: the same fold, so the state is still the sequential loop's bit
//   for bit. The second walk is the plain one from that start; a span of
//   one chunk keeps its display values in registers between the walks, so
//   nothing is remapped twice. One launch, no scratch in device memory.
//   What a tile costs is its frames' walk (the log axis's top tiles take
//   the max of ~55 bins a pixel a frame), so the split pays past one block
//   an SM. Measured on an H100 at the spectrogram, us a launch: 342 unsplit,
//   356, 189, 64.5 and 52.2 with 2, 4, 8 and 16 blocks a tile (2 and 4 walk
//   spans of several chunks, so remap all but the last chunk twice).
//
// Two C entries share this device code. sig_display_map is the fused
// function above. sig_display_remap is its first half alone
// (spectrum_values): remap_frames, the function the fused kernel inlines,
// over the flattened leading axes, each warp storing its frames' values
// instead of feeding them to the decay; no state, no barrier. The second
// half alone, for values that are already display values (post_process,
// the resonator's readout), is a kernel of its own, display_decay_db.cu:
// the same arithmetic and the same exact split of the decay, laid out for
// a pass that reads one value for each value it writes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarp = 32;
constexpr int kGroup = 8;      // frames a warp handles per chunk (1 for T <= 8)
constexpr int kMaxGroups = 8;  // warps a block
constexpr int kMaxTaps = 10;
constexpr int kMaxK = 8;
constexpr int kMinBlocks = 4;    // blocks an SM holds at the launch bounds
constexpr int kMaxCluster = 16;  // blocks a tile when T is split (above 8: a non-portable cluster)

// One pixel's remap plan: tap interpolation, or the max of a contiguous
// chunk of bins (a single bin is a chunk of one).
struct PixelPlan {
  int kind;  // 0 interp, 1 chunk max
  int idx0, idx1;
  float w0, w1;
  int lo, len;
  const int* idx;
  const float* wts;
};

// kTaps: 1 or 2 taps held in registers; 0 takes any count up to kMaxTaps
// from the tables in device memory, per frame.
template <int kTaps>
__device__ __forceinline__ PixelPlan load_plan(
    bool active, int p, int taps, const int* __restrict__ interp_indices,
    const float* __restrict__ interp_weights,
    const bool* __restrict__ interp_mask, const bool* __restrict__ single_mask,
    const int* __restrict__ single_bin, const int* __restrict__ chunk_lo,
    const int* __restrict__ chunk_len) {
  PixelPlan pl;
  pl.kind = 1;
  pl.idx0 = 0;
  pl.idx1 = 0;
  pl.w0 = 0.f;
  pl.w1 = 0.f;
  pl.lo = 0;
  pl.len = 1;
  pl.idx = interp_indices + (size_t)p * taps;
  pl.wts = interp_weights + (size_t)p * taps;
  if (active) {
    if (interp_mask[p]) {
      pl.kind = 0;
      if (kTaps >= 1) {
        pl.idx0 = pl.idx[0];
        pl.w0 = pl.wts[0];
      }
      if (kTaps >= 2) {
        pl.idx1 = pl.idx[1];
        pl.w1 = pl.wts[1];
      }
    } else if (single_mask[p]) {
      pl.lo = single_bin[p];
    } else {
      pl.lo = chunk_lo[p];
      pl.len = chunk_len[p];
    }
  }
  return pl;
}

// Remap `live` (<= kFrames) frames of one pixel: v[i] from the row at
// row0 + i * frame_stride. The pixel's kind outside, the frames inside, so
// that the loads of one tap or one chunk element are independent and in
// flight together.
template <int kTaps, int kFrames>
__device__ __forceinline__ void remap_frames(
    float (&v)[kFrames], const PixelPlan& pl, const float* __restrict__ row0,
    size_t frame_stride, int live, int taps, float inv_size) {
#pragma unroll
  for (int i = 0; i < kFrames; ++i) v[i] = 0.f;
  if (pl.kind == 0) {
    if (kTaps == 0) {
      for (int j = 0; j < taps; ++j) {  // tap order, as the plain sum
        const int at = __ldg(pl.idx + j);
        const float wt = __ldg(pl.wts + j);
#pragma unroll
        for (int i = 0; i < kFrames; ++i) {
          if (i < live) v[i] += row0[i * frame_stride + at] * wt;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kFrames; ++i) {
        if (i < live) {
          float acc = 0.f;
          acc += row0[i * frame_stride + pl.idx0] * pl.w0;
          if (kTaps >= 2) acc += row0[i * frame_stride + pl.idx1] * pl.w1;
          v[i] = acc;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kFrames; ++i) v[i] = inv_size * fabsf(v[i]);
  } else {
    // a single bin is a chunk of one
#pragma unroll
    for (int i = 0; i < kFrames; ++i) {
      if (i < live) v[i] = row0[i * frame_stride + pl.lo];
    }
    for (int j = 1; j < pl.len; ++j) {
#pragma unroll
      for (int i = 0; i < kFrames; ++i) {
        if (i < live) v[i] = fmaxf(v[i], row0[i * frame_stride + pl.lo + j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kFrames; ++i) v[i] = inv_size * v[i];
  }
}

// One link of the split decay's fold: `n` valid frames decay the state
// `s`, then the max with `l`, the end value those frames reach from an
// empty state.
__device__ __forceinline__ float fold(float s, float pole, int n, float l) {
  for (int i = 0; i < n; ++i) s = pole * s;
  return fmaxf(s, l);
}

// A cluster barrier in two halves: a block arrives once it is done reading
// its peers' shared memory and waits before it exits, so that no block
// leaves while a peer may still read its own.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// kFrames: frames a warp handles per chunk. `mags` holds magnitudes
// [pairs, T, rows, nv] to remap. kSplit: a tile's frames are split across
// the blocks of a cluster along x (grid.x = tiles x cluster size).
template <int kTaps, int kFrames, bool kSplit>
__global__ void __launch_bounds__(kWarp * kMaxGroups, kMinBlocks) display_map_kernel(
    const float* __restrict__ mags, const int* __restrict__ interp_indices,
    const float* __restrict__ interp_weights,
    const bool* __restrict__ interp_mask, const bool* __restrict__ single_mask,
    const int* __restrict__ single_bin, const int* __restrict__ chunk_lo,
    const int* __restrict__ chunk_len, const float* __restrict__ slope_map,
    const float* __restrict__ decay_poles, const float* __restrict__ scalars,
    const bool* __restrict__ valid, float* __restrict__ state,
    float* __restrict__ out, int T, int K, int rows, int P, int nv, int taps) {
  // per chunk parity: [groups + 1][K][32] floats (the groups' end values,
  // then the chunk's start state), and [groups] counts of valid frames;
  // kSplit: then the block's span's [K][32] end values and its count
  extern __shared__ float ends[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int g = threadIdx.x / kWarp;
  const int groups = blockDim.x / kWarp;
  const int ends_stride = (groups + 1) * K * kWarp;  // one parity
  int* counts = reinterpret_cast<int*>(ends + 2 * ends_stride);
  float* span_ends = reinterpret_cast<float*>(counts + 2 * kMaxGroups);
  int* span_count = reinterpret_cast<int*>(span_ends + K * kWarp);

  // this block's frames [f0, f1): all of T, or its rank's share in the cluster
  int rank = 0, blocks = 1;
  if constexpr (kSplit) {
    rank = (int)cg::this_cluster().block_rank();
    blocks = (int)cg::this_cluster().num_blocks();
  }
  const int f0 = (int)((long long)T * rank / blocks);
  const int f1 = (int)((long long)T * (rank + 1) / blocks);

  const int p = blockIdx.x / blocks * kWarp + lane;
  const int r = blockIdx.y;
  const int pair = blockIdx.z;
  const bool active = p < P;

  // this pixel's plan
  const PixelPlan pl =
      load_plan<kTaps>(active, p, taps, interp_indices, interp_weights,
                       interp_mask, single_mask, single_bin, chunk_lo, chunk_len);

  const float inv_size = scalars[0];
  const float lower = scalars[1];
  const float dyr = scalars[2];
  const float clip_db = scalars[3];
  const float slope = active ? slope_map[p] : 0.f;

  const size_t plane = (size_t)rows * P;  // one line graph's [rows, P]
  float* st = state + (size_t)pair * K * plane + (size_t)r * P + p;
  if (g == 0) {
    // the carried state (parity 0, slot groups): the first chunk's start
    // state; split, read by every block before the last one writes it
    for (int k = 0; k < K; ++k) {
      ends[(groups * K + k) * kWarp + lane] = active ? st[k * plane] : 0.f;
    }
  }

  const float* src = mags + ((size_t)pair * T * rows + r) * nv;
  const size_t frame_stride = (size_t)rows * nv;
  const int chunk_frames = groups * kFrames;
  float v[kFrames];  // this group's display values

  // A walk over [f0, f1), chunk by chunk. Each group remaps its frames and
  // publishes its end value from an empty state and its count of valid
  // frames. The split's first walk (outputs false) then folds the span's end
  // values from them; a walk with outputs folds each group's start state,
  // runs the recurrence and stores the dB values.
  auto walk = [&](auto outputs) {
    constexpr bool kOutputs = decltype(outputs)::value;
    for (int c0 = f0, parity = 0; c0 < f1; c0 += chunk_frames, parity ^= 1) {
      const int t0 = c0 + g * kFrames;  // this group's frames [t0, t0 + count)
      int count = f1 - t0;
      count = count < 0 ? 0 : (count > kFrames ? kFrames : count);
      unsigned steps = 0;  // bit i: frame t0 + i updates the state
      if (valid == nullptr) {
        steps = (1u << count) - 1u;
      } else {
        for (int i = 0; i < count; ++i) steps |= valid[t0 + i] ? 1u << i : 0u;
      }

      // 1. this group's display values (a split span of one chunk has them
      //    from its first walk)
      if (!(kSplit && kOutputs && f0 + chunk_frames >= f1)) {
        const float* row0 = src + (size_t)t0 * frame_stride;
        const int live = active ? count : 0;  // frames this lane reads
        remap_frames<kTaps, kFrames>(v, pl, row0, frame_stride, live, taps, inv_size);
      }

      // 2. this group's end values from an empty state, published to the block
      float* mine = ends + parity * ends_stride;
      for (int k = 0; k < K; ++k) {
        const float pole = decay_poles[k];
        float l = -CUDART_INF_F;
#pragma unroll
        for (int i = 0; i < kFrames; ++i) {
          if (steps & (1u << i)) l = fmaxf(pole * l, v[i]);
        }
        mine[(g * K + k) * kWarp + lane] = l;
      }
      if (lane == 0) counts[parity * kMaxGroups + g] = __popc(steps);
      __syncthreads();

      if constexpr (!kOutputs) {
        // the span's end values so far, folded through this chunk's groups
        // (warp g folds line graphs g, g + groups, ...)
        for (int k = g; k < K; k += groups) {
          const float pole = decay_poles[k];
          float l = c0 == f0 ? -CUDART_INF_F : span_ends[k * kWarp + lane];
          for (int h = 0; h < groups; ++h) {
            l = fold(l, pole, counts[parity * kMaxGroups + h], mine[(h * K + k) * kWarp + lane]);
          }
          span_ends[k * kWarp + lane] = l;
        }
        if (threadIdx.x == 0) {
          int n = c0 == f0 ? 0 : *span_count;
          for (int h = 0; h < groups; ++h) n += counts[parity * kMaxGroups + h];
          *span_count = n;
        }
        continue;
      }

      const bool last_chunk = c0 + chunk_frames >= f1;
      for (int k = 0; k < K; ++k) {
        const float pole = decay_poles[k];
        // 3. the state this group starts from: the chunk's start state
        //    folded, in order, through the groups before this one
        float s = mine[(groups * K + k) * kWarp + lane];
        for (int h = 0; h < g; ++h) {
          s = fold(s, pole, counts[parity * kMaxGroups + h], mine[(h * K + k) * kWarp + lane]);
        }
        // 4. the recurrence over this group's frames, and the dB map
        float* o = out + (((size_t)pair * T + t0) * K + k) * plane + (size_t)r * P + p;
#pragma unroll
        for (int i = 0; i < kFrames; ++i) {
          if (i < count && active) {
            if (steps & (1u << i)) s = fmaxf(pole * s, v[i]);
            const float x = slope * s / lower;
            o[(size_t)i * K * plane] = x > 0.f ? logf(fmaxf(x, 1e-38f)) * dyr : clip_db;
          }
        }
        // the last group ends on the chunk's end state: the next chunk's
        // start state, in the other parity (read there after that chunk's
        // barrier), and after the last chunk (of the last block) the
        // carried state
        if (g == groups - 1) {
          if (!last_chunk) {
            ends[(parity ^ 1) * ends_stride + (groups * K + k) * kWarp + lane] = s;
          } else if (active && rank == blocks - 1) {
            st[k * plane] = s;
          }
        }
      }
    }
  };

  if constexpr (kSplit) {
    walk(std::false_type{});
    cg::this_cluster().sync();  // every span's end values are in its block's shared memory
    // this block's start state: the carried state folded, in rank order,
    // through the spans of the blocks before this one
    for (int k = g; k < K; k += groups) {
      const float pole = decay_poles[k];
      float s = ends[(groups * K + k) * kWarp + lane];
      for (int h = 0; h < rank; ++h) {
        const float* e = cg::this_cluster().map_shared_rank(span_ends, h);
        const int n = *cg::this_cluster().map_shared_rank(span_count, h);
        s = fold(s, pole, n, e[k * kWarp + lane]);
      }
      ends[(groups * K + k) * kWarp + lane] = s;  // published by the walk's first barrier
    }
    cluster_arrive();
  }
  walk(std::true_type{});
  if constexpr (kSplit) cluster_wait();
}

// The remap alone: mags [frames, rows, nv] -> out [frames, rows, P]. Warp g
// of block z maps the block's 32 pixels for its own kFrames consecutive
// frames; no state, no barrier.
template <int kTaps, int kFrames>
__global__ void __launch_bounds__(kWarp * kMaxGroups, kMinBlocks) display_remap_kernel(
    const float* __restrict__ mags, const int* __restrict__ interp_indices,
    const float* __restrict__ interp_weights,
    const bool* __restrict__ interp_mask, const bool* __restrict__ single_mask,
    const int* __restrict__ single_bin, const int* __restrict__ chunk_lo,
    const int* __restrict__ chunk_len, const float* __restrict__ scalars,
    float* __restrict__ out, int frames, int rows, int P, int nv, int taps) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int g = threadIdx.x / kWarp;
  const int groups = blockDim.x / kWarp;
  const int p = blockIdx.x * kWarp + lane;
  const int r = blockIdx.y;
  const int t0 = (blockIdx.z * groups + g) * kFrames;
  int count = frames - t0;
  count = count > kFrames ? kFrames : count;
  if (p >= P || count <= 0) return;
  const PixelPlan pl =
      load_plan<kTaps>(true, p, taps, interp_indices, interp_weights, interp_mask,
                       single_mask, single_bin, chunk_lo, chunk_len);
  const size_t frame_stride = (size_t)rows * nv;
  const float* row0 = mags + ((size_t)t0 * rows + r) * nv;
  float v[kFrames];
  remap_frames<kTaps, kFrames>(v, pl, row0, frame_stride, count, taps, scalars[0]);
  float* o = out + ((size_t)t0 * rows + r) * P + p;
#pragma unroll
  for (int i = 0; i < kFrames; ++i) {
    if (i < count) o[(size_t)i * rows * P] = v[i];
  }
}

typedef void (*KernelFn)(const float*, const int*, const float*, const bool*,
                         const bool*, const int*, const int*, const int*,
                         const float*, const float*, const float*, const bool*,
                         float*, float*, int, int, int, int, int, int);
typedef void (*RemapFn)(const float*, const int*, const float*, const bool*,
                        const bool*, const int*, const int*, const int*,
                        const float*, float*, int, int, int, int, int);

}  // namespace

// Short calls a warp per frame, otherwise kGroup frames a warp; a tile's T
// split across a cluster of `cluster` blocks (1: no split; at most
// kMaxCluster and T).
extern "C" int sig_display_map(
    const float* mags, const int* interp_indices, const float* interp_weights,
    const bool* interp_mask, const bool* single_mask, const int* single_bin,
    const int* chunk_lo, const int* chunk_len, const float* slope_map,
    const float* decay_poles, const float* scalars, const bool* valid,
    float* state, float* out, int pairs, int T, int K, int rows, int P, int nv,
    int taps, int cluster, void* stream) {
  if (taps < 1 || taps > kMaxTaps || K < 1 || K > kMaxK || rows < 1 || P < 1 ||
      nv < 1 || T < 1 || pairs < 1 || pairs > 65535 || rows > 65535 ||
      cluster < 1 || cluster > kMaxCluster || cluster > T) {
    return (int)cudaErrorInvalidValue;
  }
  const bool split = cluster > 1;
  const bool single = !split && T <= kMaxGroups;
  const int frames = single ? 1 : kGroup;
  const int span = (T + cluster - 1) / cluster;  // the most frames a block takes
  int groups = (span + frames - 1) / frames;
  if (groups > kMaxGroups) groups = kMaxGroups;
  // at most 2 * 9 * 8 * 32 + 8 * 32 floats and 17 counts: under the 48 KB default
  const size_t smem = sizeof(float) * ((size_t)2 * (groups + 1) * K * kWarp + (split ? K * kWarp : 0)) +
                      sizeof(int) * (2 * kMaxGroups + (split ? 1 : 0));
  static const KernelFn kernels[3][3] = {
      {display_map_kernel<0, kGroup, false>, display_map_kernel<1, kGroup, false>,
       display_map_kernel<2, kGroup, false>},
      {display_map_kernel<0, 1, false>, display_map_kernel<1, 1, false>,
       display_map_kernel<2, 1, false>},
      {display_map_kernel<0, kGroup, true>, display_map_kernel<1, kGroup, true>,
       display_map_kernel<2, kGroup, true>},
  };
  const int tap_kind = taps <= 2 ? taps : 0;
  const KernelFn kernel = kernels[split ? 2 : (single ? 1 : 0)][tap_kind];
  const dim3 grid((P + kWarp - 1) / kWarp * cluster, rows, pairs);
  if (!split) {
    kernel<<<grid, groups * kWarp, smem, (cudaStream_t)stream>>>(
        mags, interp_indices, interp_weights, interp_mask, single_mask,
        single_bin, chunk_lo, chunk_len, slope_map, decay_poles, scalars, valid,
        state, out, T, K, rows, P, nv, taps);
    return (int)cudaGetLastError();
  }
  // above 8 blocks a cluster the non-portable opt-in, once per kernel
  static bool non_portable[3] = {};
  if (cluster > 8 && !non_portable[tap_kind]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    non_portable[tap_kind] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(groups * kWarp, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, mags, interp_indices, interp_weights, interp_mask, single_mask,
      single_bin, chunk_lo, chunk_len, slope_map, decay_poles, scalars, valid,
      state, out, T, K, rows, P, nv, taps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Remap alone: mags [frames, rows, nv] -> out [frames, rows, P] =
// inv_size * (the pixel's tap sum rectified, or its chunk's max).
extern "C" int sig_display_remap(
    const float* mags, const int* interp_indices, const float* interp_weights,
    const bool* interp_mask, const bool* single_mask, const int* single_bin,
    const int* chunk_lo, const int* chunk_len, const float* scalars, float* out,
    int frames, int rows, int P, int nv, int taps, void* stream) {
  if (taps < 1 || taps > kMaxTaps || rows < 1 || rows > 65535 || P < 1 ||
      nv < 1 || frames < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const bool single = frames <= kMaxGroups;
  const int per_warp = single ? 1 : kGroup;
  int groups = (frames + per_warp - 1) / per_warp;
  if (groups > kMaxGroups) groups = kMaxGroups;
  const int per_block = groups * per_warp;
  const long long blocks = ((long long)frames + per_block - 1) / per_block;
  if (blocks > 65535) return (int)cudaErrorInvalidValue;
  static const RemapFn kernels[2][3] = {
      {display_remap_kernel<0, kGroup>, display_remap_kernel<1, kGroup>,
       display_remap_kernel<2, kGroup>},
      {display_remap_kernel<0, 1>, display_remap_kernel<1, 1>,
       display_remap_kernel<2, 1>},
  };
  const RemapFn kernel = kernels[single ? 1 : 0][taps <= 2 ? taps : 0];
  const dim3 grid((P + kWarp - 1) / kWarp, rows, (unsigned)blocks);
  kernel<<<grid, groups * kWarp, 0, (cudaStream_t)stream>>>(
      mags, interp_indices, interp_weights, interp_mask, single_mask,
      single_bin, chunk_lo, chunk_len, scalars, out, frames, rows, P, nv, taps);
  return (int)cudaGetLastError();
}
