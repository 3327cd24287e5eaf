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

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kGroup = 8;      // frames a warp handles per chunk (1 for T <= 8)
constexpr int kMaxGroups = 8;  // warps a block
constexpr int kMaxTaps = 10;
constexpr int kMaxK = 8;

// kTaps: 1 or 2 taps held in registers; 0 takes any count up to kMaxTaps
// from the tables in device memory, per frame. kFrames: frames a warp
// handles per chunk.
template <int kTaps, int kFrames>
__global__ void __launch_bounds__(kWarp * kMaxGroups, 4) display_map_kernel(
    const float* __restrict__ mags, const int* __restrict__ interp_indices,
    const float* __restrict__ interp_weights,
    const bool* __restrict__ interp_mask, const bool* __restrict__ single_mask,
    const int* __restrict__ single_bin, const int* __restrict__ chunk_lo,
    const int* __restrict__ chunk_len, const float* __restrict__ slope_map,
    const float* __restrict__ decay_poles, const float* __restrict__ scalars,
    const bool* __restrict__ valid, float* __restrict__ state,
    float* __restrict__ out, int T, int K, int rows, int P, int nv, int taps) {
  // per chunk parity: [groups + 1][K][32] floats (the groups' end values,
  // then the chunk's start state), and [groups] counts of valid frames
  extern __shared__ float ends[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int g = threadIdx.x / kWarp;
  const int groups = blockDim.x / kWarp;
  const int ends_stride = (groups + 1) * K * kWarp;  // one parity
  int* counts = reinterpret_cast<int*>(ends + 2 * ends_stride);

  const int p = blockIdx.x * kWarp + lane;
  const int r = blockIdx.y;
  const int pair = blockIdx.z;
  const bool active = p < P;

  // this pixel's plan
  int kind = 1;  // 0 interp, 1 chunk max (a single bin is a chunk of one)
  int idx0 = 0, idx1 = 0;
  float w0 = 0.f, w1 = 0.f;
  int lo = 0, len = 1;
  const int* idx = interp_indices + (size_t)p * taps;
  const float* wts = interp_weights + (size_t)p * taps;
  if (active) {
    if (interp_mask[p]) {
      kind = 0;
      if (kTaps >= 1) {
        idx0 = idx[0];
        w0 = wts[0];
      }
      if (kTaps >= 2) {
        idx1 = idx[1];
        w1 = wts[1];
      }
    } else if (single_mask[p]) {
      lo = single_bin[p];
    } else {
      lo = chunk_lo[p];
      len = chunk_len[p];
    }
  }

  const float inv_size = scalars[0];
  const float lower = scalars[1];
  const float dyr = scalars[2];
  const float clip_db = scalars[3];
  const float slope = active ? slope_map[p] : 0.f;

  const size_t plane = (size_t)rows * P;  // one line graph's [rows, P]
  float* st = state + (size_t)pair * K * plane + (size_t)r * P + p;
  if (g == 0) {
    // the first chunk's start state (parity 0, slot groups)
    for (int k = 0; k < K; ++k) {
      ends[(groups * K + k) * kWarp + lane] = active ? st[k * plane] : 0.f;
    }
  }

  const float* src = mags + ((size_t)pair * T * rows + r) * nv;
  const size_t frame_stride = (size_t)rows * nv;
  const int chunk_frames = groups * kFrames;

  for (int c0 = 0, parity = 0; c0 < T; c0 += chunk_frames, parity ^= 1) {
    const int t0 = c0 + g * kFrames;  // this group's frames [t0, t0 + count)
    int count = T - t0;
    count = count < 0 ? 0 : (count > kFrames ? kFrames : count);
    unsigned steps = 0;  // bit i: frame t0 + i updates the state
    if (valid == nullptr) {
      steps = (1u << count) - 1u;
    } else {
      for (int i = 0; i < count; ++i) steps |= valid[t0 + i] ? 1u << i : 0u;
    }

    // 1. remap this group's frames: the pixel's kind outside, the frames
    //    inside, so that the group's loads of one tap or one chunk element
    //    are independent and in flight together
    float v[kFrames];
    const float* row0 = src + (size_t)t0 * frame_stride;
    const int live = active ? count : 0;  // frames this lane reads
#pragma unroll
    for (int i = 0; i < kFrames; ++i) v[i] = 0.f;
    if (kind == 0) {
      if (kTaps == 0) {
        for (int j = 0; j < taps; ++j) {  // tap order, as the plain sum
          const int at = __ldg(idx + j);
          const float wt = __ldg(wts + j);
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
            acc += row0[i * frame_stride + idx0] * w0;
            if (kTaps >= 2) acc += row0[i * frame_stride + idx1] * w1;
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
        if (i < live) v[i] = row0[i * frame_stride + lo];
      }
      for (int j = 1; j < len; ++j) {
#pragma unroll
        for (int i = 0; i < kFrames; ++i) {
          if (i < live) v[i] = fmaxf(v[i], row0[i * frame_stride + lo + j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kFrames; ++i) v[i] = inv_size * v[i];
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

    const bool last_chunk = c0 + chunk_frames >= T;
    for (int k = 0; k < K; ++k) {
      const float pole = decay_poles[k];
      // 3. the state this group starts from: the chunk's start state
      //    folded, in order, through the groups before this one
      float s = mine[(groups * K + k) * kWarp + lane];
      for (int h = 0; h < g; ++h) {
        const int n = counts[parity * kMaxGroups + h];
        for (int i = 0; i < n; ++i) s = pole * s;
        s = fmaxf(s, mine[(h * K + k) * kWarp + lane]);
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
      // barrier), and after the last chunk the carried state
      if (g == groups - 1) {
        if (!last_chunk) {
          ends[(parity ^ 1) * ends_stride + (groups * K + k) * kWarp + lane] = s;
        } else if (active) {
          st[k * plane] = s;
        }
      }
    }
  }
}

typedef void (*KernelFn)(const float*, const int*, const float*, const bool*,
                         const bool*, const int*, const int*, const int*,
                         const float*, const float*, const float*, const bool*,
                         float*, float*, int, int, int, int, int, int);

}  // namespace

extern "C" int sig_display_map(
    const float* mags, const int* interp_indices, const float* interp_weights,
    const bool* interp_mask, const bool* single_mask, const int* single_bin,
    const int* chunk_lo, const int* chunk_len, const float* slope_map,
    const float* decay_poles, const float* scalars, const bool* valid,
    float* state, float* out, int pairs, int T, int K, int rows, int P, int nv,
    int taps, void* stream) {
  if (taps < 1 || taps > kMaxTaps || K < 1 || K > kMaxK || rows < 1 ||
      P < 1 || nv < 1 || T < 1 || pairs < 1 || pairs > 65535 || rows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  // short calls: a warp per frame; otherwise kGroup frames a warp
  const bool single = T <= kMaxGroups;
  const int frames = single ? 1 : kGroup;
  int groups = (T + frames - 1) / frames;
  if (groups > kMaxGroups) groups = kMaxGroups;
  // at most 2 * 9 * 8 * 32 floats and 16 counts: under the 48 KB default
  const size_t smem = sizeof(float) * (size_t)2 * (groups + 1) * K * kWarp +
                      sizeof(int) * 2 * kMaxGroups;
  static const KernelFn kernels[2][3] = {
      {display_map_kernel<0, kGroup>, display_map_kernel<1, kGroup>,
       display_map_kernel<2, kGroup>},
      {display_map_kernel<0, 1>, display_map_kernel<1, 1>, display_map_kernel<2, 1>},
  };
  const KernelFn kernel = kernels[single ? 1 : 0][taps <= 2 ? taps : 0];
  const dim3 grid((P + kWarp - 1) / kWarp, rows, pairs);
  kernel<<<grid, groups * kWarp, smem, (cudaStream_t)stream>>>(
      mags, interp_indices, interp_weights, interp_mask, single_mask,
      single_bin, chunk_lo, chunk_len, slope_map, decay_poles, scalars, valid,
      state, out, T, K, rows, P, nv, taps);
  return (int)cudaGetLastError();
}
