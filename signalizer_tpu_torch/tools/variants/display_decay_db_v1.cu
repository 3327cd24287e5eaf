// Kernel B's decay-and-dB entry as it was before it had a kernel of its own:
// the fused display kernel (csrc/display_map.cu) instantiated without its
// remap, a warp per 32 pixels x 8 frames, up to 8 warps a block walking T
// in chunks of 64 frames with a block barrier and a serial fold per chunk,
// one 4-byte load and store a lane. Kept for the kernel_variants tool,
// which times it in turns with the package's kernel; not part of the
// package's library.
//
// Entry sig_display_decay_db_v1 takes sig_display_decay_db's arguments.
// Compiled with one of these, it leaves one part out, to show what that
// part costs (the outputs are then wrong):
//   SIG_DROP_LOADS  values formed from the pixel and frame, no vals read;
//   SIG_DROP_DB     the decayed state stored as it is, no division or log;
//   SIG_DROP_FOLD   each group starts from the chunk's start state, no fold.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kGroup = 8;
constexpr int kMaxGroups = 8;
constexpr int kMaxK = 8;

template <int kFrames>
__global__ void __launch_bounds__(kWarp * kMaxGroups, 4) decay_db_v1_kernel(
    const float* __restrict__ vals, const float* __restrict__ slope_map,
    const float* __restrict__ decay_poles, const float* __restrict__ scalars,
    const bool* __restrict__ valid, float* __restrict__ state,
    float* __restrict__ out, int T, int K, int rows, int P) {
  extern __shared__ float ends[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int g = threadIdx.x / kWarp;
  const int groups = blockDim.x / kWarp;
  const int ends_stride = (groups + 1) * K * kWarp;
  int* counts = reinterpret_cast<int*>(ends + 2 * ends_stride);

  const int p = blockIdx.x * kWarp + lane;
  const int r = blockIdx.y;
  const int pair = blockIdx.z;
  const bool active = p < P;

  const float lower = scalars[1];
  const float dyr = scalars[2];
  const float clip_db = scalars[3];
  const float slope = active ? slope_map[p] : 0.f;

  const size_t plane = (size_t)rows * P;
  float* st = state + (size_t)pair * K * plane + (size_t)r * P + p;
  if (g == 0) {
    for (int k = 0; k < K; ++k) {
      ends[(groups * K + k) * kWarp + lane] = active ? st[k * plane] : 0.f;
    }
  }

  const float* src = vals + ((size_t)pair * T * rows + r) * P;
  const size_t frame_stride = (size_t)rows * P;
  const int chunk_frames = groups * kFrames;

  for (int c0 = 0, parity = 0; c0 < T; c0 += chunk_frames, parity ^= 1) {
    const int t0 = c0 + g * kFrames;
    int count = T - t0;
    count = count < 0 ? 0 : (count > kFrames ? kFrames : count);
    unsigned steps = 0;
    if (valid == nullptr) {
      steps = (1u << count) - 1u;
    } else {
      for (int i = 0; i < count; ++i) steps |= valid[t0 + i] ? 1u << i : 0u;
    }

    float v[kFrames];
    const float* row0 = src + (size_t)t0 * frame_stride;
    const int live = active ? count : 0;
#pragma unroll
    for (int i = 0; i < kFrames; ++i) {
#ifdef SIG_DROP_LOADS
      v[i] = i < live ? (float)((p + t0 + i) & 1023) * 1e-3f : 0.f;
#else
      v[i] = i < live ? row0[i * frame_stride + p] : 0.f;
#endif
    }

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
      float s = mine[(groups * K + k) * kWarp + lane];
#ifndef SIG_DROP_FOLD
      for (int h = 0; h < g; ++h) {
        const int n = counts[parity * kMaxGroups + h];
        for (int i = 0; i < n; ++i) s = pole * s;
        s = fmaxf(s, mine[(h * K + k) * kWarp + lane]);
      }
#endif
      float* o = out + (((size_t)pair * T + t0) * K + k) * plane + (size_t)r * P + p;
#pragma unroll
      for (int i = 0; i < kFrames; ++i) {
        if (i < count && active) {
          if (steps & (1u << i)) s = fmaxf(pole * s, v[i]);
#ifdef SIG_DROP_DB
          o[(size_t)i * K * plane] = s;
#else
          const float x = slope * s / lower;
          o[(size_t)i * K * plane] = x > 0.f ? logf(fmaxf(x, 1e-38f)) * dyr : clip_db;
#endif
        }
      }
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

}  // namespace

extern "C" int sig_display_decay_db_v1(
    const float* vals, const float* slope_map, const float* decay_poles,
    const float* scalars, const bool* valid, float* state, float* out,
    int pairs, int T, int K, int rows, int P, void* stream) {
  if (K < 1 || K > kMaxK || rows < 1 || P < 1 || T < 1 || pairs < 1 ||
      pairs > 65535 || rows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const bool single = T <= kMaxGroups;
  const int frames = single ? 1 : kGroup;
  int groups = (T + frames - 1) / frames;
  if (groups > kMaxGroups) groups = kMaxGroups;
  const size_t smem = sizeof(float) * (size_t)2 * (groups + 1) * K * kWarp +
                      sizeof(int) * 2 * kMaxGroups;
  const dim3 grid((P + kWarp - 1) / kWarp, rows, pairs);
  if (single) {
    decay_db_v1_kernel<1><<<grid, groups * kWarp, smem, (cudaStream_t)stream>>>(
        vals, slope_map, decay_poles, scalars, valid, state, out, T, K, rows, P);
  } else {
    decay_db_v1_kernel<kGroup><<<grid, groups * kWarp, smem, (cudaStream_t)stream>>>(
        vals, slope_map, decay_poles, scalars, valid, state, out, T, K, rows, P);
  }
  return (int)cudaGetLastError();
}
