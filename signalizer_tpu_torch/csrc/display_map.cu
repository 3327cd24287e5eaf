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
// chunk_lo, chunk_len [P]); slope_map [P]; decay_poles [K]; scalars [4] =
// inv_size, lower, 1/log(upper/lower), clip_db (f32, computed on the
// device exactly as the dB map computes them); valid [T] bool or null;
// state [pairs, K, rows, P] f32, updated in place; out [pairs, T, K, rows,
// P] f32.
//
// Grid (ceil(P/128), rows, pairs), 128 threads, one thread per pixel. Each
// thread walks t = 0..T-1 in order, so the decay recurrence needs no scan:
//   v = inv_size * (interp ? |sum w*m[idx]| : single ? m[bin] : max m[lo..lo+len))
//   for k: if valid[t]: s_k = max(pole_k * s_k, v)
//          out = x > 0 ? log(max(x, 1e-38)) * dyr : clip_db,  x = slope*s_k/lower
//
// What bounds it on the H100: HBM traffic — each magnitude is read once
// from device memory and each output written once (34 MB + 34 MB at the
// headline, ~20 us at 3.35 TB/s); the per-pixel work is a handful of flops
// and one log per output; with only pairs*rows*P threads in flight (32 K
// at the headline) the T loop is latency-bound. The design: per frame, the
// block stages the bin range its 128 pixels touch (found once with a
// shared min/max) into shared memory with coalesced cp.async copies, double
// buffered so frame t+1 is in flight while frame t is computed; the taps'
// gathers and the chunk max then read shared memory, not scattered global
// addresses; taps and the K states stay in registers across the whole T
// loop; the chunk max stays in f32 (no dense selector operands, which were
// the TPU's answer to having no cheap gather). TMA staging and fusing with
// the FFT kernel are later work.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTaps = 10;
constexpr int kMaxK = 8;

// Start this thread's share of the asynchronous copy of bins [lo, hi] of
// one magnitude row into shared memory, as one pipeline batch.
__device__ __forceinline__ void stage_row(float* dst, const float* src, int lo,
                                          int hi) {
  for (int i = lo + threadIdx.x; i <= hi; i += kThreads) {
    __pipeline_memcpy_async(dst + i, src + i, sizeof(float));
  }
  __pipeline_commit();
}

__global__ void display_map_kernel(
    const float* __restrict__ mags, const int* __restrict__ interp_indices,
    const float* __restrict__ interp_weights,
    const bool* __restrict__ interp_mask, const bool* __restrict__ single_mask,
    const int* __restrict__ single_bin, const int* __restrict__ chunk_lo,
    const int* __restrict__ chunk_len, const float* __restrict__ slope_map,
    const float* __restrict__ decay_poles, const float* __restrict__ scalars,
    const bool* __restrict__ valid, float* __restrict__ state,
    float* __restrict__ out, int T, int K, int rows, int P, int nv, int taps) {
  extern __shared__ float rows_buf[];  // two frames, [2][nv]
  __shared__ int s_lo, s_hi;

  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int r = blockIdx.y;
  const int pair = blockIdx.z;
  const bool active = p < P;

  // this pixel's plan and the bin range it reads
  int kind = 2;  // 0 interp, 1 single bin, 2 chunk max
  int idx[kMaxTaps];
  float wts[kMaxTaps];
  int lo = 0, len = 1, plo = nv, phi = -1;
  if (active) {
    if (interp_mask[p]) {
      kind = 0;
#pragma unroll
      for (int j = 0; j < kMaxTaps; ++j) {
        if (j < taps) {
          idx[j] = interp_indices[p * taps + j];
          wts[j] = interp_weights[p * taps + j];
          plo = min(plo, idx[j]);
          phi = max(phi, idx[j]);
        }
      }
    } else if (single_mask[p]) {
      kind = 1;
      lo = single_bin[p];
      plo = phi = lo;
    } else {
      lo = chunk_lo[p];
      len = chunk_len[p];
      plo = lo;
      phi = lo + len - 1;
    }
  }
  if (threadIdx.x == 0) {
    s_lo = nv;
    s_hi = -1;
  }
  __syncthreads();
  if (active) {
    atomicMin(&s_lo, plo);
    atomicMax(&s_hi, phi);
  }
  __syncthreads();
  const int blo = s_lo, bhi = s_hi;

  const float inv_size = scalars[0];
  const float lower = scalars[1];
  const float dyr = scalars[2];
  const float clip_db = scalars[3];
  const float slope = active ? slope_map[p] : 0.f;

  const size_t plane = (size_t)rows * P;  // one line graph's [rows, P]
  float* st = state + (size_t)pair * K * plane + (size_t)r * P + p;
  float s[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) s[k] = (active && k < K) ? st[k * plane] : 0.f;

  const float* src = mags + ((size_t)pair * T * rows + r) * nv;
  const size_t frame_stride = (size_t)rows * nv;
  stage_row(rows_buf, src, blo, bhi);
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
      // buffer (t+1)&1 was last read in frame t-1, before its closing barrier
      stage_row(rows_buf + ((t + 1) & 1) * nv, src + (t + 1) * frame_stride, blo, bhi);
      __pipeline_wait_prior(1);  // this thread's copies of frame t landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // everyone's copies of frame t landed
    const float* row = rows_buf + (t & 1) * nv;
    if (active) {
      float v;
      if (kind == 0) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxTaps; ++j) {
          if (j < taps) acc += row[idx[j]] * wts[j];
        }
        v = fabsf(acc);
      } else if (kind == 1) {
        v = row[lo];
      } else {
        v = row[lo];
        for (int i = 1; i < len; ++i) v = fmaxf(v, row[lo + i]);
      }
      v = inv_size * v;

      const bool step = valid == nullptr || valid[t];
      float* o = out + (((size_t)pair * T + t) * K * rows + r) * P + p;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          if (step) s[k] = fmaxf(decay_poles[k] * s[k], v);
          const float x = slope * s[k] / lower;
          o[k * plane] = x > 0.f ? logf(fmaxf(x, 1e-38f)) * dyr : clip_db;
        }
      }
    }
    __syncthreads();  // frame t's reads done before frame t+2 refills its buffer
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) st[k * plane] = s[k];
    }
  }
}

}  // namespace

extern "C" int sig_display_map(
    const float* mags, const int* interp_indices, const float* interp_weights,
    const bool* interp_mask, const bool* single_mask, const int* single_bin,
    const int* chunk_lo, const int* chunk_len, const float* slope_map,
    const float* decay_poles, const float* scalars, const bool* valid,
    float* state, float* out, int pairs, int T, int K, int rows, int P, int nv,
    int taps, void* stream) {
  if (taps < 1 || taps > kMaxTaps || K < 1 || K > kMaxK || rows < 1 ||
      P < 1 || nv < 1 || pairs > 65535 || rows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = 2 * sizeof(float) * (size_t)nv;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        display_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((P + kThreads - 1) / kThreads, rows, pairs);
  display_map_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      mags, interp_indices, interp_weights, interp_mask, single_mask,
      single_bin, chunk_lo, chunk_len, slope_map, decay_poles, scalars, valid,
      state, out, T, K, rows, P, nv, taps);
  return (int)cudaGetLastError();
}
