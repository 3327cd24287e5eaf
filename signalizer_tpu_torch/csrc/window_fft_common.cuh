// What the forms of kernel A share (window_fft_mag.cu, the one-block form;
// window_fft_mag_cluster.cu, a row in a thread-block cluster;
// window_fft_mag_long.cu, the four-step form for the longest rows): the
// channel modes, the packing of a windowed sample, the bit reversal, the
// shared-memory swizzle of a transform held in shared memory and its
// radix-2 stages.

#pragma once

#include <cuda_runtime.h>

namespace {

enum Mode {
  kLeft = 0,
  kRight = 1,
  kMerge = 2,
  kSide = 3,
  kPhase = 4,
  kSeparate = 5,
  kMidSide = 6,
  kComplex = 7,
};

__host__ __device__ inline int rows_of(int mode) {
  return (mode == kPhase || mode == kSeparate || mode == kMidSide) ? 2 : 1;
}

// Shared-memory slot of element i of an l-point core: the low four index
// bits (one 128-byte row of float2 banks) are XORed with bits 4..7 and with
// the top four bits. Without it the prologue's bit-reversed scatter puts a
// warp's stores in one bank and the first pass (eight consecutive elements
// per thread) takes 8x its conflict-free shared-memory cycles. It is a
// bijection on [0, l): bits 4 and up are unchanged.
__device__ __forceinline__ int slot(int i, int log2l) {
  int x = i ^ ((i >> 4) & 15);
  if (log2l > 8) x ^= (i >> (log2l - 4)) & 15;
  return x;
}

__device__ __forceinline__ int bit_reverse(int i, int log2l) {
  return (int)(__brev((unsigned)i) >> (32 - log2l));
}

// One windowed, packed real sample of row r (the packing factors of
// _pack_channels). Channels a mode does not use arrive as zeros.
__device__ __forceinline__ float pack(int mode, int r, float l, float rr,
                                      float win) {
  switch (mode) {
    case kLeft:
      return l * win;
    case kRight:
      return rr * win;
    case kMerge:
      return ((l + rr) * 0.5f) * win;
    case kSide:
      return ((l - rr) * 0.5f) * win;
    case kMidSide:
      return ((r == 0 ? l + rr : l - rr) * 0.5f) * win;
    default:  // kPhase, kSeparate: the channel itself
      return (r == 0 ? l : rr) * win;
  }
}

// Radix-2 DIT stages s .. s+M-1 on the 2^M values v[j] = element p + j*h
// (h = 2^s, p < h) of a transform held bit-reversed: stage t combines
// elements half = 2^t apart with twiddle exp(-2*pi*i*pos/(2*half)) =
// tw[half + pos]. The same butterflies, in the same order per element, as
// M separate radix-2 stages.
template <int M>
__device__ __forceinline__ void radix_stages(float2 (&v)[1 << M], const float2* tw,
                                             int h, int p) {
#pragma unroll
  for (int q = 0; q < M; ++q) {
    const int half = h << q;
#pragma unroll
    for (int j = 0; j < (1 << M); ++j) {
      if (j & (1 << q)) continue;
      const int j1 = j | (1 << q);
      const int pos = p + (j & ((1 << q) - 1)) * h;
      const float2 w = tw[half + pos];
      const float tr = w.x * v[j1].x - w.y * v[j1].y;
      const float ti = w.x * v[j1].y + w.y * v[j1].x;
      v[j1] = make_float2(v[j].x - tr, v[j].y - ti);
      v[j] = make_float2(v[j].x + tr, v[j].y + ti);
    }
  }
}

// Radix-2 DIT stages s .. s+M-1 of an l-point transform held bit-reversed
// in shared memory (swizzled by slot). Each work item loads the 2^M
// elements base + j*h (h = 2^s) that those M stages mix only among
// themselves, runs the M stages' butterflies in registers and stores them
// back: one shared-memory round trip and one barrier (the caller's)
// instead of M.
template <int M>
__device__ __forceinline__ void fft_pass(float2* buf, const float2* tw, int l,
                                         int log2l, int s) {
  const int h = 1 << s;
  for (int item = threadIdx.x; item < (l >> M); item += blockDim.x) {
    const int p = item & (h - 1);
    const int base = ((item >> s) << (s + M)) + p;
    float2 v[1 << M];
#pragma unroll
    for (int j = 0; j < (1 << M); ++j) v[j] = buf[slot(base + j * h, log2l)];
    radix_stages<M>(v, tw, h, p);
#pragma unroll
    for (int j = 0; j < (1 << M); ++j) buf[slot(base + j * h, log2l)] = v[j];
  }
}

// The first `stages` stages (all log2l by default) of an l-point transform
// held bit-reversed in shared memory, up to three a pass, a barrier after
// each. With stages < log2l they are the complete transforms of the
// 2^(log2l - stages) consecutive runs of 2^stages elements.
__device__ __forceinline__ void fft_in_shared(float2* buf, const float2* tw,
                                              int l, int log2l, int stages = -1) {
  if (stages < 0) stages = log2l;
  for (int s = 0; s < stages;) {
    const int m = stages - s < 3 ? stages - s : 3;
    if (m == 3) {
      fft_pass<3>(buf, tw, l, log2l, s);
    } else if (m == 2) {
      fft_pass<2>(buf, tw, l, log2l, s);
    } else {
      fft_pass<1>(buf, tw, l, log2l, s);
    }
    s += m;
    __syncthreads();
  }
}

}  // namespace
