// What both forms of kernel A share (window_fft_mag.cu, the one-block form;
// window_fft_mag_long.cu, the four-step form for longer rows): the channel
// modes, the packing of a windowed sample, the bit reversal and the
// shared-memory swizzle of a transform held in shared memory.

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

}  // namespace
