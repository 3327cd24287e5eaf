// Kernel A: channel packing -> window -> N-point FFT -> |X|, for sm_90a.
//
// Replaces the TPU kernel signalizer_tpu/kernels/pallas_spectrum.py::
// fused_window_rfft_mag (a Bailey four-step DFT as MXU matmuls), and folds
// in what its callers did around it: _pack_channels and the DC/Nyquist
// halving (signalizer_tpu/kernels/spectrum.py:118-142, :198-200).
//
// Layout: frames [B, C, W] f32 (C >= 2, channel 0 = left, 1 = right),
// window [W] f32, twiddles [N] float2 in per-stage order: entry half + pos
// (half = 1, 2, .., N/2; pos < half) is exp(-2*pi*i*pos/(2*half)), computed
// in float64 on the host and rounded once (entry 0 is unused). Output rows:
//   modes LEFT/RIGHT/MERGE/SIDE (rows 1), SEPARATE/MIDSIDE (rows 2):
//       out [B, rows, N/2+1] f32 magnitudes, DC and Nyquist halved;
//   PHASE (rows 2): out [B, 2, N/2+1, 2] f32 halved complex half spectra;
//   COMPLEX (rows 1): out [B, N] f32 full-circle magnitudes, no halving.
//
// What bounds it on the H100: per row it reads W*4 bytes per channel it
// uses and writes (N/2+1)*4 (16 KB in, 8 KB out at the 4096-point SEPARATE
// headline), about 2.5 N log2 N flops, so HBM traffic sets the floor
// (~100 MB per 4096-row call, ~30 us at 3.35 TB/s) and everything the
// kernel adds to that is shared-memory traffic, barrier latency and
// instruction throughput (measured at the headline: about 3x that floor, of
// which the loads and stores are a tenth). The design spends as little of
// them as it can:
//
// * Packed real transform. A real row x[0..N) runs as the N/2-point complex
//   transform of z[m] = x[2m] + i*x[2m+1] (half the butterflies and half the
//   shared memory of an N-point transform with a zero imaginary part), and
//   the epilogue splits it,
//     X[k] = (Z[k] + conj Z[N/2-k])/2 - (i/2) e^{-2 pi i k/N} (Z[k] - conj Z[N/2-k]),
//   for the pair (k, N/2-k) at once, fused with the halving and the
//   magnitude. Each row still depends only on itself, so a silent row stays
//   exactly zero and a row's error is relative to its own peak; left and
//   right are never packed into one transform (the split would leak the
//   loud channel's rounding into a silent one). COMPLEX runs the same core
//   at length N.
// * Twiddles in stage order. Stage `half`'s twiddles are the consecutive
//   table entries [half, 2*half), so a warp's twiddle reads in a pass are
//   one or two cache lines, not a scatter over the flat exp(-2 pi i k/N)
//   table; every block reads the same 8*L bytes (L = core length), which
//   stay in L1. Copying them into shared memory first measured the same at
//   the headline (within 1%) for twice the shared memory, so the kernel
//   does not. The split's factors (one coalesced read per output pair) are
//   the table's last stage. No __sinf, no fast math, no recurrences: the
//   display floor is -96 dB.
// * Radix-8 passes. The core is an in-place radix-2 decimation-in-time
//   transform held bit-reversed; each thread runs up to three stages on
//   eight values in registers per shared-memory pass (2048 = 8*8*8*4: four
//   passes and barriers for a 4096-point real row). The XOR swizzle of the
//   slots (see slot) is kept from the complex-transform version of this
//   kernel: the passes' access patterns are the same at the new length, and
//   the prologue's bit-reversed scatter of z[2q], z[2q+1] lands within 4x
//   of conflict-free.
// * Rows in flight. One block per row, 256 threads (one radix-8 item per
//   thread and pass at the headline) and 8*L bytes of shared memory: four
//   blocks share an SM, so one row's barriers hide behind another's loads.
//   (Blocks that stay resident and stride over the rows measured 1-2%
//   slower at the headline.)
// * 16-byte loads of the frame and the window when W is a multiple of four
//   and both pointers are 16-byte aligned; scalar loads otherwise, in the
//   same kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_fft_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__global__ void __launch_bounds__(kMaxThreads)
    window_fft_mag_kernel(const float* __restrict__ frames,
                          const float* __restrict__ window,
                          const float2* __restrict__ tw,
                          float* __restrict__ out, int channels, int w,
                          int log2n, int mode) {
  extern __shared__ float2 buf[];  // the row's l complex values
  const int n = 1 << log2n;
  const bool cplx = mode == kComplex;
  const int log2l = cplx ? log2n : log2n - 1;  // the complex core's length
  const int l = 1 << log2l;
  const int rows = rows_of(mode);

  const bool vec =
      (w & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(frames) | reinterpret_cast<uintptr_t>(window)) & 15) == 0;

  const int row = blockIdx.x;
  const int b = row / rows;
  const int r = row - b * rows;
  const float* left = frames + (size_t)b * channels * w;
  const float* right = left + w;
  // the channels this mode and row read
  const bool plain_row = mode == kPhase || mode == kSeparate;
  const bool use_l = !(mode == kRight || (plain_row && r == 1));
  const bool use_r = !(mode == kLeft || (plain_row && r == 0));

  // prologue: pack channels, window, zero-pad, scatter bit-reversed
  if (vec) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = threadIdx.x; q < (n >> 2); q += blockDim.x) {
      const int i = q << 2;
      float4 a = zero, c = zero, win = zero;
      if (i < w) {  // w is a multiple of four here: the whole piece is inside
        if (use_l) a = load4(left + i);
        if (use_r) c = load4(right + i);
        win = load4(window + i);
      }
      if (cplx) {
        buf[slot(bit_reverse(i, log2l), log2l)] = make_float2(a.x * win.x, c.x * win.x);
        buf[slot(bit_reverse(i + 1, log2l), log2l)] = make_float2(a.y * win.y, c.y * win.y);
        buf[slot(bit_reverse(i + 2, log2l), log2l)] = make_float2(a.z * win.z, c.z * win.z);
        buf[slot(bit_reverse(i + 3, log2l), log2l)] = make_float2(a.w * win.w, c.w * win.w);
      } else {
        const int m = q << 1;  // z[m] = x[2m] + i x[2m+1]
        buf[slot(bit_reverse(m, log2l), log2l)] = make_float2(
            pack(mode, r, a.x, c.x, win.x), pack(mode, r, a.y, c.y, win.y));
        buf[slot(bit_reverse(m + 1, log2l), log2l)] = make_float2(
            pack(mode, r, a.z, c.z, win.z), pack(mode, r, a.w, c.w, win.w));
      }
    }
  } else {
    for (int m = threadIdx.x; m < l; m += blockDim.x) {
      float2 z = make_float2(0.f, 0.f);
      if (cplx) {
        if (m < w) z = make_float2(left[m] * window[m], right[m] * window[m]);
      } else {
        const int i = m << 1;
        if (i < w) {
          z.x = pack(mode, r, use_l ? left[i] : 0.f, use_r ? right[i] : 0.f, window[i]);
        }
        if (i + 1 < w) {
          z.y = pack(mode, r, use_l ? left[i + 1] : 0.f, use_r ? right[i + 1] : 0.f,
                     window[i + 1]);
        }
      }
      buf[slot(bit_reverse(m, log2l), log2l)] = z;
    }
  }
  __syncthreads();

  // radix-2 DIT, up to three stages per pass in registers (see fft_pass)
  fft_in_shared(buf, tw, l, log2l);

  // epilogue
  if (cplx) {
    float* o = out + (size_t)b * n;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const float2 z = buf[slot(k, log2l)];
      o[k] = sqrtf(z.x * z.x + z.y * z.y);
    }
  } else {
    // split the packed transform into the real row's bins k and l-k
    // (nb = l = N/2; Z[l] is Z[0]); tw[l + k] = exp(-2*pi*i*k/N)
    const size_t o0 = (size_t)row * (l + 1);
    for (int k = threadIdx.x; k <= (l >> 1); k += blockDim.x) {
      const int km = l - k;
      const float2 zk = buf[slot(k, log2l)];
      const float2 zm = buf[slot(km & (l - 1), log2l)];
      const float2 wk = __ldg(tw + l + k);
      const float er = 0.5f * (zk.x + zm.x), ei = 0.5f * (zk.y - zm.y);
      const float dr = 0.5f * (zk.x - zm.x), di = 0.5f * (zk.y + zm.y);
      const float p = wk.x * di + wk.y * dr;
      const float q = wk.x * dr - wk.y * di;
      const float scale = k == 0 ? 0.5f : 1.f;  // DC with k, Nyquist with l-k
      const float2 xk = make_float2(er + p, ei - q);
      const float2 xm = make_float2(er - p, -ei - q);
      if (mode == kPhase) {
        float2* o = reinterpret_cast<float2*>(out) + o0;
        o[k] = make_float2(xk.x * scale, xk.y * scale);
        if (km != k) o[km] = make_float2(xm.x * scale, xm.y * scale);
      } else {
        float* o = out + o0;
        o[k] = sqrtf(xk.x * xk.x + xk.y * xk.y) * scale;
        if (km != k) o[km] = sqrtf(xm.x * xm.x + xm.y * xm.y) * scale;
      }
    }
  }
}

}  // namespace

extern "C" int sig_window_fft_mag(const float* frames, const float* window,
                                  const float* twiddles, float* out,
                                  int batch, int channels, int w, int log2n,
                                  int mode, void* stream) {
  // real modes up to 32768 points, COMPLEX up to 16384: 8*L bytes of data
  if (mode < kLeft || mode > kComplex || log2n < 3 ||
      log2n > (mode == kComplex ? 14 : 15) || w < 1 || w > (1 << log2n) ||
      channels < 2 || batch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int log2l = mode == kComplex ? log2n : log2n - 1;
  const int l = 1 << log2l;
  const size_t smem = sizeof(float2) * (size_t)l;
  int threads = l / 8;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  static size_t granted = 48 * 1024;  // the largest opt-in granted so far
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        window_fft_mag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  const long long total_rows = (long long)batch * rows_of(mode);
  if (total_rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  window_fft_mag_kernel<<<(unsigned)total_rows, threads, smem, (cudaStream_t)stream>>>(
      frames, window, reinterpret_cast<const float2*>(twiddles), out, channels,
      w, log2n, mode);
  return (int)cudaGetLastError();
}

extern "C" const char* sig_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
