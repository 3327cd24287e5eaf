// Kernel A: channel packing -> window -> N-point FFT -> |X|, for sm_90a.
//
// Replaces the TPU kernel signalizer_tpu/kernels/pallas_spectrum.py::
// fused_window_rfft_mag (a Bailey four-step DFT as MXU matmuls), and folds
// in what its callers did around it: _pack_channels and the DC/Nyquist
// halving (signalizer_tpu/kernels/spectrum.py:118-142, :198-200).
//
// Layout: frames [B, C, W] f32 (C >= 2, channel 0 = left, 1 = right),
// window [W] f32, twiddles [N/2] float2 = exp(-2*pi*i*k/N) computed in
// float64 on the host. One block per output row (B * rows blocks):
//   modes LEFT/RIGHT/MERGE/SIDE (rows 1), SEPARATE/MIDSIDE (rows 2):
//       out [B, rows, N/2+1] f32 magnitudes, DC and Nyquist halved;
//   PHASE (rows 2): out [B, 2, N/2+1, 2] f32 halved complex half spectra;
//   COMPLEX (rows 1): out [B, N] f32 full-circle magnitudes, no halving.
//
// What bounds it on the H100: per row it reads W*C*4 bytes and writes
// (N/2+1)*4 (32 KB in, 8 KB out at the 4096-point headline), about 5 N
// log2 N flops, so HBM traffic sets the floor (~100 MB per 4096-row call,
// ~30 us at 3.35 TB/s). The FFT itself runs out of shared memory: an
// in-place radix-2 decimation-in-time transform over N complex values
// (8*N bytes: 32 KB at N = 4096, 128 KB at 16384 with the opt-in
// attribute). The design keeps this simple and right first: the input is
// scattered into bit-reversed order while it is packed and windowed, each
// thread runs up to three radix-2 stages on eight values in registers per
// shared-memory pass (4 passes and barriers at N = 4096, not 12), and the
// epilogue writes coalesced rows. A real row runs as a complex
// transform with a zero imaginary part (twice the flops of a packed real
// FFT, but a silent row stays exactly zero and each row's error is
// relative to its own peak). Twiddles come from the float64 table, never
// __sinf: the display floor is -96 dB. Shared memory is XOR-swizzled (see
// slot) so the bit-reversed scatter and the short-stride passes do not
// serialise on one bank. A packed real transform and fusing with the
// display kernel are later work.

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

// Shared-memory slot of element i: the low four index bits (one 128-byte
// row of float2 banks) are XORed with bits 4..7 and with the top four bits.
// Without it the prologue's bit-reversed scatter puts a warp's 32 stores in
// one bank and the first pass (eight consecutive elements per thread) takes
// 8x its conflict-free shared-memory cycles; with it every access pattern
// here is within 2x of conflict-free (counted per pattern, N = 32..16384).
// It is a bijection on [0, n): bits 4 and up are unchanged.
__device__ __forceinline__ int slot(int i, int log2n) {
  int x = i ^ ((i >> 4) & 15);
  if (log2n > 8) x ^= (i >> (log2n - 4)) & 15;
  return x;
}

// Radix-2 DIT stages s .. s+M-1 of an n-point transform held bit-reversed
// in shared memory. Stage t combines elements half = 2^t apart with twiddle
// exp(-2*pi*i*pos/(2*half)) = twiddles[pos << (log2n - 1 - t)]. Each work
// item loads the 2^M elements base + j*h (h = 2^s) that those M stages mix
// only among themselves, runs the M stages' butterflies in registers and
// stores them back: the same butterflies, in the same order per element,
// as M separate radix-2 stages, with one shared-memory round trip and one
// barrier instead of M.
template <int M>
__device__ __forceinline__ void fft_pass(float2* buf,
                                         const float2* __restrict__ twiddles,
                                         int n, int log2n, int s) {
  const int h = 1 << s;
  for (int item = threadIdx.x; item < (n >> M); item += blockDim.x) {
    const int p = item & (h - 1);
    const int base = ((item >> s) << (s + M)) + p;
    float2 v[1 << M];
#pragma unroll
    for (int j = 0; j < (1 << M); ++j) v[j] = buf[slot(base + j * h, log2n)];
#pragma unroll
    for (int q = 0; q < M; ++q) {
      const int shift = log2n - 1 - (s + q);
#pragma unroll
      for (int j = 0; j < (1 << M); ++j) {
        if (j & (1 << q)) continue;
        const int j1 = j | (1 << q);
        const int pos = p + (j & ((1 << q) - 1)) * h;
        const float2 tw = twiddles[pos << shift];
        const float tr = tw.x * v[j1].x - tw.y * v[j1].y;
        const float ti = tw.x * v[j1].y + tw.y * v[j1].x;
        v[j1] = make_float2(v[j].x - tr, v[j].y - ti);
        v[j] = make_float2(v[j].x + tr, v[j].y + ti);
      }
    }
#pragma unroll
    for (int j = 0; j < (1 << M); ++j) buf[slot(base + j * h, log2n)] = v[j];
  }
}

__global__ void window_fft_mag_kernel(const float* __restrict__ frames,
                                      const float* __restrict__ window,
                                      const float2* __restrict__ twiddles,
                                      float* __restrict__ out, int channels,
                                      int w, int log2n, int mode) {
  extern __shared__ float2 buf[];
  const int n = 1 << log2n;
  const int rows = rows_of(mode);
  const int b = blockIdx.x / rows;
  const int r = blockIdx.x - b * rows;
  const float* left = frames + (size_t)b * channels * w;
  const float* right = left + w;

  // prologue: pack channels, window, zero-pad, scatter bit-reversed
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float re = 0.f, im = 0.f;
    if (i < w) {
      // read only the channels this mode and row use
      const float win = window[i];
      switch (mode) {
        case kLeft:
          re = left[i] * win;
          break;
        case kRight:
          re = right[i] * win;
          break;
        case kMerge:
          re = ((left[i] + right[i]) * 0.5f) * win;
          break;
        case kSide:
          re = ((left[i] - right[i]) * 0.5f) * win;
          break;
        case kMidSide:
          re = ((r == 0 ? left[i] + right[i] : left[i] - right[i]) * 0.5f) * win;
          break;
        case kComplex:
          re = left[i] * win;
          im = right[i] * win;
          break;
        default:  // kPhase, kSeparate: the channel itself
          re = (r == 0 ? left[i] : right[i]) * win;
          break;
      }
    }
    buf[slot(__brev((unsigned)i) >> (32 - log2n), log2n)] = make_float2(re, im);
  }
  __syncthreads();

  // radix-2 DIT, up to three stages per pass in registers (see fft_pass)
  for (int s = 0; s < log2n;) {
    const int m = log2n - s < 3 ? log2n - s : 3;
    if (m == 3) {
      fft_pass<3>(buf, twiddles, n, log2n, s);
    } else if (m == 2) {
      fft_pass<2>(buf, twiddles, n, log2n, s);
    } else {
      fft_pass<1>(buf, twiddles, n, log2n, s);
    }
    s += m;
    __syncthreads();
  }

  // epilogue
  const int nb = n >> 1;
  if (mode == kComplex) {
    float* o = out + (size_t)b * n;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const float2 z = buf[slot(k, log2n)];
      o[k] = sqrtf(z.x * z.x + z.y * z.y);
    }
  } else if (mode == kPhase) {
    float2* o = reinterpret_cast<float2*>(out) + (size_t)blockIdx.x * (nb + 1);
    for (int k = threadIdx.x; k <= nb; k += blockDim.x) {
      const float scale = (k == 0 || k == nb) ? 0.5f : 1.f;
      const float2 z = buf[slot(k, log2n)];
      o[k] = make_float2(z.x * scale, z.y * scale);
    }
  } else {
    float* o = out + (size_t)blockIdx.x * (nb + 1);
    for (int k = threadIdx.x; k <= nb; k += blockDim.x) {
      const float scale = (k == 0 || k == nb) ? 0.5f : 1.f;
      const float2 z = buf[slot(k, log2n)];
      o[k] = sqrtf(z.x * z.x + z.y * z.y) * scale;
    }
  }
}

}  // namespace

extern "C" int sig_window_fft_mag(const float* frames, const float* window,
                                  const float* twiddles, float* out,
                                  int batch, int channels, int w, int log2n,
                                  int mode, void* stream) {
  if (mode < kLeft || mode > kComplex || log2n < 1 || log2n > 14 ||
      w > (1 << log2n) || channels < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = 1 << log2n;
  const size_t smem = sizeof(float2) * (size_t)n;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_fft_mag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = n / 2;
  if (threads > 512) threads = 512;
  if (threads < 32) threads = 32;
  const unsigned blocks = (unsigned)batch * (unsigned)rows_of(mode);
  window_fft_mag_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      frames, window, reinterpret_cast<const float2*>(twiddles), out, channels,
      w, log2n, mode);
  return (int)cudaGetLastError();
}

extern "C" const char* sig_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
