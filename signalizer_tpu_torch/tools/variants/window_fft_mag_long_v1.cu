// Kernel A's two-pass form as it was before pass 2 stored whole sectors:
// pass 2 took rows k1 = j and L1 - j of the scratch in one block and stored
// bins k1 + L1 k2, 4-byte values L1 floats apart, each filling one 32-byte
// sector. Pass 1 is the same as the package's (csrc/window_fft_mag_long.cu). Kept
// for the kernel_variants tool, which times it in turns with the package's
// form; not part of the package's library.
//
// Entry sig_window_fft_mag_long_v1 takes the arguments the package's entry
// took then (no rows a block, no wave). Compiled with SIG_DROP_STORES,
// pass 2 computes its magnitudes and stores none of them (the outputs are
// then wrong), to show what the strided stores cost.

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_fft_common.cuh"

#ifdef SIG_DROP_STORES
#define SIG_STORED(v) ((v) < 0.f)  // magnitudes are never negative
#else
#define SIG_STORED(v) true
#endif

namespace {

constexpr int kLog2Cols = 4;
constexpr int kCols = 1 << kLog2Cols;  // columns a pass-1 block transforms
constexpr int kThreads = 256;
constexpr int kMinLog2L = 10;  // L1 >= 32, L2 >= 32
constexpr int kMaxLog2L = 20;  // L1, L2 <= 1024: pass 1 holds 128 KB

// Radix-2 DIT stages s .. s+M-1 of 2^log2count l-point transforms held
// bit-reversed in shared memory, element i of transform g at at(i, g): the
// fft_pass of window_fft_common.cuh over several transforms at once. Work item
// `item` takes transform g = item mod 2^log2count (kGFast: neighbouring
// threads take neighbouring transforms, for the interleaved layout) or
// g = item / (l / 2^M) (neighbouring threads walk one transform).
template <int M, bool kGFast, class At>
__device__ __forceinline__ void batched_pass(float2* buf, const float2* tw,
                                             int log2l, int log2count, int s,
                                             At at) {
  const int h = 1 << s;
  const int per = 1 << (log2l - M);  // items a transform
  const int items = per << log2count;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int g = kGFast ? item & ((1 << log2count) - 1) : item >> (log2l - M);
    const int it = kGFast ? item >> log2count : item & (per - 1);
    const int p = it & (h - 1);
    const int base = ((it >> s) << (s + M)) + p;
    float2 v[1 << M];
#pragma unroll
    for (int j = 0; j < (1 << M); ++j) v[j] = buf[at(base + j * h, g)];
    radix_stages<M>(v, tw, h, p);
#pragma unroll
    for (int j = 0; j < (1 << M); ++j) buf[at(base + j * h, g)] = v[j];
  }
}

// All log2l stages, up to three a shared-memory pass, a barrier after each.
template <bool kGFast, class At>
__device__ __forceinline__ void batched_fft(float2* buf, const float2* tw,
                                            int log2l, int log2count, At at) {
  for (int s = 0; s < log2l;) {
    const int m = log2l - s < 3 ? log2l - s : 3;
    if (m == 3) {
      batched_pass<3, kGFast>(buf, tw, log2l, log2count, s, at);
    } else if (m == 2) {
      batched_pass<2, kGFast>(buf, tw, log2l, log2count, s, at);
    } else {
      batched_pass<1, kGFast>(buf, tw, log2l, log2count, s, at);
    }
    s += m;
    __syncthreads();
  }
}

__device__ __forceinline__ int core_log2(int log2n, int mode) {
  return mode == kComplex ? log2n : log2n - 1;
}

__device__ __forceinline__ int columns_log2(int log2l) { return log2l >> 1; }

// Pass 1: grid (B * rows) * (L2 / kCols) blocks, kThreads threads,
// kCols * L1 * 8 bytes of shared memory.
__global__ void __launch_bounds__(kThreads)
    long_columns_v1_kernel(const float* __restrict__ frames,
                        const float* __restrict__ window,
                        const float2* __restrict__ tw,
                        float2* __restrict__ scratch, int channels, int w,
                        int log2n, int mode) {
  extern __shared__ float2 buf[];  // [L1][kCols]: column g of row i at i*kCols + g
  const bool cplx = mode == kComplex;
  const int log2l = core_log2(log2n, mode);
  const int log2l1 = columns_log2(log2l);
  const int log2l2 = log2l - log2l1;
  const int l1 = 1 << log2l1;
  const int rows = rows_of(mode);

  const int pieces = 1 << (log2l2 - kLog2Cols);  // blocks a row
  const int row = blockIdx.x / pieces;
  const int c0 = (blockIdx.x - row * pieces) << kLog2Cols;
  const int b = row / rows;
  const int r = row - b * rows;
  const float* left = frames + (size_t)b * channels * w;
  const float* right = left + w;
  // the channels this mode and row read
  const bool plain_row = mode == kPhase || mode == kSeparate;
  const bool use_l = !(mode == kRight || (plain_row && r == 1));
  const bool use_r = !(mode == kLeft || (plain_row && r == 0));
  const auto at = [](int i, int g) { return (i << kLog2Cols) | g; };

  // prologue: z[L2 n1 + n2] for this block's columns, packed, windowed,
  // zero-padded past W, bit-reversed in n1
  for (int q = threadIdx.x; q < (l1 << kLog2Cols); q += blockDim.x) {
    const int g = q & (kCols - 1);
    const int n1 = q >> kLog2Cols;
    const int m = (n1 << log2l2) + c0 + g;
    float2 z = make_float2(0.f, 0.f);
    if (cplx) {
      if (m < w) z = make_float2(left[m] * window[m], right[m] * window[m]);
    } else {
      const int i = m << 1;  // z[m] = x[2m] + i x[2m+1]
      if (i < w) {
        z.x = pack(mode, r, use_l ? left[i] : 0.f, use_r ? right[i] : 0.f, window[i]);
      }
      if (i + 1 < w) {
        z.y = pack(mode, r, use_l ? left[i + 1] : 0.f, use_r ? right[i + 1] : 0.f,
                   window[i + 1]);
      }
    }
    buf[at(bit_reverse(n1, log2l1), g)] = z;
  }
  __syncthreads();

  batched_fft<true>(buf, tw, log2l1, kLog2Cols, at);

  // epilogue: Y[k1][n2] = (column n2's transform)[k1] * w_L^(n2 k1)
  const int half_l = 1 << (log2l - 1);
  float2* y = scratch + ((size_t)row << log2l);
  for (int q = threadIdx.x; q < (l1 << kLog2Cols); q += blockDim.x) {
    const int g = q & (kCols - 1);
    const int k1 = q >> kLog2Cols;
    const int n2 = c0 + g;
    const float2 v = buf[at(k1, g)];
    const int j = (n2 * k1) & ((half_l << 1) - 1);
    float2 t = __ldg(tw + half_l + (j & (half_l - 1)));
    if (j & half_l) t = make_float2(-t.x, -t.y);
    y[((size_t)k1 << log2l2) + n2] =
        make_float2(v.x * t.x - v.y * t.y, v.x * t.y + v.y * t.x);
  }
}

// Pass 2: grid (B * rows) * (L1/2 + 1) blocks, threads from the launcher,
// 2 * L2 * 8 bytes of shared memory.
__global__ void __launch_bounds__(kThreads)
    long_rows_v1_kernel(const float2* __restrict__ scratch,
                     const float2* __restrict__ tw, float* __restrict__ out,
                     int log2n, int mode) {
  extern __shared__ float2 buf[];  // [2][L2], each row swizzled by slot()
  const bool cplx = mode == kComplex;
  const int log2l = core_log2(log2n, mode);
  const int log2l1 = columns_log2(log2l);
  const int log2l2 = log2l - log2l1;
  const int l = 1 << log2l;
  const int l1 = 1 << log2l1;
  const int l2 = 1 << log2l2;

  const int pieces = (l1 >> 1) + 1;
  const int row = blockIdx.x / pieces;
  const int j = blockIdx.x - row * pieces;  // rows j and l1 - j of Y
  const int log2count = (j == 0 || j == (l1 >> 1)) ? 0 : 1;
  const auto at = [log2l2](int i, int g) { return (g << log2l2) | slot(i, log2l2); };

  const float2* y = scratch + ((size_t)row << log2l);
  for (int q = threadIdx.x; q < (l2 << log2count); q += blockDim.x) {
    const int g = q >> log2l2;
    const int n2 = q & (l2 - 1);
    const int k1 = g ? l1 - j : j;
    buf[at(bit_reverse(n2, log2l2), g)] = y[((size_t)k1 << log2l2) + n2];
  }
  __syncthreads();

  batched_fft<false>(buf, tw, log2l2, log2count, at);

  if (cplx) {
    float* o = out + ((size_t)row << log2l);
    for (int q = threadIdx.x; q < (l2 << log2count); q += blockDim.x) {
      const int g = q >> log2l2;
      const int k2 = q & (l2 - 1);
      const int k1 = g ? l1 - j : j;
      const float2 z = buf[at(k2, g)];
      const float m = sqrtf(z.x * z.x + z.y * z.y);
      if (SIG_STORED(m)) o[k1 + (k2 << log2l1)] = m;
    }
    return;
  }
  // split the packed transform into the real row's bins k and l - k
  // (Z[l] is Z[0]); tw[l + k] = exp(-2*pi*i*k/N) for k <= l/2
  const size_t o0 = (size_t)row * (l + 1);
  const int other = log2count;  // the partner row's slot in buf
  const int n_out = j == 0 ? (l2 >> 1) + 1 : (log2count ? l2 : l2 >> 1);
  for (int k2 = threadIdx.x; k2 < n_out; k2 += blockDim.x) {
    const int k2m = j == 0 ? (l2 - k2) & (l2 - 1) : l2 - 1 - k2;
    int k = j + (k2 << log2l1);
    int km = l - k;
    float2 zk = buf[at(k2, 0)];
    float2 zm = buf[at(k2m, other)];
    if (k > (l >> 1)) {  // the split's factor for the smaller of the two
      const int t = k;
      k = km;
      km = t;
      const float2 zt = zk;
      zk = zm;
      zm = zt;
    }
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
      const float mk = sqrtf(xk.x * xk.x + xk.y * xk.y) * scale;
      const float mm = sqrtf(xm.x * xm.x + xm.y * xm.y) * scale;
      if (SIG_STORED(mk)) o[k] = mk;
      if (km != k && SIG_STORED(mm)) o[km] = mm;
    }
  }
}

}  // namespace

// Both passes on `stream`, pass 1 then pass 2; returns the first error.
// scratch: [batch * rows, L] float2.
extern "C" int sig_window_fft_mag_long_v1(const float* frames, const float* window,
                                       const float* twiddles, float* scratch,
                                       float* out, int batch, int channels,
                                       int w, int log2n, int mode,
                                       void* stream) {
  if (mode < kLeft || mode > kComplex || w < 1 || channels < 2 || batch < 1 ||
      log2n < 1 || log2n > 30 || w > (1 << log2n)) {
    return (int)cudaErrorInvalidValue;
  }
  const int log2l = mode == kComplex ? log2n : log2n - 1;
  if (log2l < kMinLog2L || log2l > kMaxLog2L) return (int)cudaErrorInvalidValue;
  const int log2l1 = log2l >> 1;
  const int log2l2 = log2l - log2l1;
  const long long total_rows = (long long)batch * rows_of(mode);
  const long long blocks1 = total_rows << (log2l2 - kLog2Cols);
  const long long blocks2 = total_rows * ((1 << (log2l1 - 1)) + 1);
  if (blocks1 > 0x7fffffffLL || blocks2 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  const size_t smem1 = sizeof(float2) * ((size_t)kCols << log2l1);
  const size_t smem2 = sizeof(float2) * ((size_t)2 << log2l2);
  static size_t granted1 = 48 * 1024;  // the largest opt-ins granted so far
  static size_t granted2 = 48 * 1024;
  if (smem1 > granted1) {
    cudaError_t err = cudaFuncSetAttribute(
        long_columns_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    if (err != cudaSuccess) return (int)err;
    granted1 = smem1;
  }
  if (smem2 > granted2) {
    cudaError_t err = cudaFuncSetAttribute(
        long_rows_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
    if (err != cudaSuccess) return (int)err;
    granted2 = smem2;
  }
  const float2* tw = reinterpret_cast<const float2*>(twiddles);
  float2* y = reinterpret_cast<float2*>(scratch);
  cudaStream_t s = (cudaStream_t)stream;
  long_columns_v1_kernel<<<(unsigned)blocks1, kThreads, smem1, s>>>(
      frames, window, tw, y, channels, w, log2n, mode);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // one radix-8 item a thread for the two rows of a block
  int threads2 = (2 << log2l2) / 8;
  if (threads2 > kThreads) threads2 = kThreads;
  if (threads2 < 32) threads2 = 32;
  long_rows_v1_kernel<<<(unsigned)blocks2, threads2, smem2, s>>>(y, tw, out, log2n, mode);
  return (int)cudaGetLastError();
}
