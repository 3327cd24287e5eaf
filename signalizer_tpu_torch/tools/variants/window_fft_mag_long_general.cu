// Kernel A's two-pass form with its pass-2 block size and its waves as
// arguments: the package's form (csrc/window_fft_mag_long.cu, R = 8 rows a
// pass-2 block, all rows at once) generalised to R = 2^log2r = 8, 16 or 32
// rows a pass-2 block (where 2R + 1 rows of L2 + 1 points fit one block's
// shared memory) and to passes run wave by wave (pass 1 then pass 2 on
// wave_rows rows at a time, reusing one scratch region of wave_rows rows,
// to keep it in L2 between them; wave_rows <= 0: all rows at once). Both
// were measured slower on the H100 (PERF.md). Kept for the kernel_variants
// tool, which times every R and waves of 16 and 8 rows in turns with the
// package's form; not part of the package's library.
//
// Entry sig_window_fft_mag_long_general takes the package entry's arguments
// and log2r and wave_rows before the stream. scratch: [wave rows, L] float2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_fft_common.cuh"

namespace {

constexpr int kLog2Cols = 4;
constexpr int kCols = 1 << kLog2Cols;  // columns a pass-1 block transforms
constexpr int kThreads = 256;
constexpr int kThreads2 = 512;  // the most a pass-2 block takes
constexpr int kLoads = 4;       // 16-byte loads a pass-2 thread keeps in flight
constexpr int kSplit = 4;       // split factors a pass-2 thread keeps in flight
constexpr int kMinLog2L = 10;   // L1 >= 32, L2 >= 32
constexpr int kMaxLog2L = 20;   // L1, L2 <= 1024: pass 1 holds 128 KB
constexpr int kMaxSmem = 232448;

// Radix-2 DIT stages s .. s+M-1 of 2^log2count l-point transforms held
// bit-reversed in shared memory and interleaved (element i of transform g
// at (i << log2count) | g): the fft_pass of window_fft_common.cuh over
// several transforms at once, neighbouring threads on neighbouring
// transforms.
template <int M>
__device__ __forceinline__ void columns_pass(float2* buf, const float2* tw,
                                                int log2l, int log2count, int s) {
  const int h = 1 << s;
  const int items = 1 << (log2l - M + log2count);
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int g = item & ((1 << log2count) - 1);
    const int it = item >> log2count;
    const int p = it & (h - 1);
    const int base = ((it >> s) << (s + M)) + p;
    float2 v[1 << M];
#pragma unroll
    for (int j = 0; j < (1 << M); ++j) v[j] = buf[((base + j * h) << log2count) | g];
    radix_stages<M>(v, tw, h, p);
#pragma unroll
    for (int j = 0; j < (1 << M); ++j) buf[((base + j * h) << log2count) | g] = v[j];
  }
}

// The same stages on `count` l-point transforms (any count) whose element
// i of transform g lies at at(i, g); neighbouring threads walk one
// transform.
template <int M, class At>
__device__ __forceinline__ void rows_pass(float2* buf, const float2* tw,
                                          int log2l, int count, int s, At at) {
  const int h = 1 << s;
  const int log2per = log2l - M;  // items a transform: 2^log2per
  const int items = count << log2per;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int g = item >> log2per;
    const int it = item & ((1 << log2per) - 1);
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

// All log2l stages of pass 2's rows, up to three a shared-memory pass, a
// barrier after each; columns_fft the same for pass 1's columns.
template <class At>
__device__ __forceinline__ void rows_fft(float2* buf, const float2* tw,
                                         int log2l, int count, At at) {
  for (int s = 0; s < log2l;) {
    const int m = log2l - s < 3 ? log2l - s : 3;
    if (m == 3) {
      rows_pass<3>(buf, tw, log2l, count, s, at);
    } else if (m == 2) {
      rows_pass<2>(buf, tw, log2l, count, s, at);
    } else {
      rows_pass<1>(buf, tw, log2l, count, s, at);
    }
    s += m;
    __syncthreads();
  }
}

__device__ __forceinline__ void columns_fft(float2* buf, const float2* tw,
                                               int log2l, int log2count) {
  for (int s = 0; s < log2l;) {
    const int m = log2l - s < 3 ? log2l - s : 3;
    if (m == 3) {
      columns_pass<3>(buf, tw, log2l, log2count, s);
    } else if (m == 2) {
      columns_pass<2>(buf, tw, log2l, log2count, s);
    } else {
      columns_pass<1>(buf, tw, log2l, log2count, s);
    }
    s += m;
    __syncthreads();
  }
}

__device__ __forceinline__ int core_log2(int log2n, int mode) {
  return mode == kComplex ? log2n : log2n - 1;
}

__device__ __forceinline__ int columns_log2(int log2l) { return log2l >> 1; }

// Pass 1: grid (rows of this wave) * (L2 / kCols) blocks, kThreads
// threads, kCols * L1 * 8 bytes of shared memory. Row row0 + i of the
// batch goes to row i of the scratch.
__global__ void __launch_bounds__(kThreads)
    long_columns_kernel(const float* __restrict__ frames,
                        const float* __restrict__ window,
                        const float2* __restrict__ tw,
                        float2* __restrict__ scratch, int channels, int w,
                        int log2n, int mode, int row0) {
  extern __shared__ float2 buf[];  // [L1][kCols]: column g of row i at i*kCols + g
  const bool cplx = mode == kComplex;
  const int log2l = core_log2(log2n, mode);
  const int log2l1 = columns_log2(log2l);
  const int log2l2 = log2l - log2l1;
  const int l1 = 1 << log2l1;
  const int rows = rows_of(mode);

  const int pieces = 1 << (log2l2 - kLog2Cols);  // blocks a row
  const int wave_row = blockIdx.x / pieces;
  const int c0 = (blockIdx.x - wave_row * pieces) << kLog2Cols;
  const int row = row0 + wave_row;
  const int b = row / rows;
  const int r = row - b * rows;
  const float* left = frames + (size_t)b * channels * w;
  const float* right = left + w;
  // the channels this mode and row read
  const bool plain_row = mode == kPhase || mode == kSeparate;
  const bool use_l = !(mode == kRight || (plain_row && r == 1));
  const bool use_r = !(mode == kLeft || (plain_row && r == 0));

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
    buf[(bit_reverse(n1, log2l1) << kLog2Cols) | g] = z;
  }
  __syncthreads();

  columns_fft(buf, tw, log2l1, kLog2Cols);

  // epilogue: Y[k1][n2] = (column n2's transform)[k1] * w_L^(n2 k1)
  const int half_l = 1 << (log2l - 1);
  float2* y = scratch + ((size_t)wave_row << log2l);
  for (int q = threadIdx.x; q < (l1 << kLog2Cols); q += blockDim.x) {
    const int g = q & (kCols - 1);
    const int k1 = q >> kLog2Cols;
    const int n2 = c0 + g;
    const float2 v = buf[(k1 << kLog2Cols) | g];
    const int j = (n2 * k1) & ((half_l << 1) - 1);
    float2 t = __ldg(tw + half_l + (j & (half_l - 1)));
    if (j & half_l) t = make_float2(-t.x, -t.y);
    y[((size_t)k1 << log2l2) + n2] =
        make_float2(v.x * t.x - v.y * t.y, v.x * t.y + v.y * t.x);
  }
}

// Pass 2: grid (rows of this wave) * (L1 / 2R) blocks, threads from the
// launcher, (2R + 1) * (L2 + 1) * 8 bytes of shared memory at most. Row i
// of the scratch is row row0 + i of the output.
__global__ void __launch_bounds__(kThreads2)
    long_rows_kernel(const float2* __restrict__ scratch,
                     const float2* __restrict__ tw, float* __restrict__ out,
                     int log2n, int mode, int log2r, int row0) {
  extern __shared__ float2 buf[];  // [held][L2 + 1], each row swizzled by slot()
  const bool cplx = mode == kComplex;
  const int log2l = core_log2(log2n, mode);
  const int log2l1 = columns_log2(log2l);
  const int log2l2 = log2l - log2l1;
  const int l = 1 << log2l;
  const int l1 = 1 << log2l1;
  const int l2 = 1 << log2l2;
  const int run = 1 << log2r;  // R

  const int groups = l1 >> (log2r + 1);  // blocks a row
  const int wave_row = blockIdx.x / groups;
  const int g = blockIdx.x - wave_row * groups;
  const int row = row0 + wave_row;
  // the held rows: slots [0, R) are rows a0.. (the run), slots [R, held)
  // rows p_lo..p_hi (the mirrors, with row L1/2 in the last block); COMPLEX
  // needs no mirrors and holds the 2R rows from 2gR
  const int a0 = g << (log2r + cplx);
  const int p_lo = cplx ? a0 + run : (g == groups - 1 ? l1 >> 1 : l1 - a0 - run + 1);
  const int p_hi = cplx ? a0 + 2 * run - 1 : (g == 0 ? l1 - 1 : l1 - a0);
  const int held = run + p_hi - p_lo + 1;
  const int stride = l2 + 1;  // a float2 of padding: the transposed reads fall on distinct banks
  const auto at = [stride, log2l2](int i, int h) { return h * stride + slot(i, log2l2); };
  const auto k1_of = [=](int h) { return h < run ? a0 + h : p_lo + h - run; };

  // the held rows of the scratch, two points a 16-byte load, kLoads loads
  // a thread in flight before the first is scattered (bit-reversed)
  const float2* y = scratch + ((size_t)wave_row << log2l);
  const int pieces = (held << log2l2) >> 1;
  for (int u0 = threadIdx.x; u0 < pieces; u0 += kLoads * blockDim.x) {
    float4 z[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int u = u0 + j * blockDim.x;
      if (u < pieces) {
        const int h = u >> (log2l2 - 1);
        const int n2 = (u << 1) & (l2 - 1);
        z[j] = *reinterpret_cast<const float4*>(y + ((size_t)k1_of(h) << log2l2) + n2);
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int u = u0 + j * blockDim.x;
      if (u < pieces) {
        const int h = u >> (log2l2 - 1);
        const int n2 = (u << 1) & (l2 - 1);
        buf[at(bit_reverse(n2, log2l2), h)] = make_float2(z[j].x, z[j].y);
        buf[at(bit_reverse(n2 + 1, log2l2), h)] = make_float2(z[j].z, z[j].w);
      }
    }
  }
  __syncthreads();

  rows_fft(buf, tw, log2l2, held, at);

  const size_t o0 = cplx ? (size_t)row << log2l : (size_t)row * (l + 1);
  if (!cplx) {
    // the real split, in place: pair (k, l - k) from the run's row k1 at
    // k2 and its mirror; X[k] goes where Z[k] was. tw[l + k] =
    // exp(-2*pi*i*k/N) for k <= l/2: neighbouring threads take
    // neighbouring rows k1 at one k2, so their factors are neighbours too
    const int pairs = (run << log2l2) + (g == groups - 1 ? l2 >> 1 : 0);
    // pair q: bins k <= l/2 and km = l - k in slots sk and sm (live false:
    // row 0's second half, which its first half covers)
    const auto pair_of = [&](int q, int& k, int& km, int& sk, int& sm) {
      int ha, hb, k1, k2, k2m;
      if (q < (run << log2l2)) {
        ha = q & (run - 1);
        k2 = q >> log2r;
        k1 = a0 + ha;
        if (k1 == 0) {  // row 0 with itself
          if (k2 > (l2 >> 1)) return false;
          hb = ha;
          k2m = (l2 - k2) & (l2 - 1);
        } else {
          hb = run + (l1 - k1) - p_lo;
          k2m = l2 - 1 - k2;
        }
      } else {  // row L1/2 with itself, the first of the last block's mirrors
        k2 = q - (run << log2l2);
        k1 = l1 >> 1;
        ha = hb = run;
        k2m = l2 - 1 - k2;
      }
      k = k1 + (k2 << log2l1);
      km = l - k;
      sk = at(k2, ha);
      sm = at(k2m, hb);
      if (k > (l >> 1)) {  // the split's factor for the smaller of the two
        const int t = k;
        k = km;
        km = t;
        const int ts = sk;
        sk = sm;
        sm = ts;
      }
      return true;
    };
    // kSplit pairs a thread at a time, their factors' loads in flight together
    for (int q0 = threadIdx.x; q0 < pairs; q0 += kSplit * blockDim.x) {
      int k[kSplit], km[kSplit], sk[kSplit], sm[kSplit];
      bool live[kSplit];
      float2 wk[kSplit];
#pragma unroll
      for (int j = 0; j < kSplit; ++j) {
        const int q = q0 + j * blockDim.x;
        live[j] = q < pairs && pair_of(q, k[j], km[j], sk[j], sm[j]);
        if (live[j]) wk[j] = __ldg(tw + l + k[j]);
      }
#pragma unroll
      for (int j = 0; j < kSplit; ++j) {
        if (!live[j]) continue;
        const float2 zk = buf[sk[j]];
        const float2 zm = buf[sm[j]];
        const float er = 0.5f * (zk.x + zm.x), ei = 0.5f * (zk.y - zm.y);
        const float dr = 0.5f * (zk.x - zm.x), di = 0.5f * (zk.y + zm.y);
        const float p = wk[j].x * di + wk[j].y * dr;
        const float qq = wk[j].x * dr - wk[j].y * di;
        const float scale = k[j] == 0 ? 0.5f : 1.f;  // DC with k, Nyquist with l-k
        const float2 xk = make_float2(er + p, ei - qq);
        const float2 xm = make_float2(er - p, -ei - qq);
        float2 vk, vm;  // PHASE: the halved complex bins; else .x the magnitude
        if (mode == kPhase) {
          vk = make_float2(xk.x * scale, xk.y * scale);
          vm = make_float2(xm.x * scale, xm.y * scale);
        } else {
          vk = make_float2(sqrtf(xk.x * xk.x + xk.y * xk.y) * scale, 0.f);
          vm = make_float2(sqrtf(xm.x * xm.x + xm.y * xm.y) * scale, 0.f);
        }
        buf[sk[j]] = vk;
        if (km[j] == l) {
          // the Nyquist bin: Z[l] is Z[0], whose slot X[0] took; X[l] goes
          // to row 0's padding, stored after the last k2 as bin 0 + L1 L2
          buf[l2] = vm;
        } else if (km[j] != k[j]) {
          buf[sm[j]] = vm;
        }
      }
    }
    __syncthreads();
  }

  // the stores, through the transpose: element q of the block's bins in
  // order (k2, then slot h: the run's R bins, then the mirrors'), so a
  // warp's consecutive threads store consecutive bins k1 + L1 k2 (block 0
  // of a real row ends on the Nyquist bin, k2 = L2 of row 0)
  const int stored = (held << log2l2) + (g == 0 && !cplx ? 1 : 0);
  int k2 = threadIdx.x / held;
  int h = threadIdx.x - k2 * held;
  const int step_k2 = blockDim.x / held;
  const int step_h = blockDim.x - step_k2 * held;
  for (int q = threadIdx.x; q < stored; q += blockDim.x) {
    const float2 z = buf[k2 == l2 ? l2 : at(k2, h)];
    const size_t k = o0 + k1_of(h) + ((size_t)k2 << log2l1);
    if (cplx) {
      out[k] = sqrtf(z.x * z.x + z.y * z.y);
    } else if (mode == kPhase) {
      reinterpret_cast<float2*>(out)[k] = z;
    } else {
      out[k] = z.x;
    }
    h += step_h;
    k2 += step_k2;
    if (h >= held) {
      h -= held;
      ++k2;
    }
  }
}

size_t rows_smem(int log2r, int log2l2) {
  return sizeof(float2) * ((size_t)2 * (1 << log2r) + 1) * ((1 << log2l2) + 1);
}

}  // namespace

// Both passes on `stream`, wave by wave (pass 1 then pass 2 on wave_rows
// rows at a time, all rows at once for wave_rows <= 0), pass-2 blocks of
// R = 2^log2r rows; returns the first error. scratch: [wave rows, L]
// float2, reused by every wave.
extern "C" int sig_window_fft_mag_long_general(const float* frames, const float* window,
                                               const float* twiddles, float* scratch,
                                               float* out, int batch, int channels,
                                               int w, int log2n, int mode, int log2r,
                                               int wave_rows, void* stream) {
  if (mode < kLeft || mode > kComplex || w < 1 || channels < 2 || batch < 1 ||
      log2n < 1 || log2n > 30 || w > (1 << log2n)) {
    return (int)cudaErrorInvalidValue;
  }
  const int log2l = mode == kComplex ? log2n : log2n - 1;
  if (log2l < kMinLog2L || log2l > kMaxLog2L) return (int)cudaErrorInvalidValue;
  const int log2l1 = log2l >> 1;
  const int log2l2 = log2l - log2l1;
  const size_t smem1 = sizeof(float2) * ((size_t)kCols << log2l1);
  const size_t smem2 = rows_smem(log2r, log2l2);
  if (log2r < 3 || log2r > 5 || log2r > log2l1 - 1 || smem2 > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total_rows = (long long)batch * rows_of(mode);
  const long long wave = wave_rows <= 0 || wave_rows > total_rows ? total_rows : wave_rows;
  const long long blocks1 = wave << (log2l2 - kLog2Cols);
  const long long blocks2 = wave << (log2l1 - 1 - log2r);
  if (blocks1 > 0x7fffffffLL || blocks2 > 0x7fffffffLL || total_rows > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }

  static size_t granted1 = 48 * 1024;  // the largest opt-ins granted so far
  static size_t granted2 = 48 * 1024;
  if (smem1 > granted1) {
    cudaError_t err = cudaFuncSetAttribute(
        long_columns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    if (err != cudaSuccess) return (int)err;
    granted1 = smem1;
  }
  if (smem2 > granted2) {
    cudaError_t err = cudaFuncSetAttribute(
        long_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
    if (err != cudaSuccess) return (int)err;
    granted2 = smem2;
  }
  const float2* tw = reinterpret_cast<const float2*>(twiddles);
  float2* y = reinterpret_cast<float2*>(scratch);
  cudaStream_t s = (cudaStream_t)stream;
  // about four radix-8 items a thread for a block's rows
  int threads2 = (int)((2 << (log2r + log2l2)) / 32);
  threads2 = threads2 > kThreads2 ? kThreads2 : (threads2 < 128 ? 128 : threads2);
  for (long long r0 = 0; r0 < total_rows; r0 += wave) {
    const long long n = total_rows - r0 < wave ? total_rows - r0 : wave;
    long_columns_kernel<<<(unsigned)(n << (log2l2 - kLog2Cols)), kThreads, smem1, s>>>(
        frames, window, tw, y, channels, w, log2n, mode, (int)r0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    long_rows_kernel<<<(unsigned)(n << (log2l1 - 1 - log2r)), threads2, smem2, s>>>(
        y, tw, out, log2n, mode, log2r, (int)r0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
