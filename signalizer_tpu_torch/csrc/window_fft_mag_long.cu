// Kernel A, two-pass form: channel packing -> window -> N-point FFT -> |X|
// for rows too long for a thread-block cluster's shared memory (real
// N > 131072, COMPLEX N > 65536; window_fft_mag_cluster.cu takes the rows
// between one block's limit and those), as a four-step transform through
// device memory, for sm_90a.
//
// Replaces, for those lengths, the same TPU kernel as window_fft_mag.cu:
// signalizer_tpu/kernels/pallas_spectrum.py::fused_window_rfft_mag, with
// its callers' packing and DC/Nyquist halving folded in. Same layouts and
// modes as window_fft_mag.cu (frames [B, C, W] f32; out [B, rows, N/2+1]
// magnitudes, PHASE [B, 2, N/2+1, 2] halved complex, COMPLEX [B, N]), plus
// a scratch [rows, L] float2 that the wrapper allocates.
//
// Why another form: the one-block kernel holds a row's L-point complex core
// (L = N/2 for a packed real row, N for COMPLEX) in shared memory, 8*L
// bytes, at most 227 KB a block; the cluster form spreads it over 2-8
// blocks, up to L = 65536. Longer rows go through device memory.
//
// The four-step. Write L = L1 * L2 (L1 = 2^floor(log2(L)/2), L2 = L / L1),
// the core's input z[m] with m = L2*n1 + n2 and its output Z[k] with
// k = k1 + L1*k2:
//   Z[k1 + L1 k2] = sum_n2 w_L2^(n2 k2) [w_L^(n2 k1) sum_n1 z[L2 n1 + n2] w_L1^(n1 k1)]
// (w_M = exp(-2 pi i / M)).
// * Pass 1 (long_columns_kernel): a block takes kCols = 16 consecutive
//   columns n2 of one row. It packs and windows their L1 samples each (a
//   warp's loads are 16 consecutive z: 128 contiguous bytes a channel),
//   runs the 16 L1-point transforms in shared memory (interleaved, column
//   fastest, so a warp's accesses fall on distinct banks), multiplies by
//   w_L^(n2 k1) and writes Y[k1][n2] to the scratch (16 consecutive float2
//   a row k1).
// * Pass 2 (long_rows_kernel): a block takes R = 8 consecutive rows
//   k1 in [a0, a0 + R) of Y (a0 = g R, g < L1 / 2R) and their mirrors
//   L1 - k1 (mod L1), so that the real split, which pairs Z[k] with
//   Z[L - k], closes in the block: for k = k1 + L1 k2 (0 < k1 < L1/2) the
//   partner is L - k = (L1 - k1) + L1 (L2 - 1 - k2), in the mirror run;
//   row 0 pairs with itself at (L2 - k2) mod L2 (block 0) and row L1/2 at L2 - 1 - k2
//   (the last block adds it to its mirror run). So a block holds at most
//   2R + 1 rows, 2R+1 L2-point transforms in shared memory, each row L2 + 1
//   float2 apart. It runs them, splits in place (X[k] where Z[k] was;
//   X[L], the Nyquist bin, in row 0's padding), and stores through the
//   transpose: consecutive threads take consecutive bins k1 + L1 k2 of the
//   held rows, so a warp stores runs of at least R consecutive bins (block
//   0's mirror run meets the next k2's run, and its last ends on the
//   Nyquist bin): 32 bytes or more, whole sectors but for a run's ends.
//   COMPLEX needs no mirrors: its blocks hold 2R consecutive rows and store
//   |Z|, runs of 2R bins.
// * Twiddles: the constant's fft_twiddles table [N] (float64 on the host,
//   rounded once; see window_fft_mag.cu). The stage twiddles of both
//   transforms are its entries [1, L1) and [1, L2); w_L^j is entry
//   L/2 + (j mod L/2), negated for j >= L/2 (w_L^(L/2) = -1 exactly); the
//   split's factors exp(-2 pi i k / N) are entries [L, 2L). No fast math,
//   no recurrences.
// * Left and right are never packed into one transform, so a silent row
//   stays exactly zero and a row's error is relative to its own peak.
//
// What bounds it on the H100: the bytes the function must move are those of
// the one-block form (frames, window and twiddles read once, rows written
// once: 25.6 MB in and 16.8 MB out for 16 pairs of 200000 samples at
// N = 262144, about 13.5 us at 3.35 TB/s). The scratch round trip, 16 bytes
// a complex point (written by pass 1, read by pass 2), is this design's
// cost: 33.5 MB each way at that shape. Stored a bin at a time, pass 2's
// outputs would fill one 32-byte sector a 4-byte value (rows k1 hold bins L1
// floats apart); through the transpose they are runs of whole sectors.
// Pass-2 blocks of 16 or 32 rows, and the passes run wave by wave to keep
// the scratch in L2 between them, were measured slower on the H100
// (PERF.md §6). The cluster form
// (window_fft_mag_cluster.cu) keeps the row on chip; this form is left for
// the rows it cannot hold.

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_fft_common.cuh"

namespace {

constexpr int kLog2Cols = 4;
constexpr int kCols = 1 << kLog2Cols;  // columns a pass-1 block transforms
constexpr int kThreads = 256;
constexpr int kLog2Run = 3;
constexpr int kRun = 1 << kLog2Run;  // R: rows a pass-2 block stores, besides their mirrors
constexpr int kLoads = 4;   // 16-byte loads a pass-2 thread keeps in flight
constexpr int kSplit = 4;   // split factors a pass-2 thread keeps in flight
constexpr int kMinLog2L = 10;  // L1 >= 32, L2 >= 32
constexpr int kMaxLog2L = 20;  // L1, L2 <= 1024: pass 1 holds 128 KB
// a pass-2 block holds at most 2R + 1 rows of L2 + 1 points: 137 KB at L2 = 1024
static_assert(sizeof(float2) * (2 * kRun + 1) * ((1 << (kMaxLog2L - kMaxLog2L / 2)) + 1) <= 232448,
              "pass 2's rows fit one block's shared memory");
static_assert(2 * kRun <= 1 << (kMinLog2L / 2), "a pass-2 block's rows and mirrors fit L1");
constexpr int kThreads2 = (2 * kRun << (kMaxLog2L - kMaxLog2L / 2)) / 32;  // the most a pass-2 block takes

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

// Pass 1: grid rows * (L2 / kCols) blocks, kThreads threads,
// kCols * L1 * 8 bytes of shared memory.
__global__ void __launch_bounds__(kThreads)
    long_columns_kernel(const float* __restrict__ frames,
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
  float2* y = scratch + ((size_t)row << log2l);
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

// Pass 2: grid rows * (L1 / 2R) blocks, threads from the launcher,
// (2R + 1) * (L2 + 1) * 8 bytes of shared memory at most.
__global__ void __launch_bounds__(kThreads2)
    long_rows_kernel(const float2* __restrict__ scratch,
                     const float2* __restrict__ tw, float* __restrict__ out,
                     int log2n, int mode) {
  extern __shared__ float2 buf[];  // [held][L2 + 1], each row swizzled by slot()
  const bool cplx = mode == kComplex;
  const int log2l = core_log2(log2n, mode);
  const int log2l1 = columns_log2(log2l);
  const int log2l2 = log2l - log2l1;
  const int l = 1 << log2l;
  const int l1 = 1 << log2l1;
  const int l2 = 1 << log2l2;
  const int groups = l1 >> (kLog2Run + 1);  // blocks a row
  const int row = blockIdx.x / groups;
  const int g = blockIdx.x - row * groups;
  // the held rows: slots [0, R) are rows a0.. (the run), slots [R, held)
  // rows p_lo..p_hi (the mirrors, with row L1/2 in the last block); COMPLEX
  // needs no mirrors and holds the 2R rows from 2gR
  const int a0 = g << (kLog2Run + cplx);
  const int p_lo = cplx ? a0 + kRun : (g == groups - 1 ? l1 >> 1 : l1 - a0 - kRun + 1);
  const int p_hi = cplx ? a0 + 2 * kRun - 1 : (g == 0 ? l1 - 1 : l1 - a0);
  const int held = kRun + p_hi - p_lo + 1;
  const int stride = l2 + 1;  // a float2 of padding: the transposed reads fall on distinct banks
  const auto at = [stride, log2l2](int i, int h) { return h * stride + slot(i, log2l2); };
  const auto k1_of = [=](int h) { return h < kRun ? a0 + h : p_lo + h - kRun; };

  // the held rows of the scratch, two points a 16-byte load, kLoads loads
  // a thread in flight before the first is scattered (bit-reversed)
  const float2* y = scratch + ((size_t)row << log2l);
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
    const int pairs = (kRun << log2l2) + (g == groups - 1 ? l2 >> 1 : 0);
    // pair q: bins k <= l/2 and km = l - k in slots sk and sm (live false:
    // row 0's second half, which its first half covers)
    const auto pair_of = [&](int q, int& k, int& km, int& sk, int& sm) {
      int ha, hb, k1, k2, k2m;
      if (q < (kRun << log2l2)) {
        ha = q & (kRun - 1);
        k2 = q >> kLog2Run;
        k1 = a0 + ha;
        if (k1 == 0) {  // row 0 with itself
          if (k2 > (l2 >> 1)) return false;
          hb = ha;
          k2m = (l2 - k2) & (l2 - 1);
        } else {
          hb = kRun + (l1 - k1) - p_lo;
          k2m = l2 - 1 - k2;
        }
      } else {  // row L1/2 with itself, the first of the last block's mirrors
        k2 = q - (kRun << log2l2);
        k1 = l1 >> 1;
        ha = hb = kRun;
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

}  // namespace

// Both passes on `stream`, pass 1 then pass 2; returns the first error.
// scratch: [batch * rows, L] float2.
extern "C" int sig_window_fft_mag_long(const float* frames, const float* window,
                                       const float* twiddles, float* scratch,
                                       float* out, int batch, int channels,
                                       int w, int log2n, int mode, void* stream) {
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
  const long long blocks2 = total_rows << (log2l1 - 1 - kLog2Run);
  if (blocks1 > 0x7fffffffLL || blocks2 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  const size_t smem1 = sizeof(float2) * ((size_t)kCols << log2l1);
  const size_t smem2 = sizeof(float2) * (2 * kRun + 1) * ((1 << log2l2) + 1);
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
  long_columns_kernel<<<(unsigned)blocks1, kThreads, smem1, s>>>(frames, window, tw, y,
                                                                 channels, w, log2n, mode);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // about four radix-8 items a thread for a block's rows
  int threads2 = (2 * kRun << log2l2) / 32;
  threads2 = threads2 < 128 ? 128 : threads2;
  long_rows_kernel<<<(unsigned)blocks2, threads2, smem2, s>>>(y, tw, out, log2n, mode);
  return (int)cudaGetLastError();
}
