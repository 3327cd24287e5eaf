// Kernel A, cluster form: channel packing -> window -> N-point FFT -> |X|
// for rows too long for one block's shared memory (real N = 65536 and
// 131072, COMPLEX N = 32768 and 65536), each row held in the distributed
// shared memory of one thread-block cluster, for sm_90a.
//
// Replaces, for those lengths, the same TPU kernel as window_fft_mag.cu:
// signalizer_tpu/kernels/pallas_spectrum.py::fused_window_rfft_mag, with
// its callers' packing and DC/Nyquist halving folded in. Same layouts and
// modes as window_fft_mag.cu: frames [B, C, W] f32 (channel 0 left, 1
// right), window [W] f32, twiddles [N] float2 in per-stage order (entry
// half + pos is exp(-2*pi*i*pos/(2*half))); out [B, rows, N/2+1]
// magnitudes with DC and Nyquist halved, PHASE [B, 2, N/2+1, 2] halved
// complex half spectra, COMPLEX [B, N] full-circle magnitudes.
//
// What bounds it on the H100: bytes. It reads each frame sample it uses,
// the window and the twiddle table once and writes each output once: 98.3
// MB in and 67.1 MB out for 16 pairs x 16 frames x 2 x 48000 samples at
// N = 65536 (512 rows), 49.6 us at 3.35 TB/s; its ~1.5 GFLOP take 22 us
// at 67 TFLOP/s. The two-pass form (window_fft_mag_long.cu) added a
// 134 MB scratch written and read back through HBM, 4-byte stores 512 bytes
// apart and a second launch. This form keeps the row on chip:
//
// * The row's L-point complex core (L = N/2 packed real, N for COMPLEX;
//   8*L bytes: 256 KB at N = 65536, more than one block's 227 KB) is split
//   over a cluster of S blocks, L/S points each. The core is an in-place
//   radix-2 decimation-in-time transform held bit-reversed, so each eighth
//   of it ("virtual block" k, positions [k*L/8, (k+1)*L/8)) is a complete
//   L/8-point transform of the decimated input z[8n + bitrev_8(k)]. Block c
//   holds the V = 8/S virtual blocks c + S*t; their inputs are the runs
//   z[8n + V*bitrev_S(c) + (0 .. V-1)], V consecutive points, which a
//   thread reads as one 16-byte load of the frame and of the window (two
//   packed real points; four for V = 4 make a whole 32-byte sector). Each
//   block then runs the one-block form's radix-8 passes (fft_pass) on its V
//   transforms in its own shared memory. (A block holding one decimated
//   transform, V = 1, reads 8 bytes of every 32- or 64-byte sector, and
//   its loads cost more than its passes on the card.)
// * The last 3 stages mix element i of the 8 virtual blocks (elements L/8
//   apart). After a cluster barrier they run as one radix-8 pass read
//   through distributed shared memory (each value from its owner's slot(),
//   the owner's swizzle), fused with the epilogue: a work unit takes
//   elements i and L/8 - i of every virtual block (i = 0 takes 0 and L/16),
//   whose radix-8 outputs Z[i + k*L/8] and Z[L/8 - i + k*L/8] are each
//   other's partners in the real split (Z[k] with Z[L - k]). So the split,
//   the halving and |.| follow in registers, and nothing is written back to
//   shared memory or exchanged a second time. A warp's units are
//   consecutive i, so each of its stores fills 128 contiguous bytes.
//   COMPLEX stores |Z| of the same values.
// * One launch a call, grid = rows x S blocks; a last cluster barrier keeps
//   every block's shared memory alive until its peers have read it. The
//   wrapper takes S = 4 for L = 32768 and S = 8 for 65536 (64 KB a block,
//   at most 64 registers a thread; see threads_of): on the card S = 2, 4
//   and 8 took 228, 231 and 241 us for 512 rows of N = 65536 and 27, 20 and
//   19 us for 16, and at N = 131072 S = 8 beat S = 4 by 14%.
// * Twiddles: the fft_twiddles table [N] alone. Stage `half`'s are entries
//   [half, 2*half), the cross-block stages' included; the split's factors
//   exp(-2 pi i k/N) are entries [L, 2L). No fast math, no recurrences:
//   the display floor is -96 dB.
// * Left and right are never packed into one transform, so a silent row
//   stays exactly zero and a row's error is relative to its own peak.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_fft_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLog2R = 3;      // the cross-block pass is radix 8
constexpr int kMinLog2L = 7;   // at least 16 points a virtual block
constexpr int kMaxLog2L = 16;  // the longest core: 65536 complex points
constexpr size_t kMaxSmem = 227 * 1024;

// The real split of bin k (k <= L/2) with its partner L - k: X[k] and
// X[L - k] from Z[k] and Z[L - k] with the factor tw[l + k] =
// exp(-2*pi*i*k/N), DC and Nyquist halved, stored as |X| or (PHASE) the
// halved complex value. k = 0 writes DC and Nyquist (Z[L] = Z[0]); k = L/2
// writes one bin.
__device__ __forceinline__ void split_store(float* out, const float2* tw, int l,
                                            int k, float2 zk, float2 zm, bool phase) {
  const int km = l - k;
  const float2 wk = __ldg(tw + l + k);
  const float er = 0.5f * (zk.x + zm.x), ei = 0.5f * (zk.y - zm.y);
  const float dr = 0.5f * (zk.x - zm.x), di = 0.5f * (zk.y + zm.y);
  const float p = wk.x * di + wk.y * dr;
  const float q = wk.x * dr - wk.y * di;
  const float scale = k == 0 ? 0.5f : 1.f;  // DC with k, Nyquist with l-k
  const float2 xk = make_float2(er + p, ei - q);
  const float2 xm = make_float2(er - p, -ei - q);
  if (phase) {
    float2* o = reinterpret_cast<float2*>(out);
    o[k] = make_float2(xk.x * scale, xk.y * scale);
    if (km != k) o[km] = make_float2(xm.x * scale, xm.y * scale);
  } else {
    out[k] = sqrtf(xk.x * xk.x + xk.y * xk.y) * scale;
    if (km != k) out[km] = sqrtf(xm.x * xm.x + xm.y * xm.y) * scale;
  }
}

// Threads a block and the fewest blocks an SM should hold, by cluster size:
// each at most 64 registers a thread. S = 8: 32 KB a block, four an SM;
// S = 4: 64 KB, two of 512 threads; S = 2: 128 KB, one of 1024.
__host__ __device__ constexpr int threads_of(int log2s) {
  return log2s == 3 ? 256 : log2s == 2 ? 512 : 1024;
}
__host__ __device__ constexpr int min_blocks_of(int log2s) {
  return log2s == 3 ? 4 : log2s == 2 ? 2 : 1;
}

// kV = 1, 2 or 4 consecutive windowed, packed samples z[m0 .. m0 + kV) of
// row r, zero past W: one 16-byte load of the frame and of the window for
// two real samples (8 bytes for one), four COMPLEX ones, where `vec` (base
// pointers 16-byte aligned, W a multiple of four) and the run is inside W;
// scalar loads otherwise.
template <int kV>
__device__ __forceinline__ void load_run(float2 (&z)[kV], const float* left, const float* right,
                                         const float* window, int w, int m0, int mode, int r,
                                         bool use_l, bool use_r, bool vec) {
  const float zero = 0.f;
  if (mode == kComplex) {  // z[m] = (left[m] win[m], right[m] win[m])
    if constexpr (kV == 4) {
      if (vec && m0 + 4 <= w) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(left + m0));
        const float4 d = __ldg(reinterpret_cast<const float4*>(right + m0));
        const float4 win = __ldg(reinterpret_cast<const float4*>(window + m0));
        z[0] = make_float2(a.x * win.x, d.x * win.x);
        z[1] = make_float2(a.y * win.y, d.y * win.y);
        z[2] = make_float2(a.z * win.z, d.z * win.z);
        z[3] = make_float2(a.w * win.w, d.w * win.w);
        return;
      }
    }
#pragma unroll
    for (int t = 0; t < kV; ++t) {
      const int m = m0 + t;
      z[t] = m < w ? make_float2(left[m] * window[m], right[m] * window[m]) : make_float2(zero, zero);
    }
    return;
  }
  const int i0 = m0 << 1;  // z[m] = x[2m] + i x[2m+1]
  if (vec && i0 + 2 * kV <= w) {
    if constexpr (kV == 1) {
      const float2 zero2 = make_float2(0.f, 0.f);
      const float2 a = use_l ? __ldg(reinterpret_cast<const float2*>(left + i0)) : zero2;
      const float2 d = use_r ? __ldg(reinterpret_cast<const float2*>(right + i0)) : zero2;
      const float2 win = __ldg(reinterpret_cast<const float2*>(window + i0));
      z[0] = make_float2(pack(mode, r, a.x, d.x, win.x), pack(mode, r, a.y, d.y, win.y));
    } else {
      const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < kV; q += 2) {
        const int i = i0 + 2 * q;
        const float4 a = use_l ? __ldg(reinterpret_cast<const float4*>(left + i)) : zero4;
        const float4 d = use_r ? __ldg(reinterpret_cast<const float4*>(right + i)) : zero4;
        const float4 win = __ldg(reinterpret_cast<const float4*>(window + i));
        z[q] = make_float2(pack(mode, r, a.x, d.x, win.x), pack(mode, r, a.y, d.y, win.y));
        z[q + 1] = make_float2(pack(mode, r, a.z, d.z, win.z), pack(mode, r, a.w, d.w, win.w));
      }
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < kV; ++t) {
    const int i = i0 + 2 * t;
    z[t] = make_float2(zero, zero);
    if (i < w) z[t].x = pack(mode, r, use_l ? left[i] : zero, use_r ? right[i] : zero, window[i]);
    if (i + 1 < w) {
      z[t].y = pack(mode, r, use_l ? left[i + 1] : zero, use_r ? right[i + 1] : zero, window[i + 1]);
    }
  }
}

// Grid: rows * S blocks in clusters of S = 2^kLog2S, threads_of(kLog2S)
// threads (fewer for short rows), 8*L/S bytes of dynamic shared memory.
// The core is cut into R = 8 virtual blocks of L/8 points: virtual block
// k = c + S*t (t < V = 8/S) lives in block c at local offset t*L/8.
template <int kLog2S>
__global__ void __launch_bounds__(threads_of(kLog2S), min_blocks_of(kLog2S))
    window_fft_mag_cluster_kernel(const float* __restrict__ frames,
                                  const float* __restrict__ window,
                                  const float2* __restrict__ tw,
                                  float* __restrict__ out, int channels, int w,
                                  int log2n, int mode) {
  constexpr int kLog2V = kLog2R - kLog2S;
  constexpr int S = 1 << kLog2S;
  constexpr int V = 1 << kLog2V;
  constexpr int R = 1 << kLog2R;
  extern __shared__ float2 buf[];  // this block's L/S points of the core
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const bool cplx = mode == kComplex;
  const int log2l = cplx ? log2n : log2n - 1;
  const int l = 1 << log2l;
  const int log2b = log2l - kLog2S;  // this block's share: lb = L/S points
  const int lb = 1 << log2b;
  const int log2h = log2l - kLog2R;  // a virtual block: lh = L/8 points
  const int lh = 1 << log2h;
  const int rows = rows_of(mode);

  const int row = blockIdx.x >> kLog2S;
  const int b = row / rows;
  const int r = row - b * rows;
  const float* left = frames + (size_t)b * channels * w;
  const float* right = left + w;
  // the channels this mode and row read
  const bool plain_row = mode == kPhase || mode == kSeparate;
  const bool use_l = !(mode == kRight || (plain_row && r == 1));
  const bool use_r = !(mode == kLeft || (plain_row && r == 0));
  const bool vec =
      ((reinterpret_cast<uintptr_t>(left) | reinterpret_cast<uintptr_t>(right) |
        reinterpret_cast<uintptr_t>(window)) & 15) == 0 &&
      (w & 3) == 0;

  // prologue: virtual block k = c + S t holds z[8 n + bitrev_8(k)], and
  // bitrev_8(c + S t) = V bitrev_S(c) + bitrev_V(t): this block's samples
  // are the runs z[8 n + V bitrev_S(c) + (0 .. V-1)], one run a thread and
  // step, scattered to local element e = V n + t', held at bitrev(e)
  const int m_base = bit_reverse(c, kLog2S) << kLog2V;
  for (int n = threadIdx.x; n < lh; n += blockDim.x) {
    float2 z[V];
    load_run<V>(z, left, right, window, w, (n << kLog2R) + m_base, mode, r, use_l, use_r, vec);
#pragma unroll
    for (int t = 0; t < V; ++t) buf[slot(bit_reverse((n << kLog2V) + t, log2b), log2b)] = z[t];
  }
  __syncthreads();

  // the first log2(L/8) stages: the V local L/8-point transforms
  fft_in_shared(buf, tw, lb, log2b, log2h);

  // every block's share transformed before any block reads a peer's
  cluster.sync();

  // the last 3 stages across the virtual blocks, fused with the epilogue.
  // Unit u < L/16 takes elements ia = u and ib = L/8 - u (u = 0:
  // ib = L/16) of every virtual block, so each element is in one unit;
  // block c takes units [c * per, (c + 1) * per), a warp consecutive ones.
  const int per = lh >> (kLog2S + 1);  // units a block: L/(16 S)
  const int u0 = c * per;
  const bool phase = mode == kPhase;
  float* o = out + (cplx ? ((size_t)row << log2l) : (size_t)row * (l + 1) * (phase ? 2 : 1));
  for (int u = u0 + threadIdx.x; u < u0 + per; u += blockDim.x) {
    const int ia = u;
    const int ib = u ? lh - u : lh >> 1;
    float2 va[R], vb[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      // virtual block k: block k mod S, local offset (k / S) * lh
      const float2* peer = cluster.map_shared_rank(buf, k & (S - 1));
      const int off = (k >> kLog2S) << log2h;
      va[k] = peer[slot(off + ia, log2b)];
      vb[k] = peer[slot(off + ib, log2b)];
    }
    radix_stages<kLog2R>(va, tw, lh, ia);
    radix_stages<kLog2R>(vb, tw, lh, ib);
    // now va[k] = Z[ia + k L/8], vb[k] = Z[ib + k L/8]
    if (cplx) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        o[ia + k * lh] = sqrtf(va[k].x * va[k].x + va[k].y * va[k].y);
        o[ib + k * lh] = sqrtf(vb[k].x * vb[k].x + vb[k].y * vb[k].y);
      }
    } else if (u) {
      // Z[ia + k L/8] pairs with Z[L - ia - k L/8] = Z[ib + (7-k) L/8];
      // for k < 4 the first of each pair is the smaller bin (<= L/2)
#pragma unroll
      for (int k = 0; k < R / 2; ++k) {
        split_store(o, tw, l, ia + k * lh, va[k], vb[R - 1 - k], phase);
        split_store(o, tw, l, ib + k * lh, vb[k], va[R - 1 - k], phase);
      }
    } else {
      // element 0: bins k L/8 pair with (8 - k) L/8 (k = 0: DC with
      // Nyquist, k = 4: L/2 alone); element L/16: bins L/16 + k L/8 pair
      // with L/16 + (7-k) L/8
#pragma unroll
      for (int k = 0; k <= R / 2; ++k) {
        split_store(o, tw, l, k * lh, va[k], va[(R - k) & (R - 1)], phase);
      }
#pragma unroll
      for (int k = 0; k < R / 2; ++k) {
        split_store(o, tw, l, ib + k * lh, vb[k], vb[R - 1 - k], phase);
      }
    }
  }

  // no block leaves while a peer may still read its shared memory
  cluster.sync();
}

// One cluster launch of S = 2^kLog2S blocks a row on `stream`: the
// shared-memory opt-in (above 48 KB) and a check that such a cluster fits
// the card, each once per size; then the launch's own error.
template <int kLog2S>
int launch(const float* frames, const float* window, const float2* tw, float* out,
           int total_rows, int channels, int w, int log2n, int mode, size_t smem,
           int threads, cudaStream_t stream) {
  const auto kernel = window_fft_mag_cluster_kernel<kLog2S>;
  static size_t granted = 48 * 1024;  // the largest opt-in granted so far
  static size_t checked = 0;          // the last size found to fit
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)total_rows << kLog2S, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << kLog2S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem != checked) {
    int clusters = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    checked = smem;
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, frames, window, tw, out,
                                       channels, w, log2n, mode);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// One launch, clusters of 2^log2s blocks (2, 4 or 8), a cluster a row;
// returns the first CUDA error. Takes cores of L = 128 .. 65536 points
// (L = N/2 for real modes, N for COMPLEX) whose share, 8*L/S bytes, fits
// one block.
extern "C" int sig_window_fft_mag_cluster(const float* frames, const float* window,
                                          const float* twiddles, float* out,
                                          int batch, int channels, int w,
                                          int log2n, int mode, int log2s,
                                          void* stream) {
  if (mode < kLeft || mode > kComplex || w < 1 || channels < 2 || batch < 1 ||
      log2n < 1 || log2n > 30 || w > (1 << log2n) || log2s < 1 || log2s > 3) {
    return (int)cudaErrorInvalidValue;
  }
  const int log2l = mode == kComplex ? log2n : log2n - 1;
  const size_t smem = sizeof(float2) << (log2l - log2s);
  if (log2l < kMinLog2L || log2l > kMaxLog2L || smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total_rows = (long long)batch * rows_of(mode);
  if ((total_rows << log2s) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // one radix-8 item a thread and pass, up to the size's threads
  int threads = (1 << (log2l - log2s)) / 8;
  if (threads > threads_of(log2s)) threads = threads_of(log2s);
  if (threads < 32) threads = 32;
  const float2* tw = reinterpret_cast<const float2*>(twiddles);
  cudaStream_t s = (cudaStream_t)stream;
  switch (log2s) {
    case 1:
      return launch<1>(frames, window, tw, out, (int)total_rows, channels, w, log2n, mode, smem,
                       threads, s);
    case 2:
      return launch<2>(frames, window, tw, out, (int)total_rows, channels, w, log2n, mode, smem,
                       threads, s);
    default:
      return launch<3>(frames, window, tw, out, (int)total_rows, channels, w, log2n, mode, smem,
                       threads, s);
  }
}
