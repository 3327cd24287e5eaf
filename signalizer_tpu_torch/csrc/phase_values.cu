// The Spectrum's PHASE values: each pixel's mid magnitude and phase
// cancellation from the pair's complex half spectra, for sm_90a.
//
// Replaces the plain path of kernels/spectrum.py (phase_values_plain: the
// complex tap interpolation, _binmax_argbin's padded first-maximum argbin,
// the gathers and the cancellation, some sixty torch operations a call).
// The JAX package's counterpart, spectrum_values' PHASE branch in
// signalizer_tpu/kernels/spectrum.py, runs as XLA operations with no Pallas
// kernel, so this replaces no TPU kernel. (ref: TransformDSP.inl:671-850.)
//
// Layout: spec [frames, 2, nv] complex64 read as float2 (kernel A's PHASE
// output in place: row 0 the left channel, row 1 the right); the plan tables
// per pixel (interp_indices/weights [P, taps], interp_mask, single_mask,
// single_bin, chunk_lo, chunk_len [P]); scalars[0] = inv_size; out [frames,
// 2, P] f32, row 0 the mid, row 1 the cancellation. |z| is hypotf, as
// torch's complex abs on the card. Per frame and pixel:
//   interpolation pixel: il = sum_j w_j * L[idx_j], ir likewise (complex, in
//     tap order), mid = inv * (sum_j w_j * |L[idx_j]| + sum_j w_j * |R[idx_j]|),
//     m = inv * (|il| + |ir|), cancel = 1 - (m > 0 ? inv * |il + ir| / max(m, 1e-30) : 0)
//   bin-max pixel: b = the first bin of [chunk_lo, chunk_lo + chunk_len) (or
//     single_bin) where max(|L|, |R|) peaks (a strict >: the first maximum
//     wins; a NaN counts as the largest, the first NaN winning, as torch's
//     argmax has it), then with l = L[b], r = R[b]:
//     mid = inv * (|l| + |r|), cancel = 1 - (mid > 0 ? inv * |l + r| / max(mid, 1e-30) : 0)
// Each product, sum and quotient is rounded on its own, as torch's separate
// launches round it (__fmul_rn, __fadd_rn, __fdiv_rn: nvcc would contract a
// product and a sum into an FMA), so the kernel gives the plain path's
// values bit for bit wherever the plain path's sums run in tap order (1 and
// 2 taps; torch may reassociate a longer tap sum).
//
// What bounds it on the H100: the complex spectra read once and the values
// written once: at the PHASE headline (16 pairs x 128 frames, N = 4096, 1024
// px) 67.1 MB + 16.8 MB, 25 us at 3.35 TB/s. The arithmetic, two hypotf a
// bin of a chunk and seven an interpolation pixel, an IEEE division a pixel,
// is some 15 M warp instructions there, under the bytes' time at 4 a cycle
// an SM.
//
// Design: kernel B's remap, for complex input and two rows out (the two
// rows need both channels, so one thread forms both). A bin-max pixel's
// chunk is walked by kLanes lanes, the fewest (a power of two, at most 32)
// that leave each at most 32 bins of the plan's longest chunk: 1 lane at
// N = 4096 (chunks to 16 bins), 2 at 16384 (63), 8 at 65536 (249), 32 at
// 2^21 (7948). Lane k walks bins k, k + kLanes, ..., kBatch loads in
// flight, keeping its first maximum and that bin's two complex values; a
// butterfly of shuffles over the pixel's lanes keeps the largest, the
// lowest bin on ties, and the winner's values are read again. With one
// lane a warp maps 32 pixels of one frame and a block up to kMaxGroups
// frames of the same pixels; with more, a warp maps 32 / kLanes pixels of
// one frame (an interpolation pixel's lanes all form it, one writes). The
// tap count is a template parameter (1 and 2 taps in registers, other
// counts from the tables). Measured (us a call, H100 80GB HBM3 at 700 W):
// at the PHASE headline a warp of 8, 4, 2 or 1 frames 143, 78, 58, 49 (a
// thread's frames in flight together did not pay for the warps they took),
// and 1, 2, 4 or 32 lanes a pixel 45, 72, 115, 776; at 65536 points, 16 x
// 128 frames, 1, 4, 8 or 32 lanes 720, 507, 529, 1008, and 16 x 1 frames
// 57, 16, 10, 11; at 2^21, 1 x 1 frame, 1, 8 or 32 lanes 1608, 192, 50;
// one lane's walk without the batched loads 2400 against 750 at 65536
// (16 x 128 frames, one lane a pixel).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxGroups = 8;  // warps a block, a frame each
constexpr int kMaxTaps = 10;
constexpr int kBatch = 4;  // bins a lane loads at a time
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum of the two magnitudes: a NaN propagates
__device__ __forceinline__ float power(float2 l, float2 r) {
  const float a = hypotf(l.x, l.y), b = hypotf(r.x, r.y);
  return (a != a || a > b) ? a : b;
}

// torch.argmax's order: greater, or a NaN over a number (the earlier bin
// wins every tie, since the walk runs in bin order)
__device__ __forceinline__ bool beats(float v, float best) {
  return v > best || (v != v && best == best);
}

// 1 - (m > 0 ? num / max(m, 1e-30) : 0), m and num already scaled by inv
__device__ __forceinline__ float cancellation(float num, float m) {
  return __fsub_rn(1.f, m > 0.f ? __fdiv_rn(num, fmaxf(m, 1e-30f)) : 0.f);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

// acc + w * z, the product rounded first
__device__ __forceinline__ float2 cmadd(float2 acc, float2 z, float w) {
  return make_float2(__fadd_rn(acc.x, __fmul_rn(z.x, w)), __fadd_rn(acc.y, __fmul_rn(z.y, w)));
}

__device__ __forceinline__ float cabs(float2 z) { return hypotf(z.x, z.y); }

// kTaps: 1 or 2 taps held in registers; 0 takes any count up to kMaxTaps
// from the tables, tap by tap. kLanes: the lanes a pixel. kLanes 1: warp g
// of block (x, y) maps pixels 32x.. of frame y * groups + g, a pixel a
// lane. kLanes > 1: warp g of block (x, y) maps 32 / kLanes pixels of frame
// x, from pixel (y * kMaxGroups + g) * 32 / kLanes, kLanes lanes each.
template <int kTaps, int kLanes>
__global__ void __launch_bounds__(kWarp * kMaxGroups) phase_values_kernel(
    const float2* __restrict__ spec, const int* __restrict__ interp_indices,
    const float* __restrict__ interp_weights, const bool* __restrict__ interp_mask,
    const bool* __restrict__ single_mask, const int* __restrict__ single_bin,
    const int* __restrict__ chunk_lo, const int* __restrict__ chunk_len,
    const float* __restrict__ scalars, float* __restrict__ out, int frames, int P, int nv,
    int taps) {
  constexpr int kPixels = kWarp / kLanes;  // a warp's pixels
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int sub = lane % kLanes;  // the lane's place in its pixel's lanes
  int p;
  long long t;
  if (kLanes == 1) {
    p = blockIdx.x * kWarp + lane;
    t = (long long)blockIdx.y * (blockDim.x / kWarp) + warp;
    if (p >= P || t >= frames) return;
  } else {
    p = (blockIdx.y * kMaxGroups + warp) * kPixels + lane / kLanes;
    t = blockIdx.x;
    if ((blockIdx.y * kMaxGroups + warp) * kPixels >= P) return;  // the whole warp
  }
  const bool writes = p < P && sub == 0;
  if (p >= P) p = P - 1;  // past the axis: walks the last pixel with its warp, writes nothing

  const float inv = scalars[0];
  const float2* left = spec + t * 2 * (size_t)nv;  // the frame's left row
  const float2* right = left + nv;
  float mid, cancel;
  if (interp_mask[p]) {  // (a pixel's lanes alike)
    float2 il = make_float2(0.f, 0.f), ir = il;
    float ml = 0.f, mr = 0.f;
    const int* idx = interp_indices + (size_t)p * taps;
    const float* wts = interp_weights + (size_t)p * taps;
    const int n = kTaps == 0 ? taps : kTaps;  // a constant for 1 and 2 taps: unrolled
    for (int j = 0; j < n; ++j) {  // tap order, from 0 as torch's sum starts
      const int at = __ldg(idx + j);
      const float w = __ldg(wts + j);
      const float2 l = left[at], r = right[at];
      il = cmadd(il, l, w);
      ir = cmadd(ir, r, w);
      ml = __fadd_rn(ml, __fmul_rn(cabs(l), w));
      mr = __fadd_rn(mr, __fmul_rn(cabs(r), w));
    }
    mid = __fmul_rn(inv, __fadd_rn(ml, mr));
    const float m = __fmul_rn(inv, __fadd_rn(cabs(il), cabs(ir)));
    cancel = cancellation(__fmul_rn(inv, cabs(cadd(il, ir))), m);
  } else {
    int lo = single_bin[p], len = 1;
    if (!single_mask[p]) {
      lo = chunk_lo[p];
      len = chunk_len[p] > 1 ? chunk_len[p] : 1;  // a chunk of none reads its first bin, as the padded argmax does
    }
    // the lane's first maximum over bins sub, sub + kLanes, ..., kBatch
    // loads in flight at a time; the lane of sub 0 always holds the
    // chunk's first bin
    float best = -INFINITY;
    int bin = len;
    float2 l = make_float2(0.f, 0.f), r = l;
    for (int j = sub; j < len; j += kLanes * kBatch) {
      float2 a[kBatch], b[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j + u * kLanes < len) {
          a[u] = left[lo + j + u * kLanes];
          b[u] = right[lo + j + u * kLanes];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j + u * kLanes < len) {
          const float v = power(a[u], b[u]);
          if (beats(v, best)) {
            best = v;
            bin = j + u * kLanes;
            l = a[u];
            r = b[u];
          }
        }
      }
    }
    if (kLanes > 1) {
      // the largest of the pixel's lanes, the lowest bin on ties; the
      // winner's values read again. The shuffles name the pixel's lanes
      // alone: another pixel of the warp may be an interpolation pixel.
      const unsigned group =
          kLanes == kWarp ? kFull : ((1u << (kLanes % kWarp)) - 1u) << (lane & ~(kLanes - 1));
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) {
        const float v = __shfl_xor_sync(group, best, o);
        const int c = __shfl_xor_sync(group, bin, o);
        if (beats(v, best) || (!beats(best, v) && c < bin)) {
          best = v;
          bin = c;
        }
      }
      if (!writes) return;
      l = left[lo + bin];
      r = right[lo + bin];
    }
    mid = __fmul_rn(inv, __fadd_rn(cabs(l), cabs(r)));
    cancel = cancellation(__fmul_rn(inv, cabs(cadd(l, r))), mid);
  }
  if (!writes) return;
  float* o = out + (size_t)t * 2 * P + p;
  o[0] = mid;
  o[P] = cancel;
}

typedef void (*KernelFn)(const float2*, const int*, const float*, const bool*, const bool*,
                         const int*, const int*, const int*, const float*, float*, int, int,
                         int, int);

template <int kLanes>
KernelFn pick(int taps) {
  return taps == 1   ? phase_values_kernel<1, kLanes>
         : taps == 2 ? phase_values_kernel<2, kLanes>
                     : phase_values_kernel<0, kLanes>;
}

// the lanes a pixel: the fewest (a power of two, at most a warp) that
// leave a lane at most a warp's width of the plan's longest chunk
int lanes_for(int longest) {
  int lanes = 1;
  while (lanes < kWarp && longest > kWarp * lanes) lanes *= 2;
  return lanes;
}

}  // namespace

// spec [frames, 2, nv] complex64 (as float pairs) -> out [frames, 2, P] f32:
// the mid and the cancellation. longest: the plan's longest chunk (the
// banded tables' width), which picks the lanes a pixel.
extern "C" int sig_phase_values(
    const void* spec, const int* interp_indices, const float* interp_weights,
    const bool* interp_mask, const bool* single_mask, const int* single_bin,
    const int* chunk_lo, const int* chunk_len, const float* scalars, float* out, int frames,
    int P, int nv, int taps, int longest, void* stream) {
  if (taps < 1 || taps > kMaxTaps || P < 1 || nv < 1 || frames < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int lanes = lanes_for(longest);
  dim3 grid;
  int threads = kWarp * kMaxGroups;
  KernelFn kernel;
  if (lanes == 1) {
    const int groups = frames < kMaxGroups ? frames : kMaxGroups;
    const int blocks = (frames + groups - 1) / groups;
    if (blocks > 65535) return (int)cudaErrorInvalidValue;
    grid = dim3((P + kWarp - 1) / kWarp, blocks, 1);
    threads = groups * kWarp;
    kernel = pick<1>(taps);
  } else {
    const int per_block = kMaxGroups * (kWarp / lanes);
    const int blocks = (P + per_block - 1) / per_block;
    if (blocks > 65535) return (int)cudaErrorInvalidValue;
    grid = dim3(frames, blocks, 1);
    switch (lanes) {
      case 2: kernel = pick<2>(taps); break;
      case 4: kernel = pick<4>(taps); break;
      case 8: kernel = pick<8>(taps); break;
      case 16: kernel = pick<16>(taps); break;
      default: kernel = pick<32>(taps); break;
    }
  }
  kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float2*)spec, interp_indices, interp_weights, interp_mask, single_mask, single_bin,
      chunk_lo, chunk_len, scalars, out, frames, P, nv, taps);
  return (int)cudaGetLastError();
}
