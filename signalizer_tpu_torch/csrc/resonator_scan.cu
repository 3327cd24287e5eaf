// Kernel H: the resonator bank's chunk recurrence and its windowed readout
// in one launch, for sm_90a.
//
// Replaces the lax.scan of signalizer_tpu/kernels/resonator.py:274-315
// (resonate_chunks: z <- z * c^W + drive_t over T chunks, a valid mask, a
// readout after every chunk when asked) and the readout after it
// (resonator_readout_complex, :318); no Pallas kernel. The drives stay one
// float32 matrix product in torch (the JAX package's einsum outside any
// kernel). (ref: continuous resonate over blob chunks,
// TransformDSP.inl:1163-1211; copyResonatorStateInto.)
//
// Layout: state [B, P, V, 2] f32 (re, im pairs); drives [B, T, P, V, 2];
// decay_re, decay_im [P, V] (c^W), decay_stride floats apart (2: the re
// and im of one [P, V, 2] tensor); valid [T] f32 (nonzero: valid) or null;
// combine [V]; gain [P]. Out: the new state [B, P, V, 2]; the final
// state's readout re, im [B, P] (sum over v in index order of
// state * combine_v, times gain) and its magnitude sqrt(re^2 + im^2); with
// readouts non-null, the magnitude after every chunk [T, B, P] (every
// chunk, valid or not: an invalid one reads the bank as it stands). The
// state update is torch's order,
//   re' = ((zr * dr) - (zi * di)) + drive_re
//   im' = ((zr * di) + (zi * dr)) + drive_im
// each operation rounded on its own (__fmul_rn and friends: nvcc would
// contract a product and a sum into an FMA), so the state is the plain
// loop's bit for bit.
//
// What bounds it on the H100: the drives are read once (12.6 MB at the
// cfg6 backlog, 16 pairs x 2 rows x 16 chunks x 1024 px x 3 vectors) and
// the state read and written once (0.8 MB): about 4 us at 3.35 TB/s.
//
// Design: one thread a (b, pixel) holds the pixel's V complex states in
// registers and walks T in order, keeping kAhead chunks' drives in flight
// (the load of chunk t + kAhead issued as chunk t is consumed). A warp's
// threads are neighbouring pixels, whose V pairs lie side by side: each
// load of a warp reads 32 neighbouring 8-byte pairs. V (2K + 1 for a
// cosine-sum window of order K: 1 to 9) is a template argument, so the
// states live in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 4;  // chunks whose drives a thread keeps in flight

struct Args {
  const float* state;
  const float* drives;
  const float* decay_re;
  const float* decay_im;
  const float* valid;
  const float* combine;
  const float* gain;
  float* state_out;
  float* re;
  float* im;
  float* mag;
  float* readouts;
  int B, T, P, decay_stride;
};

// the windowed readout of one pixel's states: (re, im) times gain, the
// sum over v in index order
template <int V>
__device__ __forceinline__ float2 readout(const float (&zr)[V], const float (&zi)[V],
                                          const float (&comb)[V], float g) {
  float sr = __fmul_rn(zr[0], comb[0]);
  float si = __fmul_rn(zi[0], comb[0]);
#pragma unroll
  for (int v = 1; v < V; ++v) {
    sr = __fadd_rn(sr, __fmul_rn(zr[v], comb[v]));
    si = __fadd_rn(si, __fmul_rn(zi[v], comb[v]));
  }
  return make_float2(__fmul_rn(sr, g), __fmul_rn(si, g));
}

__device__ __forceinline__ float magnitude(float2 z) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(z.x, z.x), __fmul_rn(z.y, z.y)));
}

template <int V>
__global__ void __launch_bounds__(kThreads) resonator_scan_kernel(Args a) {
  const int P = a.P;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= P) return;
  const int T = a.T;
  const size_t cell = (size_t)V * 2;  // one pixel's floats

  float zr[V], zi[V], dr[V], di[V], comb[V];
  const float2* st = reinterpret_cast<const float2*>(a.state + ((size_t)b * P + p) * cell);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float2 z = st[v];
    zr[v] = z.x;
    zi[v] = z.y;
    dr[v] = a.decay_re[((size_t)p * V + v) * a.decay_stride];
    di[v] = a.decay_im[((size_t)p * V + v) * a.decay_stride];
    comb[v] = a.combine[v];
  }
  const float g = a.gain[p];

  // chunk t's drives for this pixel: [V] float2, P * V pairs apart a chunk
  const float2* drv = reinterpret_cast<const float2*>(a.drives + ((size_t)b * T * P + p) * cell);
  const size_t chunk = (size_t)P * V;  // pairs a chunk
  float2 ring[kAhead][V];
  bool ok[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (i < T) {
#pragma unroll
      for (int v = 0; v < V; ++v) ring[i][v] = drv[(size_t)i * chunk + v];
      ok[i] = a.valid == nullptr || a.valid[i] != 0.f;
    }
  }
  for (int t0 = 0; t0 < T; t0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int t = t0 + i;
      if (t < T) {
        float2 d[V];
#pragma unroll
        for (int v = 0; v < V; ++v) d[v] = ring[i][v];
        const bool valid = ok[i];
        const int next = t + kAhead;
        if (next < T) {
#pragma unroll
          for (int v = 0; v < V; ++v) ring[i][v] = drv[(size_t)next * chunk + v];
          ok[i] = a.valid == nullptr || a.valid[next] != 0.f;
        }
        if (valid) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float r = __fadd_rn(__fsub_rn(__fmul_rn(zr[v], dr[v]), __fmul_rn(zi[v], di[v])), d[v].x);
            const float m = __fadd_rn(__fadd_rn(__fmul_rn(zr[v], di[v]), __fmul_rn(zi[v], dr[v])), d[v].y);
            zr[v] = r;
            zi[v] = m;
          }
        }
        if (a.readouts != nullptr) {
          a.readouts[((size_t)t * a.B + b) * P + p] = magnitude(readout<V>(zr, zi, comb, g));
        }
      }
    }
  }

  float2* out = reinterpret_cast<float2*>(a.state_out + ((size_t)b * P + p) * cell);
#pragma unroll
  for (int v = 0; v < V; ++v) out[v] = make_float2(zr[v], zi[v]);
  const float2 z = readout<V>(zr, zi, comb, g);
  const size_t o = (size_t)b * P + p;
  a.re[o] = z.x;
  a.im[o] = z.y;
  a.mag[o] = magnitude(z);
}

bool aligned8(const void* ptr) { return ((uintptr_t)ptr & 7) == 0; }

}  // namespace

// The recurrence over T chunks and the readouts: state [B, P, V, 2], drives
// [B, T, P, V, 2], decay_re/decay_im [P, V] decay_stride floats apart, valid [T] f32 or null, combine
// [V], gain [P]; out state_out [B, P, V, 2], re, im, mag [B, P], readouts
// [T, B, P] or null. V odd, 1 to 9.
extern "C" int sig_resonator_scan(
    const float* state, const float* drives, const float* decay_re, const float* decay_im,
    const float* valid, const float* combine, const float* gain, float* state_out, float* re,
    float* im, float* mag, float* readouts, int B, int T, int P, int V, int decay_stride,
    void* stream) {
  if (B < 1 || B > 65535 || T < 0 || P < 1 || decay_stride < 1 || !aligned8(state) ||
      !aligned8(drives) || !aligned8(state_out)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = {state, drives, decay_re, decay_im, valid, combine, gain, state_out, re, im, mag,
            readouts, B, T, P, decay_stride};
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  cudaStream_t s = (cudaStream_t)stream;
  switch (V) {
    case 1: resonator_scan_kernel<1><<<grid, kThreads, 0, s>>>(a); break;
    case 3: resonator_scan_kernel<3><<<grid, kThreads, 0, s>>>(a); break;
    case 5: resonator_scan_kernel<5><<<grid, kThreads, 0, s>>>(a); break;
    case 7: resonator_scan_kernel<7><<<grid, kThreads, 0, s>>>(a); break;
    case 9: resonator_scan_kernel<9><<<grid, kThreads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
