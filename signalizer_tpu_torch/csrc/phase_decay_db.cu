// Kernel G: the Spectrum's PHASE display tail (the mid row's peak decay, the
// one-pole phase smoothing, the dB map of both rows) over T frames and K
// line graphs, for sm_90a.
//
// Replaces the compiled loops of post_process's PHASE branch,
// signalizer_tpu/kernels/spectrum.py:551-584: peak_decay_scan (a
// lax.associative_scan, signalizer_tpu/kernels/peak_decay.py:93) on the mid
// row and the lax.scan of the phase smoothing (:575); no Pallas kernel.
// (ref: TransformDSP.inl:1336-1341 peak filter, :1395-1419 phase smoothing.)
//
// Layout: vals [pairs, T, 2, P] f32 (row 0 the mid magnitude, row 1 the
// cancellation in [0, 1]); slope_map [P]; decay_poles [K] and phase_poles
// [K] (the decay poles to the power 0.3, computed by torch on the device so
// that the pow's rounding is the plain version's); scalars [4] = inv_size,
// lower, 1/log(upper/lower), clip_db; valid [T] f32 (nonzero: valid) or
// null; magnitude [pairs, K, rows, P] f32, of which only row 0 is read and
// written; phase [pairs, K, P] f32, updated in place; out [pairs, T, K, 2,
// P] f32. Per pixel, line graph k and frame t, when valid[t]:
//   m   = mid * 0.5
//   s   = max(pole_k * s, m)            (torch.maximum: NaN propagates)
//   tgt = cancel * m
//   ph  = tgt + pp_k * (ph - tgt)
// then out = (db(s), db(ph)), db(v) = log(max(v * slope / lower, 1e-38)) *
// dyr where v * slope / lower > 0, else clip_db. Each product, difference
// and sum of the recurrence is rounded on its own, as torch's separate
// launches round it (__fmul_rn, __fsub_rn, __fadd_rn: nvcc would contract
// a product and a sum into an FMA), so the states are the plain loop's bit
// for bit. The map forms slope / lower once a pixel and multiplies: within
// two ulps of torch's product and division, far inside the display's 1e-5.
//
// What bounds it on the H100: each value is read once and each output
// written once (16.8 MB + 33.5 MB at the Spectrum headline, 16 pairs x 128
// frames x 1024 px x 2 line graphs: 15.0 us at 3.35 TB/s); the states and
// the slope are 0.4 MB more. Each output also costs a log and some address
// arithmetic: with logf some 40 instructions an output, 10.5 M warp
// instructions at the headline, ~11 us of the card's issue slots at 4 a
// cycle an SM; with __logf about half.
//
// Design: a block is a pair, a tile of kTile pixels and up to kGroup line
// graphs, over a chunk of T. Its 128 threads stage the tile's frames in a
// ring of shared memory, kFrames frames a stage, with cp.async (16 bytes a
// copy where P is a multiple of 4), kStages - 1 stages in flight. One
// thread walks each (pixel, line graph) out of shared memory, the values
// read once for every line graph, and writes each frame's (s, ph) into a
// shared stage; then all the block's threads map that stage to dB, 4
// pixels a thread, and store 16 bytes at a time, evict-first. Where the
// grid of pixel tiles and pairs is small (the spectrogram's 1 pair x 512
// frames), T is split into chunks of a multiple of kWalkFrames frames: a
// first kernel walks the recurrence alone over every chunk but the last,
// kWalkFrames frames a stage, and writes each chunk's start states into a
// scratch; the second maps every (chunk, tile, pair) from its start,
// walking the recurrence again from that exact state: the same operations
// from the same state, so the states stay the plain loop's bit for bit. A
// walking thread first loads its stage's values into registers, so that no
// shared-memory load waits on the recurrence's chain. At T = 1 (the
// per-tick call) a kernel of its own steps each (pair, line graph, row), 4
// pixels at a time, straight from device memory: no stage, no barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                     // pixels a block
constexpr int kThreads = 128;                 // threads a block
constexpr int kGroup = 8;                     // line graphs a block, at most
constexpr int kWalkFrames = 32;               // frames a stage of the walk; a chunk is a multiple of it
constexpr int kFrames = 8;                    // frames a stage of the mapping pass
constexpr int kStages = 4;                    // stages in the mapping pass's ring
constexpr int kWalkStages = 4;                // stages in the walk pass's ring
constexpr int kItems = kGroup * kTile / kThreads;  // (pixel, line graph) walks a thread, at most
static_assert(kTile % 32 == 0 && (kGroup * kTile) % kThreads == 0 && kThreads % kTile == 0,
              "a warp walks one line graph; the walks and the map's pixels share out evenly");
static_assert(kStages >= 2 && kWalkStages >= 2, "a ring of two stages or more");
static_assert((kThreads / kTile) % 2 == 0, "the map's threads cover both rows of a frame");

struct Args {
  const float* vals;
  const float* slope_map;
  const float* decay_poles;
  const float* phase_poles;
  const float* scalars;
  const float* valid;
  float* magnitude;
  float* phase;
  float* out;
  float* starts;  // [pairs, chunks, K, 2, P]: each chunk's start (s, ph); null for one chunk
  int T, K, rows, P, chunk, chunks, groups;
};

// the ring's valid flags, in words, padded so that what follows is 16-byte aligned
__host__ __device__ constexpr int flag_words(int frames, int stages) { return (frames * stages + 3) & ~3; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// torch.maximum: a NaN in either operand is the result (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// One frame of the recurrence in torch's order, each operation rounded on
// its own, when the frame is valid.
__device__ __forceinline__ void step(float mid, float cancel, bool valid, float pole, float pp, float& s,
                                     float& ph) {
  const float m = __fmul_rn(mid, 0.5f);
  const float tgt = __fmul_rn(cancel, m);
  const float s_new = max_nan(__fmul_rn(pole, s), m);
  const float ph_new = __fadd_rn(tgt, __fmul_rn(pp, __fsub_rn(ph, tgt)));
  s = valid ? s_new : s;
  ph = valid ? ph_new : ph;
}

// The normalized dB map of v, scale = slope / lower of its pixel. The log
// is __logf (lg2.approx, within 2^-22.6 of log2 in absolute terms, times
// ln 2): within a few 1e-7 of logf, times dyr, on every argument the clamp
// lets through; logf costs some 12 FMAs and a branch more an output
// (measured in PERF.md's findings).
__device__ __forceinline__ float db(float v, float scale, float dyr, float clip_db) {
  const float x = __fmul_rn(v, scale);
  return x > 0.f ? __logf(fmaxf(x, 1e-38f)) * dyr : clip_db;
}

// Grid (P / kTile, chunks x groups, pairs). kMap: the mapping pass (walks
// its chunk from its start and stores the display); else the walk pass
// (walks every chunk but the last, writes each chunk's start). kF frames a
// stage, kS stages in the ring; kVec: P a multiple of 4 and the values and
// output 16-byte aligned (16-byte copies and stores).
template <bool kMap, int kF, int kS, bool kMasked, bool kVec>
__device__ __forceinline__ void run(const Args& a) {
  constexpr int V = kVec ? 4 : 1;
  constexpr int kQuads = kTile / V;  // a thread's V pixels of the map: quad tid % kQuads
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int P = a.P, T = a.T, K = a.K;
  const int p0 = blockIdx.x * kTile;
  const int np = min(kTile, P - p0);
  const int pair = blockIdx.z;
  const int k0 = (blockIdx.y % a.groups) * kGroup;
  const int nk = min(kGroup, K - k0);
  const int chunk = kMap ? blockIdx.y / a.groups : 0;
  const int t0 = chunk * a.chunk;
  const int n = kMap ? min(T, t0 + a.chunk) - t0 : (a.chunks - 1) * a.chunk;
  const int stages = (n + kF - 1) / kF;

  float* ring = smem;                        // [kS][kF][2][kTile]
  float* flags = ring + kS * kF * 2 * kTile;  // [kS][kF], padded to 16 bytes
  float* sp = flags + flag_words(kF, kS);     // [kF][nk][2][kTile]: the stage's (s, ph)
  const float* src = a.vals + ((size_t)pair * T + t0) * 2 * P + p0;

  // stage st: frames t0 + st kF .. into slot st % kS
  auto issue = [&](int st) {
    const int f0 = st * kF;
    const int nf = min(kF, n - f0);
    float* dst = ring + (st % kS) * kF * 2 * kTile;
    const float* from = src + (size_t)f0 * 2 * P;
    for (int i = tid; i < nf * 2 * kTile / V; i += kThreads) {
      const int q = i % kQuads, fr = i / kQuads;  // fr = frame * 2 + row
      if (V * q < np) {
        if constexpr (kVec) {
          cp_async16(dst + fr * kTile + 4 * q, from + (size_t)fr * P + 4 * q);
        } else {
          cp_async4(dst + fr * kTile + q, from + (size_t)fr * P + q);
        }
      }
    }
    if (kMasked && tid < nf) cp_async4(flags + (st % kS) * kF + tid, a.valid + t0 + f0 + tid);
  };
#pragma unroll
  for (int st = 0; st < kS - 1; ++st) {
    if (st < stages) issue(st);
    cp_commit();
  }

  // the walks: thread tid walks items tid + j kThreads, item = line graph
  // kk (a warp's) x pixel p
  const size_t plane = (size_t)a.K * 2 * P;  // a chunk's starts, or a frame's outputs
  float s[kItems], ph[kItems], pole[kItems], pp[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int item = tid + j * kThreads, kk = item / kTile, p = item % kTile;
    s[j] = ph[j] = pole[j] = pp[j] = 0.f;
    if (kk < nk && p < np) {
      const int k = k0 + kk;
      pole[j] = a.decay_poles[k];
      pp[j] = a.phase_poles[k];
      const size_t at = ((size_t)pair * K + k) * P + p0 + p;
      if (kMap && a.chunks > 1) {
        const float* st = a.starts + ((size_t)pair * a.chunks + chunk) * plane + ((size_t)k * 2) * P + p0 + p;
        s[j] = st[0];
        ph[j] = st[P];
      } else {
        s[j] = a.magnitude[(((size_t)pair * K + k) * a.rows) * P + p0 + p];
        ph[j] = a.phase[at];
      }
      if (!kMap) {  // chunk 0 starts from the state itself
        float* st = a.starts + (size_t)pair * a.chunks * plane + ((size_t)k * 2) * P + p0 + p;
        st[0] = s[j];
        st[P] = ph[j];
      }
    }
  }
  float scale[V];
  const float dyr = a.scalars[2], clip_db = a.scalars[3];
  if (kMap) {
    const float lower = a.scalars[1];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = p0 + V * (tid % kQuads) + i;
      scale[i] = p < P ? a.slope_map[p] / lower : 0.f;
    }
  }

  for (int st = 0; st < stages; ++st) {
    cp_wait<kS - 2>();
    __syncthreads();  // stage st has landed; the last stage's walks and maps are done
    if (st + kS - 1 < stages) issue(st + kS - 1);
    cp_commit();
    const float* rv = ring + (st % kS) * kF * 2 * kTile;
    const float* rf = flags + (st % kS) * kF;
    const int nf = min(kF, n - st * kF);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int item = tid + j * kThreads, kk = item / kTile, p = item % kTile;
      if (kk < nk && p < np) {
        float sj = s[j], phj = ph[j];
        float* o = sp + kk * 2 * kTile + p;
        if (nf == kF) {
          // the stage's values into registers first, so that no load waits
          // on the recurrence's chain
          float mid[kF], cancel[kF];
          bool valid[kF];
#pragma unroll
          for (int f = 0; f < kF; ++f) {
            mid[f] = rv[f * 2 * kTile + p];
            cancel[f] = rv[f * 2 * kTile + kTile + p];
            valid[f] = !kMasked || rf[f] != 0.f;
          }
#pragma unroll
          for (int f = 0; f < kF; ++f) {
            step(mid[f], cancel[f], valid[f], pole[j], pp[j], sj, phj);
            if (kMap) {
              o[f * nk * 2 * kTile] = sj;
              o[f * nk * 2 * kTile + kTile] = phj;
            }
          }
        } else {
          for (int f = 0; f < nf; ++f) {
            step(rv[f * 2 * kTile + p], rv[f * 2 * kTile + kTile + p], !kMasked || rf[f] != 0.f, pole[j], pp[j],
                 sj, phj);
            if (kMap) {
              o[f * nk * 2 * kTile] = sj;
              o[f * nk * 2 * kTile + kTile] = phj;
            }
          }
        }
        s[j] = sj;
        ph[j] = phj;
        if (!kMap && ((st + 1) * kF) % a.chunk == 0) {  // the start of chunk (st + 1) kF / chunk
          const int c = (st + 1) * kF / a.chunk;
          float* to = a.starts + ((size_t)pair * a.chunks + c) * plane + ((size_t)(k0 + kk) * 2) * P + p0 + p;
          to[0] = sj;
          to[P] = phj;
        }
      }
    }
    if constexpr (kMap) {
      __syncthreads();  // the stage's (s, ph) are in sp
      // thread tid maps row `row` of pixels V q .. V q + V - 1, frames f =
      // g, g + kFStep, ... of every line graph
      constexpr int kFStep = kThreads / kQuads / 2;
      const int q = tid % kQuads, row = (tid / kQuads) & 1, g = tid / kQuads / 2;
      const size_t frame0 = (size_t)pair * T + t0 + st * kF;
      for (int kk = 0; kk < nk && V * q < np; ++kk) {
        for (int f = g; f < nf; f += kFStep) {
          const float* from = sp + ((f * nk + kk) * 2 + row) * kTile + V * q;
          float* to = a.out + (frame0 + f) * plane + ((size_t)(k0 + kk) * 2 + row) * P + p0 + V * q;
          if constexpr (kVec) {
            const float4 v = *reinterpret_cast<const float4*>(from);
            float4 d;
            d.x = db(v.x, scale[0], dyr, clip_db);
            d.y = db(v.y, scale[1], dyr, clip_db);
            d.z = db(v.z, scale[2], dyr, clip_db);
            d.w = db(v.w, scale[3], dyr, clip_db);
            __stcs(reinterpret_cast<float4*>(to), d);
          } else {
            __stcs(to, db(from[0], scale[0], dyr, clip_db));
          }
        }
      }
    }
  }
  cp_wait<0>();
  if (kMap && chunk == a.chunks - 1) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int item = tid + j * kThreads, kk = item / kTile, p = item % kTile;
      if (kk < nk && p < np) {
        const int k = k0 + kk;
        a.magnitude[(((size_t)pair * K + k) * a.rows) * P + p0 + p] = s[j];
        a.phase[((size_t)pair * K + k) * P + p0 + p] = ph[j];
      }
    }
  }
}

// the mapping pass (every call): kFrames frames a stage
template <bool kMasked, bool kVec>
__global__ void __launch_bounds__(kThreads) phase_decay_db_kernel(Args a) {
  run<true, kFrames, kStages, kMasked, kVec>(a);
}

// the walk pass (T in more than one chunk): kWalkFrames frames a stage
template <bool kMasked, bool kVec>
__global__ void __launch_bounds__(kThreads) phase_walk_kernel(Args a) {
  run<false, kWalkFrames, kWalkStages, kMasked, kVec>(a);
}

// T = 1 (the per-tick call): a thread is a (pair, line graph, row) and V
// pixels, one step of its recurrence (row 0 the decay, row 1 the phase)
// and its dB straight from device memory, V at a time; no stage, no barrier.
// Grid: pairs x K x 2 x ceil(P / V) threads in blocks of kTickThreads.
constexpr int kTickThreads = 256;

template <bool kMasked, bool kVec>
__global__ void __launch_bounds__(kTickThreads) phase_tick_kernel(Args a, int pairs) {
  constexpr int V = kVec ? 4 : 1;
  const int P = a.P, K = a.K, quads = (P + V - 1) / V;
  long long i = (long long)blockIdx.x * kTickThreads + threadIdx.x;
  if (i >= (long long)pairs * K * 2 * quads) return;
  const int q = (int)(i % quads);
  i /= quads;
  const int row = (int)(i & 1);
  i >>= 1;
  const int k = (int)(i % K), pair = (int)(i / K);
  const bool valid = !kMasked || a.valid[0] != 0.f;
  const float pole = a.decay_poles[k], pp = a.phase_poles[k];
  const float lower = a.scalars[1], dyr = a.scalars[2], clip_db = a.scalars[3];
  const size_t p = (size_t)V * q;
  const float* mid = a.vals + (size_t)pair * 2 * P + p;
  float* state = row == 0 ? a.magnitude + (((size_t)pair * K + k) * a.rows) * P + p
                          : a.phase + ((size_t)pair * K + k) * P + p;
  float* o = a.out + (((size_t)pair * K + k) * 2 + row) * P + p;
  float m[V], c[V], st[V], slope[V];
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(m) = *reinterpret_cast<const float4*>(mid);
    *reinterpret_cast<float4*>(c) = *reinterpret_cast<const float4*>(mid + P);
    *reinterpret_cast<float4*>(st) = *reinterpret_cast<const float4*>(state);
    *reinterpret_cast<float4*>(slope) = *reinterpret_cast<const float4*>(a.slope_map + p);
  } else {
    m[0] = mid[0];
    c[0] = mid[P];
    st[0] = state[0];
    slope[0] = a.slope_map[p];
  }
  float d[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float s = st[e], ph = st[e];
    step(m[e], c[e], valid, pole, pp, s, ph);
    st[e] = row == 0 ? s : ph;
    d[e] = db(st[e], slope[e] / lower, dyr, clip_db);
  }
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(state) = *reinterpret_cast<const float4*>(st);
    __stcs(reinterpret_cast<float4*>(o), *reinterpret_cast<const float4*>(d));
  } else {
    state[0] = st[0];
    __stcs(o, d[0]);
  }
}

typedef void (*KernelFn)(Args);

// dynamic shared memory of a pass: the ring, its flags and (mapping) a
// stage's (s, ph) of nk line graphs
constexpr size_t smem_of(int frames, int stages, int nk, bool map) {
  return sizeof(float) * ((size_t)stages * frames * 2 * kTile + flag_words(frames, stages) +
                          (map ? (size_t)frames * nk * 2 * kTile : 0));
}

int launch(KernelFn fn, dim3 grid, size_t smem, const Args& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fn<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kMasked, bool kVec>
int launch_passes(const Args& a, int pairs, cudaStream_t stream) {
  if (a.T == 1) {
    const long long threads = (long long)pairs * a.K * 2 * ((a.P + (kVec ? 3 : 0)) / (kVec ? 4 : 1));
    if (threads > 0x7fffffffLL * kTickThreads) return (int)cudaErrorInvalidValue;
    phase_tick_kernel<kMasked, kVec><<<(unsigned)((threads + kTickThreads - 1) / kTickThreads), kTickThreads, 0,
                                      stream>>>(a, pairs);
    return (int)cudaGetLastError();
  }
  const int tiles = (a.P + kTile - 1) / kTile;
  const int nk = a.K < kGroup ? a.K : kGroup;
  if (a.chunks > 1) {
    const int err = launch(phase_walk_kernel<kMasked, kVec>, dim3(tiles, a.groups, pairs),
                           smem_of(kWalkFrames, kWalkStages, nk, false), a, stream);
    if (err != 0) return err;
  }
  return launch(phase_decay_db_kernel<kMasked, kVec>, dim3(tiles, a.chunks * a.groups, pairs),
                smem_of(kFrames, kStages, nk, true), a, stream);
}

}  // namespace

// The PHASE tail: vals [pairs, T, 2, P], magnitude [pairs, K, rows, P]
// (row 0 updated in place), phase [pairs, K, P] (updated in place), out
// [pairs, T, K, 2, P]; valid [T] f32 or null. T in chunks of chunk_frames
// frames: one chunk (chunk_frames >= T) is one launch and starts may be
// null; more take starts [pairs, chunks, K, 2, P] f32 as scratch and
// chunk_frames a multiple of kWalkFrames, and launch the walk pass first.
extern "C" int sig_phase_decay_db(
    const float* vals, const float* slope_map, const float* decay_poles,
    const float* phase_poles, const float* scalars, const float* valid,
    float* magnitude, float* phase, float* out, float* starts, int pairs, int T, int K, int rows,
    int P, int chunk_frames, void* stream) {
  if (pairs < 1 || pairs > 65535 || T < 1 || K < 1 || rows < 1 || P < 1 || chunk_frames < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunks = chunk_frames >= T ? 1 : (T + chunk_frames - 1) / chunk_frames;
  const int groups = (K + kGroup - 1) / kGroup;
  if ((long long)chunks * groups > 65535) return (int)cudaErrorInvalidValue;
  if (chunks > 1 && (starts == nullptr || chunk_frames % kWalkFrames != 0)) return (int)cudaErrorInvalidValue;
  Args a = {vals, slope_map, decay_poles, phase_poles, scalars, valid, magnitude, phase, out, starts,
            T, K, rows, P, chunks > 1 ? chunk_frames : T, chunks, groups};
  const bool vec = P % 4 == 0 && (((uintptr_t)vals | (uintptr_t)out | (uintptr_t)magnitude | (uintptr_t)phase |
                                   (uintptr_t)slope_map) % 16) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (valid != nullptr) return vec ? launch_passes<true, true>(a, pairs, s) : launch_passes<true, false>(a, pairs, s);
  return vec ? launch_passes<false, true>(a, pairs, s) : launch_passes<false, false>(a, pairs, s);
}
