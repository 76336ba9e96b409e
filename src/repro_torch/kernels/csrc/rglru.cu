// RG-LRU gated linear recurrence on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru.py, rglru_kernel (body
// _kernel): for every batch row and channel c, over t = 0 .. T-1,
//
//   r = sigmoid(ga_t),  i = sigmoid(gx_t),  log_a = 8 a_log[c] r
//   a = exp(log_a),  b = sqrt(max(1 - exp(2 log_a), 1e-12)) (i x_t)
//   h_t = a h_{t-1} + b
//
// from h0, with the gate math fused.  x, ga, gx are (B, T, D) in f32 or
// bf16 (one source, templated on the type), a_log (D,) and h0 (B, D)
// f32.  Outputs: h (B, T, D) in x's type, and the final state (B, D) in
// f32, before any rounding to x's type: the decode cache is seeded from
// it (the TPU kernel's second output, h_ref, which its JAX wrapper
// drops).  Built with -fmad=false, so each multiply and add rounds as
// the plain PyTorch version's separate elementwise operations do; the
// two exps of the decay go through f64 and round once, as the plain
// version's do (f32 exp is off by up to an ulp, which the recurrence
// accumulates past rtol 1e-5 over a few hundred steps).  So the kernel
// is bitwise equal to the plain version.
//
// What bounds it on this card.  It reads x, ga, gx once and writes h
// once (recurrentgemma-2b's prefill: B 2, T 4,096, D 2,560 in bf16 is
// ~168 MB, ~0.05 ms at 3.35 TB/s).  Only h_t = a h + b is serial: one
// multiply and one add a step.  The gate math is not: two f64 exps, two
// f32 expfs, two IEEE divides and a sqrt per element, independent of h,
// and the larger part of the work.
//
// What the design does about it.  One block per (batch row, group of
// kGroup channels).  Warp 0 is the chain: lane = channel, it walks t in
// order over tiles of kTile steps that sit in a ring of kStages stages
// in shared memory, reading a_t and b_t and writing h_t over b_t.  The
// other kProducerWarps warps feed it: each thread owns one (step, 8
// channels) item of every tile, loads the item's x, ga, gx one tile
// ahead with 16-byte loads, computes its a and b into the ring, and,
// once the chain has walked that stage, stores the finished h of its
// item to global memory as one 16-byte store (the chain itself would
// store 2-4 bytes a lane a step).  The stages are handed over at named
// barriers (csrc/sync.cuh): "full" (producers arrive, the chain waits)
// and "empty" (the chain arrives, producers wait).  A channel's
// per-step arithmetic is the one-thread kernel's, operation for
// operation; the parallelism is in the gate math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sync.cuh"

namespace {

// 16 channels and 4 producer warps a block: 320 blocks at recurrentgemma's
// (2, 2,560), at most 3 on an SM.  32 channels (160 blocks, 2 on some SMs
// and 1 on others) and 8 (640 blocks of 16-byte rows) ran slower on the
// H100 (PERF.md, section 6).
constexpr int kGroup = 16;  // channels per block: chain lanes
constexpr int kChunk = 8;   // channels per producer item
constexpr int kProducerWarps = 4;
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kThreads = 32 + kProducers;
constexpr int kTile = kProducers * kChunk / kGroup;  // steps per stage
constexpr int kStages = 4;
constexpr int kWalk = 16;  // steps the chain reads ahead of its walk
constexpr int kBarFull = 1;             // ids 1 .. kStages
constexpr int kBarEmpty = 1 + kStages;  // ids kStages + 1 .. 2 kStages
constexpr int kStageFloats = kTile * kGroup;
static_assert(kGroup % kChunk == 0 && kGroup <= 32, "group");
static_assert(kTile % kWalk == 0, "tile");
static_assert(2 * kStages <= 15, "named barriers");
static_assert(2 * kStages * kStageFloats * 4 <= 48 * 1024, "static smem");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Eight consecutive elements of T as 16-byte words.
template <typename T>
struct Vec8 {
  static constexpr int kWords = kChunk * sizeof(T) / 16;
  union {
    uint4 w[kWords];
    T e[kChunk];
  };
};

// The n (<= 8) valid elements at p, zeros past them: 16-byte loads when
// the whole chunk is valid and aligned (`vec`), else one by one.
template <typename T>
__device__ __forceinline__ Vec8<T> load8(const T* __restrict__ p, int n,
                                         bool vec) {
  Vec8<T> r;
  if (vec && n == kChunk) {
#pragma unroll
    for (int i = 0; i < Vec8<T>::kWords; ++i)
      r.w[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      r.e[i] = i < n ? p[i] : T(0.0f);
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ p,
                                       const float (&h)[kChunk], int n,
                                       bool vec) {
  Vec8<T> r;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) r.e[i] = T(h[i]);
  if (vec && n == kChunk) {
#pragma unroll
    for (int i = 0; i < Vec8<T>::kWords; ++i)
      reinterpret_cast<uint4*>(p)[i] = r.w[i];
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < n) p[i] = r.e[i];
  }
}

// exp of an f32 through f64, rounded once to f32: the plain version's
// exp (kernels/rglru.py `_exp`), so the decay a_t rounds alike in both.
__device__ __forceinline__ float exp_rn(float v) {
  return static_cast<float>(exp(static_cast<double>(v)));
}

// a_t and b_t of one item's eight channels, into the ring.
template <typename T>
__device__ __forceinline__ void gates(const Vec8<T>& x, const Vec8<T>& ga,
                                      const Vec8<T>& gx,
                                      const float (&al8)[kChunk],
                                      float* __restrict__ sa,
                                      float* __restrict__ sb) {
  float a[kChunk], b[kChunk];
#pragma unroll
  for (int e = 0; e < kChunk; ++e) {
    const float r = 1.0f / (1.0f + expf(-to_f(ga.e[e])));
    const float iv = 1.0f / (1.0f + expf(-to_f(gx.e[e])));
    const float log_a = al8[e] * r;
    a[e] = exp_rn(log_a);
    b[e] = sqrtf(fmaxf(1.0f - exp_rn(2.0f * log_a), 1e-12f)) *
           (iv * to_f(x.e[e]));
  }
#pragma unroll
  for (int i = 0; i < kChunk; i += 4) {
    *reinterpret_cast<float4*>(sa + i) = make_float4(a[i], a[i + 1],
                                                     a[i + 2], a[i + 3]);
    *reinterpret_cast<float4*>(sb + i) = make_float4(b[i], b[i + 1],
                                                     b[i + 2], b[i + 3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ ga,
             const T* __restrict__ gx, const float* __restrict__ a_log,
             const float* __restrict__ h0, T* __restrict__ out,
             float* __restrict__ h_last, int Tn, int D, int vec) {
  // [stage][step][channel]: a_t; b_t, which the chain overwrites with h_t
  __shared__ __align__(16) float ring_a[kStages * kStageFloats];
  __shared__ __align__(16) float ring_b[kStages * kStageFloats];
  const int b = blockIdx.y;
  const int cg = blockIdx.x * kGroup;
  const int ntiles = (Tn + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x < 32) {  // the chain
    // lanes past the group read lane 0's column and store nothing
    const int l = lane < kGroup ? lane : 0;
    const int c = cg + lane;
    const bool own = lane < kGroup && c < D;
    float h = own ? h0[(size_t)b * D + c] : 0.0f;
    for (int k = 0; k < ntiles; ++k) {
      const int s = k % kStages;
      const int n = min(kTile, Tn - k * kTile);
      const float* sa = ring_a + s * kStageFloats + l;
      float* sb = ring_b + s * kStageFloats + l;
      bar_sync(kBarFull + s, kThreads);
      for (int t0 = 0; t0 < n; t0 += kWalk) {
        float av[kWalk], bv[kWalk];
#pragma unroll
        for (int j = 0; j < kWalk; ++j) {
          av[j] = sa[(t0 + j) * kGroup];
          bv[j] = sb[(t0 + j) * kGroup];
        }
        const int m = min(kWalk, n - t0);
#pragma unroll
        for (int j = 0; j < kWalk; ++j) {
          if (j < m) {
            h = av[j] * h + bv[j];
            if (lane < kGroup) sb[(t0 + j) * kGroup] = h;
          }
        }
      }
      bar_arrive(kBarEmpty + s, kThreads);
    }
    if (own) h_last[(size_t)b * D + c] = h;
    return;
  }

  // the producers: thread p owns step `row` and channels c0 .. c0 + 7 of
  // every tile; nc of them are real (<= 0: the item lies past D)
  const int p = threadIdx.x - 32;
  const int row = p / (kGroup / kChunk);
  const int col = (p % (kGroup / kChunk)) * kChunk;
  const int c0 = cg + col;
  const int nc = min(kChunk, D - c0);
  const int slot = row * kGroup + col;
  float al8[kChunk];
#pragma unroll
  for (int e = 0; e < kChunk; ++e)
    al8[e] = e < nc ? 8.0f * a_log[c0 + e] : 0.0f;
  const size_t base = ((size_t)b * Tn + row) * D + c0;
  auto real = [&](int k) { return nc > 0 && k * kTile + row < Tn; };
  auto at = [&](int k) { return base + (size_t)k * kTile * D; };
  auto store_h = [&](int k) {
    if (!real(k)) return;
    const float* sh = ring_b + (k % kStages) * kStageFloats + slot;
    float h[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(sh + i);
      h[i] = v.x, h[i + 1] = v.y, h[i + 2] = v.z, h[i + 3] = v.w;
    }
    store8(out + at(k), h, nc, vec);
  };

  const int n0 = real(0) ? nc : 0;
  Vec8<T> nx = load8(x + base, n0, vec), nga = load8(ga + base, n0, vec),
          ngx = load8(gx + base, n0, vec);
  for (int k = 0; k < ntiles; ++k) {
    const int s = k % kStages;
    const Vec8<T> cx = nx, cga = nga, cgx = ngx;
    if (k + 1 < ntiles) {  // the next tile's loads fly under this one
      const int n1 = real(k + 1) ? nc : 0;
      const size_t i = at(k + 1);
      nx = load8(x + i, n1, vec);
      nga = load8(ga + i, n1, vec);
      ngx = load8(gx + i, n1, vec);
    }
    if (k >= kStages) {  // the stage holds tile k - kStages: once walked,
                         // store its h
      bar_sync(kBarEmpty + s, kThreads);
      store_h(k - kStages);
    }
    if (real(k))
      gates(cx, cga, cgx, al8, ring_a + s * kStageFloats + slot,
            ring_b + s * kStageFloats + slot);
    bar_arrive(kBarFull + s, kThreads);
  }
  for (int k = max(ntiles - kStages, 0); k < ntiles; ++k) {
    bar_sync(kBarEmpty + k % kStages, kThreads);
    store_h(k);
  }
}

template <typename T>
int launch(const void* x, const void* ga, const void* gx, const float* a_log,
           const float* h0, void* out, float* h_last, int B, int Tn, int D,
           cudaStream_t s) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(ga) |
                        reinterpret_cast<uintptr_t>(gx) |
                        reinterpret_cast<uintptr_t>(out);
  const int vec = D % kChunk == 0 && any % 16 == 0;
  const dim3 grid((D + kGroup - 1) / kGroup, B);
  rglru_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(ga),
      static_cast<const T*>(gx), a_log, h0, static_cast<T*>(out), h_last,
      Tn, D, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Returns a cudaError_t (0 on success).
extern "C" int rglru_launch(const void* x, const void* ga, const void* gx,
                            const float* a_log, const float* h0, void* out,
                            float* h_last, int B, int Tn, int D, int dtype,
                            void* stream) {
  if (B <= 0 || D <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, ga, gx, a_log, h0, out, h_last, B, Tn, D, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ga, gx, a_log, h0, out, h_last, B, Tn,
                                 D, s);
  return cudaErrorInvalidValue;
}
