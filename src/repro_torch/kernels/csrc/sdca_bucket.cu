// Dense bucketed SDCA sub-epoch for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sdca_bucket.py,
// sdca_bucket_kernel (body _kernel): one worker's pass over its bucket
// tiles, per bucket m0 = X_b^T v, G = X_b^T X_b, the serial B-step
// delta recursion, then v += (sigma'/lam_n) X_b delta.
//
// What bounds it on this card: not bytes or FLOPs but the serial chain.
// Each worker visits its n/W coordinates one after another, and each
// coordinate's delta depends on the margins the previous one left; a
// logistic delta is a 40-step bisection, each step a dependent
// logf + log1pf evaluation.  The tile traffic (d_pad*B*4 bytes per
// bucket) and the Gram FLOPs are far below what the card could move in
// that time.
//
// What the design does about it: one block per worker, all W workers in
// one launch, so the W chains run side by side on W SMs; inside a block
// the chain is kept short and nothing else waits on it.
//  * One chain warp owns the chain and the worker's v (in shared memory
//    when the tiles are, else in v_out).  It holds the bucket's margins
//    (margin j in lane j % 32, slot j / 32), computes m0 = X_b^T v and
//    walks the B coordinates with m_j += c G_ij in registers.  No block
//    barrier per coordinate.
//  * kProducerWarps producer warps stage bucket b+1's tile, a and y into
//    the other of two shared-memory stages with cp.async and compute its
//    Gram matrix and q_j = sigma' G_jj / lam_n (neither depends on v)
//    while the chain works on bucket b.  One named-barrier hand-off per
//    bucket and stage (FULL: producers arrive, the chain waits; EMPTY:
//    the reverse).
//  * The logistic delta is the serial 40-step bisection walked by the
//    chain warp as a tree of kTreeLevels levels a round
//    (bisect_tree.cuh): 8 dependent evaluations instead of 40, bit for
//    bit the serial interval.  Ridge and hinge are a few operations:
//    every lane computes the same value.
// Every sum (m0_j over f, G_ij over f, (X_b delta)_f over i) runs in the
// same order as the plain loop of the earlier one-thread-per-delta
// kernel; those sums and the recursion are dense_recursion.cuh's, which
// the tensor-parallel pair (sdca_bucket_tp.cu) shares.  The tile and G sit in shared memory when two stages of them
// fit the 227 KB opt-in, else they are read from global memory (G from
// a (W, 2, B, B) scratch the wrapper allocates).  Each worker owns its v
// replica in v_out, so no two blocks write the same address.  fp32 on
// the CUDA cores: no tensor cores, no TF32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_recursion.cuh"
#include "objectives.cuh"

namespace {

constexpr int kChainThreads = 32;
constexpr int kProducerWarps = 3;
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kThreads = kChainThreads + kProducers;
constexpr int kStages = 2;
// named barriers (0 is __syncthreads)
constexpr int kBarProducers = 1;
constexpr int kBarFull = 2;    // + stage
constexpr int kBarEmpty = 4;   // + stage

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// Shared memory, in floats:
//   del (B) | per stage s: a (B), y (B), q (B) | v (d_pad) and per stage
//   x (d_pad*B) when x_in_smem | per stage G (B*B) when g_in_smem
struct Smem {
  float* del;
  float* ayq;      // stage s at ayq + 3*B*s
  float* v;        // nullptr when v lives in v_out
  float* x;        // stage s at x + d_pad*B*s; nullptr: global tiles
  float* G;        // stage s at G + B*B*s (shared or global scratch)
};

__device__ __forceinline__ Smem carve(float* smem, float* g_scratch, int w,
                                      int d_pad, int B, int x_in_smem,
                                      int g_in_smem) {
  Smem s;
  s.del = smem;
  s.ayq = s.del + B;
  float* p = s.ayq + 3 * B * kStages;
  s.v = s.x = nullptr;
  if (x_in_smem) {
    s.v = p;
    p += d_pad;
    p += (4 - (reinterpret_cast<uintptr_t>(p) / 4) % 4) % 4;  // 16 B align
    s.x = p;
    p += (size_t)kStages * d_pad * B;
  }
  s.G = g_in_smem ? p : g_scratch + (size_t)w * kStages * B * B;
  return s;
}

__device__ void producer(const Smem& sm, const float* __restrict__ xw,
                         const float* __restrict__ yb,
                         const float* __restrict__ ab, size_t row0, int nb,
                         int d_pad, int B, float lam_n, float sig) {
  const int ptid = threadIdx.x - kChainThreads;
  const size_t tile = (size_t)d_pad * B;
  const bool vec = (tile % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(xw) % 16 == 0);
  for (int b = 0; b < nb; ++b) {
    const int st = b % kStages;
    if (b >= kStages) bar_sync(kBarEmpty + st, kThreads);
    const float* xg = xw + (size_t)b * tile;
    float* ayq = sm.ayq + 3 * B * st;
    const size_t row = row0 + (size_t)b * B;
    for (int i = ptid; i < B; i += kProducers) {
      cp_async4(ayq + i, ab + row + i);
      cp_async4(ayq + B + i, yb + row + i);
    }
    const float* x = xg;
    if (sm.x != nullptr) {
      float* xs = sm.x + tile * st;
      if (vec) {
        for (size_t t = 4 * (size_t)ptid; t < tile; t += 4 * kProducers)
          cp_async16(xs + t, xg + t);
      } else {
        for (size_t t = ptid; t < tile; t += kProducers)
          cp_async4(xs + t, xg + t);
      }
      x = xs;
    }
    cp_async_wait_all();
    bar_sync(kBarProducers, kProducers);  // every producer's copies landed
    float* G = sm.G + (size_t)B * B * st;
    for (int t = ptid; t < B * B; t += kProducers) {
      const int i = t / B, j = t - (t / B) * B;
      const float s = gram_sum(x, d_pad, B, i, j);
      G[t] = s;
      if (i == j) ayq[2 * B + i] = sig * s / lam_n;
    }
    __threadfence_block();
    bar_arrive(kBarFull + st, kThreads);
  }
}

template <int OBJ, int MPL>
__device__ void chain(const Smem& sm, const float* __restrict__ xw,
                      const float* __restrict__ v0w,
                      float* __restrict__ v_outw, float* __restrict__ a_out,
                      size_t row0, int nb, int d_pad, int B, float lam_n,
                      float sig) {
  const int t = threadIdx.x, lane = t;
  const size_t tile = (size_t)d_pad * B;
  float* v = sm.v != nullptr ? sm.v : v_outw;
  for (int f = t; f < d_pad; f += kChainThreads) v[f] = v0w[f];
  __syncwarp();
  const float vscale = sig / lam_n;
  for (int b = 0; b < nb; ++b) {
    const int st = b % kStages;
    bar_sync(kBarFull + st, kThreads);
    const float* x = sm.x != nullptr ? sm.x + tile * st : xw + (size_t)b * tile;
    const float* G = sm.G + (size_t)B * B * st;
    const float* ayq = sm.ayq + 3 * B * st;

    // margins at bucket entry, one coordinate per lane and slot
    float m[MPL];
#pragma unroll
    for (int k = 0; k < MPL; ++k) {
      const int j = lane + 32 * k;
      m[k] = j < B ? margin_sum(x, v, d_pad, B, j) : 0.0f;
    }

    // the serial recursion over the bucket's coordinates
    bucket_recursion<OBJ, MPL>(m, G, B, ayq, ayq + B, ayq + 2 * B, sm.del,
                               B, lam_n, sig, lane);
    __syncwarp();

    // v += (sigma'/lam_n) X_b delta;  alpha_b += delta
    for (int f = t; f < d_pad; f += kChainThreads) {
      v[f] = v[f] + vscale * update_sum(x, sm.del, B, f);
    }
    const size_t row = row0 + (size_t)b * B;
    for (int i = t; i < B; i += kChainThreads)
      a_out[row + i] = ayq[i] + sm.del[i];
    __syncwarp();
    if (b + kStages < nb) bar_arrive(kBarEmpty + st, kThreads);
  }
  if (sm.v != nullptr) {
    for (int f = t; f < d_pad; f += kChainThreads) v_outw[f] = v[f];
  }
}

template <int OBJ, int MPL>
__global__ void __launch_bounds__(kThreads)
sdca_bucket_kernel(const float* __restrict__ xb, const float* __restrict__ yb,
                   const float* __restrict__ ab, const float* __restrict__ v0,
                   float* __restrict__ a_out, float* __restrict__ v_out,
                   float* __restrict__ g_scratch, int nb, int d_pad, int B,
                   float lam_n, float sig, int x_in_smem, int g_in_smem) {
  extern __shared__ float smem[];
  const int w = blockIdx.x;
  const Smem sm = carve(smem, g_scratch, w, d_pad, B, x_in_smem, g_in_smem);
  const size_t tile = (size_t)d_pad * B;
  const float* xw = xb + (size_t)w * nb * tile;
  const size_t row0 = (size_t)w * nb * B;
  if (threadIdx.x < kChainThreads) {
    chain<OBJ, MPL>(sm, xw, v0 + (size_t)w * d_pad,
                    v_out + (size_t)w * d_pad, a_out, row0, nb, d_pad, B,
                    lam_n, sig);
  } else {
    producer(sm, xw, yb, ab, row0, nb, d_pad, B, lam_n, sig);
  }
}

template <int OBJ, int MPL>
cudaError_t launch(const float* xb, const float* yb, const float* ab,
                   const float* v0, float* a_out, float* v_out,
                   float* g_scratch, int W, int nb, int d_pad, int B,
                   float lam_n, float sig, int x_in_smem, int g_in_smem,
                   int smem_bytes, cudaStream_t stream) {
  auto fn = sdca_bucket_kernel<OBJ, MPL>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  fn<<<W, kThreads, smem_bytes, stream>>>(xb, yb, ab, v0, a_out, v_out,
                                          g_scratch, nb, d_pad, B, lam_n,
                                          sig, x_in_smem, g_in_smem);
  return cudaGetLastError();
}

template <int OBJ>
cudaError_t launch_mpl(const float* xb, const float* yb, const float* ab,
                       const float* v0, float* a_out, float* v_out,
                       float* g_scratch, int W, int nb, int d_pad, int B,
                       float lam_n, float sig, int x_in_smem, int g_in_smem,
                       int smem_bytes, cudaStream_t s) {
#define SDCA_LAUNCH(M)                                                     \
  return launch<OBJ, M>(xb, yb, ab, v0, a_out, v_out, g_scratch, W, nb,    \
                        d_pad, B, lam_n, sig, x_in_smem, g_in_smem,        \
                        smem_bytes, s)
  if (B <= 32) SDCA_LAUNCH(1);
  if (B <= 64) SDCA_LAUNCH(2);
  if (B <= 128) SDCA_LAUNCH(4);
  if (B <= 256) SDCA_LAUNCH(8);
  SDCA_LAUNCH(16);
#undef SDCA_LAUNCH
}

}  // namespace

// B <= 512 (16 margins per lane).  Returns a cudaError_t (0 on success).
extern "C" int sdca_bucket_launch(const float* xb, const float* yb,
                                  const float* ab, const float* v0,
                                  float* a_out, float* v_out,
                                  float* g_scratch, int W, int nb, int d_pad,
                                  int B, float lam_n, float sig, int obj,
                                  int x_in_smem, int g_in_smem,
                                  int smem_bytes, void* stream) {
  if (B <= 0 || B > 512 || d_pad <= 0) return cudaErrorInvalidValue;
  if (W <= 0 || nb <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (obj) {
    case OBJ_RIDGE:
      return launch_mpl<OBJ_RIDGE>(xb, yb, ab, v0, a_out, v_out, g_scratch,
                                   W, nb, d_pad, B, lam_n, sig, x_in_smem,
                                   g_in_smem, smem_bytes, s);
    case OBJ_HINGE:
      return launch_mpl<OBJ_HINGE>(xb, yb, ab, v0, a_out, v_out, g_scratch,
                                   W, nb, d_pad, B, lam_n, sig, x_in_smem,
                                   g_in_smem, smem_bytes, s);
    case OBJ_LOGISTIC:
      return launch_mpl<OBJ_LOGISTIC>(xb, yb, ab, v0, a_out, v_out,
                                      g_scratch, W, nb, d_pad, B, lam_n, sig,
                                      x_in_smem, g_in_smem, smem_bytes, s);
    default:
      return cudaErrorInvalidValue;
  }
}
