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
// accumulates past rtol 1e-5 over a few hundred steps).
//
// What bounds it on this card: bytes.  It reads x, ga, gx once and
// writes h once (recurrentgemma-2b's prefill: B 2, T 4,096, D 2,560 in
// bf16 is ~168 MB, ~0.05 ms at 3.35 TB/s); its ~20 flops per element
// are nothing beside that.  The recurrence is serial in t.
//
// What the design does about it (simple first): one thread per (batch
// row, channel) walks t in order, so neighbouring threads read and
// write neighbouring channels (coalesced).  The loads do not depend on
// h, so each thread holds 16 steps of x, ga, gx in registers and issues
// the next 16 steps' loads before it walks the current ones: the gate
// math of 16 independent steps overlaps one memory round trip, and
// only h_t = a h + b is serial (a loop that loads each step as it walks
// it waits for memory every step).  B x D is only 5,120 threads at
// recurrentgemma's width, 80 blocks of 64: far from filling 132 SMs.  A chunked scan over t (each chunk's
// (prod a, h) pair combined afterwards) is the later fix.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kChunk = 16;  // time steps loaded ahead, per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// exp of an f32 through f64, rounded once to f32: the plain version's
// exp (kernels/rglru.py `_exp`), so the decay a_t rounds alike in both.
__device__ __forceinline__ float exp_rn(float v) {
  return static_cast<float>(exp(static_cast<double>(v)));
}

template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x,
                                           const T* __restrict__ ga,
                                           const T* __restrict__ gx,
                                           size_t e, int n, int D,
                                           float (&xv)[kChunk],
                                           float (&gav)[kChunk],
                                           float (&gxv)[kChunk]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (j < n) {
      const size_t i = e + (size_t)j * D;
      xv[j] = to_f(x[i]);
      gav[j] = to_f(ga[i]);
      gxv[j] = to_f(gx[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ ga,
             const T* __restrict__ gx, const float* __restrict__ a_log,
             const float* __restrict__ h0, T* __restrict__ out,
             float* __restrict__ h_last, int Tn, int D) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= D) return;
  const float al8 = 8.0f * a_log[c];
  float h = h0[(size_t)b * D + c];
  const size_t base = (size_t)b * Tn * D + c;
  float xv[kChunk], gav[kChunk], gxv[kChunk];
  load_chunk(x, ga, gx, base, min(kChunk, Tn), D, xv, gav, gxv);
  for (int t0 = 0; t0 < Tn; t0 += kChunk) {
    const int n = min(kChunk, Tn - t0);
    float a[kChunk], bt[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {   // the gates: independent steps
      if (j < n) {
        const float r = 1.0f / (1.0f + expf(-gav[j]));
        const float iv = 1.0f / (1.0f + expf(-gxv[j]));
        const float log_a = al8 * r;
        a[j] = exp_rn(log_a);
        bt[j] = sqrtf(fmaxf(1.0f - exp_rn(2.0f * log_a), 1e-12f)) *
                (iv * xv[j]);
      }
    }
    if (t0 + kChunk < Tn)   // the next chunk's loads fly under the chain
      load_chunk(x, ga, gx, base + (size_t)(t0 + kChunk) * D,
                 min(kChunk, Tn - t0 - kChunk), D, xv, gav, gxv);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {   // the recurrence: serial in t
      if (j < n) {
        h = a[j] * h + bt[j];
        store(&out[base + (size_t)(t0 + j) * D], h);
      }
    }
  }
  h_last[(size_t)b * D + c] = h;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Returns a cudaError_t (0 on success).
extern "C" int rglru_launch(const void* x, const void* ga, const void* gx,
                            const float* a_log, const float* h0, void* out,
                            float* h_last, int B, int Tn, int D, int dtype,
                            void* stream) {
  if (B <= 0 || D <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  if (dtype == 0) {
    rglru_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(ga),
        static_cast<const float*>(gx), a_log, h0, static_cast<float*>(out),
        h_last, Tn, D);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    rglru_kernel<bf><<<grid, kThreads, 0, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(ga),
        static_cast<const bf*>(gx), a_log, h0, static_cast<bf*>(out), h_last,
        Tn, D);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
