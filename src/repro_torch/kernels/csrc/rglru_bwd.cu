// RG-LRU recurrence backward on Hopper (sm_90a).
//
// The gradient of the TPU kernel src/repro/kernels/rglru.py, rglru_kernel,
// whose function the reference's train step differentiates with
// jax.value_and_grad through its associative scan
// (src/repro/models/recurrent.py, _rglru_scan); the JAX package has no
// custom_vjp.  It replaces no Pallas kernel of its own: it is the
// backward of csrc/rglru.cu's forward,
//
//   r = sigmoid(ga_t),  i = sigmoid(gx_t),  log_a = 8 a_log[c] r
//   a = exp(log_a),  e2 = exp(2 log_a),  z = 1 - e2
//   b = sqrt(max(z, 1e-12)) (i x_t),     h_t = a h_{t-1} + b,
//
// for every (batch row, channel) from h0.  Given dh (B, T, D) in x's type
// and dh_T (B, D) f32, the gradient through the final state (zero in
// training, but honoured), with g_t = dh_t + a_{t+1} g_{t+1} the total
// gradient into h_t (g_{T-1} = dh_{T-1} + dh_T):
//
//   da = g h_{t-1},  du = g sqrt(max(z, 1e-12)),  dx = du i,
//   dgx = (du x) i (1 - i),  dz = g (i x) 0.5 / sqrt(max(z, 1e-12)) where
//   z > 1e-12 (half of it where z == 1e-12, as JAX's max splits a tie),
//   dlog_a = da a - 2 dz e2,  dga = dlog_a 8 a_log r (1 - r),
//   d a_log = 8 sum_t dlog_a r,  dh0 = a_0 g_0.
//
// One thread per (batch row, channel) walks t forward first, recomputing
// h in f32 into a scratch buffer (B, T, D) (the forward returns h in x's
// type, too coarse for da), then walks t backward, recomputing the gates,
// and writes dx, dga, dgx (x's type), dh0 and its partial of d a_log,
// (B, D) f32 each; the caller sums the partials over the batch rows in
// order, so nothing is accumulated across threads.  Built with
// -fmad=false, and with the forward's f64 exps, so every operation rounds
// as the plain PyTorch version's (kernels/rglru.py `rglru_bwd_plain`)
// separate elementwise operations do.
//
// What bounds it on this card: memory and the serial chain.  It reads x,
// ga, gx and dh once and writes dx, dga, dgx once (recurrentgemma-2b's
// train step: B 1, T 2,048, D 2,560 in bf16, ~73 MB, ~0.02 ms at 3.35
// TB/s) and writes and rereads the f32 h; each step of a walk depends on
// the one before through one multiply and add, so a thread's time is T
// steps of its latency.
//
// What the design does about it: the loads of consecutive channels are
// consecutive threads' (coalesced); the gates of a step do not depend on
// the chain, so the compiler overlaps them across the unrolled steps.  A
// block has 64 threads so that recurrentgemma's 2,560 channels spread
// over 40 SMs.  Shared memory: none.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// csrc/rglru.cu's exp: through f64, rounded once to f32
__device__ __forceinline__ float exp_rn(float v) {
  return static_cast<float>(exp(static_cast<double>(v)));
}

struct Gates {
  float r, iv, la, a, e2, z, sq, xf, u;
};

// the forward's gate arithmetic, operation for operation
__device__ __forceinline__ Gates gates(float xv, float gav, float gxv,
                                       float al8) {
  Gates s;
  s.r = 1.0f / (1.0f + expf(-gav));
  s.iv = 1.0f / (1.0f + expf(-gxv));
  s.la = al8 * s.r;
  s.a = exp_rn(s.la);
  s.e2 = exp_rn(2.0f * s.la);
  s.z = 1.0f - s.e2;
  s.sq = sqrtf(fmaxf(s.z, 1e-12f));
  s.xf = xv;
  s.u = s.iv * xv;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const T* __restrict__ x, const T* __restrict__ ga,
                 const T* __restrict__ gx, const float* __restrict__ a_log,
                 const float* __restrict__ h0, const T* __restrict__ dh,
                 const float* __restrict__ dh_last, float* __restrict__ hs,
                 T* __restrict__ dx, T* __restrict__ dga,
                 T* __restrict__ dgx, float* __restrict__ dh0,
                 float* __restrict__ dal_part, int Tn, int D) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= D) return;
  const float al8 = 8.0f * a_log[c];
  const size_t bc = (size_t)b * D + c;
  const size_t base = (size_t)b * Tn * D + c;

  // walk 1: h_t in f32
  const float h_init = h0[bc];
  float h = h_init;
#pragma unroll 4
  for (int t = 0; t < Tn; ++t) {
    const size_t i = base + (size_t)t * D;
    const Gates s = gates(to_f(x[i]), to_f(ga[i]), to_f(gx[i]), al8);
    h = s.a * h + s.sq * s.u;
    hs[i] = h;
  }

  // walk 2: g_t from the end, and each step's gradients
  float carry = dh_last[bc];
  float dal = 0.0f;
#pragma unroll 4
  for (int t = Tn - 1; t >= 0; --t) {
    const size_t i = base + (size_t)t * D;
    const Gates s = gates(to_f(x[i]), to_f(ga[i]), to_f(gx[i]), al8);
    const float g = to_f(dh[i]) + carry;
    const float hp = t > 0 ? hs[i - D] : h_init;
    const float da = g * hp;
    const float du = g * s.sq;
    const float dsq = g * s.u;
    store(&dx[i], du * s.iv);
    store(&dgx[i], (du * s.xf) * (s.iv * (1.0f - s.iv)));
    const float dmax = dsq * (0.5f / s.sq);
    const float dz = s.z > 1e-12f ? dmax : s.z == 1e-12f ? 0.5f * dmax : 0.0f;
    const float de2 = -dz;
    const float dla = da * s.a + 2.0f * (de2 * s.e2);
    dal = dal + dla * s.r;
    store(&dga[i], (dla * al8) * (s.r * (1.0f - s.r)));
    carry = s.a * g;
  }
  dh0[bc] = carry;
  dal_part[bc] = 8.0f * dal;
}

template <typename T>
int launch(const void* x, const void* ga, const void* gx, const float* a_log,
           const float* h0, const void* dh, const float* dh_last, float* hs,
           void* dx, void* dga, void* dgx, float* dh0, float* dal_part,
           int B, int Tn, int D, cudaStream_t s) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_bwd_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(ga),
      static_cast<const T*>(gx), a_log, h0, static_cast<const T*>(dh),
      dh_last, hs, static_cast<T*>(dx), static_cast<T*>(dga),
      static_cast<T*>(dgx), dh0, dal_part, Tn, D);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x, ga, gx, dh, dx, dga, dgx); a_log, h0,
// dh_last, the scratch hs (B, T, D), dh0 and dal_part f32.  Returns a
// cudaError_t (0 on success).
extern "C" int rglru_bwd_launch(const void* x, const void* ga,
                                const void* gx, const float* a_log,
                                const float* h0, const void* dh,
                                const float* dh_last, float* hs, void* dx,
                                void* dga, void* dgx, float* dh0,
                                float* dal_part, int B, int Tn, int D,
                                int dtype, void* stream) {
  if (B <= 0 || D <= 0 || Tn < 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, ga, gx, a_log, h0, dh, dh_last, hs, dx, dga, dgx,
                         dh0, dal_part, B, Tn, D, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ga, gx, a_log, h0, dh, dh_last, hs, dx,
                                 dga, dgx, dh0, dal_part, B, Tn, D, s);
  return cudaErrorInvalidValue;
}
