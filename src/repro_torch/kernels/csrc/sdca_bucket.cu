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
// What the design does about it: one thread block per worker, all P*K
// workers in one launch (the TPU's sequential "arbitrary" grid becomes a
// loop over buckets inside the block), so the W chains run side by side
// on W SMs.  The block's threads share the parallel work of a bucket
// (tile staging, margins, the B*B Gram, the v update, and the per-step
// margin update m += coef*G_i); one thread runs the delta of each
// coordinate.  The tile and G sit in shared memory when they fit the
// 227 KB opt-in, else they are read from global memory (G from a
// (W, B, B) scratch the wrapper allocates).  Each worker owns its v
// replica in v_out, so no two blocks write the same address.  fp32 FMA
// on the CUDA cores: no tensor cores, no TF32.
#include <cuda_runtime.h>

#include "objectives.cuh"

namespace {

constexpr int kThreads = 256;

template <int OBJ>
__global__ void __launch_bounds__(kThreads)
sdca_bucket_kernel(const float* __restrict__ xb, const float* __restrict__ yb,
                   const float* __restrict__ ab, const float* __restrict__ v0,
                   float* __restrict__ a_out, float* __restrict__ v_out,
                   float* __restrict__ g_scratch, int nb, int d_pad, int B,
                   float lam_n, float sig, int x_in_smem, int g_in_smem) {
  extern __shared__ float smem[];
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  float* m_s = smem;                 // (B,) running margins
  float* del_s = m_s + B;            // (B,) deltas
  float* coef_s = del_s + B;         // (4,) broadcast slot
  float* x_s = coef_s + 4;           // (d_pad, B) tile when x_in_smem
  float* G = g_in_smem ? x_s + (x_in_smem ? (size_t)d_pad * B : 0)
                       : g_scratch + (size_t)w * B * B;

  const size_t tile = (size_t)d_pad * B;
  const float* xw = xb + (size_t)w * nb * tile;
  float* v = v_out + (size_t)w * d_pad;
  for (int f = tid; f < d_pad; f += blockDim.x) {
    v[f] = v0[(size_t)w * d_pad + f];
  }
  const float vscale = sig / lam_n;
  __syncthreads();

  for (int b = 0; b < nb; ++b) {
    const float* xg = xw + (size_t)b * tile;
    const float* x = xg;
    if (x_in_smem) {
      for (size_t t = tid; t < tile; t += blockDim.x) x_s[t] = xg[t];
      x = x_s;
      __syncthreads();
    }
    // margins at bucket entry and the bucket Gram matrix
    for (int i = tid; i < B; i += blockDim.x) {
      float s = 0.0f;
      for (int f = 0; f < d_pad; ++f) s += x[(size_t)f * B + i] * v[f];
      m_s[i] = s;
    }
    for (int t = tid; t < B * B; t += blockDim.x) {
      const int i = t / B, j = t - (t / B) * B;
      float s = 0.0f;
      for (int f = 0; f < d_pad; ++f) {
        s += x[(size_t)f * B + i] * x[(size_t)f * B + j];
      }
      G[t] = s;
    }
    __syncthreads();

    // the serial recursion over the bucket's coordinates
    const size_t row = ((size_t)w * nb + b) * B;
    for (int i = 0; i < B; ++i) {
      if (tid == 0) {
        const float q = sig * G[i * B + i] / lam_n;
        const float d = obj_delta<OBJ>(m_s[i], ab[row + i], yb[row + i], q);
        del_s[i] = d;
        coef_s[0] = sig * d / lam_n;
      }
      __syncthreads();
      const float c = coef_s[0];
      for (int j = tid; j < B; j += blockDim.x) m_s[j] += c * G[i * B + j];
      __syncthreads();
    }

    // v += (sigma'/lam_n) X_b delta;  alpha_b += delta
    for (int f = tid; f < d_pad; f += blockDim.x) {
      float s = 0.0f;
      for (int i = 0; i < B; ++i) s += x[(size_t)f * B + i] * del_s[i];
      v[f] = v[f] + vscale * s;
    }
    for (int i = tid; i < B; i += blockDim.x) {
      a_out[row + i] = ab[row + i] + del_s[i];
    }
    __syncthreads();
  }
}

template <int OBJ>
cudaError_t launch(const float* xb, const float* yb, const float* ab,
                   const float* v0, float* a_out, float* v_out,
                   float* g_scratch, int W, int nb, int d_pad, int B,
                   float lam_n, float sig, int x_in_smem, int g_in_smem,
                   int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sdca_bucket_kernel<OBJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  sdca_bucket_kernel<OBJ><<<W, kThreads, smem_bytes, stream>>>(
      xb, yb, ab, v0, a_out, v_out, g_scratch, nb, d_pad, B, lam_n, sig,
      x_in_smem, g_in_smem);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sdca_bucket_launch(const float* xb, const float* yb,
                                  const float* ab, const float* v0,
                                  float* a_out, float* v_out,
                                  float* g_scratch, int W, int nb, int d_pad,
                                  int B, float lam_n, float sig, int obj,
                                  int x_in_smem, int g_in_smem,
                                  int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (obj) {
    case OBJ_RIDGE:
      return launch<OBJ_RIDGE>(xb, yb, ab, v0, a_out, v_out, g_scratch, W,
                               nb, d_pad, B, lam_n, sig, x_in_smem,
                               g_in_smem, smem_bytes, s);
    case OBJ_HINGE:
      return launch<OBJ_HINGE>(xb, yb, ab, v0, a_out, v_out, g_scratch, W,
                               nb, d_pad, B, lam_n, sig, x_in_smem,
                               g_in_smem, smem_bytes, s);
    case OBJ_LOGISTIC:
      return launch<OBJ_LOGISTIC>(xb, yb, ab, v0, a_out, v_out, g_scratch,
                                  W, nb, d_pad, B, lam_n, sig, x_in_smem,
                                  g_in_smem, smem_bytes, s);
    default:
      return cudaErrorInvalidValue;
  }
}
