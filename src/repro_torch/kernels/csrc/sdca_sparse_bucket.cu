// Sparse (padded-CSR) bucketed SDCA sub-epoch for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sdca_sparse_bucket.py,
// sdca_sparse_bucket_kernel (bodies _kernel, _gather_rows,
// _bucket_recursion): per bucket, gather the touched entries of v into
// a working set W, run the serial recursion on W with feature-match
// corrections, and scatter the update rows back into v in visiting
// order.
//
// What bounds it on this card: the serial chain of n/W coordinates per
// worker.  Each coordinate's margin needs the updates of every earlier
// coordinate that shares a feature, and a logistic delta is a 40-step
// bisection of dependent logf + log1pf evaluations.  The bytes (the
// idx/val tiles, nnz entries of v per row) and FLOPs are a small
// fraction of what the card could do in that time.
//
// What the design does about it: one thread block per worker, all P*K
// workers in one launch, each walking its buckets in a loop (the TPU's
// sequential grid).  v stays in global memory (at d = 1M it is 4 MB, far
// over shared memory); each worker owns its replica in v_out.  The
// bucket's idx/val tile, W and the update rows U live in shared memory,
// so a coordinate touches v only through W; one thread runs the margin
// and the delta, the block applies the corrections and the ordered
// scatter in parallel.
//
// Bitwise contract with the plain scan (core/sdca.py sparse_scan), for
// any rows: built with -fmad=false, every multiply and add is a separate
// IEEE operation as in the scan; the margin is summed left to right over
// k; u = (sigma' delta / lam_n) * val is formed once per entry; W[j,k]
// receives the same u values, in the same (coordinate, k) order, that
// the scan adds into v[idx[j,k]]; the final scatter adds U into each
// touched v entry in i-major, k-minor order, one leader thread per
// distinct feature id.
#include <cuda_runtime.h>

#include "objectives.cuh"

namespace {

constexpr int kThreads = 256;

template <int OBJ>
__global__ void __launch_bounds__(kThreads)
sdca_sparse_bucket_kernel(const int* __restrict__ idxb,
                          const float* __restrict__ valb,
                          const float* __restrict__ yb,
                          const float* __restrict__ ab,
                          const float* __restrict__ qb,
                          const float* __restrict__ v0,
                          float* __restrict__ a_out,
                          float* __restrict__ v_out, int nb, int B, int nnz,
                          int d_pad, float lam_n, float sig) {
  extern __shared__ float smem[];
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int E = B * nnz;
  int* idx_s = reinterpret_cast<int*>(smem);   // (B, nnz)
  float* val_s = smem + E;                     // (B, nnz)
  float* W_s = val_s + E;                      // (B, nnz) working set
  float* U_s = W_s + E;                        // (B, nnz) update rows
  float* del_s = U_s + E;                      // (B,)
  float* coef_s = del_s + B;                   // (4,) broadcast slot

  float* v = v_out + (size_t)w * d_pad;
  for (int f = tid; f < d_pad; f += blockDim.x) {
    v[f] = v0[(size_t)w * d_pad + f];
  }
  __syncthreads();

  for (int b = 0; b < nb; ++b) {
    const size_t tile = ((size_t)w * nb + b) * E;
    const size_t row = ((size_t)w * nb + b) * B;
    for (int t = tid; t < E; t += blockDim.x) {
      idx_s[t] = idxb[tile + t];
      val_s[t] = valb[tile + t];
    }
    __syncthreads();
    // bucket entry: gather the touched rows of v (its only reads)
    for (int t = tid; t < E; t += blockDim.x) W_s[t] = v[idx_s[t]];
    __syncthreads();

    for (int i = 0; i < B; ++i) {
      const int ri = i * nnz;
      if (tid == 0) {
        float m = 0.0f;
        for (int k = 0; k < nnz; ++k) m = m + W_s[ri + k] * val_s[ri + k];
        const float q = sig * qb[row + i] / lam_n;
        const float d = obj_delta<OBJ>(m, ab[row + i], yb[row + i], q);
        del_s[i] = d;
        coef_s[0] = sig * d / lam_n;
      }
      __syncthreads();
      const float c = coef_s[0];
      for (int k = tid; k < nnz; k += blockDim.x) {
        U_s[ri + k] = c * val_s[ri + k];
      }
      // later rows' entries that alias a feature of row i receive the
      // u values the scan adds into v, in k order
      for (int t = ri + nnz + tid; t < E; t += blockDim.x) {
        const int p = idx_s[t];
        float wv = W_s[t];
        for (int k = 0; k < nnz; ++k) {
          if (idx_s[ri + k] == p) wv = wv + c * val_s[ri + k];
        }
        W_s[t] = wv;
      }
      __syncthreads();
    }

    // ordered scatter: the first entry of each feature id accumulates
    // every entry of that id in visiting order, then writes v once
    for (int t = tid; t < E; t += blockDim.x) {
      const int p = idx_s[t];
      bool leader = true;
      for (int s = 0; s < t; ++s) {
        if (idx_s[s] == p) {
          leader = false;
          break;
        }
      }
      if (!leader) continue;
      float acc = v[p];
      acc = acc + U_s[t];
      for (int s = t + 1; s < E; ++s) {
        if (idx_s[s] == p) acc = acc + U_s[s];
      }
      v[p] = acc;
    }
    for (int i = tid; i < B; i += blockDim.x) {
      a_out[row + i] = ab[row + i] + del_s[i];
    }
    __syncthreads();
  }
}

template <int OBJ>
cudaError_t launch(const int* idxb, const float* valb, const float* yb,
                   const float* ab, const float* qb, const float* v0,
                   float* a_out, float* v_out, int W, int nb, int B, int nnz,
                   int d_pad, float lam_n, float sig, int smem_bytes,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sdca_sparse_bucket_kernel<OBJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  sdca_sparse_bucket_kernel<OBJ><<<W, kThreads, smem_bytes, stream>>>(
      idxb, valb, yb, ab, qb, v0, a_out, v_out, nb, B, nnz, d_pad, lam_n,
      sig);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sdca_sparse_bucket_launch(const int* idxb, const float* valb,
                                         const float* yb, const float* ab,
                                         const float* qb, const float* v0,
                                         float* a_out, float* v_out, int W,
                                         int nb, int B, int nnz, int d_pad,
                                         float lam_n, float sig, int obj,
                                         int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (obj) {
    case OBJ_RIDGE:
      return launch<OBJ_RIDGE>(idxb, valb, yb, ab, qb, v0, a_out, v_out, W,
                               nb, B, nnz, d_pad, lam_n, sig, smem_bytes, s);
    case OBJ_HINGE:
      return launch<OBJ_HINGE>(idxb, valb, yb, ab, qb, v0, a_out, v_out, W,
                               nb, B, nnz, d_pad, lam_n, sig, smem_bytes, s);
    case OBJ_LOGISTIC:
      return launch<OBJ_LOGISTIC>(idxb, valb, yb, ab, qb, v0, a_out, v_out,
                                  W, nb, B, nnz, d_pad, lam_n, sig,
                                  smem_bytes, s);
    default:
      return cudaErrorInvalidValue;
  }
}
