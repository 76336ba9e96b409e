// One bucket of the dense tensor-parallel SDCA sub-epoch on Hopper
// (sm_90a), split around the model lanes' exchange: the pair of
// kernels that lets each model lane run in its own process.
//
// Replaces, with the whole-tile kernel sdca_bucket.cu, the TPU kernel
// src/repro/kernels/sdca_bucket.py, sdca_bucket_kernel, in the form
// its tensor-parallel caller runs it (src/repro/core/sdca.py
// dense_local_subepoch with model_axis: per bucket the lanes' packed
// [m0 | G] partials are psum'd over 'model', every lane runs the same
// recursion on the sum, and each lane updates its own rows of v).
//
//  * sdca_bucket_tp_partials: one block per (worker, lane) forms the
//    lane's packed (B, 1 + B) partials of bucket b from its (d_loc, B)
//    rows of the tile and its d_loc slice of v: column 0 is
//    m0_j = sum_f x[f][j] v[f], column 1 + i is G_ji = sum_f x[f][j]
//    x[f][i], each sum over f ascending (dense_recursion.cuh, B1's
//    order); one thread an entry.
//  * the host sums the lanes' partials in lane order (one process: the
//    stacked lanes; a process mesh: an ordered all-gather over 'model').
//  * sdca_bucket_tp_solve: one block per (worker, lane) reads its
//    worker's summed [m0 | G], walks the bucket's B-step recursion on
//    the chain warp (the logistic bisection as a tree, bisect_tree.cuh,
//    as B1's chain does), writes the bucket's duals, and adds
//    (sigma'/lam_n) X delta into the lane's slice of v, in place.
//
// What bounds it: the recursion's serial chain, as in B1, and at one
// block per (worker, lane) the two launches and the exchange a bucket.
// The tile is read from global memory (d_loc x B f32: 64 KB at epsilon's
// d_loc 1,000 and B 16), through L1.  fp32 on the CUDA cores, built with
// the common flags, as B1 is.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_recursion.cuh"
#include "objectives.cuh"

namespace {

constexpr int kPartialThreads = 256;
constexpr int kSolveThreads = 128;

__global__ void __launch_bounds__(kPartialThreads)
tp_partials_kernel(const float* __restrict__ xb, const float* __restrict__ v,
                   float* __restrict__ packed, int Mh, int nb, int b,
                   int d_loc, int B) {
  const int g = blockIdx.x;  // (worker, lane), lane-minor
  const int w = g / Mh, m = g % Mh;
  const size_t d_all = (size_t)Mh * d_loc;
  const float* x = xb + (((size_t)w * nb + b) * d_all + (size_t)m * d_loc)
                   * B;
  const float* vl = v + (size_t)w * d_all + (size_t)m * d_loc;
  float* out = packed + (size_t)g * B * (B + 1);
  for (int t = threadIdx.x; t < B * (B + 1); t += kPartialThreads) {
    const int j = t / (B + 1), c = t - j * (B + 1);
    out[t] = c == 0 ? margin_sum(x, vl, d_loc, B, j)
                    : gram_sum(x, d_loc, B, j, c - 1);
  }
}

// Shared memory, in floats: a, y, q, delta (B each).
template <int OBJ, int MPL>
__global__ void __launch_bounds__(kSolveThreads)
tp_solve_kernel(const float* __restrict__ total, const float* __restrict__ xb,
                const float* __restrict__ yb, const float* __restrict__ ab,
                float* __restrict__ v, float* __restrict__ a_out, int Mh,
                int nb, int b, int d_loc, int B, float lam_n, float sig) {
  extern __shared__ float smem[];
  float* a = smem;
  float* y = a + B;
  float* q = y + B;
  float* del = q + B;
  const int g = blockIdx.x;
  const int w = g / Mh, m = g % Mh;
  const int tid = threadIdx.x;
  const int ld = B + 1;
  const float* P = total + (size_t)w * B * ld;  // the worker's [m0 | G]
  const size_t row = ((size_t)w * nb + b) * B;
  for (int i = tid; i < B; i += kSolveThreads) {
    a[i] = ab[row + i];
    y[i] = yb[row + i];
    q[i] = sig * P[(size_t)i * ld + 1 + i] / lam_n;
  }
  __syncthreads();
  if (tid < 32) {
    float mg[MPL];
#pragma unroll
    for (int k = 0; k < MPL; ++k) {
      const int j = tid + 32 * k;
      mg[k] = j < B ? P[(size_t)j * ld] : 0.0f;
    }
    bucket_recursion<OBJ, MPL>(mg, P + 1, ld, a, y, q, del, B, lam_n, sig,
                               tid);
  }
  __syncthreads();
  const size_t d_all = (size_t)Mh * d_loc;
  const float* x = xb + (((size_t)w * nb + b) * d_all + (size_t)m * d_loc)
                   * B;
  float* vl = v + (size_t)w * d_all + (size_t)m * d_loc;
  const float vscale = sig / lam_n;
  for (int f = tid; f < d_loc; f += kSolveThreads) {
    vl[f] = vl[f] + vscale * update_sum(x, del, B, f);
  }
  for (int i = tid; i < B; i += kSolveThreads) {
    a_out[(size_t)g * B + i] = a[i] + del[i];
  }
}

template <int OBJ, int MPL>
cudaError_t solve_as(const float* total, const float* xb, const float* yb,
                     const float* ab, float* v, float* a_out, int G, int Mh,
                     int nb, int b, int d_loc, int B, float lam_n, float sig,
                     cudaStream_t s) {
  tp_solve_kernel<OBJ, MPL><<<G, kSolveThreads, 4 * B * sizeof(float), s>>>(
      total, xb, yb, ab, v, a_out, Mh, nb, b, d_loc, B, lam_n, sig);
  return cudaGetLastError();
}

template <int OBJ>
cudaError_t solve_mpl(const float* total, const float* xb, const float* yb,
                      const float* ab, float* v, float* a_out, int G, int Mh,
                      int nb, int b, int d_loc, int B, float lam_n, float sig,
                      cudaStream_t s) {
#define TP_SOLVE(M)                                                          \
  return solve_as<OBJ, M>(total, xb, yb, ab, v, a_out, G, Mh, nb, b, d_loc, \
                          B, lam_n, sig, s)
  if (B <= 32) TP_SOLVE(1);
  if (B <= 64) TP_SOLVE(2);
  if (B <= 128) TP_SOLVE(4);
  if (B <= 256) TP_SOLVE(8);
  TP_SOLVE(16);
#undef TP_SOLVE
}

}  // namespace

// xb (W, nb, Mh*d_loc, B), v (W, Mh*d_loc) -> packed (W, Mh, B, 1 + B).
// Returns a cudaError_t (0 on success).
extern "C" int sdca_bucket_tp_partials_launch(const float* xb, const float* v,
                                              float* packed, int W, int Mh,
                                              int nb, int b, int d_loc, int B,
                                              void* stream) {
  if (B <= 0 || B > 512 || d_loc <= 0 || Mh <= 0 || b < 0 || b >= nb)
    return cudaErrorInvalidValue;
  if (W <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tp_partials_kernel<<<W * Mh, kPartialThreads, 0, s>>>(xb, v, packed, Mh, nb,
                                                         b, d_loc, B);
  return cudaGetLastError();
}

// total (W, B, 1 + B) the lane-summed [m0 | G]; yb, ab (W, nb, B);
// v (W, Mh*d_loc) updated in place; a_out (W, Mh, B).  B <= 512.
extern "C" int sdca_bucket_tp_solve_launch(const float* total,
                                           const float* xb, const float* yb,
                                           const float* ab, float* v,
                                           float* a_out, int W, int Mh,
                                           int nb, int b, int d_loc, int B,
                                           float lam_n, float sig, int obj,
                                           void* stream) {
  if (B <= 0 || B > 512 || d_loc <= 0 || Mh <= 0 || b < 0 || b >= nb)
    return cudaErrorInvalidValue;
  if (W <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = W * Mh;
  switch (obj) {
    case OBJ_RIDGE:
      return solve_mpl<OBJ_RIDGE>(total, xb, yb, ab, v, a_out, G, Mh, nb, b,
                                  d_loc, B, lam_n, sig, s);
    case OBJ_HINGE:
      return solve_mpl<OBJ_HINGE>(total, xb, yb, ab, v, a_out, G, Mh, nb, b,
                                  d_loc, B, lam_n, sig, s);
    case OBJ_LOGISTIC:
      return solve_mpl<OBJ_LOGISTIC>(total, xb, yb, ab, v, a_out, G, Mh, nb,
                                     b, d_loc, B, lam_n, sig, s);
    default:
      return cudaErrorInvalidValue;
  }
}
