// The dense bucket's arithmetic: the whole-tile kernel's (sdca_bucket.cu,
// B1) sums and the recursion it shares with the tensor-parallel pair
// (sdca_bucket_tp.cu), which splits the bucket around the model lanes'
// exchange of [m0 | G].
//
// A bucket tile x is (d, B), row f at x + f*B.  margin_sum, gram_sum and
// update_sum are B1's alone: over f ascending for m0_j and G_ij, over i
// ascending for (X delta)_f.  The pair forms its sums in its own order
// from rows staged in shared memory (sdca_bucket_tp.cu); both kernels
// run bucket_recursion, which walks the B coordinates in order on one
// warp, margin j in lane j % 32, slot j / 32.
#pragma once

#include <stddef.h>

#include "bisect_tree.cuh"

namespace {

// m0_j = sum over f of x[f][j] v[f]
__device__ __forceinline__ float margin_sum(const float* x, const float* v,
                                            int d, int B, int j) {
  float s = 0.0f;
  for (int f = 0; f < d; ++f) s += x[(size_t)f * B + j] * v[f];
  return s;
}

// G_ij = sum over f of x[f][i] x[f][j]
__device__ __forceinline__ float gram_sum(const float* x, int d, int B,
                                          int i, int j) {
  float s = 0.0f;
  for (int f = 0; f < d; ++f) {
    s += x[(size_t)f * B + i] * x[(size_t)f * B + j];
  }
  return s;
}

// (X delta)_f = sum over i of x[f][i] delta_i
__device__ __forceinline__ float update_sum(const float* x, const float* del,
                                            int B, int f) {
  float s = 0.0f;
  for (int i = 0; i < B; ++i) s += x[(size_t)f * B + i] * del[i];
  return s;
}

// The serial recursion over a bucket's B coordinates, on one warp: m
// holds the margins at bucket entry (margin j = lane + 32 k in m[k]), G
// the Gram matrix with rows `ldg` apart, a / y / q the coordinates'
// duals, labels and sigma' G_ii / lam_n.  Lane 0 writes each delta to
// del; the margins leave with every update applied.
template <int OBJ, int MPL>
__device__ __forceinline__ void bucket_recursion(
    float (&m)[MPL], const float* G, int ldg, const float* a,
    const float* y, const float* q, float* del, int B, float lam_n,
    float sig, int lane) {
  for (int i = 0; i < B; ++i) {
    float mi_own = m[0];
#pragma unroll
    for (int k = 1; k < MPL; ++k) {
      if (k == (i >> 5)) mi_own = m[k];
    }
    const float mi = __shfl_sync(0xffffffffu, mi_own, i & 31);
    const float d = chain_delta<OBJ>(mi, a[i], y[i], q[i], lane);
    if (lane == 0) del[i] = d;
    const float c = sig * d / lam_n;
#pragma unroll
    for (int k = 0; k < MPL; ++k) {
      const int j = lane + 32 * k;
      if (j < B) m[k] += c * G[(size_t)i * ldg + j];
    }
  }
}

}  // namespace
