// One bucket of the feature-sharded sparse SDCA sub-epoch on Hopper
// (sm_90a): the in-bucket recursion on the exchanged working set, on
// every lane, then the scatter of the entries the lane owns into its
// slice of v.
//
// Replaces the TPU kernel src/repro/kernels/sdca_sparse_bucket.py,
// sdca_sparse_sharded_bucket (bodies _sharded_kernel and
// _bucket_recursion).
//
// What bounds it on this card: the serial chain.  Each row's margin is
// a left-to-right sum of nnz products (3,728 dependent adds at webspam
// width), and a logistic delta is a 40-step bisection; a row needs every
// earlier row's updates.  Bytes (the tiles, the exchanged W, the touched
// slice entries) and operations are a small fraction of what the card
// could do in that time.
//
// What the design does about it:
//  - One thread block per (worker, lane), every block of the bucket in
//    one launch.  At webspam width the idx tile alone is 238,592 bytes,
//    so the tiles, the working set and the update rows stay in global
//    memory (per-block scratch S and U from the wrapper, ~7.6 MB each
//    over 32 blocks, held by the L2).
//  - No feature-match scan.  The wrapper's layout (ops.sharded_tiles)
//    sorts each bucket's entries by (feature id, visiting position),
//    stably, and gives every entry t four links:
//      pos[t]        its place in that order;
//      slot[t]       the place of its feature's first entry (the
//                    feature's slot in S, which holds the feature's
//                    current value);
//      run_len[t]    for the first entry of a feature in a row, the
//                    row's count of entries of that feature, else 0;
//      group_len[t]  for the first entry of a feature in the bucket,
//                    the bucket's count of them, else 0.
//    The entries of one feature are contiguous in that order, in
//    visiting order, so U is stored in that order and every walk below
//    reads consecutive addresses: O(B*nnz) work per bucket however
//    often a feature repeats (rows repeat ids as zero-valued duplicates;
//    one Zipf-popular id reaches ~3,400 entries per bucket).
//  - Per row: all threads form the products S[slot]*val into shared
//    memory, thread 0 sums them left to right and runs the delta, all
//    threads form u = (sigma' delta / lam_n) * val, and the first entry
//    of each feature in the row adds the row's u values of that feature
//    into S in visiting order.
//
// Bitwise contract with the plain version (sdca_sparse_sharded_plain)
// and with the replicated scan (core/sdca.py sparse_scan), for a W that
// holds the same bits for equal ids (what the exchange gives): built
// with -fmad=false; every product is rounded before it is added, as in
// the scan; a feature's S value receives the u values the scan adds into
// v[p], in the same order; the owned scatter starts from the slice's
// value and adds the feature's u values in visiting order, one thread
// per feature.
#include <cuda_runtime.h>

#include "objectives.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // products summed per shared-memory pass

template <int OBJ>
__global__ void __launch_bounds__(kThreads)
sdca_sparse_sharded_bucket_kernel(
    const int* __restrict__ idxb, const float* __restrict__ valb,
    const float* __restrict__ yb, const float* __restrict__ ab,
    const float* __restrict__ qb, const int* __restrict__ links,
    const float* __restrict__ Wx, float* __restrict__ v_loc,
    float* __restrict__ a_out, float* __restrict__ S, float* __restrict__ U,
    int M, int nb, int b, int B, int nnz, int d_loc, float lam_n,
    float sig) {
  __shared__ float prod_s[kChunk];
  __shared__ float coef_s;
  const int g = blockIdx.x;  // (worker, lane) block, lane-minor
  const int w = g / M;
  const int lane = g % M;
  const int tid = threadIdx.x;
  const int E = B * nnz;
  const size_t wb = (size_t)w * nb + b;
  const int* idx = idxb + wb * E;
  const float* val = valb + wb * E;
  const float* y = yb + wb * B;
  const float* a = ab + wb * B;
  const float* qrow = qb + wb * B;
  const int* pos = links + wb * 4 * E;
  const int* slot = pos + E;
  const int* run_len = slot + E;
  const int* group_len = run_len + E;
  const float* Wg = Wx + (size_t)g * E;
  float* Sg = S + (size_t)g * E;
  float* Ug = U + (size_t)g * E;
  float* v = v_loc + (size_t)g * d_loc;
  const long long lo = (long long)lane * d_loc;

  // each feature's slot starts at its working-set value
  for (int t = tid; t < E; t += blockDim.x) {
    if (group_len[t] > 0) Sg[pos[t]] = Wg[t];
  }
  __syncthreads();

  for (int i = 0; i < B; ++i) {
    const int ri = i * nnz;
    float m = 0.0f;  // thread 0's margin
    for (int k0 = 0; k0 < nnz; k0 += kChunk) {
      const int kn = min(kChunk, nnz - k0);
      for (int k = tid; k < kn; k += blockDim.x) {
        const int t = ri + k0 + k;
        prod_s[k] = Sg[slot[t]] * val[t];
      }
      __syncthreads();
      if (tid == 0) {
        for (int k = 0; k < kn; ++k) m = m + prod_s[k];
      }
      __syncthreads();
    }
    if (tid == 0) {
      const float q = sig * qrow[i] / lam_n;
      const float d = obj_delta<OBJ>(m, a[i], y[i], q);
      a_out[(size_t)g * B + i] = a[i] + d;
      coef_s = sig * d / lam_n;
    }
    __syncthreads();
    const float c = coef_s;
    for (int k = tid; k < nnz; k += blockDim.x) {
      const int t = ri + k;
      Ug[pos[t]] = c * val[t];
    }
    __syncthreads();
    // the row's first entry of each feature adds the row's u values of
    // that feature into its slot, in k order
    for (int k = tid; k < nnz; k += blockDim.x) {
      const int t = ri + k;
      const int L = run_len[t];
      if (L > 0) {
        const float* u = Ug + pos[t];
        const int h = slot[t];
        float acc = Sg[h];
        for (int j = 0; j < L; ++j) acc = acc + u[j];
        Sg[h] = acc;
      }
    }
    __syncthreads();
  }

  // owned scatter: the bucket's first entry of each feature the lane owns
  // adds every u value of that feature into the slice, in visiting order
  for (int t = tid; t < E; t += blockDim.x) {
    const int L = group_len[t];
    if (L <= 0) continue;
    const long long q = (long long)idx[t] - lo;
    if (q < 0 || q >= d_loc) continue;
    const float* u = Ug + pos[t];
    float acc = v[q];
    for (int j = 0; j < L; ++j) acc = acc + u[j];
    v[q] = acc;
  }
}

template <int OBJ>
cudaError_t launch(const int* idxb, const float* valb, const float* yb,
                   const float* ab, const float* qb, const int* links,
                   const float* Wx, float* v_loc, float* a_out, float* S,
                   float* U, int G, int M, int nb, int b, int B, int nnz,
                   int d_loc, float lam_n, float sig, cudaStream_t stream) {
  sdca_sparse_sharded_bucket_kernel<OBJ><<<G, kThreads, 0, stream>>>(
      idxb, valb, yb, ab, qb, links, Wx, v_loc, a_out, S, U, M, nb, b, B,
      nnz, d_loc, lam_n, sig);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sdca_sparse_sharded_bucket_launch(
    const int* idxb, const float* valb, const float* yb, const float* ab,
    const float* qb, const int* links, const float* Wx, float* v_loc,
    float* a_out, float* S, float* U, int G, int M, int nb, int b, int B,
    int nnz, int d_loc, float lam_n, float sig, int obj, void* stream) {
  if (G <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (obj) {
    case OBJ_RIDGE:
      return launch<OBJ_RIDGE>(idxb, valb, yb, ab, qb, links, Wx, v_loc,
                               a_out, S, U, G, M, nb, b, B, nnz, d_loc,
                               lam_n, sig, s);
    case OBJ_HINGE:
      return launch<OBJ_HINGE>(idxb, valb, yb, ab, qb, links, Wx, v_loc,
                               a_out, S, U, G, M, nb, b, B, nnz, d_loc,
                               lam_n, sig, s);
    case OBJ_LOGISTIC:
      return launch<OBJ_LOGISTIC>(idxb, valb, yb, ab, qb, links, Wx, v_loc,
                                  a_out, S, U, G, M, nb, b, B, nnz, d_loc,
                                  lam_n, sig, s);
    default:
      return cudaErrorInvalidValue;
  }
}
