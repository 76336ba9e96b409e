// One bucket of the feature-sharded sparse SDCA sub-epoch on Hopper
// (sm_90a): the in-bucket recursion on the exchanged working set, on
// every lane, then the scatter of the entries the lane owns into its
// slice of v.  W, the working set, is one (B, nnz) tile per worker,
// read by each of its lanes' blocks.
//
// Replaces the TPU kernel src/repro/kernels/sdca_sparse_bucket.py,
// sdca_sparse_sharded_bucket (bodies _sharded_kernel and
// _bucket_recursion).
//
// What bounds it on this card: the serial chain.  Each row's margin is
// a left-to-right sum of nnz products (3,728 dependent adds at webspam
// width, ~8.5 us a row), and a logistic delta is a 40-step bisection; a
// row needs every earlier row's updates.  Bytes (the tiles, the
// worker's exchanged W, the touched slice entries) and operations are a
// small fraction of what the card could do in that time.
//
// What the design does about it: one block per (worker, lane), every
// block of the bucket in one launch.  At webspam width the idx tile
// alone is 238,592 bytes, so the tiles, the links and the feature cells
// S (one per entry place, ~7.6 MB over 32 blocks, held by the L2) stay
// in global memory; the row's operands live in shared memory (in a
// global scratch row per block where nnz is too wide for it, the same
// code on other addresses).  The row is walked over the links of
// ops.sharded_tiles (sparse_recursion.cuh: slot, run_len, rpos; pos and
// group_len for the scatter) so that no pair of ids is ever compared,
// and its time is the chain's:
//  * The chain warp (warp 0): lane 0 sums the row's products left to
//    right, chunk by chunk, with 16-byte loads as each chunk's flag is
//    published; the warp walks the delta as a tree (bisect_tree.cuh)
//    and hands the row's coefficient over at a named barrier.
//  * kProducerWarps producer warps form the products chunk by chunk
//    (chunk c by warp c mod kProducerWarps, each published by a release
//    flag), so the products of chunk c+1 are ready while lane 0 sums
//    chunk c; meanwhile they stage the row's val, slot, run_len and
//    rpos.  Given the coefficient they form u = c * val into the row's
//    run order, then fold each run into its feature's cell, with named
//    barriers among themselves only.  No __syncthreads per row.
//  * The owned scatter: a feature's cell started at its W value and
//    folded the feature's u values in visiting order.  W is the
//    worker's gather over all its lanes' slices (B3,
//    sdca_sparse_gather_bucket.cu), so an owned feature's W value is
//    the lane's own slice entry, and its cell is the entry's new value:
//    the scatter writes it.
//
// Bitwise contract with the plain version (sdca_sparse_sharded_plain)
// and with the replicated scan (core/sdca.py sparse_scan), for a W that
// is B3's gather of this v_loc: built with -fmad=false; every product is
// rounded before it is added, as in the scan; a feature's cell receives
// the u values the scan adds into v[p], in the same order; the owned
// slice entries end at the value the scan's v[p] ends.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_recursion.cuh"
#include "sync.cuh"

namespace {

constexpr int kChainThreads = 32;
constexpr int kProducerWarps = 15;
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kThreads = kChainThreads + kProducers;
constexpr int kChunk = 256;  // products per published chunk
constexpr int kPerLane = kChunk / 32;
// entries a thread walks at once in the loops over the bucket and the
// row: their loads are all in flight before the first is used
constexpr int kBatch = 8;
// named barriers (0 is __syncthreads)
constexpr int kBarCoef = 1;       // the chain arrives, the producers wait
constexpr int kBarProducers = 2;  // the producers among themselves
constexpr int kPlanes = 5;        // pos, slot, run_len, group_len, rpos

__device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// The row's operands, in 4-byte words (the wrapper's sharded_row_words
// and sharded_smem_bytes mirror it): prod, u_row, val, slot, run_len,
// rpos (round4(nnz) each), in shared memory or in the block's scratch
// row; then, in shared memory, one ready flag per chunk and the
// coefficient.
constexpr int kRowArrays = 6;
struct Row {
  float* prod;
  float* u_row;
  float* val;
  int* slot;
  int* run_len;
  int* rpos;
  int* ready;
  float* coef;
};

__device__ __forceinline__ Row carve(float* rows, int* flags, int nnz) {
  const int n = round4(nnz);
  Row r;
  r.prod = rows;
  r.u_row = r.prod + n;
  r.val = r.u_row + n;
  r.slot = reinterpret_cast<int*>(r.val + n);
  r.run_len = r.slot + n;
  r.rpos = r.run_len + n;
  r.ready = flags;
  r.coef = reinterpret_cast<float*>(r.ready + (nnz + kChunk - 1) / kChunk);
  return r;
}

template <int OBJ>
__device__ void chain(const Row& r, const float* __restrict__ y,
                      const float* __restrict__ a,
                      const float* __restrict__ qrow,
                      float* __restrict__ a_out, int B, int nnz,
                      float lam_n, float sig) {
  const int lane = threadIdx.x;
  const int nch = (nnz + kChunk - 1) / kChunk;
  for (int i = 0; i < B; ++i) {
    const float ai = a[i], yi = y[i], q_eff = sig * qrow[i] / lam_n;
    float m = 0.0f;
    if (lane == 0) {
      for (int c = 0; c < nch; ++c) {
        flag_wait(r.ready + c, i + 1);
        const int k0 = c * kChunk;
        m = ordered_sum(m, r.prod + k0, min(kChunk, nnz - k0));
      }
    }
    m = __shfl_sync(kFullMask, m, 0);
    const float d = chain_delta<OBJ>(m, ai, yi, q_eff, lane);
    if (lane == 0) {
      a_out[i] = ai + d;
      *r.coef = sig * d / lam_n;
    }
    __threadfence_block();
    bar_arrive(kBarCoef, kThreads);
  }
}

__device__ void producer(const Row& r, const float* __restrict__ val,
                         const int* __restrict__ slot,
                         const int* __restrict__ run_len,
                         const int* __restrict__ rpos, float* Sg, int B,
                         int nnz) {
  const int ptid = threadIdx.x - kChainThreads;
  const int pw = ptid / 32, lane = ptid % 32;
  const int nch = (nnz + kChunk - 1) / kChunk;
  for (int i = 0; i < B; ++i) {
    const int ri = i * nnz;
    // the products, chunk by chunk, and the row's operands staged
    for (int c = pw; c < nch; c += kProducerWarps) {
      const int k0 = c * kChunk + lane;
      int h[kPerLane], rl[kPerLane], rp[kPerLane];
      float x[kPerLane], sv[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int k = k0 + 32 * j;
        if (k < nnz) {
          const int t = ri + k;
          h[j] = slot[t];
          x[j] = val[t];
          rl[j] = run_len[t];
          rp[j] = rpos[t];
        }
      }
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        if (k0 + 32 * j < nnz) sv[j] = Sg[h[j]];
      }
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int k = k0 + 32 * j;
        if (k < nnz) {
          r.prod[k] = sv[j] * x[j];
          r.val[k] = x[j];
          r.slot[k] = h[j];
          r.run_len[k] = rl[j];
          r.rpos[k] = rp[j];
        }
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) flag_release(r.ready + c, i + 1);
    }
    bar_sync(kBarCoef, kThreads);
    const float cf = *r.coef;
    for (int k = ptid; k < nnz; k += kProducers)
      r.u_row[r.rpos[k]] = cf * r.val[k];
    bar_sync(kBarProducers, kProducers);
    // the row's runs: distinct features, so every cell is read first
    for (int k0 = ptid; k0 < nnz; k0 += kProducers * kBatch) {
      int L[kBatch], h[kBatch];
      float sv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int k = k0 + kProducers * j;
        L[j] = k < nnz ? r.run_len[k] : 0;
        h[j] = L[j] > 0 ? r.slot[k] : 0;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (L[j] > 0) sv[j] = Sg[h[j]];
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (L[j] > 0) {
          const int k = k0 + kProducers * j;
          Sg[h[j]] = fold(sv[j], r.u_row + r.rpos[k], L[j]);
        }
      }
    }
    bar_sync(kBarProducers, kProducers);
  }
}

template <int OBJ, bool kRowsInSmem>
__global__ void __launch_bounds__(kThreads, 1)
sdca_sparse_sharded_bucket_kernel(
    const int* __restrict__ idxb, const float* __restrict__ valb,
    const float* __restrict__ yb, const float* __restrict__ ab,
    const float* __restrict__ qb, const int* __restrict__ links,
    const float* __restrict__ Wx, float* __restrict__ v_loc,
    float* __restrict__ a_out, float* S, float* rows_g, int M, int nb,
    int b, int B, int nnz, int d_loc, float lam_n, float sig) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.x;  // (worker, lane) block, lane-minor
  const int row_words = kRowArrays * round4(nnz);
  const Row r =
      kRowsInSmem
          ? carve(smem, reinterpret_cast<int*>(smem + row_words), nnz)
          : carve(rows_g + (size_t)g * row_words,
                  reinterpret_cast<int*>(smem), nnz);
  const int w = g / M;
  const int lane = g % M;
  const int tid = threadIdx.x;
  const int E = B * nnz;
  const size_t wb = (size_t)w * nb + b;
  const int* idx = idxb + wb * E;
  const float* val = valb + wb * E;
  const int* pos = links + wb * kPlanes * E;
  const int* slot = pos + E;
  const int* run_len = slot + E;
  const int* group_len = run_len + E;
  const int* rpos = group_len + E;
  const float* Wg = Wx + (size_t)w * E;  // the worker's, on every lane
  float* Sg = S + (size_t)g * E;
  float* v = v_loc + (size_t)g * d_loc;
  const long long lo = (long long)lane * d_loc;

  // each feature's cell (the place of its first entry) starts at its
  // working-set value
  for (int t0 = tid; t0 < E; t0 += kThreads * kBatch) {
    int gl[kBatch], ps[kBatch];
    float wv[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int t = t0 + kThreads * j;
      gl[j] = t < E ? group_len[t] : 0;
      ps[j] = gl[j] > 0 ? pos[t] : 0;
      wv[j] = gl[j] > 0 ? Wg[t] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (gl[j] > 0) Sg[ps[j]] = wv[j];
    }
  }
  for (int c = tid; c * kChunk < nnz; c += kThreads) r.ready[c] = 0;
  __syncthreads();

  if (tid < kChainThreads) {
    chain<OBJ>(r, yb + wb * B, ab + wb * B, qb + wb * B,
               a_out + (size_t)g * B, B, nnz, lam_n, sig);
  } else {
    producer(r, val, slot, run_len, rpos, Sg, B, nnz);
  }
  __syncthreads();

  // owned scatter: each feature the lane owns ends at its cell's value
  for (int t0 = tid; t0 < E; t0 += kThreads * kBatch) {
    int ps[kBatch];
    long long q[kBatch];
    float sv[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int t = t0 + kThreads * j;
      const bool first = t < E && group_len[t] > 0;
      q[j] = first ? (long long)idx[t] - lo : -1;
      if (q[j] >= d_loc) q[j] = -1;
      ps[j] = q[j] >= 0 ? pos[t] : 0;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (q[j] >= 0) sv[j] = Sg[ps[j]];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (q[j] >= 0) v[q[j]] = sv[j];
    }
  }
}

template <int OBJ, bool kRowsInSmem>
cudaError_t launch_as(const int* idxb, const float* valb, const float* yb,
                      const float* ab, const float* qb, const int* links,
                      const float* Wx, float* v_loc, float* a_out, float* S,
                      float* rows_g, int G, int M, int nb, int b, int B,
                      int nnz, int d_loc, float lam_n, float sig,
                      int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sdca_sparse_sharded_bucket_kernel<OBJ, kRowsInSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  sdca_sparse_sharded_bucket_kernel<OBJ, kRowsInSmem>
      <<<G, kThreads, smem_bytes, stream>>>(idxb, valb, yb, ab, qb, links,
                                            Wx, v_loc, a_out, S, rows_g, M,
                                            nb, b, B, nnz, d_loc, lam_n, sig);
  return cudaGetLastError();
}

// rows_g null: the row's operands in shared memory
template <int OBJ>
cudaError_t launch(const int* idxb, const float* valb, const float* yb,
                   const float* ab, const float* qb, const int* links,
                   const float* Wx, float* v_loc, float* a_out, float* S,
                   float* rows_g, int G, int M, int nb, int b, int B, int nnz,
                   int d_loc, float lam_n, float sig, int smem_bytes,
                   cudaStream_t stream) {
  return rows_g == nullptr
             ? launch_as<OBJ, true>(idxb, valb, yb, ab, qb, links, Wx, v_loc,
                                    a_out, S, rows_g, G, M, nb, b, B, nnz,
                                    d_loc, lam_n, sig, smem_bytes, stream)
             : launch_as<OBJ, false>(idxb, valb, yb, ab, qb, links, Wx,
                                     v_loc, a_out, S, rows_g, G, M, nb, b, B,
                                     nnz, d_loc, lam_n, sig, smem_bytes,
                                     stream);
}

}  // namespace

extern "C" int sdca_sparse_sharded_bucket_launch(
    const int* idxb, const float* valb, const float* yb, const float* ab,
    const float* qb, const int* links, const float* Wx, float* v_loc,
    float* a_out, float* S, float* rows_g, int G, int M, int nb, int b, int B,
    int nnz, int d_loc, float lam_n, float sig, int obj, int smem_bytes,
    void* stream) {
  if (G <= 0) return cudaSuccess;
  if (B <= 0 || nnz <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (obj) {
    case OBJ_RIDGE:
      return launch<OBJ_RIDGE>(idxb, valb, yb, ab, qb, links, Wx, v_loc,
                               a_out, S, rows_g, G, M, nb, b, B, nnz, d_loc,
                               lam_n, sig, smem_bytes, s);
    case OBJ_HINGE:
      return launch<OBJ_HINGE>(idxb, valb, yb, ab, qb, links, Wx, v_loc,
                               a_out, S, rows_g, G, M, nb, b, B, nnz, d_loc,
                               lam_n, sig, smem_bytes, s);
    case OBJ_LOGISTIC:
      return launch<OBJ_LOGISTIC>(idxb, valb, yb, ab, qb, links, Wx, v_loc,
                                  a_out, S, rows_g, G, M, nb, b, B, nnz, d_loc,
                                  lam_n, sig, smem_bytes, s);
    default:
      return cudaErrorInvalidValue;
  }
}
