// The in-bucket recursion of the sparse SDCA kernels, walked over links.
//
// The device side of the reference's shared `_bucket_recursion`
// (src/repro/kernels/sdca_sparse_bucket.py), used by the replicated
// kernel (sdca_sparse_bucket.cu) and the feature-sharded one
// (sdca_sparse_sharded_bucket.cu).  A bucket's B rows of nnz entries,
// entry t = i*nnz + k in visiting order, carry these links:
//   slot[t]     the cell of t's feature in S, which holds the feature's
//               current value (one cell per distinct feature id);
//   run_len[t]  at the row's first entry of a feature, the row's count
//               of entries of that feature, else 0;
//   rpos[t]     t's place when the row's entries are sorted stably by
//               feature id, so the row's entries of one feature (its
//               run) sit together in k order, starting at its first;
//   rval        val in the row's run order (rval[rpos[t]] = val[t]),
//               where a kernel keeps it (the replicated one).
// A row is then, without comparing a single pair of ids:
//   1. m = sum over k, left to right, of S[slot[t]] * val[t] (each
//      product rounded before it is added);
//   2. delta from (m, a, y, sigma' q / lam_n) (bisect_tree.cuh);
//   3. u = (sigma' delta / lam_n) * val[t] once per entry;
//   4. the first entry of each run folds the run's u values into its
//      feature's cell in k order: S[h] = ((S[h] + u_0) + u_1) + ...,
//      reading them from the row's run order (u stored at rpos[t]) or
//      forming them there (from rval[rpos[t] + j]).
// Each feature's cell thus receives the u values the plain scan
// (core/sdca.py sparse_scan) adds into v[id], in the same order, and a
// row's margin reads the values the scan's gather reads.  After the
// bucket, a feature's cell is the scan's v[id] bit for bit when it
// started from v[id].  Built with -fmad=false, so no multiply and add
// fuse anywhere on the way.
#pragma once

#include "bisect_tree.cuh"
#include "objectives.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// acc + p[0] + p[1] + ... + p[n-1], left to right, with 16-byte loads
// kept kSumAhead ahead of the adds; p is 16-byte aligned.
constexpr int kSumAhead = 8;
__device__ __forceinline__ float add4(float acc, float4 x) {
  acc = acc + x.x;
  acc = acc + x.y;
  acc = acc + x.z;
  return acc + x.w;
}
__device__ __forceinline__ float ordered_sum(float acc,
                                             const float* __restrict__ p,
                                             int n) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const int n4 = n >> 2;
  int j = 0;
  if (n4 >= kSumAhead) {
    float4 cur[kSumAhead];
#pragma unroll
    for (int g = 0; g < kSumAhead; ++g) cur[g] = p4[g];
    for (j = kSumAhead; j + kSumAhead <= n4; j += kSumAhead) {
      float4 nxt[kSumAhead];
#pragma unroll
      for (int g = 0; g < kSumAhead; ++g) nxt[g] = p4[j + g];
#pragma unroll
      for (int g = 0; g < kSumAhead; ++g) acc = add4(acc, cur[g]);
#pragma unroll
      for (int g = 0; g < kSumAhead; ++g) cur[g] = nxt[g];
    }
#pragma unroll
    for (int g = 0; g < kSumAhead; ++g) acc = add4(acc, cur[g]);
  }
  for (; j < n4; ++j) acc = add4(acc, p4[j]);
  for (int k = n4 << 2; k < n; ++k) acc = acc + p[k];
  return acc;
}

// acc + u[0] + ... + u[n-1], left to right (a run of one feature, or
// its whole group, in visiting order).
__device__ __forceinline__ float fold(float acc, const float* u, int n) {
#pragma unroll 4
  for (int j = 0; j < n; ++j) acc = acc + u[j];
  return acc;
}

// One row walked by one warp, every operand in shared memory (the
// replicated kernel's row).  slot/run_len/rpos/rval/val point at the
// row's nnz entries (rval: val in the row's run order); prod is nnz
// floats of 16-byte aligned scratch; q_eff = sigma' q / lam_n.  Returns
// delta on every lane.  No block barrier, two __syncwarp:
//  * lane k % 32 forms the product of entry k; lane 0 adds them up in
//    k order;
//  * the warp walks the delta (all lanes alike);
//  * the first lane of each run forms the run's u values from rval and
//    folds them into the feature's cell.  The cell's value and the
//    entry's operands of the first 64 entries are still in the lane's
//    registers from the products: no cell changes between a row's
//    products and its runs, and each cell has one run in the row.
template <int OBJ>
__device__ __forceinline__ float warp_row(
    float* S, const int* __restrict__ slot, const int* __restrict__ run_len,
    const int* __restrict__ rpos, const float* __restrict__ rval,
    const float* __restrict__ val, float* __restrict__ prod, int nnz,
    float a, float y, float q_eff, float lam_n, float sig, int lane) {
  // the first 64 entries' operands, kept for the runs
  int h[2], L[2], rp[2];
  float sv[2], x[2];
  for (int g = 0; g < nnz; g += 64) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = g + 32 * e + lane;
      if (k < nnz) {
        const int hk = slot[k];
        const float xk = val[k];
        const float s = S[hk];
        prod[k] = s * xk;
        if (g == 0) {
          h[e] = hk;
          x[e] = xk;
          sv[e] = s;
          L[e] = run_len[k];
          rp[e] = rpos[k];
        }
      } else if (g == 0) {
        L[e] = 0;
      }
    }
  }
  __syncwarp();
  float m = 0.0f;
  if (lane == 0) m = ordered_sum(0.0f, prod, nnz);
  m = __shfl_sync(kFullMask, m, 0);
  const float d = chain_delta<OBJ>(m, a, y, q_eff, lane);
  const float c = sig * d / lam_n;
  // entry k starts a run of Lk entries of the feature in cell hk, whose
  // value is s; the run's values sit in rval from place p
  auto fold_run = [&](int hk, float s, float xk, int Lk, int p) {
    float acc = s + c * xk;
    for (int j = 1; j < Lk; ++j) acc = acc + c * rval[p + j];
    S[hk] = acc;
  };
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (L[e] > 0) fold_run(h[e], sv[e], x[e], L[e], rp[e]);
  }
  for (int k = 64 + lane; k < nnz; k += 32) {
    const int Lk = run_len[k];
    if (Lk > 0) {
      const int hk = slot[k];
      fold_run(hk, S[hk], val[k], Lk, rpos[k]);
    }
  }
  __syncwarp();
  return d;
}

}  // namespace
