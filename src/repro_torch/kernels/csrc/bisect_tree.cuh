// The logistic delta of objectives.cuh walked by one warp as a tree.
//
// The serial bisection evaluates g' at 40 dependent midpoints.  Here
// one warp walks it kTreeLevels levels a round: in each round lane t
// evaluates g' at the midpoint of one node of the next levels (every
// node of them once), replaying the node's path from the round's
// (lo, hi) with the serial code's mid = 0.5f*(lo+hi), and the ballot of
// the signs gives every lane the same walk down to the round's new
// (lo, hi), which the lane of the path's deepest node hands out.  Every
// evaluated point is one the serial loop evaluates, so the final
// interval is the serial one bit for bit, in 40 / kTreeLevels = 8
// dependent evaluations instead of 40.  The warp's lanes hold the 31
// nodes of 5 levels, and a round needs shuffles alone.
//
// Used by the chain warps of the SDCA kernels (sdca_bucket.cu,
// sdca_sparse_bucket.cu, sdca_sparse_sharded_bucket.cu); all 32 lanes
// of the warp call chain_delta together.
#pragma once

#include <stdint.h>

#include "objectives.cuh"

namespace {

// levels of the bisection tree walked per round: one warp's lanes hold
// its 2^5 - 1 nodes (deeper trees on more warps measured slower, PERF.md)
constexpr int kTreeLevels = 5;
static_assert(BISECT_ITERS % kTreeLevels == 0, "whole rounds");

// One round of the walk: (lo, hi) -> the interval kTreeLevels serial
// steps later.  Node n (heap order: the root is 1, n's children are 2n
// and 2n+1) is lane n - 1; lane 31 holds none (node 0).
__device__ __forceinline__ void tree_round(float& lo, float& hi, float m,
                                           float b0, float y, float q,
                                           int node, int depth) {
  // this lane's node: replay its path from the round's interval
  float l = lo, h = hi;
#pragma unroll
  for (int lev = kTreeLevels - 2; lev >= 0; --lev) {
    if (lev < depth) {
      const float mid = 0.5f * (l + h);
      if ((node >> lev) & 1) {
        l = mid;
      } else {
        h = mid;
      }
    }
  }
  const float mid = 0.5f * (l + h);
  const float gp = logistic_gprime(mid, b0, m, y, q);
  const bool up = depth < kTreeLevels && gp * y < 0.0f;
  // the new interval, should this node be the path's deepest
  const float nlo = up ? mid : l;
  const float nhi = up ? h : mid;
  const uint32_t bal = __ballot_sync(0xffffffffu, up);
  int j = 1;
#pragma unroll
  for (int s = 0; s < kTreeLevels; ++s) j = 2 * j + ((bal >> (j - 1)) & 1u);
  const int src = (j >> 1) - 1;            // the deepest node's lane
  lo = __shfl_sync(0xffffffffu, nlo, src);
  hi = __shfl_sync(0xffffffffu, nhi, src);
}

// The logistic delta of objectives.cuh (serial bisection) as a tree walk
// of kTreeLevels levels a round by the chain warp; every lane returns the
// same value.
__device__ __forceinline__ float logistic_delta_tree(float m, float a,
                                                     float y, float q,
                                                     int lane) {
  const float b0 = a * y;
  float lo = (float)1e-6;
  float hi = (float)(1.0 - 1e-6);
  const int node = lane < 31 ? lane + 1 : 0;
  const int depth = node > 0 ? 31 - __clz(node) : kTreeLevels;
#pragma unroll 1
  for (int r = 0; r < BISECT_ITERS / kTreeLevels; ++r)
    tree_round(lo, hi, m, b0, y, q, node, depth);
  const float b = 0.5f * (lo + hi);
  return (b - b0) * y;
}

template <int OBJ>
__device__ __forceinline__ float chain_delta(float m, float a, float y,
                                             float q, int lane) {
  if constexpr (OBJ == OBJ_LOGISTIC) {
    return logistic_delta_tree(m, a, y, q, lane);
  } else {
    return obj_delta<OBJ>(m, a, y, q);
  }
}

}  // namespace
