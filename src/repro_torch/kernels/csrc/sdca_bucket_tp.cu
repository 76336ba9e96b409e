// One bucket of the dense tensor-parallel SDCA sub-epoch on Hopper
// (sm_90a), around the model lanes' exchange: bucket b's solve and
// bucket b+1's partials in one launch, so that each model lane can run
// in its own process and the tile is staged once.
//
// Replaces, with the whole-tile kernel sdca_bucket.cu, the TPU kernel
// src/repro/kernels/sdca_bucket.py, sdca_bucket_kernel, in the form
// its tensor-parallel caller runs it (src/repro/core/sdca.py
// dense_local_subepoch with model_axis: per bucket the lanes' packed
// [m0 | G] partials are psum'd over 'model', every lane runs the same
// recursion on the sum, and each lane updates its own rows of v).  The
// caller drives it as
//
//     parts = step(b = -1, nxt = 0)        // bucket 0's partials
//     for b in 0 .. nb-1:
//         total = the lane-ordered sum of parts over 'model'
//         a[b], parts = step(b, b + 1)     // the last step forms none
//
// so a sub-epoch of nb buckets is nb + 1 launches.  One block per
// (worker, lane) of kThreads threads:
//
//  * the chain warp (warp 0) reads its worker's summed [m0 | G] of
//    bucket b into shared memory and walks the bucket's B-step recursion
//    on it (dense_recursion.cuh's bucket_recursion, the logistic
//    bisection as a tree, bisect_tree.cuh), then writes the duals and
//    hands the deltas to the compute warps (named barrier kBarDeltas);
//  * the producer (lane 0 of warp 1) streams the lane's rows of the
//    tiles through kSlots shared-memory slots with bulk asynchronous
//    copies (cp.async.bulk, completing on each slot's FULL mbarrier;
//    the compute warps free a slot on its EMPTY mbarrier).  A lane's rows
//    of a bucket are one contiguous span; a stage is `rows` of them
//    (layout_of), so shared memory does not grow with d_loc.  All the
//    copies the slots hold are issued at kernel entry and overlap the
//    chain;
//  * the kComputeWarps compute warps first form bucket nxt's Gram matrix
//    G = X^T X, which does not depend on v, while the chain runs: lane l
//    holds a kTile x kTile tile of G's upper triangle in registers
//    (passes of 32 tiles while B needs more; when a pass has fewer, the
//    warp's lanes hold it lane_groups times over), and row group g =
//    cw + kComputeWarps * (lane group) takes the rows f = g (mod
//    kComputeWarps * lane groups) in ascending order; the groups'
//    partials are summed in group order and mirrored.  Then, per stage
//    and once the deltas are in, each row f of bucket b gives v_new[f] =
//    v[f] + (sigma'/lam_n) sum_i x[f][i] delta_i (one thread a row,
//    row_dot's order), written to v in place, and bucket nxt's m0 =
//    X^T v_new accumulates from it, warp cw taking the rows f = cw (mod
//    kComputeWarps) in ascending order (lane j a coordinate), the warps'
//    partials summed in warp order.
//
// Every sum's order depends on d_loc, B and the block's own data only,
// never on W, Mh, the block's place in the grid or the alignment of its
// rows, so a lane run alone is bitwise the same lane of a stacked launch
// (what a process mesh rests on).  No atomics.
//
// What bounds it: the recursion's serial chain, as in B1 (≈ 26 µs a
// logistic bucket of 16 on the H100); the tile's bytes (64 KB at
// epsilon's d_loc 1,000 and B 16) arrive while it runs and G is formed
// while it runs, so only the v update and m0 follow it (≈ 2,400 cycles a
// stage of 240 rows at B 16, two compute warps a scheduler; PERF.md has
// the timeline).  fp32 on the CUDA cores, built with the common flags,
// as B1 is.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_recursion.cuh"
#include "objectives.cuh"
#include "sync.cuh"

namespace {

constexpr int kComputeWarps = 8;
constexpr int kComputeThreads = 32 * kComputeWarps;
constexpr int kThreads = 64 + kComputeThreads;  // chain, producer, compute
constexpr int kSlots = 10;                      // shared-memory stages
constexpr int kSlotFloats = 4096;               // a slot's rows of x and v
constexpr int kTile = 4;                        // a lane's G tile
constexpr int kTotalSmemMaxB = 64;              // [m0 | G] staged up to it
constexpr int kMaxBucket = 512;
constexpr int kRedFloats = 32 * kTile * kTile;  // a warp's partials
// named barriers (0 is __syncthreads)
constexpr int kBarCompute = 1;  // the compute warps
constexpr int kBarDeltas = 2;   // the chain warp and the compute warps

static_assert(kRedFloats >= kMaxBucket, "a warp's m0 partials fit its row");

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// The block's dynamic shared memory, in floats, each part 16-byte
// aligned: FULL and EMPTY mbarriers (kSlots each) | kSlots slots, each
// a stage's x rows and v rows, each with room for a 3-float offset |
// kComputeWarps rows of partials | two v_new buffers | a, y, q, deltas |
// the worker's [m0 | G] when B <= kTotalSmemMaxB (else read in place).
struct Layout {
  int rows;        // rows of a stage, a multiple of kComputeWarps * groups
  int x_floats;    // a slot's x region
  int slot_floats;
  int total_in_smem;
  int bytes;
};

// G's upper triangle in kTile x kTile tiles; a pass gives each lane one
// (32 tiles a pass, or all of them), and a warp's lanes hold a pass's
// tiles `lane_groups` times over, each group on its own rows.
__host__ __device__ inline int gram_tiles(int B) {
  const int nT = (B + kTile - 1) / kTile;
  return nT * (nT + 1) / 2;
}
__host__ __device__ inline int lane_groups(int B) {
  const int T = gram_tiles(B);
  return 32 / (T < 32 ? T : 32);
}

__host__ __device__ inline Layout layout_of(int B) {
  Layout L;
  const int ng = kComputeWarps * lane_groups(B);  // the rows' groups
  const int r = kSlotFloats / (B + 1) / ng * ng;
  L.rows = r > ng ? r : ng;
  L.x_floats = round4(L.rows * B + 3);
  L.slot_floats = L.x_floats + round4(L.rows + 3);
  L.total_in_smem = B <= kTotalSmemMaxB;
  const int floats = 4 * kSlots + kSlots * L.slot_floats +
                     kComputeWarps * kRedFloats + 2 * round4(L.rows) +
                     4 * round4(B) +
                     (L.total_in_smem ? round4(B * (B + 1)) : 0);
  L.bytes = 4 * floats;
  return L;
}

struct Smem {
  uint64_t* full;
  uint64_t* empty;
  float* slots;
  float* red;
  float* vbuf;
  float *a, *y, *q, *del;
  float* total;  // nullptr: the worker's [m0 | G] in global memory
};

__device__ __forceinline__ Smem carve(float* smem, const Layout& L, int B) {
  Smem s;
  s.full = reinterpret_cast<uint64_t*>(smem);
  s.empty = s.full + kSlots;
  s.slots = smem + 4 * kSlots;
  s.red = s.slots + kSlots * L.slot_floats;
  s.vbuf = s.red + kComputeWarps * kRedFloats;
  s.a = s.vbuf + 2 * round4(L.rows);
  s.y = s.a + round4(B);
  s.q = s.y + round4(B);
  s.del = s.q + round4(B);
  s.total = L.total_in_smem ? s.del + round4(B) : nullptr;
  return s;
}

struct StepArgs {
  const float* total;  // (W, B, 1 + B) the lane-summed partials of b
  const float* xb;     // (W, nb, Mh * d_loc, B)
  const float* yb;     // (W, nb, B)
  const float* ab;
  float* v;            // (W, Mh * d_loc), updated in place
  float* a_out;        // (W, Mh, B)
  float* parts;        // (W, Mh, B, 1 + B) bucket nxt's partials
  int Mh, nb, b, nxt, d_loc, B;
  float lam_n, sig;
};

// ---- mbarriers and bulk copies ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// The producer's arrival, with the bytes its bulk copies will bring.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Waits for the completion of the phase of parity `parity`.  A wait that
// outlasts any legitimate run (~5 s of cycles) traps, so a broken
// hand-off ends the launch with an error instead of hanging the card.
__device__ __forceinline__ bool mbar_try(uint32_t a, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(a), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(a, parity)) {
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// n floats at src staged into the region at dst, at the offset
// (src's address mod 16) / 4, so that both agree mod 16 bytes: the
// 16-byte-aligned middle [lo, hi) goes by one bulk copy, the at most
// 3 + 3 floats around it by the producer thread.
struct Span {
  const float* src;
  float* dst;  // where src[0] lands
  int n, lo, hi;
};

__device__ __forceinline__ int offset_of(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

__device__ __forceinline__ Span span_of(float* region, const float* src,
                                        int n) {
  Span s;
  s.src = src;
  s.n = n;
  const int off = offset_of(src);
  s.dst = region + off;
  s.lo = (4 - off) & 3;
  s.hi = ((off + n) & ~3) - off;
  if (s.hi <= s.lo) s.lo = s.hi = n;  // no whole 16 bytes: all by hand
  return s;
}

// ---- the staged items ------------------------------------------------

// The launch's items in the order the producer fills the slots and the
// compute warps drain them: with nxt, `passes` sweeps of bucket nxt's K
// stages (its Gram matrix); then per stage k the rows of bucket b with
// the v rows they update, and the rows of bucket nxt (with the v rows
// when there is no solve).
struct Item {
  int tile, k, with_v;
};

__device__ __forceinline__ Item item_at(int q, int b, int nxt, int K,
                                        int passes) {
  const int q1 = nxt >= 0 ? passes * K : 0;
  if (q < q1) return {nxt, q % K, 0};
  q -= q1;
  const int per = (b >= 0) + (nxt >= 0);
  const int k = q / per;
  if (b >= 0 && q % per == 0) return {b, k, 1};
  return {nxt, k, b < 0};
}

// One (worker, lane)'s rows: bucket t's span and its v slice.
struct LaneRows {
  const float* x0;   // bucket 0's span
  size_t stride;     // floats from one bucket's span to the next
  float* v;          // the lane's slice of v
  int d_loc, B, rows;
  __device__ const float* x(int t, int k) const {
    return x0 + t * stride + (size_t)k * rows * B;
  }
  __device__ int rows_of(int k) const {
    const int left = d_loc - k * rows;
    return left < rows ? left : rows;
  }
};

// ---- the chain warp --------------------------------------------------

template <int OBJ, int MPL>
__device__ void chain(const Smem& sm, const StepArgs& p, int w, int g) {
  const int lane = threadIdx.x;
  const int B = p.B, ld = B + 1;
  const float* P = p.total + (size_t)w * B * ld;  // the worker's [m0 | G]
  if (sm.total != nullptr) {
    for (int t = lane; t < B * ld; t += 32) sm.total[t] = P[t];
    P = sm.total;
  }
  const size_t row = ((size_t)w * p.nb + p.b) * B;
  for (int i = lane; i < B; i += 32) {
    sm.a[i] = p.ab[row + i];
    sm.y[i] = p.yb[row + i];
  }
  __syncwarp();
  for (int i = lane; i < B; i += 32)
    sm.q[i] = p.sig * P[(size_t)i * ld + 1 + i] / p.lam_n;
  float mg[MPL];
#pragma unroll
  for (int k = 0; k < MPL; ++k) {
    const int j = lane + 32 * k;
    mg[k] = j < B ? P[(size_t)j * ld] : 0.0f;
  }
  __syncwarp();
  bucket_recursion<OBJ, MPL>(mg, P + 1, ld, sm.a, sm.y, sm.q, sm.del, B,
                             p.lam_n, p.sig, lane);
  __syncwarp();
  for (int i = lane; i < B; i += 32)
    p.a_out[(size_t)g * B + i] = sm.a[i] + sm.del[i];
  bar_arrive(kBarDeltas, 32 + kComputeThreads);
}

// ---- the producer ----------------------------------------------------

__device__ void producer(const Smem& sm, const Layout& L, const LaneRows& lr,
                         int b, int nxt, int K, int passes, int Q) {
  for (int q = 0; q < Q; ++q) {
    const int s = q % kSlots;
    if (q >= kSlots) mbar_wait(sm.empty + s, ((q / kSlots) - 1) & 1);
    const Item it = item_at(q, b, nxt, K, passes);
    const int rows = lr.rows_of(it.k);
    float* slot = sm.slots + (size_t)s * L.slot_floats;
    Span sp[2];
    sp[0] = span_of(slot, lr.x(it.tile, it.k), rows * lr.B);
    sp[1] = span_of(slot + L.x_floats, lr.v + (size_t)it.k * lr.rows,
                    it.with_v ? rows : 0);
    uint32_t bytes = 0;
    for (const Span& c : sp) {
      for (int i = 0; i < c.lo; ++i) c.dst[i] = c.src[i];
      for (int i = c.hi; i < c.n; ++i) c.dst[i] = c.src[i];
      bytes += 4u * (c.hi - c.lo);
    }
    // the hand copies before any later bulk write to the same bytes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive_expect_tx(sm.full + s, bytes);
    for (const Span& c : sp) {
      if (c.hi > c.lo)
        bulk_copy(c.dst + c.lo, c.src + c.lo, 4u * (c.hi - c.lo),
                  sm.full + s);
    }
  }
}

// ---- the compute warps -----------------------------------------------

// The 4 entries of a staged row at p, column c (zeros past B).  VEC:
// the rows are 16-byte aligned (B % 4 == 0 and aligned tiles), one
// 16-byte load.
template <bool VEC>
__device__ __forceinline__ void load4(float (&o)[kTile], const float* p,
                                      int c, int B) {
  if (VEC) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x;
    o[1] = t.y;
    o[2] = t.z;
    o[3] = t.w;
  } else {
#pragma unroll
    for (int a = 0; a < kTile; ++a) o[a] = c + a < B ? p[a] : 0.0f;
  }
}

// (X delta)_f of staged row f: the sum of x_i delta_i over 4-column
// blocks from block (f >> 1) & 3 on, wrapping, each block's columns
// ascending (8 consecutive rows then read 16-byte blocks in distinct
// banks); over the columns ascending when B % 4 != 0.
template <bool VEC>
__device__ __forceinline__ float row_dot(const float* x, const float* del,
                                         int B, int f) {
  float s = 0.0f;
  if (B % 4 == 0) {
    const int nc = B / 4;
    int c = ((f >> 1) & 3) % nc;
    for (int n = 0; n < nc; ++n) {
      float t[4];
      load4<VEC>(t, x + 4 * c, 4 * c, B);
#pragma unroll
      for (int e = 0; e < 4; ++e) s += t[e] * del[4 * c + e];
      c = c + 1 == nc ? 0 : c + 1;
    }
  } else {
    for (int i = 0; i < B; ++i) s += x[i] * del[i];
  }
  return s;
}

// Tile t of G's upper triangle, row-major over (ti <= tj).
__device__ __forceinline__ void tile_coords(int t, int nT, int& ti,
                                            int& tj) {
  ti = 0;
  while (t >= nT - ti) {
    t -= nT - ti;
    ++ti;
  }
  tj = ti + t;
}

__device__ __forceinline__ void wait_slot(const Smem& sm, int q) {
  mbar_wait(sm.full + q % kSlots, (q / kSlots) & 1);
}

__device__ __forceinline__ void release_slot(const Smem& sm, int q,
                                             int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(sm.empty + q % kSlots);
}

template <int MPL, bool VEC>
__device__ void compute(const Smem& sm, const Layout& L, const LaneRows& lr,
                        const StepArgs& p, int g, int K, int passes) {
  const int ct = threadIdx.x - 64, cw = ct >> 5, lane = ct & 31;
  const int B = p.B, ld = B + 1;
  const int nT = (B + kTile - 1) / kTile, T = gram_tiles(B);
  const int per = T < 32 ? T : 32, LG = lane_groups(B);
  const int lg = lane / per, step = kComputeWarps * LG;  // rows apart
  float* out = p.parts + (size_t)g * B * ld;
  const bool have_b = p.b >= 0, have_n = p.nxt >= 0;
  auto slot = [&](int i) {
    return sm.slots + (size_t)(i % kSlots) * L.slot_floats;
  };
  int q = 0;

  // 1. bucket nxt's Gram matrix, one pass of `per` tiles at a time: lane
  // group lg of warp cw takes the rows f = cw + kComputeWarps lg (mod
  // step), tile pass * per + lane % per
  if (have_n) {
    for (int pass = 0; pass < passes; ++pass) {
      const int t = pass * per + lane % per;
      const bool mine = lg < LG && t < T;
      int ti = 0, tj = 0;
      if (mine) tile_coords(t, nT, ti, tj);
      float acc[kTile][kTile];
#pragma unroll
      for (int a = 0; a < kTile; ++a)
#pragma unroll
        for (int c = 0; c < kTile; ++c) acc[a][c] = 0.0f;
      for (int k = 0; k < K; ++k, ++q) {
        wait_slot(sm, q);
        const int r0 = cw + kComputeWarps * lg;
        const float* x = slot(q) + offset_of(lr.x(p.nxt, k)) + r0 * B;
        const int rows = lr.rows_of(k);
        if (mine) {
          const float* pi = x + kTile * ti;
          const float* pj = x + kTile * tj;
#pragma unroll 4
          for (int r = r0; r < rows; r += step) {
            float xi[kTile], xj[kTile];
            load4<VEC>(xi, pi, kTile * ti, B);
            load4<VEC>(xj, pj, kTile * tj, B);
#pragma unroll
            for (int a = 0; a < kTile; ++a)
#pragma unroll
              for (int c = 0; c < kTile; ++c) acc[a][c] += xi[a] * xj[c];
            pi += step * B;
            pj += step * B;
          }
        }
        release_slot(sm, q, lane);
      }
      // the groups' partials, summed in the order of their rows mod step
      float* red = sm.red + cw * kRedFloats + lane * kTile * kTile;
#pragma unroll
      for (int a = 0; a < kTile; ++a)
#pragma unroll
        for (int c = 0; c < kTile; ++c) red[a * kTile + c] = acc[a][c];
      bar_sync(kBarCompute, kComputeThreads);
      for (int e = ct; e < per * kTile * kTile; e += kComputeThreads) {
        const int te = pass * per + e / (kTile * kTile);
        if (te >= T) continue;
        int ei, ej;
        tile_coords(te, nT, ei, ej);
        const int i = kTile * ei + (e / kTile) % kTile;
        const int j = kTile * ej + e % kTile;
        if (i >= B || j >= B) continue;
        float s = 0.0f;
        for (int gi = 0; gi < step; ++gi) {
          const float* rg = sm.red + (gi % kComputeWarps) * kRedFloats +
                            (gi / kComputeWarps) * per * kTile * kTile;
          s = gi == 0 ? rg[e] : s + rg[e];
        }
        out[(size_t)i * ld + 1 + j] = s;
        if (ei != ej) out[(size_t)j * ld + 1 + i] = s;
      }
      bar_sync(kBarCompute, kComputeThreads);
    }
  }

  // 2. per stage: bucket b's rows update v, bucket nxt's rows take m0
  if (have_b) bar_sync(kBarDeltas, 32 + kComputeThreads);
  const float vscale = p.sig / p.lam_n;
  float m0[MPL];
#pragma unroll
  for (int k = 0; k < MPL; ++k) m0[k] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int rows = lr.rows_of(k);
    const float* vrow = lr.v + (size_t)k * lr.rows;
    const float* vb = nullptr;
    const int q_b = q, q_n = q + have_b;
    if (have_b) {
      wait_slot(sm, q_b);
      const float* x = slot(q_b) + offset_of(lr.x(p.b, k));
      const float* vs = slot(q_b) + L.x_floats + offset_of(vrow);
      float* vn = sm.vbuf + (k & 1) * round4(L.rows);
      for (int r = ct; r < rows; r += kComputeThreads) {
        const float val =
            vs[r] + vscale * row_dot<VEC>(x + (size_t)r * B, sm.del, B, r);
        lr.v[(size_t)k * lr.rows + r] = val;
        vn[r] = val;
      }
      vb = vn;
      if (have_n) bar_sync(kBarCompute, kComputeThreads);
    }
    if (have_n) {
      wait_slot(sm, q_n);
      const float* x = slot(q_n) + offset_of(lr.x(p.nxt, k)) + cw * B +
                       lane;
      if (!have_b) vb = slot(q_n) + L.x_floats + offset_of(vrow);
      const float* vr = vb + cw;
#pragma unroll 8
      for (int r = cw; r < rows; r += kComputeWarps) {
        const float vf = *vr;
#pragma unroll
        for (int kk = 0; kk < MPL; ++kk) {
          if (lane + 32 * kk < B) m0[kk] += x[32 * kk] * vf;
        }
        x += kComputeWarps * B;
        vr += kComputeWarps;
      }
    }
    if (have_b) release_slot(sm, q_b, lane);
    if (have_n) release_slot(sm, q_n, lane);
    q += have_b + have_n;
  }
  if (have_n) {
#pragma unroll
    for (int kk = 0; kk < MPL; ++kk) {
      const int j = lane + 32 * kk;
      if (j < B) sm.red[cw * kRedFloats + j] = m0[kk];
    }
    bar_sync(kBarCompute, kComputeThreads);
    for (int j = ct; j < B; j += kComputeThreads) {
      float s = sm.red[j];
      for (int wp = 1; wp < kComputeWarps; ++wp)
        s += sm.red[wp * kRedFloats + j];
      out[(size_t)j * ld] = s;
    }
  }
}

// ---- the kernel and its launcher ---------------------------------------

template <int OBJ, int MPL, bool VEC>
__global__ void __launch_bounds__(kThreads, 1) tp_step_kernel(StepArgs p) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout_of(p.B);
  const Smem sm = carve(smem, L, p.B);
  const int g = blockIdx.x;  // (worker, lane), lane-minor
  const int w = g / p.Mh, m = g % p.Mh;
  const size_t d_all = (size_t)p.Mh * p.d_loc;
  LaneRows lr;
  lr.x0 = p.xb + ((size_t)w * p.nb * d_all + (size_t)m * p.d_loc) * p.B;
  lr.stride = d_all * p.B;
  lr.v = p.v + (size_t)w * d_all + (size_t)m * p.d_loc;
  lr.d_loc = p.d_loc;
  lr.B = p.B;
  lr.rows = L.rows;
  const int K = (p.d_loc + L.rows - 1) / L.rows;
  const int passes = (gram_tiles(p.B) + 31) / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(sm.full + s, 1);
      mbar_init(sm.empty + s, kComputeWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    if (p.b >= 0) chain<OBJ, MPL>(sm, p, w, g);
  } else if (warp == 1) {
    const int Q = (p.nxt >= 0 ? passes * K : 0) +
                  K * ((p.b >= 0) + (p.nxt >= 0));
    if (threadIdx.x == 32) producer(sm, L, lr, p.b, p.nxt, K, passes, Q);
  } else {
    compute<MPL, VEC>(sm, L, lr, p, g, K, passes);
  }
}

template <int OBJ, int MPL>
cudaError_t step_as(const StepArgs& p, int G, int smem, cudaStream_t s) {
  // 16-byte rows: every span of the lane's rows starts on 16 bytes
  const bool vec = p.B % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p.xb) % 16 == 0;
  auto fn = vec ? tp_step_kernel<OBJ, MPL, true>
                : tp_step_kernel<OBJ, MPL, false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fn<<<G, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int OBJ>
cudaError_t step_mpl(const StepArgs& p, int G, int smem, cudaStream_t s) {
  if (p.B <= 32) return step_as<OBJ, 1>(p, G, smem, s);
  if (p.B <= 64) return step_as<OBJ, 2>(p, G, smem, s);
  if (p.B <= 128) return step_as<OBJ, 4>(p, G, smem, s);
  if (p.B <= 256) return step_as<OBJ, 8>(p, G, smem, s);
  return step_as<OBJ, 16>(p, G, smem, s);
}

}  // namespace

// b in [-1, nb): the bucket solved (-1: none); nxt in [-1, nb): the
// bucket whose partials are formed (-1: none).  total (W, B, 1 + B) the
// lane-summed [m0 | G] of b; xb (W, nb, Mh*d_loc, B); yb, ab (W, nb, B);
// v (W, Mh*d_loc) updated in place; a_out (W, Mh, B); parts (W, Mh, B,
// 1 + B).  B <= 512; smem_bytes must be the layout's (the wrapper's
// `tp_step_smem_bytes` mirrors it; with W = 0 the call checks only its
// arguments).  Returns a cudaError_t (0 on success).
extern "C" int sdca_bucket_tp_step_launch(
    const float* total, const float* xb, const float* yb, const float* ab,
    float* v, float* a_out, float* parts, int W, int Mh, int nb, int b,
    int nxt, int d_loc, int B, float lam_n, float sig, int obj,
    int smem_bytes, void* stream) {
  if (B <= 0 || B > kMaxBucket || d_loc <= 0 || Mh <= 0 || nb <= 0 ||
      b < -1 || b >= nb || nxt < -1 || nxt >= nb || (b < 0 && nxt < 0) ||
      (b >= 0 && (total == nullptr || a_out == nullptr)) ||
      (nxt >= 0 && parts == nullptr) || smem_bytes != layout_of(B).bytes)
    return cudaErrorInvalidValue;
  if (W <= 0) return cudaSuccess;
  const StepArgs p{total, xb, yb, ab, v, a_out, parts, Mh, nb, b, nxt,
                   d_loc, B, lam_n, sig};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = W * Mh;
  switch (obj) {
    case OBJ_RIDGE:
      return step_mpl<OBJ_RIDGE>(p, G, smem_bytes, s);
    case OBJ_HINGE:
      return step_mpl<OBJ_HINGE>(p, G, smem_bytes, s);
    case OBJ_LOGISTIC:
      return step_mpl<OBJ_LOGISTIC>(p, G, smem_bytes, s);
    default:
      return cudaErrorInvalidValue;
  }
}
