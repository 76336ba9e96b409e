// Sparse (padded-CSR) bucketed SDCA sub-epoch for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sdca_sparse_bucket.py,
// sdca_sparse_bucket_kernel (bodies _kernel, _gather_rows,
// _bucket_recursion): per bucket, gather the touched entries of v into
// a working set, run the serial recursion on it with the feature-match
// corrections, and scatter the updates back into v in visiting order.
//
// What bounds it on this card: the serial chain of n/W coordinates per
// worker.  Each coordinate's margin needs the updates of every earlier
// coordinate that shares a feature, and a logistic delta is a 40-step
// bisection of dependent logf + log1pf evaluations.  The bytes (the
// idx/val tiles, nnz entries of v per row) and FLOPs are a small
// fraction of what the card could do in that time.
//
// What the design does about it: one block per worker, all P*K workers
// in one launch, each walking its buckets in a loop (the TPU's
// sequential grid); v stays in global memory (at d = 1M it is 4 MB),
// each worker owning its replica in v_out.  Inside a block the chain is
// one warp and nothing else waits on it:
//  * The chain warp walks each row over links (sparse_recursion.cuh,
//    warp_row): lanes form the products, lane 0 sums them in k order,
//    the warp walks the delta as a tree (bisect_tree.cuh), and the
//    first lane of each run folds the run's u values into the feature's
//    cell of S.  No block barrier per row, no comparison of ids on the
//    chain.
//  * kProducerWarps producer warps stage bucket b+1 into the other of
//    two shared-memory stages while the chain works on bucket b: the
//    val tile, a, y and sigma' q / lam_n; the bucket's distinct ids in
//    an open-addressing hash table (slot[t] = the id's cell, S is
//    indexed by cell); each row's run_len, rpos and rval (an O(nnz)
//    count per entry); and the working set S[cell] = v[id].  One
//    named-barrier hand-off per bucket and stage (FULL: producers
//    arrive, the chain waits; EMPTY: the reverse), as in sdca_bucket.cu.
//    A bucket too large for two stages in shared memory (above ~2,000
//    entries) keeps them in a scratch region per block in global
//    memory, held by L1 and L2: the same code on other addresses.
//  * The bucket boundary.  Bucket b+1's working set is read from v
//    while the chain still works on bucket b, so it misses bucket b's
//    updates (Zipf-hot ids recur from bucket to bucket).  The producers
//    therefore also list the cells of bucket b+1 whose id bucket b has
//    (a probe of bucket b's table); before walking bucket b+1 the chain
//    copies those cells from bucket b's final S.  After bucket b+1's
//    first row it writes bucket b's S back into v, and only then frees
//    bucket b's stage for bucket b+2.  Every read of v is thus after
//    the write-back of every bucket but the one before, and that one
//    is patched.
// The ordered scatter is the write-back: a feature's cell starts at
// v[id] and folds the feature's u values in visiting order, so it ends
// at the scan's v[id].
//
// Bitwise contract with the plain scan (core/sdca.py sparse_scan), for
// any rows: built with -fmad=false; the margin is summed left to right
// over k with each product rounded; u = (sigma' delta / lam_n) * val is
// formed once per entry; each v entry receives the same u values, in
// the same order, as the scan adds into it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_recursion.cuh"
#include "sync.cuh"

namespace {

constexpr int kChainThreads = 32;
constexpr int kProducerWarps = 7;
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kThreads = kChainThreads + kProducers;
constexpr int kStages = 2;
// named barriers (0 is __syncthreads)
constexpr int kBarProducers = 1;
constexpr int kBarFull = 2;    // + stage
constexpr int kBarEmpty = 4;   // + stage
constexpr int kEmptyCell = -1;  // ids are >= 0

// Cells of the hash table: the power of two at or above 2E.
__device__ __forceinline__ int table_bits(int E) {
  return 32 - __clz(2 * E - 1);
}
__device__ __forceinline__ int hash_cell(int id, int bits) {
  return static_cast<int>((static_cast<uint32_t>(id) * 2654435761u) >>
                          (32 - bits));
}

// One stage, in 4-byte words (the wrapper's smem_bytes mirrors it):
//   val, slot, run_len, rpos, rval, cells (E each), patch_dst,
//   patch_src (E each), table (H ids), S (H values), a, y, q_eff (B
//   each), counts (4: distinct ids, patch pairs)
struct Stage {
  float* val;
  int* slot;
  int* run_len;
  int* rpos;
  float* rval;
  int* cells;      // the table cell of each distinct id, in no order
  int* patch_dst;  // cell of this bucket ...
  int* patch_src;  // ... <- cell of the bucket before, same id
  int* table;
  float* S;
  float* ayq;
  int* counts;
};

__device__ __forceinline__ Stage carve_stage(float* p, int E, int H, int B) {
  Stage s;
  s.val = p;
  s.slot = reinterpret_cast<int*>(s.val + E);
  s.run_len = s.slot + E;
  s.rpos = s.run_len + E;
  s.rval = reinterpret_cast<float*>(s.rpos + E);
  s.cells = reinterpret_cast<int*>(s.rval + E);
  s.patch_dst = s.cells + E;
  s.patch_src = s.patch_dst + E;
  s.table = s.patch_src + E;
  s.S = reinterpret_cast<float*>(s.table + H);
  s.ayq = s.S + H;
  s.counts = reinterpret_cast<int*>(s.ayq + 3 * B);
  return s;
}

__device__ __forceinline__ int stage_words(int E, int H, int B) {
  return 8 * E + 2 * H + 3 * B + 4;
}

// The producers' copy of the bucket's ids (E words), then the stages:
// in shared memory behind prod where they fit, else in the block's
// scratch region in global memory (the same code on other addresses).
__device__ __forceinline__ size_t region_words(int E, int H, int B) {
  return (size_t)E + (size_t)kStages * stage_words(E, H, B);
}

struct Smem {
  float* prod;    // round4(nnz), 16-byte aligned, in shared memory: the
                  // chain's products
  int* idx;       // E: the producers' copy of the bucket's ids
  float* stages;  // kStages x stage_words
  int E, H, B;
  __device__ __forceinline__ Stage stage(int si) const {
    return carve_stage(stages + (size_t)si * stage_words(E, H, B), E, H, B);
  }
};

__device__ __forceinline__ Smem carve(float* prod, float* region, int E,
                                      int H, int B) {
  Smem s;
  s.prod = prod;
  s.idx = reinterpret_cast<int*>(region);
  s.stages = region + E;
  s.E = E;
  s.H = H;
  s.B = B;
  return s;
}

// Appends `value` to list[*count] for every lane of `act` whose `put`
// is set, with one atomic add for the warp; returns the lane's index.
__device__ __forceinline__ int append_warp(int* list, int* count, bool put,
                                           int value, unsigned act,
                                           int lane) {
  const unsigned puts = __ballot_sync(act, put);
  if (puts == 0) return -1;
  const int first = __ffs(puts) - 1;
  int base = 0;
  if (lane == first) base = atomicAdd(count, __popc(puts));
  base = __shfl_sync(act, base, first);
  const int at = base + __popc(puts & ((1u << lane) - 1u));
  if (put) list[at] = value;
  return at;
}

__device__ void producer(const Smem& sm, const int* __restrict__ idxw,
                         const float* __restrict__ valw,
                         const float* __restrict__ yw,
                         const float* __restrict__ aw,
                         const float* __restrict__ qw, const float* v,
                         int nb, int B, int nnz, float lam_n, float sig) {
  const int ptid = threadIdx.x - kChainThreads;
  const int lane = ptid % 32;
  const int E = B * nnz;
  const int bits = table_bits(E);
  const int H = 1 << bits;
  for (int b = 0; b < nb; ++b) {
    const int si = b % kStages;
    const Stage s = sm.stage(si);
    if (b >= kStages) bar_sync(kBarEmpty + si, kThreads);
    const size_t tile = (size_t)b * E;
    // 1. the tiles in, the table cleared
    for (int t = ptid; t < E; t += kProducers) {
      sm.idx[t] = idxw[tile + t];
      s.val[t] = valw[tile + t];
    }
    for (int h = ptid; h < H; h += kProducers) s.table[h] = kEmptyCell;
    for (int i = ptid; i < B; i += kProducers) {
      s.ayq[i] = aw[(size_t)b * B + i];
      s.ayq[B + i] = yw[(size_t)b * B + i];
      s.ayq[2 * B + i] = sig * qw[(size_t)b * B + i] / lam_n;
    }
    if (ptid == 0) s.counts[0] = s.counts[1] = 0;
    bar_sync(kBarProducers, kProducers);
    // 2. links: each id's cell; each entry's row place and run length
    for (int t = ptid; t < E; t += kProducers) {
      const unsigned act = __activemask();
      const int id = sm.idx[t];
      // one lane per id of this warp probes; it claims an empty cell by
      // compare-and-swap, or finds the id where another warp put it
      const int leader = __ffs(__match_any_sync(act, id)) - 1;
      int h = hash_cell(id, bits);
      bool fresh = false;
      if (lane == leader) {
        for (;;) {
          int held = reinterpret_cast<volatile int*>(s.table)[h];
          if (held == kEmptyCell) {
            held = atomicCAS(s.table + h, kEmptyCell, id);
            fresh = held == kEmptyCell;
          }
          if (fresh || held == id) break;
          h = (h + 1) & (H - 1);
        }
      }
      h = __shfl_sync(act, h, leader);
      append_warp(s.cells, s.counts, fresh, h, act, lane);
      s.slot[t] = h;
      const int* row = sm.idx + (t / nnz) * nnz;
      const int k = t % nnz;
      int place = 0, same = 0;
      bool first = true;
#pragma unroll 4
      for (int k2 = 0; k2 < nnz; ++k2) {
        const int id2 = row[k2];
        place += (id2 < id) || (id2 == id && k2 < k);
        same += id2 == id;
        first = first && !(id2 == id && k2 < k);
      }
      s.rpos[t] = place;
      s.rval[t - k + place] = s.val[t];
      s.run_len[t] = first ? same : 0;
    }
    bar_sync(kBarProducers, kProducers);
    // 3. the working set from v (missing the bucket before's updates)
    // and the cells that bucket has too, for the chain to patch
    const int F = s.counts[0];
    const Stage prev = sm.stage((b + kStages - 1) % kStages);
    for (int f = ptid; f < F; f += kProducers) {
      const int h = s.cells[f];
      const int id = s.table[h];
      s.S[h] = v[id];
      if (b > 0) {
        const unsigned act = __activemask();
        int hp = hash_cell(id, bits);
        for (int other; (other = prev.table[hp]) != id;) {
          if (other == kEmptyCell) {
            hp = -1;
            break;
          }
          hp = (hp + 1) & (H - 1);
        }
        const int p = append_warp(s.patch_dst, s.counts + 1, hp >= 0, h, act,
                                  lane);
        if (hp >= 0) s.patch_src[p] = hp;
      }
    }
    __threadfence_block();
    bar_arrive(kBarFull + si, kThreads);
  }
}

// v[id] = S[cell] for every distinct id of a stage's bucket.
__device__ __forceinline__ void write_back(const Stage& s, float* v,
                                          int lane) {
  const int F = s.counts[0];
#pragma unroll 4
  for (int f = lane; f < F; f += 32) {
    const int h = s.cells[f];
    v[s.table[h]] = s.S[h];
  }
}

template <int OBJ>
__device__ void chain(const Smem& sm, float* v, float* __restrict__ a_out,
                      int nb, int B, int nnz, float lam_n, float sig) {
  const int lane = threadIdx.x;
  for (int b = 0; b < nb; ++b) {
    const int si = b % kStages;
    const Stage s = sm.stage(si);
    bar_sync(kBarFull + si, kThreads);
    const int pi = (b + kStages - 1) % kStages;
    const Stage prev = sm.stage(pi);
    if (b > 0) {
      const int np = s.counts[1];
#pragma unroll 4
      for (int p = lane; p < np; p += 32)
        s.S[s.patch_dst[p]] = prev.S[s.patch_src[p]];
      __syncwarp();
    }
    for (int i = 0; i < B; ++i) {
      const int r = i * nnz;
      const float a = s.ayq[i];
      const float d = warp_row<OBJ>(s.S, s.slot + r, s.run_len + r,
                                    s.rpos + r, s.rval + r, s.val + r,
                                    sm.prod, nnz, a, s.ayq[B + i],
                                    s.ayq[2 * B + i], lam_n, sig, lane);
      if (lane == 0) a_out[(size_t)b * B + i] = a + d;
      // bucket b-1's write-back, after the first row so that its stores
      // drain behind the walk; then its stage is free for bucket b+1
      if (i == 0 && b > 0) {
        write_back(prev, v, lane);
        if (b + 1 < nb) {
          __threadfence_block();
          bar_arrive(kBarEmpty + pi, kThreads);
        }
      }
    }
  }
  write_back(sm.stage((nb - 1) % kStages), v, lane);
}

template <int OBJ, bool kStagesInSmem>
__global__ void __launch_bounds__(kThreads, 1)
sdca_sparse_bucket_kernel(const int* __restrict__ idxb,
                          const float* __restrict__ valb,
                          const float* __restrict__ yb,
                          const float* __restrict__ ab,
                          const float* __restrict__ qb,
                          const float* __restrict__ v0,
                          float* __restrict__ a_out, float* v_out,
                          float* stages_g, int nb, int B, int nnz, int d_pad,
                          float lam_n, float sig) {
  extern __shared__ __align__(16) float smem[];
  const int w = blockIdx.x;
  const int E = B * nnz;
  const int H = 1 << table_bits(E);
  float* region = kStagesInSmem
                      ? smem + ((nnz + 3) & ~3)
                      : stages_g + (size_t)w * region_words(E, H, B);
  const Smem sm = carve(smem, region, E, H, B);
  float* v = v_out + (size_t)w * d_pad;
  const float* v0w = v0 + (size_t)w * d_pad;
  if (d_pad % 4 == 0) {
    const float4* src = reinterpret_cast<const float4*>(v0w);
    float4* dst = reinterpret_cast<float4*>(v);
    for (int f = threadIdx.x; f < d_pad / 4; f += kThreads) dst[f] = src[f];
  } else {
    for (int f = threadIdx.x; f < d_pad; f += kThreads) v[f] = v0w[f];
  }
  __syncthreads();
  const size_t row0 = (size_t)w * nb * B;
  if (threadIdx.x < kChainThreads) {
    chain<OBJ>(sm, v, a_out + row0, nb, B, nnz, lam_n, sig);
  } else {
    producer(sm, idxb + row0 * nnz, valb + row0 * nnz, yb + row0, ab + row0,
             qb + row0, v, nb, B, nnz, lam_n, sig);
  }
}

template <int OBJ, bool kStagesInSmem>
cudaError_t launch_as(const int* idxb, const float* valb, const float* yb,
                      const float* ab, const float* qb, const float* v0,
                      float* a_out, float* v_out, float* stages_g, int W,
                      int nb, int B, int nnz, int d_pad, float lam_n,
                      float sig, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sdca_sparse_bucket_kernel<OBJ, kStagesInSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  sdca_sparse_bucket_kernel<OBJ, kStagesInSmem>
      <<<W, kThreads, smem_bytes, stream>>>(idxb, valb, yb, ab, qb, v0, a_out,
                                            v_out, stages_g, nb, B, nnz,
                                            d_pad, lam_n, sig);
  return cudaGetLastError();
}

// stages_g null: the stages in shared memory
template <int OBJ>
cudaError_t launch(const int* idxb, const float* valb, const float* yb,
                   const float* ab, const float* qb, const float* v0,
                   float* a_out, float* v_out, float* stages_g, int W, int nb,
                   int B, int nnz, int d_pad, float lam_n, float sig,
                   int smem_bytes, cudaStream_t stream) {
  return stages_g == nullptr
             ? launch_as<OBJ, true>(idxb, valb, yb, ab, qb, v0, a_out, v_out,
                                    stages_g, W, nb, B, nnz, d_pad, lam_n,
                                    sig, smem_bytes, stream)
             : launch_as<OBJ, false>(idxb, valb, yb, ab, qb, v0, a_out,
                                     v_out, stages_g, W, nb, B, nnz, d_pad,
                                     lam_n, sig, smem_bytes, stream);
}

}  // namespace

extern "C" int sdca_sparse_bucket_launch(const int* idxb, const float* valb,
                                         const float* yb, const float* ab,
                                         const float* qb, const float* v0,
                                         float* a_out, float* v_out,
                                         float* stages_g, int W, int nb,
                                         int B, int nnz, int d_pad,
                                         float lam_n, float sig, int obj,
                                         int smem_bytes, void* stream) {
  if (B <= 0 || nnz <= 0 || d_pad <= 0) return cudaErrorInvalidValue;
  if (W <= 0 || nb <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (obj) {
    case OBJ_RIDGE:
      return launch<OBJ_RIDGE>(idxb, valb, yb, ab, qb, v0, a_out, v_out,
                               stages_g, W, nb, B, nnz, d_pad, lam_n, sig,
                               smem_bytes, s);
    case OBJ_HINGE:
      return launch<OBJ_HINGE>(idxb, valb, yb, ab, qb, v0, a_out, v_out,
                               stages_g, W, nb, B, nnz, d_pad, lam_n, sig,
                               smem_bytes, s);
    case OBJ_LOGISTIC:
      return launch<OBJ_LOGISTIC>(idxb, valb, yb, ab, qb, v0, a_out, v_out,
                                  stages_g, W, nb, B, nnz, d_pad, lam_n, sig,
                                  smem_bytes, s);
    default:
      return cudaErrorInvalidValue;
  }
}
