// One bucket's working set for the feature-sharded sparse SDCA
// sub-epoch, on Hopper (sm_90a): every entry takes the bits of the v
// slice that owns its feature.
//
// Replaces the TPU kernel src/repro/kernels/sdca_sparse_bucket.py,
// sdca_sparse_gather_bucket (body _gather_slice_kernel), and with it
// the all-gather and owner-select that follow it on the reference's
// mesh.  Lane m of a worker owns the features [m*d_loc, (m+1)*d_loc)
// of v.  v_held (Wk, Mh, d_loc) holds the slices of lanes m0 ..
// m0+Mh-1; they are contiguous, so v_held[w] is v's features
// [m0*d_loc, (m0+Mh)*d_loc) in order, and an entry is one load:
//   W[w, e] = v_held[w, :, :].flat[id - m0*d_loc]  where that is held,
//   W[w, e] = +0.0                                  elsewhere,
// with the owner's own bits (-0.0 included).  Mh = M, m0 = 0 (every
// slice held) gives the exchanged working set that B4 reads on every
// lane; Mh = 1, m0 = m gives the TPU kernel's W_loc of lane m.
//
// What bounds it on this card: bytes, and the latency of the random
// reads of v.  Per worker it reads the bucket's E = B*nnz ids, the
// touched v entries (random 4-byte reads, a 32-byte sector each) and
// writes E values; no arithmetic.
//
// What the design does about it: one launch over every worker, one
// thread per 4 consecutive entries (grid.y = worker): one 16-byte read
// of the ids on the non-coherent path, not kept in L1 (no thread reads
// them again); the ownership test as one unsigned compare; four
// independent v loads in flight; one 16-byte store of W, an ordinary
// store that leaves W in the L2 for B4, which reads it next.  Where E
// is not a multiple of 4 or a base is not 16-byte aligned, the same
// threads take their 4 entries with 4-byte loads and stores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // consecutive entries per thread

__device__ __forceinline__ int4 load_ids(const int* p) {
  int4 r;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
sdca_sparse_gather_bucket_kernel(const int* __restrict__ idxb,
                                 const float* __restrict__ v_held,
                                 float* __restrict__ W, int nb, int b, int E,
                                 long long lo, long long span) {
  const int w = blockIdx.y;
  const int e0 = (blockIdx.x * kThreads + threadIdx.x) * kPer;
  if (e0 >= E) return;
  const int* ids = idxb + ((size_t)w * nb + b) * E + e0;
  const float* vw = v_held + (size_t)w * span;
  float* out = W + (size_t)w * E + e0;

  long long q[kPer];
  if (kVec) {
    const int4 p = load_ids(ids);
    q[0] = p.x - lo;
    q[1] = p.y - lo;
    q[2] = p.z - lo;
    q[3] = p.w - lo;
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) q[j] = e0 + j < E ? ids[j] - lo : -1;
  }
  bool held[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    held[j] = (unsigned long long)q[j] < (unsigned long long)span;

  float x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) x[j] = held[j] ? __ldg(vw + q[j]) : 0.0f;

  if (kVec) {
    *reinterpret_cast<float4*>(out) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (e0 + j < E) out[j] = x[j];
  }
}

template <bool kVec>
cudaError_t launch_as(const int* idxb, const float* v_held, float* W, int Wk,
                      int nb, int b, int E, long long lo, long long span,
                      cudaStream_t stream) {
  const int per_worker = (E + kPer - 1) / kPer;
  const dim3 grid((per_worker + kThreads - 1) / kThreads, Wk);
  sdca_sparse_gather_bucket_kernel<kVec><<<grid, kThreads, 0, stream>>>(
      idxb, v_held, W, nb, b, E, lo, span);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sdca_sparse_gather_bucket_launch(const int* idxb,
                                                const float* v_held, float* W,
                                                int Wk, int nb, int b, int E,
                                                int Mh, int m0, int d_loc,
                                                void* stream) {
  if (Wk <= 0 || E <= 0) return cudaSuccess;
  if (Wk > 65535 || Mh <= 0 || d_loc <= 0 || m0 < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long lo = (long long)m0 * d_loc;
  const long long span = (long long)Mh * d_loc;
  const bool vec = E % kPer == 0 &&
                   reinterpret_cast<uintptr_t>(idxb) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(W) % 16 == 0;
  return vec ? launch_as<true>(idxb, v_held, W, Wk, nb, b, E, lo, span, s)
             : launch_as<false>(idxb, v_held, W, Wk, nb, b, E, lo, span, s);
}
