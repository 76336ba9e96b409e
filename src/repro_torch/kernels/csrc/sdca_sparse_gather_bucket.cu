// One bucket's per-lane partial working sets for the feature-sharded
// sparse SDCA sub-epoch, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sdca_sparse_bucket.py,
// sdca_sparse_gather_bucket (body _gather_slice_kernel): lane m of a
// worker owns the features [m*d_loc, (m+1)*d_loc) of v, and reads
// W_loc[i,k] = v_slice[idx[i,k] - lo] where it owns the feature, else an
// exact +0.0.  The owner's bits are exactly what the replicated kernel's
// gather reads (a plain load, no arithmetic).
//
// What bounds it on this card: bytes.  It reads the worker's (B, nnz)
// idx tile, the touched entries of the lane's slice (random 4-byte
// reads into a slice of d_loc floats in global memory) and writes the
// (B, nnz) partial working set; no arithmetic.
//
// What the design does about it: one thread per entry, all (worker,
// lane) blocks of the bucket in one launch (grid.y = worker x lane,
// grid.x over the tile), so neighbouring threads read neighbouring idx
// and write neighbouring W_loc entries (coalesced); only the v reads are
// scattered, and Zipf-popular features hit the L2.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sdca_sparse_gather_bucket_kernel(const int* __restrict__ idxb,
                                 const float* __restrict__ v_loc,
                                 float* __restrict__ w_loc, int M, int nb,
                                 int b, int E, int d_loc) {
  const int g = blockIdx.y;  // (worker, lane) block, lane-minor
  const int w = g / M;
  const int lane = g % M;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= E) return;
  const int p = idxb[((size_t)w * nb + b) * E + t];
  const long long q = (long long)p - (long long)lane * d_loc;
  w_loc[(size_t)g * E + t] =
      (q >= 0 && q < d_loc) ? v_loc[(size_t)g * d_loc + q] : 0.0f;
}

}  // namespace

extern "C" int sdca_sparse_gather_bucket_launch(const int* idxb,
                                                const float* v_loc,
                                                float* w_loc, int G, int M,
                                                int nb, int b, int E,
                                                int d_loc, void* stream) {
  if (G <= 0 || E <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((E + kThreads - 1) / kThreads, G);
  sdca_sparse_gather_bucket_kernel<<<grid, kThreads, 0, s>>>(
      idxb, v_loc, w_loc, M, nb, b, E, d_loc);
  return cudaGetLastError();
}
