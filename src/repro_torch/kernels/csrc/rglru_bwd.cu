// RG-LRU recurrence backward on Hopper (sm_90a).
//
// The gradient of the TPU kernel src/repro/kernels/rglru.py, rglru_kernel,
// whose function the reference's train step differentiates with
// jax.value_and_grad through its associative scan
// (src/repro/models/recurrent.py, _rglru_scan); the JAX package has no
// custom_vjp.  It replaces no Pallas kernel of its own: it is the
// backward of csrc/rglru.cu's forward,
//
//   r = sigmoid(ga_t),  i = sigmoid(gx_t),  log_a = 8 a_log[c] r
//   a = exp(log_a),  e2 = exp(2 log_a),  z = 1 - e2
//   b = sqrt(max(z, 1e-12)) (i x_t),     h_t = a h_{t-1} + b,
//
// for every (batch row, channel) from h0.  Given dh (B, T, D) in x's type
// and dh_T (B, D) f32, the gradient through the final state (zero in
// training, but honoured), with g_t = dh_t + a_{t+1} g_{t+1} the total
// gradient into h_t (g_{T-1} = dh_{T-1} + dh_T):
//
//   da = g h_{t-1},  du = g sqrt(max(z, 1e-12)),  dx = du i,
//   dgx = (du x) i (1 - i),  dz = g (i x) 0.5 / sqrt(max(z, 1e-12)) where
//   z > 1e-12 (half of it where z == 1e-12, as JAX's max splits a tie),
//   dlog_a = da a - 2 dz e2,  dga = dlog_a 8 a_log r (1 - r),
//   d a_log = 8 sum_t dlog_a r,  dh0 = a_0 g_0.
//
// Built with -fmad=false, and with the forward's f64 exps, so every
// operation rounds as the plain PyTorch version's (kernels/rglru.py
// `rglru_bwd_plain`) separate elementwise operations do: the kernel is
// bitwise equal to it.  The phases below reorder nothing that rounds.
//
// What bounds it on this card: memory, and the serial chain.  It reads x,
// ga, gx and dh once and writes dx, dga, dgx once (recurrentgemma-2b's
// train step: B 1, T 2,048, D 2,560 in bf16, ~73 MB, ~0.022 ms at 3.35
// TB/s); each step of a chain depends on the one before through one
// multiply and one add.  The one-thread-a-channel kernel this replaces
// walked T twice with the gate math (two f64 exps a step) inside the
// chain, on 40 blocks of 64 threads: ~0.83 us a step, 3.39 ms in all on
// an NVIDIA H100 80GB HBM3.
//
// What the design does about it: the chain carries only its multiply and
// add; everything else runs in parallel over (b, t, c).  Four launches
// on one stream, through f32 scratch (4 B T D floats: a, b then h, e2
// then each step's d a_log term, dh then g; ~84 MB at recurrentgemma):
//   1. rglru_bwd_gates, one thread an element: r, i, a, e2, z and
//      b = sqrt(max(z, 1e-12)) (i x) with the forward's f64 exps, and dh
//      as f32 (exact), into the scratch.
//   2. rglru_bwd_chains, one warp a block, a lane a (batch row, channel),
//      the two walks in blocks of their own, side by side (g does not
//      depend on h): the forward walk h_t = a_t h_{t-1} + b_t over b's
//      slot, and the backward walk g_t = dh_t + carry, carry = a_t g_t
//      over dh's slot; dh0 = the last carry.  Every operand comes
//      through a ring of kStages tiles of kTile steps in shared memory,
//      filled kStages - 1 tiles ahead by cp.async (a step's 32 channels
//      are one 128-byte row, copied 16 bytes a lane), so a step costs
//      its multiply and add, not a load's latency; h and g go back
//      through the ring, a tile at a time.  (Walked one after the other,
//      a lane copying and storing its own column a step at a time, the
//      two walks took 0.279 ms at recurrentgemma's shape on the H100:
//      the lone warp's instructions, not the chain, set the pace.)
//   3. rglru_bwd_grads, one thread an element: r, i, z, sqrt(max(z,
//      1e-12)) recomputed from x, ga, gx (f32 only), a and e2 from the
//      scratch, h_{t-1} and g: dx, dgx, dga, and dlog_a r over e2's slot.
//   4. rglru_bwd_dalog, the chains' ring and layout: d a_log's partial
//      8 sum_t dlog_a r, summed from t = T - 1 down to 0 as the plain
//      version's loop does.
// The partials of d a_log are (B, D) f32; the caller sums them over the
// batch rows in order, so nothing is accumulated across threads.
// Shared memory: the chains' ring, 2 x kStages x kTile x 32 floats (96
// KiB; rglru.py's `bwd_smem_bytes`; two blocks fit an SM), and half of
// it in launch 4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // elementwise launches
constexpr int kLanes = 32;      // chain lanes a block: one warp
constexpr int kTile = 32;       // steps a ring stage
constexpr int kStages = 12;
constexpr int kRingFloats = kStages * kTile * kLanes;   // one array

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// csrc/rglru.cu's exp: through f64, rounded once to f32
__device__ __forceinline__ float exp_rn(float v) {
  return static_cast<float>(exp(static_cast<double>(v)));
}
__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// ---- launch 1: the gates --------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_gates(const T* __restrict__ x, const T* __restrict__ ga,
                const T* __restrict__ gx, const float* __restrict__ a_log,
                const T* __restrict__ dh, float* __restrict__ sa,
                float* __restrict__ sb, float* __restrict__ se2,
                float* __restrict__ sg, long long n, int D) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const float r = sigmoid(to_f(ga[i]));
  const float iv = sigmoid(to_f(gx[i]));
  const float la = (8.0f * a_log[i % D]) * r;
  const float e2 = exp_rn(2.0f * la);
  sa[i] = exp_rn(la);
  sb[i] = sqrtf(fmaxf(1.0f - e2, 1e-12f)) * (iv * to_f(x[i]));
  se2[i] = e2;
  sg[i] = to_f(dh[i]);
}

// ---- the chains' ring -----------------------------------------------------
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One walk over t (forward, or from T - 1 down with `reverse`) of the
// block's nc channels (lane = channel): v = step(t, v), v the NA arrays'
// values at t, which come through the ring (NA x kRingFloats floats at
// `ring`, [array][stage][step][lane]); with kOut, the value step returns
// goes over the last array's slot and, a tile at a time, to `out` at the
// same element.  col0: the element of the block's first channel at t = 0.
// A step's row of 32 channels is 128 contiguous bytes: where they are all
// real and 16-byte aligned (`vec`), eight lanes copy a row (16 bytes each,
// four rows an instruction) and store it back alike, else each lane its
// own column.  The fill runs kStages - 1 tiles ahead of the walk, so a
// step costs its own arithmetic, two shared-memory loads and a store.
template <int NA, bool kOut, typename Step>
__device__ __forceinline__ void walk(float* ring,
                                     const float* const (&src)[NA],
                                     float* out, size_t col0, int nc,
                                     int Tn, int D, bool reverse,
                                     Step step) {
  const int lane = threadIdx.x % kLanes;
  const int q = lane % 8, r4 = lane / 8;   // vec: 16-byte chunk, row of 4
  const bool vec = nc == kLanes && D % 4 == 0;
  const int ntiles = (Tn + kTile - 1) / kTile;
  auto row = [&](int s) {   // element of step s's row, first channel
    return col0 + (size_t)(reverse ? Tn - 1 - s : s) * D;
  };
  auto stage = [&](int k) { return ring + (k % kStages) * kTile * kLanes; };
  auto fill = [&](int k) {   // tile k of the walk into its stage
    if (k < ntiles) {
      float* st = stage(k);
      if (vec) {
#pragma unroll
        for (int i = 0; i < kTile / 4; ++i) {
          const int j = 4 * i + r4, s = k * kTile + j;
          if (s < Tn)
#pragma unroll
            for (int a = 0; a < NA; ++a)
              cp_async16(st + a * kRingFloats + j * kLanes + 4 * q,
                         src[a] + row(s) + 4 * q);
        }
      } else if (lane < nc) {
        for (int j = 0; j < kTile && k * kTile + j < Tn; ++j)
#pragma unroll
          for (int a = 0; a < NA; ++a)
            cp_async4(st + a * kRingFloats + j * kLanes + lane,
                      src[a] + row(k * kTile + j) + lane);
      }
    }
    cp_async_commit();   // an empty group past the last tile
  };
  for (int k = 0; k < kStages - 1; ++k) fill(k);
  for (int k = 0; k < ntiles; ++k) {
    __syncwarp();                    // the stage that fill reuses is read
    fill(k + kStages - 1);
    cp_async_wait<kStages - 1>();    // tile k has landed ...
    __syncwarp();                    // ... the other lanes' rows too
    float* st = stage(k);
    float* mine = st + lane;
    const int n = min(kTile, Tn - k * kTile);
    auto one = [&](int j) {
      float v[NA];
#pragma unroll
      for (int a = 0; a < NA; ++a) v[a] = mine[a * kRingFloats + j * kLanes];
      const float y = step(reverse ? Tn - 1 - (k * kTile + j)
                                   : k * kTile + j, v);
      if (kOut) mine[(NA - 1) * kRingFloats + j * kLanes] = y;
    };
    if (n == kTile) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) one(j);
    } else {
      for (int j = 0; j < n; ++j) one(j);
    }
    if (kOut) {
      __syncwarp();
      const float* o = st + (NA - 1) * kRingFloats;
      if (vec) {
#pragma unroll
        for (int i = 0; i < kTile / 4; ++i) {
          const int j = 4 * i + r4;
          if (j < n)
            *reinterpret_cast<float4*>(out + row(k * kTile + j) + 4 * q) =
                *reinterpret_cast<const float4*>(o + j * kLanes + 4 * q);
        }
      } else if (lane < nc) {
        for (int j = 0; j < n; ++j)
          out[row(k * kTile + j) + lane] = o[j * kLanes + lane];
      }
    }
  }
  cp_async_wait<0>();
}

// ---- launch 2: the chains -------------------------------------------------
// Two walks, independent of each other, one a block (blockIdx.z): the
// forward h_t = a_t h_{t-1} + b_t over sb (b_t, then h_t), and the
// backward g_t = dh_t + carry, carry = a_t g_t over sg (dh_t, then g_t),
// whose last carry is dh0.
__global__ void __launch_bounds__(kLanes)
rglru_bwd_chains(const float* __restrict__ sa, float* sb, float* sg,
                 const float* __restrict__ h0,
                 const float* __restrict__ dh_last, float* __restrict__ dh0,
                 int Tn, int D) {
  extern __shared__ __align__(16) float ring[];
  const int b = blockIdx.y, c0 = blockIdx.x * kLanes;
  const int c = c0 + threadIdx.x, nc = min(kLanes, D - c0);
  const bool own = c < D;
  const size_t bc = (size_t)b * D + c;
  const size_t col0 = (size_t)b * Tn * D + c0;
  if (blockIdx.z == 0) {
    float h = own ? h0[bc] : 0.0f;
    const float* src[2] = {sa, sb};
    walk<2, true>(ring, src, sb, col0, nc, Tn, D, false,
                  [&](int, const float* v) { return h = v[0] * h + v[1]; });
    return;
  }
  float carry = own ? dh_last[bc] : 0.0f;
  const float* src[2] = {sa, sg};
  walk<2, true>(ring, src, sg, col0, nc, Tn, D, true,
                [&](int, const float* v) {
                  const float g = v[1] + carry;
                  carry = v[0] * g;
                  return g;
                });
  if (own) dh0[bc] = carry;
}

// ---- launch 3: the gradients ----------------------------------------------
// sh holds h_t; se2 holds e2 and gets dlog_a r.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_grads(const T* __restrict__ x, const T* __restrict__ ga,
                const T* __restrict__ gx, const float* __restrict__ a_log,
                const float* __restrict__ h0, const float* __restrict__ sa,
                const float* __restrict__ sh, float* __restrict__ se2,
                const float* __restrict__ sg, T* __restrict__ dx,
                T* __restrict__ dga, T* __restrict__ dgx, long long n,
                int Tn, int D) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % D);
  const long long bt = i / D;
  const float al8 = 8.0f * a_log[c];
  const float xf = to_f(x[i]);
  const float r = sigmoid(to_f(ga[i]));
  const float iv = sigmoid(to_f(gx[i]));
  const float a = sa[i], e2 = se2[i], g = sg[i];
  const float z = 1.0f - e2;
  const float sq = sqrtf(fmaxf(z, 1e-12f));
  const float u = iv * xf;
  const float hp = bt % Tn > 0 ? sh[i - D] : h0[(bt / Tn) * D + c];
  const float da = g * hp;
  const float du = g * sq;
  const float dsq = g * u;
  store(&dx[i], du * iv);
  store(&dgx[i], (du * xf) * (iv * (1.0f - iv)));
  const float dmax = dsq * (0.5f / sq);
  const float dz = z > 1e-12f ? dmax : z == 1e-12f ? 0.5f * dmax : 0.0f;
  const float de2 = -dz;
  const float dla = da * a + 2.0f * (de2 * e2);
  se2[i] = dla * r;
  store(&dga[i], (dla * al8) * (r * (1.0f - r)));
}

// ---- launch 4: d a_log, summed over t from the end ------------------------
__global__ void __launch_bounds__(kLanes)
rglru_bwd_dalog(const float* __restrict__ term, float* __restrict__ part,
                int Tn, int D) {
  extern __shared__ __align__(16) float ring[];
  const int b = blockIdx.y, c0 = blockIdx.x * kLanes;
  const int c = c0 + threadIdx.x;
  float dal = 0.0f;
  const float* src[1] = {term};
  walk<1, false>(ring, src, nullptr, (size_t)b * Tn * D + c0,
                 min(kLanes, D - c0), Tn, D, true,
                 [&](int, const float* v) { return dal = dal + v[0]; });
  if (c < D) part[(size_t)b * D + c] = 8.0f * dal;
}

template <typename T>
int launch(const void* x, const void* ga, const void* gx, const float* a_log,
           const float* h0, const void* dh, const float* dh_last,
           float* scratch, void* dx, void* dga, void* dgx, float* dh0,
           float* dal_part, int B, int Tn, int D, cudaStream_t s) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_bwd_chains, cudaFuncAttributeMaxDynamicSharedMemorySize,
        2 * kRingFloats * 4);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const long long n = (long long)B * Tn * D;
  float *sa = scratch, *sb = sa + n, *se2 = sb + n, *sg = se2 + n;
  const unsigned elem_blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const dim3 chains((D + kLanes - 1) / kLanes, B, 2);
  const dim3 dalog((D + kLanes - 1) / kLanes, B);
  const T *xt = static_cast<const T*>(x), *gat = static_cast<const T*>(ga),
          *gxt = static_cast<const T*>(gx);
  if (n > 0) {
    rglru_bwd_gates<T><<<elem_blocks, kThreads, 0, s>>>(
        xt, gat, gxt, a_log, static_cast<const T*>(dh), sa, sb, se2, sg, n,
        D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  rglru_bwd_chains<<<chains, kLanes, 2 * kRingFloats * 4, s>>>(
      sa, sb, sg, h0, dh_last, dh0, Tn, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) {
    if (err == cudaSuccess)   // T = 0: no step, d a_log's partials are 0
      err = cudaMemsetAsync(dal_part, 0, (size_t)B * D * 4, s);
    return err;
  }
  rglru_bwd_grads<T><<<elem_blocks, kThreads, 0, s>>>(
      xt, gat, gxt, a_log, h0, sa, sb, se2, sg, static_cast<T*>(dx),
      static_cast<T*>(dga), static_cast<T*>(dgx), n, Tn, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_bwd_dalog<<<dalog, kLanes, kRingFloats * 4, s>>>(se2, dal_part, Tn,
                                                         D);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x, ga, gx, dh, dx, dga, dgx); a_log, h0,
// dh_last, dh0 and dal_part f32; scratch 4 B T D floats.  Returns a
// cudaError_t (0 on success).
extern "C" int rglru_bwd_launch(const void* x, const void* ga,
                                const void* gx, const float* a_log,
                                const float* h0, const void* dh,
                                const float* dh_last, float* scratch,
                                void* dx, void* dga, void* dgx, float* dh0,
                                float* dal_part, int B, int Tn, int D,
                                int dtype, void* stream) {
  if (B <= 0 || D <= 0 || Tn < 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, ga, gx, a_log, h0, dh, dh_last, scratch, dx, dga,
                         dgx, dh0, dal_part, B, Tn, D, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ga, gx, a_log, h0, dh, dh_last, scratch,
                                 dx, dga, dgx, dh0, dal_part, B, Tn, D, s);
  return cudaErrorInvalidValue;
}
