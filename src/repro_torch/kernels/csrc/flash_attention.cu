// Online-softmax (flash) attention forward on Hopper (sm_90a), f32 math
// on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention_kernel (body _kernel): for every (batch, head) and
// query row, o = softmax(scale * q k^T + mask) v with the running
// (max m, sum l, accumulator acc) state, so no score row ever reaches
// device memory.  Masks: causal (kpos <= qpos), local (causal and
// qpos - kpos < window) or full; keys past Sk in the last kv tile are
// masked (the ragged edge; kv is never padded); a kv tile that is
// masked for every row of the q tile is never visited.  GQA: head h
// reads kv head h / (H / Hkv).  Masked scores are
// the reference's finite -1e30, so a row's state resets exactly
// (exp(-1e30 - m) == 0) once it meets its first unmasked key.  A row
// with no unmasked key at all is undefined, as in the reference.
//
// Layout: q (B, Sq, H, hd), k (B, Sk, Hkv, hd), v (B, Sk, Hkv, hd_v),
// o (B, Sq, H, hd_v), all contiguous, f32 or bf16 (one source,
// templated on the element type); o in q's type.  hd, hd_v <= 256.
// Every score, max, sum, exponential and product is f32 on the CUDA
// cores (no tensor cores: an f32 tensor-core product would be TF32,
// which the port does not use); the kernel is held to the plain PyTorch
// version within the reference's own tolerance.  The wrapper sends it
// all f32 inputs and the bf16 head widths that flash_attention_tc.cu
// (wgmma on the bf16 tensor cores, built at the width pairs of its
// `Tile` table, which cover every served config) does not take.
//
// What bounds it on this card: operations, at the f32 CUDA-core rate
// (67 TFLOP/s): 2 (hd + hd_v) per unmasked (query, key) pair.
//
// What the design does about it: one block of 256 threads per (64-row
// q tile, batch x head); the block walks only the kv tiles its mask
// can reach, 64 keys at a time.  Each thread owns a 4 x 4 patch of the
// 64 x 64 score tile (rows ty + 16 i, columns tx + 16 j) and a
// 4 x (16 NJ) patch of the output accumulator in registers, so every
// shared-memory load feeds 2-4 FMAs.  Row max and row sum reduce over
// the 16 threads of a row with warp shuffles (a row's 16 threads are one
// half-warp).
//
// Shared memory (f32, whatever the input type; +1 pads keep the
// strided reads free of bank conflicts):
//   Q tile   64 x (hd + 1)      K tile, transposed   hd x 65
//   V tile   64 x hd_v          P tile               64 x 65
// = 214,528 bytes at hd = hd_v = 256 (recurrentgemma: one block per
// SM, under the 232,448-byte opt-in) and 66,304 bytes at hd = 64
// (smollm: three blocks per SM).  Registers: 64 accumulators at
// hd_v = 256 plus the 16 scores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;             // q rows per block
constexpr int kBK = 64;             // keys per kv tile
constexpr int kTY = 16, kTX = 16;   // thread grid over the score tile
constexpr int kThreads = kTY * kTX;
constexpr int kRI = kBQ / kTY;      // score rows per thread
constexpr int kCJ = kBK / kTX;      // score columns per thread
constexpr float kNegInf = -1e30f;

enum Kind { kCausal = 0, kLocal = 1, kFull = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int H, int Hkv, int hd, int hd_v, int kind,
                       int window, float scale) {
  extern __shared__ float smem[];
  const int QS = hd + 1, KS = kBK + 1, PS = kBK + 1;
  float* Qs = smem;              // kBQ x QS
  float* Kt = Qs + kBQ * QS;     // hd x KS (transposed)
  float* Vs = Kt + hd * KS;      // kBK x hd_v
  float* Ps = Vs + kBK * hd_v;   // kBQ x PS

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q_start = blockIdx.x * kBQ;
  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;

  const size_t q_row = (size_t)H * hd, k_row = (size_t)Hkv * hd;
  const size_t v_row = (size_t)Hkv * hd_v, o_row = (size_t)H * hd_v;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * hd;
  const T* kb = k + (size_t)b * Sk * k_row + (size_t)hk * hd;
  const T* vb = v + (size_t)b * Sk * v_row + (size_t)hk * hd_v;
  T* ob = o + (size_t)b * Sq * o_row + (size_t)h * hd_v;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd, qp = q_start + r;
    Qs[r * QS + d] = qp < Sq ? to_f(qb[(size_t)qp * q_row + d]) : 0.f;
  }

  float m[kRI], l[kRI], acc[kRI][NJ];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // the kv tiles the q tile's mask reaches (the reference's tile skip)
  const int q_end = q_start + kBQ - 1;
  int kt_end = (Sk + kBK - 1) / kBK;
  if (kind != kFull) kt_end = min(kt_end, q_end / kBK + 1);
  int kt_begin = 0;
  if (kind == kLocal && q_start - window + 1 > 0)
    kt_begin = (q_start - window + 1) / kBK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_start = kt * kBK;
    __syncthreads();  // the previous tile's K/V/P reads are done
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int r = e / hd, d = e - r * hd, kp = k_start + r;
      Kt[d * KS + r] = kp < Sk ? to_f(kb[(size_t)kp * k_row + d]) : 0.f;
    }
    for (int e = tid; e < kBK * hd_v; e += kThreads) {
      const int r = e / hd_v, c = e - r * hd_v, kp = k_start + r;
      Vs[r * hd_v + c] = kp < Sk ? to_f(vb[(size_t)kp * v_row + c]) : 0.f;
    }
    __syncthreads();

    float s[kRI][kCJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRI], kv[kCJ];
#pragma unroll
      for (int i = 0; i < kRI; ++i) qv[i] = Qs[(ty + kTY * i) * QS + d];
#pragma unroll
      for (int j = 0; j < kCJ; ++j) kv[j] = Kt[d * KS + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < kCJ; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int qp = q_start + ty + kTY * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int kp = k_start + tx + kTX * j;
        bool ok = kp < Sk;
        if (kind == kCausal) ok = ok && qp >= kp;
        else if (kind == kLocal) ok = ok && qp >= kp && qp - kp < window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + kTY * i) * PS + tx + kTX * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + ps;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRI];
#pragma unroll
      for (int i = 0; i < kRI; ++i) pv[i] = Ps[(ty + kTY * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + kTX * j;
        const float vv = c < hd_v ? Vs[kk * hd_v + c] : 0.f;
#pragma unroll
        for (int i = 0; i < kRI; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int qp = q_start + ty + kTY * i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + kTX * j;
      if (c < hd_v) store(&ob[(size_t)qp * o_row + c], acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int Hkv, int hd, int hd_v, int kind,
           int window, float scale, int smem, cudaStream_t stream) {
  auto fn = flash_attention_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hkv, hd,
      hd_v, kind, window, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_nj(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int H, int Hkv, int hd, int hd_v, int kind,
              int window, float scale, int smem, cudaStream_t stream) {
  if (hd_v <= 4 * kTX)
    return launch<T, 4>(q, k, v, o, B, Sq, Sk, H, Hkv, hd, hd_v, kind,
                        window, scale, smem, stream);
  if (hd_v <= 8 * kTX)
    return launch<T, 8>(q, k, v, o, B, Sq, Sk, H, Hkv, hd, hd_v, kind,
                        window, scale, smem, stream);
  return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, Hkv, hd, hd_v, kind,
                       window, scale, smem, stream);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int Hkv, int hd,
                                      int hd_v, int kind, int window,
                                      float scale, int dtype, int smem,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return cudaSuccess;
  if (hd <= 0 || hd > 256 || hd_v <= 0 || hd_v > 256 || Hkv <= 0 ||
      H % Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_nj<float>(q, k, v, o, B, Sq, Sk, H, Hkv, hd, hd_v, kind,
                            window, scale, smem, s);
  if (dtype == 1)
    return launch_nj<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Hkv, hd, hd_v,
                                    kind, window, scale, smem, s);
  return cudaErrorInvalidValue;
}
