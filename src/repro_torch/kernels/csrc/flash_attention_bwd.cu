// Online-softmax (flash) attention backward on Hopper (sm_90a), f32 math
// on the CUDA cores.
//
// The gradient of the TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention_kernel, which the reference's train step differentiates
// with jax.value_and_grad (the JAX package has no custom_vjp: autodiff
// runs through the kernel's blocked formulation).  It replaces no Pallas
// kernel of its own; it is the backward of the forward that
// flash_attention.cu and flash_attention_tc.cu compute, for every input
// they take: causal (kpos <= qpos), local (causal and qpos - kpos <
// window) and full masks, Sq != Sk, GQA (head h reads kv head
// h / (H / Hkv)), hd != hd_v (each <= 256), f32 or bf16, with the real
// scale hd^-0.5.
//
// With S = scale q k^T (masked), P = softmax(S) and D = rowsum(dO o):
//   dV = P^T dO,   dS = P (dO v^T - D),   dQ = scale dS k,
//   dK = scale dS^T q.
// Two launches, no atomics, so the result does not depend on the order
// in which blocks run:
//   1. fa_bwd_dq, one block per (64-row q tile, batch x head): walks the
//      kv tiles the tile's mask reaches twice, first for the rows' log-
//      sum-exp (the forward's running max and sum, so masked entries and
//      the reset at a row's first unmasked key behave as there), then for
//      dQ; it forms D from dO and o, and writes lse and D, (B, H, Sq) f32,
//      to scratch.  Recomputing lse here leaves both forward kernels as
//      they are.
//   2. fa_bwd_dkdv, one block per (32-key kv tile, batch x kv head): walks
//      the group's G heads and, for each, the q tiles whose mask reaches
//      the kv tile, in that fixed order, recomputing P from lse and
//      accumulating dV and dK in registers; each block owns its keys' rows
//      of dK and dV, so the sums over a GQA group never race.
// Both skip the tiles that the mask empties.
//
// Layout: q (B, Sq, H, hd), k (B, Sk, Hkv, hd), v (B, Sk, Hkv, hd_v),
// o and dO (B, Sq, H, hd_v), all contiguous and of one type; dq, dk, dv
// in that type with q's, k's and v's shapes.
//
// What bounds it on this card: operations, at the f32 CUDA-core rate
// (67 TFLOP/s): the five products come to 2 (3 hd + 2 hd_v) operations
// per unmasked (query, key) pair, and this kernel does q k^T three times
// and dO v^T twice, 2 (5 hd + 4 hd_v) in all.  Nothing here uses the
// tensor cores (a later redesign's work).
//
// What the design does about it: 256 threads a block.  A thread owns 2 x
// 4 entries of the 64 x 32 score tile (rows ty and ty + 32, columns tx +
// 8 j) and, in launch 1, a 2 x (8 NJ) patch of dQ; in launch 2 one key
// row of dK and dV, 8 NK and 8 NV columns.  Every shared-memory read in
// the inner loops is a broadcast or a run of 8 consecutive words.
//
// Shared memory (f32; +1 pads keep the strided reads free of bank
// conflicts), the same for both launches:
//   Q, dO tiles  64 x (hd + 1), 64 x (hd_v + 1)
//   K, V tiles   32 x (hd + 1), 32 x (hd_v + 1)
//   P / dS tile  64 x 33,  lse and D of the q tile  2 x 64
// = 206,336 bytes at hd = hd_v = 256 (under the 232,448-byte opt-in) and
// 58,880 bytes at hd = hd_v = 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows per tile
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 256;
constexpr int kTX = 8;         // threads across a score row
constexpr int kTY = kThreads / kTX;  // 32: rows ty and ty + 32
constexpr int kRI = kBQ / kTY;       // 2 score rows a thread
constexpr int kCJ = kBK / kTX;       // 4 score columns a thread
constexpr float kNegInf = -1e30f;
static_assert(kThreads / kTX == kBK, "one key row per 8 threads");

enum Kind { kCausal = 0, kLocal = 1, kFull = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// the forward kernels' mask, with the ragged edges of both tiles
__device__ __forceinline__ bool allowed(int qp, int kp, int Sq, int Sk,
                                        int kind, int window) {
  if (qp >= Sq || kp >= Sk) return false;
  if (kind == kCausal) return qp >= kp;
  if (kind == kLocal) return qp >= kp && qp - kp < window;
  return true;
}

// rows [r0, r0 + rows) of one head of a (S, heads, width) tensor (`src`
// at the head's first column, rows `row_stride` apart) into an f32 tile
// of pitch `pitch`; rows at or past S read as zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int r0, int rows, int S,
                                          size_t row_stride, int width,
                                          int pitch) {
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    const int r = e / width, c = e - r * width, p = r0 + r;
    dst[r * pitch + c] = p < S ? to_f(src[(size_t)p * row_stride + c]) : 0.f;
  }
}

// the 2 x 4 products of a thread's score entries over `width` columns
__device__ __forceinline__ void tile_dots(const float* __restrict__ A,
                                          const float* __restrict__ Bm,
                                          int width, int pitch, int ty,
                                          int tx, float (&s)[kRI][kCJ]) {
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < kCJ; ++j) s[i][j] = 0.f;
  for (int d = 0; d < width; ++d) {
    float a[kRI], bv[kCJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i) a[i] = A[(ty + kTY * i) * pitch + d];
#pragma unroll
    for (int j = 0; j < kCJ; ++j) bv[j] = Bm[(tx + kTX * j) * pitch + d];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) s[i][j] += a[i] * bv[j];
  }
}

__host__ __device__ constexpr int smem_floats(int hd, int hd_v) {
  return kBQ * (hd + 1) + kBQ * (hd_v + 1) + kBK * (hd + 1) +
         kBK * (hd_v + 1) + kBQ * (kBK + 1) + 2 * kBQ;
}

// [begin, end) of the kv tiles that q rows [q_start, q_start + kBQ)
// reach, as the forward kernels compute it
__device__ __forceinline__ void kv_tiles(int q_start, int Sk, int kind,
                                         int window, int& begin, int& end) {
  const int q_end = q_start + kBQ - 1;
  end = (Sk + kBK - 1) / kBK;
  if (kind != kFull) end = min(end, q_end / kBK + 1);
  begin = 0;
  if (kind == kLocal && q_start - window + 1 > 0)
    begin = (q_start - window + 1) / kBK;
}

// [begin, end) of the q tiles whose rows reach keys [k_start, k_start +
// kBK)
__device__ __forceinline__ void q_tiles(int k_start, int Sq, int Sk,
                                        int kind, int window, int& begin,
                                        int& end) {
  end = (Sq + kBQ - 1) / kBQ;
  begin = kind == kFull ? 0 : k_start / kBQ;
  if (kind == kLocal) {
    const long long k_last = min(k_start + kBK, Sk) - 1;
    const long long q_max = min((long long)Sq - 1, k_last + window - 1);
    end = min(end, (int)(q_max / kBQ) + 1);
  }
  end = max(begin, end);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const T* __restrict__ dout, T* __restrict__ dq,
          float* __restrict__ lse, float* __restrict__ dd, int Sq, int Sk,
          int H, int Hkv, int hd, int hd_v, int kind, int window,
          float scale) {
  extern __shared__ float smem[];
  const int QS = hd + 1, VS = hd_v + 1, PS = kBK + 1;
  float* Qs = smem;              // kBQ x QS
  float* dOs = Qs + kBQ * QS;    // kBQ x VS
  float* Ks = dOs + kBQ * VS;    // kBK x QS
  float* Vs = Ks + kBK * QS;     // kBK x VS
  float* Ps = Vs + kBK * VS;     // kBQ x PS: dS
  float* rowD = Ps + kBQ * PS;   // kBQ

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
  const T* ob = o + (size_t)b * Sq * o_row + (size_t)h * hd_v;
  const T* dob = dout + (size_t)b * Sq * o_row + (size_t)h * hd_v;
  T* dqb = dq + (size_t)b * Sq * q_row + (size_t)h * hd;

  load_tile(Qs, qb, q_start, kBQ, Sq, q_row, hd, QS);
  load_tile(dOs, dob, q_start, kBQ, Sq, o_row, hd_v, VS);
  __syncthreads();
  {  // D = rowsum(dO o): four threads a row (lanes 4r .. 4r + 3)
    const int r = tid / 4, part = tid % 4, qp = q_start + r;
    float acc = 0.f;
    if (qp < Sq)
      for (int c = part; c < hd_v; c += 4)
        acc += dOs[r * VS + c] * to_f(ob[(size_t)qp * o_row + c]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) rowD[r] = acc;
  }
  __syncthreads();

  int kt_begin, kt_end;
  kv_tiles(q_start, Sk, kind, window, kt_begin, kt_end);

  // pass 1: each row's log-sum-exp, as the forward's (max, sum) walk
  float m[kRI], l[kRI];
#pragma unroll
  for (int i = 0; i < kRI; ++i) m[i] = kNegInf, l[i] = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_start = kt * kBK;
    __syncthreads();
    load_tile(Ks, kb, k_start, kBK, Sk, k_row, hd, QS);
    __syncthreads();
    float s[kRI][kCJ];
    tile_dots(Qs, Ks, hd, QS, ty, tx, s);
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int qp = q_start + ty + kTY * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int kp = k_start + tx + kTX * j;
        s[i][j] = allowed(qp, kp, Sq, Sk, kind, window) ? s[i][j] * scale
                                                        : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) ps += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * expf(m[i] - m_new) + ps;
      m[i] = m_new;
    }
  }
  float L[kRI], Dr[kRI];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int r = ty + kTY * i, qp = q_start + r;
    L[i] = m[i] + logf(l[i]);
    Dr[i] = rowD[r];
    if (tx == 0 && qp < Sq) {
      const size_t at = ((size_t)bh) * Sq + qp;
      lse[at] = L[i];
      dd[at] = Dr[i];
    }
  }

  // pass 2: dS over the same tiles, dQ += dS k
  float acc[kRI][NJ];
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_start = kt * kBK;
    __syncthreads();  // the previous tile's K and dS reads are done
    load_tile(Ks, kb, k_start, kBK, Sk, k_row, hd, QS);
    load_tile(Vs, vb, k_start, kBK, Sk, v_row, hd_v, VS);
    __syncthreads();
    float s[kRI][kCJ], dp[kRI][kCJ];
    tile_dots(Qs, Ks, hd, QS, ty, tx, s);
    tile_dots(dOs, Vs, hd_v, VS, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int r = ty + kTY * i, qp = q_start + r;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int c = tx + kTX * j, kp = k_start + c;
        const float p = allowed(qp, kp, Sq, Sk, kind, window)
                            ? expf(s[i][j] * scale - L[i])
                            : 0.f;
        Ps[r * PS + c] = p * (dp[i][j] - Dr[i]);
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRI];
#pragma unroll
      for (int i = 0; i < kRI; ++i) pv[i] = Ps[(ty + kTY * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + kTX * j;
        const float kv = c < hd ? Ks[kk * QS + c] : 0.f;
#pragma unroll
        for (int i = 0; i < kRI; ++i) acc[i][j] += pv[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int qp = q_start + ty + kTY * i;
    if (qp >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + kTX * j;
      if (c < hd) store(&dqb[(size_t)qp * q_row + c], acc[i][j] * scale);
    }
  }
}

template <typename T, int NK, int NV>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dd,
            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
            int Hkv, int hd, int hd_v, int kind, int window, float scale) {
  extern __shared__ float smem[];
  const int QS = hd + 1, VS = hd_v + 1, PS = kBK + 1;
  float* Qs = smem;              // kBQ x QS
  float* dOs = Qs + kBQ * QS;    // kBQ x VS
  float* Ks = dOs + kBQ * VS;    // kBK x QS
  float* Vs = Ks + kBK * QS;     // kBK x VS
  float* Ps = Vs + kBK * VS;     // kBQ x PS: P, then dS
  float* rowL = Ps + kBQ * PS;   // kBQ
  float* rowD = rowL + kBQ;      // kBQ

  const int bk = blockIdx.y;
  const int b = bk / Hkv, hk = bk % Hkv;
  const int G = H / Hkv;
  const int k_start = blockIdx.x * kBK;
  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
  const int kr = tid / kTX;  // the key row this thread accumulates

  const size_t q_row = (size_t)H * hd, k_row = (size_t)Hkv * hd;
  const size_t v_row = (size_t)Hkv * hd_v, o_row = (size_t)H * hd_v;
  const T* kb = k + (size_t)b * Sk * k_row + (size_t)hk * hd;
  const T* vb = v + (size_t)b * Sk * v_row + (size_t)hk * hd_v;
  T* dkb = dk + (size_t)b * Sk * k_row + (size_t)hk * hd;
  T* dvb = dv + (size_t)b * Sk * v_row + (size_t)hk * hd_v;

  load_tile(Ks, kb, k_start, kBK, Sk, k_row, hd, QS);
  load_tile(Vs, vb, k_start, kBK, Sk, v_row, hd_v, VS);

  float acc_k[NK], acc_v[NV];
#pragma unroll
  for (int j = 0; j < NK; ++j) acc_k[j] = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) acc_v[j] = 0.f;

  int qt_begin, qt_end;
  q_tiles(k_start, Sq, Sk, kind, window, qt_begin, qt_end);

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * hd;
    const T* dob = dout + (size_t)b * Sq * o_row + (size_t)h * hd_v;
    const float* lb = lse + ((size_t)b * H + h) * Sq;
    const float* db = dd + ((size_t)b * H + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q_start = qt * kBQ;
      __syncthreads();  // the previous tile's Q, dO and dS reads are done
      load_tile(Qs, qb, q_start, kBQ, Sq, q_row, hd, QS);
      load_tile(dOs, dob, q_start, kBQ, Sq, o_row, hd_v, VS);
      if (tid < kBQ) {
        const int qp = q_start + tid;
        rowL[tid] = qp < Sq ? lb[qp] : 0.f;
        rowD[tid] = qp < Sq ? db[qp] : 0.f;
      }
      __syncthreads();
      float s[kRI][kCJ], dp[kRI][kCJ];
      tile_dots(Qs, Ks, hd, QS, ty, tx, s);
      tile_dots(dOs, Vs, hd_v, VS, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
        const int r = ty + kTY * i, qp = q_start + r;
#pragma unroll
        for (int j = 0; j < kCJ; ++j) {
          const int c = tx + kTX * j, kp = k_start + c;
          const float p = allowed(qp, kp, Sq, Sk, kind, window)
                              ? expf(s[i][j] * scale - rowL[r])
                              : 0.f;
          Ps[r * PS + c] = p;
          dp[i][j] = p * (dp[i][j] - rowD[r]);  // dS, kept for below
        }
      }
      __syncthreads();
      for (int r = 0; r < kBQ; ++r) {  // dV += P^T dO
        const float pv = Ps[r * PS + kr];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int c = tx + kTX * j;
          acc_v[j] += pv * (c < hd_v ? dOs[r * VS + c] : 0.f);
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < kCJ; ++j)
          Ps[(ty + kTY * i) * PS + tx + kTX * j] = dp[i][j];
      __syncthreads();
      for (int r = 0; r < kBQ; ++r) {  // dK += dS^T q
        const float sv = Ps[r * PS + kr];
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const int c = tx + kTX * j;
          acc_k[j] += sv * (c < hd ? Qs[r * QS + c] : 0.f);
        }
      }
    }
  }

  const int kp = k_start + kr;
  if (kp < Sk) {
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int c = tx + kTX * j;
      if (c < hd) store(&dkb[(size_t)kp * k_row + c], acc_k[j] * scale);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = tx + kTX * j;
      if (c < hd_v) store(&dvb[(size_t)kp * v_row + c], acc_v[j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *dd;
  int B, Sq, Sk, H, Hkv, hd, hd_v, kind, window;
  float scale;
  int smem;
  cudaStream_t stream;
};

// accumulator columns a thread takes for `width`: 8, 16 or 32
int cols(int width) { return width <= 64 ? 8 : width <= 128 ? 16 : 32; }

template <typename T, int NJ>
int launch_dq(const Args& a) {
  auto fn = fa_bwd_dq<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  fn<<<grid, kThreads, a.smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<T*>(a.dq), a.lse, a.dd,
      a.Sq, a.Sk, a.H, a.Hkv, a.hd, a.hd_v, a.kind, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int NK, int NV>
int launch_dkdv(const Args& a) {
  auto fn = fa_bwd_dkdv<T, NK, NV>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + kBK - 1) / kBK, a.B * a.Hkv);
  fn<<<grid, kThreads, a.smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.dd, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq, a.Sk, a.H,
      a.Hkv, a.hd, a.hd_v, a.kind, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int NK>
int launch_dkdv_nv(const Args& a) {
  switch (cols(a.hd_v)) {
    case 8: return launch_dkdv<T, NK, 8>(a);
    case 16: return launch_dkdv<T, NK, 16>(a);
    default: return launch_dkdv<T, NK, 32>(a);
  }
}

template <typename T>
int launch_all(const Args& a) {
  int err;
  switch (cols(a.hd)) {
    case 8: err = launch_dq<T, 8>(a); break;
    case 16: err = launch_dq<T, 16>(a); break;
    default: err = launch_dq<T, 32>(a); break;
  }
  if (err != cudaSuccess) return err;
  switch (cols(a.hd)) {
    case 8: return launch_dkdv_nv<T, 8>(a);
    case 16: return launch_dkdv_nv<T, 16>(a);
    default: return launch_dkdv_nv<T, 32>(a);
  }
}

}  // namespace

// Both launches on `stream`: dq, lse and D, then dk and dv.  dtype: 0 =
// f32, 1 = bf16.  `smem` must be the layout's bytes (the wrapper's
// `bwd_smem_bytes`).  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* dd,
    int B, int Sq, int Sk, int H, int Hkv, int hd, int hd_v, int kind,
    int window, float scale, int dtype, int smem, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return cudaSuccess;
  if (hd <= 0 || hd > 256 || hd_v <= 0 || hd_v > 256 || Hkv <= 0 ||
      H % Hkv != 0 || kind < 0 || kind > 2)
    return cudaErrorInvalidValue;
  if (smem != 4 * smem_floats(hd, hd_v)) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, dq, dk, dv, lse, dd, B, Sq, Sk, H, Hkv,
               hd, hd_v, kind, window, scale, smem,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_all<float>(a);
  if (dtype == 1) return launch_all<__nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}
