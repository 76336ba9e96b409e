// Online-softmax (flash) attention backward for bf16 on Hopper's tensor
// cores (sm_90a: wgmma, TMA into swizzled tiles, mbarriers).
//
// The gradient of the TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention_kernel, which the reference's train step
// differentiates with jax.value_and_grad (the JAX package has no
// custom_vjp).  It replaces no Pallas kernel of its own: it is the
// backward of flash_attention_tc.cu's forward at the padded width pairs
// the full-width train runs launch, (64, 64) (smollm-360m, whisper-base)
// and (256, 256) (recurrentgemma-2b), for bf16 q, k, v, o and dO.  Other
// pairs, and f32, go to flash_attention_bwd.cu (f32 math on the CUDA
// cores) by flash_attention.py's `bwd_route`.  Masks: causal (kpos <=
// qpos), local (causal and qpos - kpos < window) and full, with ragged
// Sq != Sk tiles; GQA and MQA (head h reads kv head h / (H / Hkv)); the
// real scale hd^-0.5.
//
// With S = scale q k^T (masked), lse each row's log-sum-exp of S,
// P = exp(S - lse) and D = rowsum(dO o):
//   dV = P^T dO,   dS = P (dO v^T - D),   dQ = scale dS k,
//   dK = scale dS^T q.
// lse comes from the forward (flash_attention_tc.cu writes it where a
// gradient is recorded): nothing walks K to recompute it.
//
// Layout: q (B, Sq, H, hd), k (B, Sk, Hkv, hd), v (B, Sk, Hkv, hd_v),
// o and dO (B, Sq, H, hd_v), all contiguous bf16; lse (B, H, Sq) f32;
// dq, dk, dv bf16 in q's, k's and v's shapes.  Built at padded widths
// (HQ, HV), each a multiple of 64 (`Tile` below), taking the real hd and
// hd_v at run time: the tensor maps' boxes read zeros past them, as past
// Sq and Sk, and only real columns are stored.
//
// Three launches, no atomics, so the result does not depend on the order
// in which blocks run:
//   1. fa_bwd_tc_dq, one warpgroup a block per (64-row q tile, batch x
//      head), q tiles issued last first (under the causal mask the late
//      ones visit the most kv tiles).  It forms D from o and dO, reads
//      lse, and writes both, per q tile (lse as lse log2(e)), to scratch
//      for launch 2 -- zeros for rows past Sq, so launch 2 reads whole
//      tiles.  Per kv tile of its mask's reach: S = Q K^T and dP = dO V^T
//      (both operands K-major from shared memory: K and V as in the
//      forward's q k^T), P = 2^(S scale log2(e) - lse log2(e)) and
//      dS = P (dP - D) in registers, dS split into two bf16 register A
//      fragments (below) of dQ += dS K (K as an MN-major B operand, as V
//      in the forward's P V).  K and V come through a ring of TMA
//      stages.
//   2. fa_bwd_tc_dkdv, one block per (64-key kv tile, batch x kv head,
//      head chunk), kv tiles issued first first (the early ones visit the
//      most q tiles).  It works in the transposed frame, keys as wgmma's
//      M: per (head, q tile) of its walk, S^T = K Q^T and dP^T = V dO^T
//      (Q and dO K-major B operands), P^T from lse by column, dS^T =
//      P^T (dP^T - D), and dV += P^T dO, dK += dS^T Q with P^T and dS^T as
//      split register A fragments and dO and Q MN-major B operands -- every
//      operand in a layout the forward already uses, so nothing is
//      transposed through shared memory.  Q, dO and their lse and D come
//      through the ring (D and lse by a 1-D bulk copy of 512 bytes).
//   3. fa_bwd_tc_reduce, only where launch 2 split a GQA group's heads
//      over blocks: the f32 per-chunk partials of dK and dV summed over
//      the chunks in head order.
// Each output has one owner, for determinism, so S and dP are formed in
// both launches; and P and dS enter their products as two bf16 terms
// each, hi = bf16(x) and lo = bf16(x - hi) (a 16-bit significand): ten
// products of 64 x 64 x hd a tile pair where the minimum is five.
// Rounding P and dS once to bf16, as flash attention kernels usually do,
// leaves their products' error at ~2^-9 of the sum of the terms'
// magnitudes: held elementwise to the f32 plain version within rtol
// 2e-2 / atol 1e-2, that failed at smollm's dV (a CPU model of the
// roundings: 1.03x the bound) and at recurrentgemma's dK (on an NVIDIA
// H100 80GB HBM3: an error of 0.03125); with the split, the model's
// worst is 0.33x.
//
// What bounds it on this card: operations.  The five products come to
// 2 (3 hd + 2 hd_v) flops per unmasked (query, key) pair: smollm-360m's
// (B 4, S 2,048, 15 heads, GQA 3, hd 64, causal) ~8.1e10, 0.081 ms at
// the bf16 peak; recurrentgemma-2b's (1, 2,048, 10 heads, MQA, hd 256)
// ~5.4e10, 0.054 ms.
//
// Where the trouble is, and what the design does about it:
//  * MQA starves launch 2: at recurrentgemma one block per (kv tile, kv
//    head) is 32 blocks on 132 SMs, each walking 10 heads x up to 32 q
//    tiles.  Where kv tiles x B x Hkv < 132 (flash_attention.py's
//    `bwd_tc_head_split`), each block takes one head of the group and
//    writes f32 partial dK and dV for it to scratch, (B, Sk, H, hd): 42
//    MB at recurrentgemma; launch 3 sums them in head order.  Whisper
//    and smollm (768 and 640 blocks) take no split.
//  * Registers at hd 256: dK and dV for 64 keys x 256 columns are 128 +
//    128 f32 registers a thread in one warpgroup, more than there are.
//    Two warpgroups share the block's 64 keys and each owns half the
//    columns of dK and dV (64 + 64 registers); each forms S^T and dP^T
//    for the same keys in full (`kColSplit`).  Launch 1's dQ is 128
//    registers beside S and dP in one warpgroup.
//  * Shared memory at hd 256: the fixed pair (Q and dO in launch 1, K and
//    V in launch 2: 64 x 256 bf16 each, 64 KB) and two stages of the
//    other pair (128 KB), plus the stages' lse and D (1 KB), 1 KB of
//    alignment and 128 B of mbarriers: 198,784 bytes of the 232,448-byte
//    opt-in (`Config::kSmem`, flash_attention.py's `bwd_tc_smem_bytes`,
//    which the launcher requires exactly).  At hd 64, 51,328 bytes: four
//    blocks an SM.
//  * Load balance under the causal mask: launch 2's early kv tiles visit
//    the most q tiles, the reverse of launch 1; each launch issues its
//    heaviest tiles first.
//  * lse against the forward's bf16 P: the forward's l sums the f32 p
//    (before their rounding to bf16 for P V), so lse is the f32
//    log-sum-exp of the scores, as flash_attention_bwd_plain's; the
//    forward's o = sum bf16(p) v / l is the o that D reads, in both.  P
//    here is the f32 softmax (within its ex2's error), split into bf16
//    terms only as dV's A fragments; dS is formed from the f32 P and
//    split as the A fragments of dQ and dK.
#include "wgmma_tma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

enum Kind { kCausal = 0, kLocal = 1, kFull = 2 };

// q rows of a q tile and keys of a kv tile: wgmma's M in launch 1 and 2
constexpr int kBQ = 64;
constexpr int kBK = 64;
// one q tile's lse log2(e) and D in the scratch and in a stage, bytes
constexpr uint32_t kLDBytes = 2 * kBQ * 4;

template <int STAGES, int COL_SPLIT>
struct TileOf {
  static constexpr int kStages = STAGES, kColSplit = COL_SPLIT;
};
// The instantiations, by padded (q/k width, v width): ring stages, and
// the warpgroups of launch 2 that share a kv tile, each owning 1 /
// kColSplit of dK's and dV's columns.  flash_attention.py's
// BWD_TC_PAIRS mirrors this table.
template <int HQ, int HV> struct Tile;
template <> struct Tile<64, 64> : TileOf<2, 1> {};
template <> struct Tile<256, 256> : TileOf<2, 2> {};

template <int HQ, int HV>
struct Config : Tile<HQ, HV> {
  using T = Tile<HQ, HV>;
  static constexpr int kHQ = HQ, kHV = HV;
  static_assert(HQ % 64 == 0 && HV % 64 == 0, "64-column sub-tiles");
  static_assert(HQ % (64 * T::kColSplit) == 0 &&
                    HV % (64 * T::kColSplit) == 0,
                "whole sub-tiles a warpgroup");
  static_assert(8 * (1 + 2 * T::kStages) <= 128,
                "the fixed, FULL and EMPTY mbarriers fit their 128 bytes");
  // a Q or K tile, a dO or V tile: 64 rows each
  static constexpr uint32_t kABytes = 64 * HQ * 2;
  static constexpr uint32_t kBBytes = 64 * HV * 2;
  static constexpr uint32_t kPairBytes = kABytes + kBBytes;
  static constexpr uint32_t kSmem =
      (1 + T::kStages) * kPairBytes + T::kStages * kLDBytes + 1024 + 128;
  static constexpr int kThreads2 = 128 * T::kColSplit;
};

// The block's shared memory: the fixed pair, the ring's stages of the
// other pair, the stages' lse and D, the mbarriers.
struct Smem {
  uint32_t fixed, ring, ld, bar_fixed, bar_full, bar_empty, pair;
  __device__ uint32_t stage(int s) const { return ring + s * pair; }
  __device__ uint32_t full(int s) const { return bar_full + 8 * s; }
  __device__ uint32_t empty(int s) const { return bar_empty + 8 * s; }
};

template <class C>
__device__ __forceinline__ Smem smem_of(uint8_t* raw) {
  Smem m;
  m.pair = C::kPairBytes;
  m.fixed = (smem_u32(raw) + 1023) & ~1023u;
  m.ring = m.fixed + C::kPairBytes;
  m.ld = m.ring + C::kStages * C::kPairBytes;
  m.bar_fixed = m.ld + C::kStages * kLDBytes;
  m.bar_full = m.bar_fixed + 8;
  m.bar_empty = m.bar_full + 8 * C::kStages;
  return m;
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// the forward's mask, with the ragged edges of both tiles
__device__ __forceinline__ bool allowed(int qp, int kp, int Sq, int Sk,
                                        int kind, int window) {
  if (qp >= Sq || kp >= Sk) return false;
  if (kind == kCausal) return qp >= kp;
  if (kind == kLocal) return qp >= kp && qp - kp < window;
  return true;
}

// every (query, key) pair of the two tiles attends
__device__ __forceinline__ bool interior(int q_lo, int k_lo, int Sq, int Sk,
                                         int kind, int window) {
  const int q_hi = q_lo + kBQ - 1, k_hi = k_lo + kBK - 1;
  return q_hi < Sq && k_hi < Sk &&
         (kind == kFull ||
          (k_hi <= q_lo && (kind == kCausal || k_lo > q_hi - window)));
}

// wgmma_ss over `width` / 16 k-steps: D = A B^T, A and B two 64-row
// tiles with their `width` columns contiguous (K-major both)
template <int W>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const uint32_t off = (kk >> 2) * 64 * 128 + (kk & 3) * 32;
    wgmma_ss_m64n64k16(d, desc_sw128(a + off, 16, 1024),
                       desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// D += A B at n = N: A the 64 x 64 register fragments `f` (16 a thread),
// B the 64 rows x N columns at tile `b` (N contiguous: MN-major)
template <int N>
__device__ __forceinline__ void issue_rs(float (&d)[N / 2],
                                         const uint32_t (&f)[16],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<N>(d, f[4 * kk], f[4 * kk + 1], f[4 * kk + 2], f[4 * kk + 3],
                desc_sw128(b + kk * 16 * 128, 64 * 128, 1024));
}

// (a, b) as two packed bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

__device__ __forceinline__ void commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ float dot8(uint4 x, uint4 y) {
  const bf16* a = reinterpret_cast<const bf16*>(&x);
  const bf16* b = reinterpret_cast<const bf16*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    s += __bfloat162float(a[i]) * __bfloat162float(b[i]);
  return s;
}

// Stores a 64-row accumulator tile (rows ra, rb of this thread; columns
// c0 + 8 j + col0 + {0, 1}) times `mul` as bf16 rows of `width` real
// columns, row r at out + r * stride.
template <int N>
__device__ __forceinline__ void store_bf16(const float (&acc)[N / 2],
                                           bf16* out, size_t stride, int ra,
                                           int rb, int rows, int c0,
                                           int col0, int width, float mul) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = c0 + 8 * j + col0;
    if (c >= width) break;
    if (ra < rows)
      *reinterpret_cast<__nv_bfloat162*>(out + ra * stride + c) =
          __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (rb < rows)
      *reinterpret_cast<__nv_bfloat162*>(out + rb * stride + c) =
          __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// store_bf16's rows in f32, unscaled
template <int N>
__device__ __forceinline__ void store_f32(const float (&acc)[N / 2],
                                          float* out, size_t stride, int ra,
                                          int rb, int rows, int c0,
                                          int col0, int width) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = c0 + 8 * j + col0;
    if (c >= width) break;
    if (ra < rows)
      *reinterpret_cast<float2*>(out + ra * stride + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (rb < rows)
      *reinterpret_cast<float2*>(out + rb * stride + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---- launch 1: dQ, and each q tile's lse log2(e) and D --------------------
template <class C>
__global__ void __launch_bounds__(128, 1)
fa_bwd_tc_dq(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_do,
             const bf16* __restrict__ o, const bf16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ ld,
             bf16* __restrict__ dq, int Sq, int Sk, int H, int Hkv, int hd,
             int hd_v, int kind, int window, float scale_log2, float scale) {
  constexpr int HQ = C::kHQ, HV = C::kHV, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = smem_of<C>(smem_raw);
  const uint32_t sQ = sm.fixed, sdO = sm.fixed + C::kABytes;

  const int ntq = gridDim.y;
  const int qt = ntq - 1 - blockIdx.y;
  const int q_start = qt * kBQ;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  // the kv tiles this q tile's mask reaches (the forward's tile skip)
  int kt_end = (Sk + kBK - 1) / kBK;
  if (kind != kFull)
    kt_end = min(kt_end, (min(q_start + kBQ, Sq) - 1) / kBK + 1);
  int kt_begin = 0;
  if (kind == kLocal && q_start - window + 1 > 0)
    kt_begin = (q_start - window + 1) / kBK;
  kt_end = max(kt_end, kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(sm.bar_fixed, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_kv = [&](int kt) {
    const int s = (kt - kt_begin) % kStages;
    const uint32_t sK = sm.stage(s), full = sm.full(s);
    mbar_arrive_expect_tx(full, C::kPairBytes);
#pragma unroll
    for (int c = 0; c < HQ / 64; ++c)
      tma_load_4d(sK + c * kBK * 128, &tm_k, full, 64 * c, hk, kt * kBK, b);
#pragma unroll
    for (int c = 0; c < HV / 64; ++c)
      tma_load_4d(sK + C::kABytes + c * kBK * 128, &tm_v, full, 64 * c, hk,
                  kt * kBK, b);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(sm.bar_fixed, C::kPairBytes);
#pragma unroll
    for (int c = 0; c < HQ / 64; ++c)
      tma_load_4d(sQ + c * kBQ * 128, &tm_q, sm.bar_fixed, 64 * c, h,
                  q_start, b);
#pragma unroll
    for (int c = 0; c < HV / 64; ++c)
      tma_load_4d(sdO + c * kBQ * 128, &tm_do, sm.bar_fixed, 64 * c, h,
                  q_start, b);
    for (int kt = kt_begin; kt < min(kt_end, kt_begin + kStages); ++kt)
      load_kv(kt);
  }

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int qa = q_start + 16 * warp + lane / 4, qb = qa + 8;
  const int col0 = 2 * (lane % 4), part = lane % 4;

  // D = rowsum(dO o) of rows qa and qb (a quad's four threads split the
  // columns), and the rows' lse log2(e), while the tiles land
  const size_t o_row = (size_t)H * hd_v;
  const size_t o_at = ((size_t)b * Sq * H + h) * hd_v;
  float D_a = 0.f, D_b = 0.f;
  for (int c = 8 * part; c < hd_v; c += 32) {
    if (qa < Sq)
      D_a += dot8(*reinterpret_cast<const uint4*>(o + o_at + qa * o_row + c),
                  *reinterpret_cast<const uint4*>(dout + o_at + qa * o_row +
                                                  c));
    if (qb < Sq)
      D_b += dot8(*reinterpret_cast<const uint4*>(o + o_at + qb * o_row + c),
                  *reinterpret_cast<const uint4*>(dout + o_at + qb * o_row +
                                                  c));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    D_a += __shfl_xor_sync(0xffffffffu, D_a, off);
    D_b += __shfl_xor_sync(0xffffffffu, D_b, off);
  }
  const float L_a = qa < Sq ? lse[(size_t)bh * Sq + qa] * kLog2e : 0.f;
  const float L_b = qb < Sq ? lse[(size_t)bh * Sq + qb] * kLog2e : 0.f;
  if (part == 0) {   // launch 2's whole-tile copy: zeros past Sq
    float* t = ld + ((size_t)bh * ntq + qt) * (2 * kBQ);
    t[qa - q_start] = L_a;
    t[kBQ + qa - q_start] = D_a;
    t[qb - q_start] = L_b;
    t[kBQ + qb - q_start] = D_b;
  }

  auto stage = [&](int kt) { return (kt - kt_begin) % kStages; };
  // Release tile kt; warp 0 then refills its stage with tile kt + kStages
  // once every thread has released kt.
  auto release = [&](int kt) {
    const uint32_t empty = sm.empty(stage(kt));
    mbar_arrive(empty);
    if (warp == 0 && kt + kStages < kt_end) {
      mbar_wait(empty, ((kt - kt_begin) / kStages) & 1);
      if (threadIdx.x == 0) load_kv(kt + kStages);
      __syncwarp();
    }
  };

  float acc[HQ / 2];
#pragma unroll
  for (int i = 0; i < HQ / 2; ++i) acc[i] = 0.f;
  mbar_wait(sm.bar_fixed, 0);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int s = stage(kt);
    mbar_wait(sm.full(s), ((kt - kt_begin) / kStages) & 1);
    const uint32_t sK = sm.stage(s), sV = sK + C::kABytes;
    float sc[32], dp[32];
    wgmma_fence();
    issue_ss<HQ>(sc, sQ, sK);
    issue_ss<HV>(dp, sdO, sV);
    commit_and_wait();
    fence_regs(sc);
    fence_regs(dp);
    const int k_lo = kt * kBK;
    const bool edge = !interior(q_start, k_lo, Sq, Sk, kind, window);
    uint32_t ds[16], ds_lo[16];
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const bool rb = r & 2;
      const float L = rb ? L_b : L_a, D = rb ? D_b : D_a;
      const int qp = rb ? qb : qa;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = ex2(fmaf(sc[r + e], scale_log2, -L));
        if (edge && !allowed(qp, k_lo + 8 * (r >> 2) + col0 + e, Sq, Sk,
                             kind, window))
          p = 0.f;
        v[e] = p * (dp[r + e] - D);
      }
      split_bf16(v[0], v[1], ds[r / 2], ds_lo[r / 2]);
    }
    fence_regs(acc);
    wgmma_fence();
    issue_rs<HQ>(acc, ds, sK);
    issue_rs<HQ>(acc, ds_lo, sK);
    commit_and_wait();
    fence_regs(acc);
    release(kt);
  }

  const size_t q_row = (size_t)H * hd;
  store_bf16<HQ>(acc, dq + ((size_t)b * Sq * H + h) * hd, q_row, qa, qb, Sq,
                 0, col0, hd, scale);
}

// ---- launch 2: dK and dV in the transposed frame --------------------------
template <class C>
__global__ void __launch_bounds__(C::kThreads2, 1)
fa_bwd_tc_dkdv(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const float* __restrict__ ld, bf16* __restrict__ dk,
               bf16* __restrict__ dv, float* __restrict__ part_k,
               float* __restrict__ part_v, int Sq, int Sk, int H, int Hkv,
               int hd, int hd_v, int kind, int window, float scale_log2,
               float scale, int split) {
  constexpr int HQ = C::kHQ, HV = C::kHV, kStages = C::kStages;
  constexpr int NQ = HQ / C::kColSplit, NV = HV / C::kColSplit;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = smem_of<C>(smem_raw);
  const uint32_t sK = sm.fixed, sV = sm.fixed + C::kABytes;

  const int kt = blockIdx.y;
  const int k_start = kt * kBK;
  const int sp = blockIdx.x % split;
  const int bk = blockIdx.x / split;
  const int b = bk / Hkv, hk = bk % Hkv;
  const int G = H / Hkv, gc = G / split;
  const int h_first = hk * G + sp * gc;
  const int ntq = (Sq + kBQ - 1) / kBQ;
  // the q tiles whose rows reach these keys
  int qt_end = ntq;
  const int qt_begin = kind == kFull ? 0 : k_start / kBQ;
  if (kind == kLocal) {
    const long long k_last = min(k_start + kBK, Sk) - 1;
    qt_end = min(qt_end,
                 (int)(min((long long)Sq - 1, k_last + window - 1) / kBQ) + 1);
  }
  const int nq = max(qt_end - qt_begin, 0);
  const int n_it = gc * nq;   // (head, q tile) pairs, heads in order

  if (threadIdx.x == 0) {
    mbar_init(sm.bar_fixed, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), C::kThreads2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_it = [&](int it) {
    const int s = it % kStages;
    const int h = h_first + it / nq, qt = qt_begin + it % nq;
    const uint32_t sQ = sm.stage(s), full = sm.full(s);
    mbar_arrive_expect_tx(full, C::kPairBytes + kLDBytes);
#pragma unroll
    for (int c = 0; c < HQ / 64; ++c)
      tma_load_4d(sQ + c * kBQ * 128, &tm_q, full, 64 * c, h, qt * kBQ, b);
#pragma unroll
    for (int c = 0; c < HV / 64; ++c)
      tma_load_4d(sQ + C::kABytes + c * kBQ * 128, &tm_do, full, 64 * c, h,
                  qt * kBQ, b);
    bulk_load(sm.ld + s * kLDBytes,
              ld + (((size_t)b * H + h) * ntq + qt) * (2 * kBQ), kLDBytes,
              full);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(sm.bar_fixed, C::kPairBytes);
#pragma unroll
    for (int c = 0; c < HQ / 64; ++c)
      tma_load_4d(sK + c * kBK * 128, &tm_k, sm.bar_fixed, 64 * c, hk,
                  k_start, b);
#pragma unroll
    for (int c = 0; c < HV / 64; ++c)
      tma_load_4d(sV + c * kBK * 128, &tm_v, sm.bar_fixed, 64 * c, hk,
                  k_start, b);
    for (int it = 0; it < min(n_it, kStages); ++it) load_it(it);
  }

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int wg = warp / 4, t = threadIdx.x % 128, lane = t % 32;
  const int ka = k_start + 16 * (t / 32) + lane / 4, kb = ka + 8;
  const int col0 = 2 * (lane % 4);
  const int cq = wg * NQ, cv = wg * NV;   // this warpgroup's columns
  const float* lds = reinterpret_cast<const float*>(
      smem_raw + (sm.ld - smem_u32(smem_raw)));

  auto release = [&](int it) {
    const uint32_t empty = sm.empty(it % kStages);
    mbar_arrive(empty);
    if (warp == 0 && it + kStages < n_it) {
      mbar_wait(empty, (it / kStages) & 1);
      if (threadIdx.x == 0) load_it(it + kStages);
      __syncwarp();
    }
  };

  float acc_k[NQ / 2], acc_v[NV / 2];
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) acc_k[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc_v[i] = 0.f;
  mbar_wait(sm.bar_fixed, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    mbar_wait(sm.full(s), (it / kStages) & 1);
    const int q_start = (qt_begin + it % nq) * kBQ;
    const uint32_t sQ = sm.stage(s), sdO = sQ + C::kABytes;
    const float* L = lds + s * (2 * kBQ);
    float st[32], dpt[32];
    wgmma_fence();
    issue_ss<HQ>(st, sK, sQ);
    issue_ss<HV>(dpt, sV, sdO);
    commit_and_wait();
    fence_regs(st);
    fence_regs(dpt);
    const bool edge = !interior(q_start, k_start, Sq, Sk, kind, window);
    uint32_t pf[16], pf_lo[16], dsf[16], dsf_lo[16];
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int kp = (r & 2) ? kb : ka;
      const int c = 8 * (r >> 2) + col0;   // the q tile's column (row)
      const float2 l2 = *reinterpret_cast<const float2*>(L + c);
      const float2 dd = *reinterpret_cast<const float2*>(L + kBQ + c);
      float p[2], d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = ex2(fmaf(st[r + e], scale_log2, -(e ? l2.y : l2.x)));
        if (edge && !allowed(q_start + c + e, kp, Sq, Sk, kind, window))
          p[e] = 0.f;
        d[e] = p[e] * (dpt[r + e] - (e ? dd.y : dd.x));
      }
      split_bf16(p[0], p[1], pf[r / 2], pf_lo[r / 2]);
      split_bf16(d[0], d[1], dsf[r / 2], dsf_lo[r / 2]);
    }
    fence_regs(acc_v);
    fence_regs(acc_k);
    wgmma_fence();
    issue_rs<NV>(acc_v, pf, sdO + (cv / 64) * kBQ * 128);
    issue_rs<NV>(acc_v, pf_lo, sdO + (cv / 64) * kBQ * 128);
    issue_rs<NQ>(acc_k, dsf, sQ + (cq / 64) * kBQ * 128);
    issue_rs<NQ>(acc_k, dsf_lo, sQ + (cq / 64) * kBQ * 128);
    commit_and_wait();
    fence_regs(acc_v);
    fence_regs(acc_k);
    release(it);
  }

  if (split == 1) {
    const size_t k_row = (size_t)Hkv * hd, v_row = (size_t)Hkv * hd_v;
    store_bf16<NQ>(acc_k, dk + ((size_t)b * Sk * Hkv + hk) * hd, k_row, ka,
                   kb, Sk, cq, col0, hd, scale);
    store_bf16<NV>(acc_v, dv + ((size_t)b * Sk * Hkv + hk) * hd_v, v_row,
                   ka, kb, Sk, cv, col0, hd_v, 1.f);
    return;
  }
  // this head chunk's f32 partials, (B, Sk, Hkv x split, width)
  const size_t rows = (size_t)Hkv * split, slot = hk * split + sp;
  store_f32<NQ>(acc_k, part_k + ((size_t)b * Sk * rows + slot) * hd,
                rows * hd, ka, kb, Sk, cq, col0, hd);
  store_f32<NV>(acc_v, part_v + ((size_t)b * Sk * rows + slot) * hd_v,
                rows * hd_v, ka, kb, Sk, cv, col0, hd_v);
}

// ---- launch 3: the head chunks' partials summed in order -------------------
// out[r][c] = mul * sum over s of part[r][s][c], s ascending; r over
// B x Sk x Hkv rows of `width` columns.
__global__ void __launch_bounds__(256)
fa_bwd_tc_reduce(const float* __restrict__ part, bf16* __restrict__ out,
                 long long rows, int split, int width, float mul) {
  const long long i = blockIdx.x * 256ll + threadIdx.x;
  if (i >= rows * width) return;
  const long long r = i / width;
  const int c = (int)(i - r * width);
  const float* p = part + r * split * width + c;
  float s = p[0];
  for (int k = 1; k < split; ++k) s += p[(size_t)k * width];
  out[i] = __float2bfloat16(s * mul);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float *ld, *part_k, *part_v;
  int B, Sq, Sk, H, Hkv, hd, hd_v, kind, window;
  float scale_log2, scale;
  int split, smem;
  cudaStream_t stream;
};

template <int HQ, int HV>
int launch(const Args& a) {
  using C = Config<HQ, HV>;
  if (a.smem != static_cast<int>(C::kSmem)) return cudaErrorInvalidValue;
  // contiguous tensors: (head, row, batch) element strides
  const long long sq[3] = {a.hd, (long long)a.H * a.hd,
                           (long long)a.Sq * a.H * a.hd};
  const long long sk[3] = {a.hd, (long long)a.Hkv * a.hd,
                           (long long)a.Sk * a.Hkv * a.hd};
  const long long sv[3] = {a.hd_v, (long long)a.Hkv * a.hd_v,
                           (long long)a.Sk * a.Hkv * a.hd_v};
  const long long so[3] = {a.hd_v, (long long)a.H * a.hd_v,
                           (long long)a.Sq * a.H * a.hd_v};
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!tensor_map(&tm_q, a.q, a.hd, a.H, a.Sq, a.B, sq, kBQ) ||
      !tensor_map(&tm_k, a.k, a.hd, a.Hkv, a.Sk, a.B, sk, kBK) ||
      !tensor_map(&tm_v, a.v, a.hd_v, a.Hkv, a.Sk, a.B, sv, kBK) ||
      !tensor_map(&tm_do, a.dout, a.hd_v, a.H, a.Sq, a.B, so, kBQ))
    return cudaErrorInvalidValue;
  auto f1 = fa_bwd_tc_dq<C>;
  auto f2 = fa_bwd_tc_dkdv<C>;
  static bool smem_set = false;   // the opt-in, once (one size a pair)
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        f1, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          f2, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int ntq = (a.Sq + kBQ - 1) / kBQ, nkt = (a.Sk + kBK - 1) / kBK;
  if (ntq > 65535 || nkt > 65535) return cudaErrorInvalidValue;
  f1<<<dim3(a.B * a.H, ntq), 128, C::kSmem, a.stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const bf16*>(a.o),
      static_cast<const bf16*>(a.dout), a.lse, a.ld, static_cast<bf16*>(a.dq),
      a.Sq, a.Sk, a.H, a.Hkv, a.hd, a.hd_v, a.kind, a.window, a.scale_log2,
      a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  f2<<<dim3(a.B * a.Hkv * a.split, nkt), C::kThreads2, C::kSmem, a.stream>>>(
      tm_q, tm_k, tm_v, tm_do, a.ld, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.part_k, a.part_v, a.Sq, a.Sk, a.H, a.Hkv,
      a.hd, a.hd_v, a.kind, a.window, a.scale_log2, a.scale, a.split);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.split == 1) return err;
  const long long rows = (long long)a.B * a.Sk * a.Hkv;
  for (int w = 0; w < 2; ++w) {
    const int width = w ? a.hd_v : a.hd;
    const long long n = rows * width;
    fa_bwd_tc_reduce<<<(unsigned)((n + 255) / 256), 256, 0, a.stream>>>(
        w ? a.part_v : a.part_k, static_cast<bf16*>(w ? a.dv : a.dk), rows,
        a.split, width, w ? 1.f : a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// All launches on `stream`: dq with the scratch `ld` ((B, H, ceil(Sq /
// 64), 2, 64) f32: each q tile's lse log2(e), then its D), then dk and
// dv, then (split > 1) their sums over the head chunks from the scratch
// part_k (B, Sk, Hkv split, hd) and part_v (B, Sk, Hkv split, hd_v) f32.
// bf16 only, every tensor contiguous; hd and hd_v multiples of 8 whose
// padded pair (each rounded up to 64) is a `Tile`; split divides
// H / Hkv.  scale = hd^-0.5, scale_log2 = scale log2(e).  `smem` must be
// the pair's `Config::kSmem` (the wrapper's `bwd_tc_smem_bytes`).
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* ld, float* part_k, float* part_v, int B, int Sq, int Sk, int H,
    int Hkv, int hd, int hd_v, int kind, int window, float scale_log2,
    float scale, int split, int smem, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || hd <= 0 || hd_v <= 0 || hd % 8 != 0 ||
      hd_v % 8 != 0 || kind < 0 || kind > 2 || split <= 0 ||
      (H / Hkv) % split != 0 ||
      (split > 1 && (part_k == nullptr || part_v == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, ld, part_k, part_v, B, Sq,
               Sk, H, Hkv, hd, hd_v, kind, window, scale_log2, scale, split,
               smem, static_cast<cudaStream_t>(stream)};
  const int hq = (hd + 63) / 64 * 64, hv = (hd_v + 63) / 64 * 64;
  if (hq == 64 && hv == 64) return launch<64, 64>(a);
  if (hq == 256 && hv == 256) return launch<256, 256>(a);
  return cudaErrorInvalidValue;
}
