// Online-softmax (flash) attention forward for bf16 on Hopper's tensor
// cores (sm_90a: wgmma, TMA into swizzled tiles, mbarriers).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention_kernel (body _kernel), for bf16 q/k/v: for every
// (batch, head) and query row, o = softmax(scale * q k^T + mask) v with
// the running (max, sum, accumulator) state, so no score row reaches
// device memory.  Masks: causal (kpos <= qpos), local (causal and
// qpos - kpos < window) or full; keys past Sk in the last kv tile are
// masked (the ragged edge; kv is never padded); a kv tile that is masked
// for every row is never visited.  GQA: head h reads kv head
// h / (H / Hkv).  Masked scores are the reference's finite -1e30, so a
// row's state resets exactly once it meets its first unmasked key.
// f32 inputs, and bf16 at width pairs no instantiation covers, go to
// flash_attention.cu (f32 CUDA-core math; a tensor-core product of f32
// would be TF32, which the port does not use).
//
// Layout: q (B, Sq, H, hd), k (B, Sk, Hkv, hd), v (B, Sk, Hkv, hd_v),
// bf16, each read through a tensor map with its own strides (MLA's v is
// a slice of its kv tensor, read in place); o (B, Sq, H, hd_v),
// contiguous; where the caller records a gradient, each row's f32
// log-sum-exp too (B, H, Sq), which flash_attention_bwd_tc.cu reads
// (serving passes no buffer, and nothing else changes).  The kernel is
// built at padded widths (HQ, HV), each a multiple of 64 (`Tile` below:
// (64, 64), (128, 64), (128, 128), (192, 128), (256, 256)), and takes
// the real hd and hd_v at run time.
// The tensor maps' inner dimension is the real width, so a 64-column
// box that reaches past it reads zeros, as rows past Sq or Sk do; zero
// columns add nothing to q k^T or to P V, and only the columns below
// hd_v are stored.  The reference pads hd and hd_v the same way, to
// its 128-lane tile.  The scale is the real hd^-0.5.
//
// What bounds it on this card: operations.  recurrentgemma-2b's prefill
// (B 2, S 4,096, 10 heads, MQA, hd 256, window 2,048) needs ~1.3e11
// flops of unmasked pairs against ~0.1 GB of q/k/v/o: ~0.13 ms at the
// bf16 tensor-core peak; internlm2-20b's (B 1, S 2,048, 48 heads, hd
// 128, causal) ~5.2e10, ~0.052 ms.  The CUDA-core kernel took 30-150x
// that.
//
// What the design does about it:
//  * One block per (q tile, batch x head): kNC consumer warpgroups of 64
//    q rows each (`Tile`).  Blocks are issued heaviest q tile first
//    across the whole grid (the q tile is the grid's slow axis, counted
//    down): causal tiles near the end of the sequence visit the most kv
//    tiles, and the light ones fill the last wave.  A q tile's heads
//    are neighbours in the grid, so under MQA / GQA they share each
//    K/V tile through L2.
//  * Q and a ring of K and V tiles of 64 keys come by TMA from 4-D
//    tensor maps; each copy's FULL mbarrier expects its bytes, and the
//    consumers release a stage on its EMPTY mbarrier.  Tiles land in the
//    128-byte-swizzled layout wgmma reads (64-column sub-tiles of 8-row,
//    1024-byte atoms; chunk c of row r at chunk c ^ (r % 8)).
//  * Who keeps the ring full depends on the registers.  A block's
//    registers are shared as if its threads were a multiple of 128, so
//    a producer warp costs a whole warpgroup's share: where the
//    consumers need it (three warpgroups at HV 128, two at HV 256),
//    warp 0 refills each stage once every warpgroup has released it.
//    (setmaxnreg, which the compiler does not allocate by, is not used.)
//  * Each consumer warpgroup computes S = Q K^T for its 64 rows by HQ/16
//    wgmma.m64n64k16 with bf16 operands from shared memory and f32
//    accumulators.  The softmax keeps the raw running max and the
//    partial sums of its two rows per thread in registers (quad shuffles
//    for the max; the sums are reduced once at the end), masks only
//    tiles that cross a mask edge, and applies hd^-0.5 after the
//    product, folded with log2(e) into one FFMA per score before ex2.
//    P is rounded to bf16 in registers: the f32 accumulator layout of S
//    is the register-A fragment layout of the next product, so
//    O += P V is 4 wgmma.m64n{HV}k16 (n64, n128 or n256) with A from
//    registers and V as an MN-major B operand, straight from the tile
//    the producer wrote; O is HV / 2 f32 registers a thread.
//  * Each tile's products run one after the other within a warpgroup;
//    the other warpgroups' softmax and products fill the gaps.  Keeping
//    S of tile j+1 and P V of tile j in flight together measured no
//    faster at hd 64 or 256 (and needs registers that four warpgroups
//    do not have).
//  * Shared memory: Q (64 kNC) x HQ, and the stages of K (64 x HQ) and
//    V (64 x HV), bf16, +1 KB alignment and 128 B of mbarriers
//    (`Config::kSmem`; flash_attention.py's smem_bytes_tc); one block
//    per SM.
#include "wgmma_tma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

enum Kind { kCausal = 0, kLocal = 1, kFull = 2 };

// keys per kv tile, at every width
constexpr int kBK = 64;

template <int NC, int STAGES, bool PRODUCER_WARP>
struct TileOf {
  static constexpr int kNC = NC, kStages = STAGES;
  static constexpr bool kProducerWarp = PRODUCER_WARP;
};
// The instantiations, by padded (q/k width, v width): consumer
// warpgroups of 64 q rows, K/V ring stages, and whether a producer warp
// keeps the ring full (else warp 0 refills each stage once every
// warpgroup has released it).  flash_attention.py's TC_HEAD_DIMS mirrors
// this table.  Times: tools/fa_tc_variants.py at the served prefills on
// an NVIDIA H100 80GB HBM3 at 700 W.
//  * (64, 64), smollm: four warpgroups, so that 256 q rows share each
//    K/V tile copied from L2; 95 registers a thread, so a producer warp
//    fits; 7 stages measured no faster than 4.
//  * (128, 64), minicpm3's MLA (96 / 64): the registers of (64, 64);
//    four warpgroups and a producer warp 0.161 ms, four refilled by
//    warp 0 0.176, three 0.202, two 0.207.
//  * (128, 128), hd 128 and 112, and (192, 128), deepseek's MLA: O is
//    64 registers a thread and the threads take 126.  Three warpgroups
//    refilled by warp 0 (384 threads; a producer warp beside them would
//    cap each thread at 128 and spill) beat two with a producer warp:
//    internlm2 0.132 against 0.140 ms, deepseek 0.105 against 0.109.
//    (128, 128): 4 stages, 177 KB (5 measured no faster); (192, 128): 3
//    stages, 193 KB (4 do not fit beside the 72 KB Q tile).
//  * (256, 256), recurrentgemma: O alone is 128 registers a thread; a
//    producer warp beside two warpgroups would cap every thread at 168
//    (spilling ~720 bytes, with serialized wgmma), so warp 0 refills and
//    the 256 threads compile to ~190 registers with no spill; two stages
//    are what fits the opt-in beside the Q tile.
// The padded columns of hd 112 and 96 cost their share of q k^T: a
// k-step loop bounded by the real width at run time made ptxas fence
// every wgmma (C7519) and measured ~10 % slower at every pair.
template <int HQ, int HV> struct Tile;
template <> struct Tile<64, 64> : TileOf<4, 4, true> {};
template <> struct Tile<128, 64> : TileOf<4, 4, true> {};
template <> struct Tile<128, 128> : TileOf<3, 4, false> {};
template <> struct Tile<192, 128> : TileOf<3, 3, false> {};
template <> struct Tile<256, 256> : TileOf<2, 2, false> {};

template <int HQ, int HV>
struct Config : Tile<HQ, HV> {
  using T = Tile<HQ, HV>;
  static constexpr int kHQ = HQ, kHV = HV;
  static_assert(HQ % 64 == 0 && HV % 64 == 0, "64-column sub-tiles");
  static_assert(8 * (1 + 2 * T::kStages) <= 128,
                "the Q, FULL and EMPTY mbarriers fit their 128 bytes");
  static constexpr int kBQ = 64 * T::kNC;
  static constexpr int kConsumers = 128 * T::kNC;
  static constexpr int kThreads =
      kConsumers + (T::kProducerWarp ? 32 : 0);
  static constexpr uint32_t kQBytes = kBQ * HQ * 2;
  static constexpr uint32_t kKBytes = kBK * HQ * 2;
  static constexpr uint32_t kVBytes = kBK * HV * 2;
  static constexpr uint32_t kStageBytes = kKBytes + kVBytes;
  static constexpr uint32_t kSmem =
      kQBytes + T::kStages * kStageBytes + 1024 + 128;
};

// One consumer warpgroup's state: 64 q rows, two per thread (a, b).
template <int HV>
struct Rows {
  float acc[HV / 2];
  float m_a, m_b, l_a, l_b;   // running max (raw scores) and partial sums
  uint32_t p[kBK / 4];        // P in bf16, the A fragments of O += P V
};

// Scores of one tile -> P (bf16 fragments) and the rows' new running
// state; returns the correction factors of the old state in (corr_a,
// corr_b).  `edge`: the tile crosses a mask edge for these rows.
template <int HV>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[kBK / 2], Rows<HV>& R, bool edge, int k_lo, int qa, int qb,
    int col0, int kind, int window, int Sk, float scale_log2, float& corr_a,
    float& corr_b) {
  constexpr int N = kBK / 2;
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    float x = sc[r];
    if (edge) {
      const int kp = k_lo + 8 * (r >> 2) + col0 + (r & 1);
      const int qp = (r & 2) ? qb : qa;
      bool ok = kp < Sk;
      if (kind == kCausal) ok = ok && qp >= kp;
      else if (kind == kLocal) ok = ok && qp >= kp && qp - kp < window;
      x = ok ? x : kNegInf;
      sc[r] = x;
    }
    if (r & 2) mx_b = fmaxf(mx_b, x);
    else mx_a = fmaxf(mx_a, x);
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(R.m_a, mx_a), mn_b = fmaxf(R.m_b, mx_b);
  corr_a = ex2((R.m_a - mn_a) * scale_log2);
  corr_b = ex2((R.m_b - mn_b) * scale_log2);
  R.m_a = mn_a;
  R.m_b = mn_b;
  // p = exp(scale (s - m)) = 2^(s scale log2(e) - m scale log2(e)), one
  // FFMA per score.  A row with no unmasked score yet (m still -1e30)
  // keeps p = 0 instead of the reference's p = 1: that state is reset
  // at the row's first unmasked key in both, and a row with none at all
  // is undefined in both.
  const float ms_a = mn_a == kNegInf ? 0.f : mn_a * scale_log2;
  const float ms_b = mn_b == kNegInf ? 0.f : mn_b * scale_log2;
  float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const float p = ex2(fmaf(sc[r], scale_log2, (r & 2) ? -ms_b : -ms_a));
    sc[r] = p;
    if (r & 2) ps_b += p;
    else ps_a += p;
  }
  R.l_a = R.l_a * corr_a + ps_a;
  R.l_b = R.l_b * corr_b + ps_b;
}

template <int HV>
__device__ __forceinline__ void rescale_and_pack(const float (&sc)[kBK / 2],
                                                 Rows<HV>& R, float corr_a,
                                                 float corr_b) {
#pragma unroll
  for (int r = 0; r < HV / 2; ++r) R.acc[r] *= (r & 2) ? corr_b : corr_a;
#pragma unroll
  for (int r = 0; r < kBK / 2; r += 2)
    R.p[r / 2] = pack_bf16(sc[r], sc[r + 1]);
}

// C: a Config (one template argument, so that __launch_bounds__ reads
// no comma of a template argument list)
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          bf16* __restrict__ o, float* __restrict__ lse,
                          int Sq, int Sk, int H, int Hkv, int hd_v, int kind,
                          int window, float scale_log2) {
  constexpr int HQ = C::kHQ, HV = C::kHV;
  constexpr int kStages = C::kStages, kBQ = C::kBQ;
  constexpr int kConsumers = C::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = sQ + C::kQBytes;     // stage s: K, then V
  const uint32_t bars = sKV + kStages * C::kStageBytes;
  const uint32_t bar_q = bars;
  const uint32_t bar_full = bars + 8;       // + 8 s
  const uint32_t bar_empty = bars + 8 + 8 * kStages;

  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  // the kv tiles the q tile's mask reaches (the reference's tile skip)
  const int q_last = min(q_start + kBQ, Sq) - 1;
  int kt_end = (Sk + kBK - 1) / kBK;
  if (kind != kFull) kt_end = min(kt_end, q_last / kBK + 1);
  int kt_begin = 0;
  if (kind == kLocal && q_start - window + 1 > 0)
    kt_begin = (q_start - window + 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile kt's K and V into its stage by TMA, completing on the stage's
  // FULL barrier (one thread).  A box's columns past the real width, like
  // its rows past Sk, land as zeros and count in the bytes.
  auto load_kv = [&](int kt) {
    const int s = (kt - kt_begin) % kStages;
    const uint32_t sK = sKV + s * C::kStageBytes, full = bar_full + 8 * s;
    mbar_arrive_expect_tx(full, C::kStageBytes);
#pragma unroll
    for (int c = 0; c < HQ / 64; ++c)            // 64-column sub-tiles
      tma_load_4d(sK + c * kBK * 128, &tm_k, full, 64 * c, hk, kt * kBK, b);
#pragma unroll
    for (int c = 0; c < HV / 64; ++c)
      tma_load_4d(sK + C::kKBytes + c * kBK * 128, &tm_v, full, 64 * c, hk,
                  kt * kBK, b);
  };
  if (threadIdx.x == 0) {   // Q; without a producer warp, the first fill
    mbar_arrive_expect_tx(bar_q, C::kQBytes);
#pragma unroll
    for (int c = 0; c < HQ / 64; ++c)
      tma_load_4d(sQ + c * kBQ * 128, &tm_q, bar_q, 64 * c, h, q_start, b);
    if constexpr (!C::kProducerWarp) {
      for (int kt = kt_begin; kt < min(kt_end, kt_begin + kStages); ++kt)
        load_kv(kt);
    }
  }
  // The warp, broadcast from lane 0 so that the compiler sees a
  // warp-uniform branch.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (C::kProducerWarp && warp == 4 * C::kNC) {
    // ---- producer warp: the K/V ring ---------------------------------------
    if (threadIdx.x % 32 == 0) {
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int i = kt - kt_begin;
        if (i >= kStages)
          mbar_wait(bar_empty + 8 * (i % kStages), (i / kStages - 1) & 1);
        load_kv(kt);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ------------------------------
    const int wg = warp / 4, t = threadIdx.x % 128;
    const int lane = t % 32;
    const int wr_lo = q_start + 64 * wg;          // the warpgroup's rows
    const int wr_hi = min(wr_lo + 63, Sq - 1);
    const int qa = wr_lo + 16 * (t / 32) + lane / 4, qb = qa + 8;
    const int col0 = 2 * (lane % 4);
    const uint32_t sQw = sQ + wg * 64 * 128;

    // The tiles these rows' mask reaches: a contiguous run [a_begin,
    // a_end) inside the block's [kt_begin, kt_end).
    int a_begin = kt_begin, a_end = kt_end;
    if (wr_lo > wr_hi) {
      a_end = a_begin;
    } else {
      if (kind != kFull) a_end = min(a_end, wr_hi / kBK + 1);
      if (kind == kLocal && wr_lo - window + 1 > 0)
        a_begin = max(a_begin, (wr_lo - window + 1) / kBK);
      a_end = max(a_end, a_begin);
    }
    auto stage = [&](int kt) { return (kt - kt_begin) % kStages; };
    auto wait_full = [&](int kt) {
      mbar_wait(bar_full + 8 * stage(kt), ((kt - kt_begin) / kStages) & 1);
    };
    // Release tile kt.  Without a producer warp, warp 0 then refills
    // its stage with tile kt + kStages once every warpgroup released kt.
    auto release = [&](int kt) {
      const uint32_t empty = bar_empty + 8 * stage(kt);
      mbar_arrive(empty);
      if constexpr (!C::kProducerWarp) {
        if (warp == 0 && kt + kStages < kt_end) {
          mbar_wait(empty, ((kt - kt_begin) / kStages) & 1);
          if (threadIdx.x == 0) load_kv(kt + kStages);
          __syncwarp();
        }
      }
    };
    auto k_tile = [&](int kt) { return sKV + stage(kt) * C::kStageBytes; };
    auto issue_qk = [&](float (&sc)[kBK / 2], int kt) {
      const uint32_t sK = k_tile(kt);
#pragma unroll
      for (int kk = 0; kk < HQ / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss_m64n64k16(
            sc, desc_sw128(sQw + (kk >> 2) * kBQ * 128 + off, 16, 1024),
            desc_sw128(sK + (kk >> 2) * kBK * 128 + off, 16, 1024), kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };
    Rows<HV> R;
    // V as an MN-major B operand: 16 keys a step, the HV / 64 sub-tiles
    // kBK * 128 bytes apart (the descriptor's leading offset)
    auto issue_pv = [&](int kt) {
      const uint32_t sV = k_tile(kt) + C::kKBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_rs<HV>(R.acc, R.p[4 * kk], R.p[4 * kk + 1], R.p[4 * kk + 2],
                     R.p[4 * kk + 3],
                     desc_sw128(sV + kk * 16 * 128, kBK * 128, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };
    auto edge = [&](int kt) {
      const int k_lo = kt * kBK, k_hi = k_lo + kBK - 1;
      return !(k_hi < Sk &&
               (kind == kFull ||
                (k_hi <= wr_lo &&
                 (kind == kCausal || k_lo > wr_hi - window))));
    };

#pragma unroll
    for (int i = 0; i < HV / 2; ++i) R.acc[i] = 0.f;
    R.m_a = R.m_b = kNegInf;
    R.l_a = R.l_b = 0.f;

    mbar_wait(bar_q, 0);
    for (int kt = kt_begin; kt < a_begin; ++kt) {   // masked for these rows
      wait_full(kt);
      release(kt);
    }
    float sc[kBK / 2], corr_a, corr_b;
    for (int kt = a_begin; kt < a_end; ++kt) {
      wait_full(kt);
      wgmma_fence();
      issue_qk(sc, kt);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(sc);
      softmax_tile<HV>(sc, R, edge(kt), kt * kBK, qa, qb, col0, kind, window,
                       Sk, scale_log2, corr_a, corr_b);
      rescale_and_pack<HV>(sc, R, corr_a, corr_b);
      fence_regs(R.acc);
      wgmma_fence();
      issue_pv(kt);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(R.acc);
      release(kt);
    }
    for (int kt = a_end; kt < kt_end; ++kt) {       // masked for these rows
      wait_full(kt);
      release(kt);
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      R.l_a += __shfl_xor_sync(0xffffffffu, R.l_a, off);
      R.l_b += __shfl_xor_sync(0xffffffffu, R.l_b, off);
    }
    // Each row's log-sum-exp of the scaled scores, for the backward
    // (flash_attention_bwd_tc.cu): (m scale log2(e) + log2 l) ln 2, l the
    // sum of the f32 p (before their rounding to bf16); a row with no
    // unmasked key gives -inf.  Serving passes no buffer.
    if (lse != nullptr && (lane & 3) == 0) {
      const float ln2 = 0.6931471805599453f;
      if (qa < Sq)
        lse[(size_t)bh * Sq + qa] =
            ((R.m_a == kNegInf ? 0.f : R.m_a * scale_log2) + log2f(R.l_a)) *
            ln2;
      if (qb < Sq)
        lse[(size_t)bh * Sq + qb] =
            ((R.m_b == kNegInf ? 0.f : R.m_b * scale_log2) + log2f(R.l_b)) *
            ln2;
    }
    // o = acc / max(l, 1e-30), as one reciprocal per row (the output is
    // bf16: the product's extra rounding is far below its ulp); only the
    // columns below hd_v (a multiple of 8) are stored
    const float inv_a = 1.f / fmaxf(R.l_a, 1e-30f);
    const float inv_b = 1.f / fmaxf(R.l_b, 1e-30f);
    const size_t o_row = (size_t)H * hd_v;
    bf16* oa = o + ((size_t)b * Sq * H + h) * hd_v + (size_t)qa * o_row + col0;
    bf16* ob = oa + 8 * o_row;
#pragma unroll
    for (int j = 0; j < HV / 8; ++j) {
      if (8 * j >= hd_v) break;
      if (qa < Sq)
        *reinterpret_cast<__nv_bfloat162*>(oa + 8 * j) = __floats2bfloat162_rn(
            R.acc[4 * j] * inv_a, R.acc[4 * j + 1] * inv_a);
      if (qb < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j) = __floats2bfloat162_rn(
            R.acc[4 * j + 2] * inv_b, R.acc[4 * j + 3] * inv_b);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;   // (B, H, Sq) f32, or null
  int B, Sq, Sk, H, Hkv, hd, hd_v, kind, window;
  float scale_log2;
  const long long* strides;   // q, k, v: (head, row, batch) each
  int smem;
  cudaStream_t stream;
};

template <int HQ, int HV>
int launch(const Args& a) {
  using C = Config<HQ, HV>;
  if (a.smem < static_cast<int>(C::kSmem)) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(&tm_q, a.q, a.hd, a.H, a.Sq, a.B, a.strides, C::kBQ) ||
      !tensor_map(&tm_k, a.k, a.hd, a.Hkv, a.Sk, a.B, a.strides + 3, kBK) ||
      !tensor_map(&tm_v, a.v, a.hd_v, a.Hkv, a.Sk, a.B, a.strides + 6, kBK))
    return cudaErrorInvalidValue;
  auto fn = flash_attention_tc_kernel<C>;
  static int smem_set = 0;   // the opt-in is set once per size
  if (a.smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return err;
    smem_set = a.smem;
  }
  const int q_tiles = (a.Sq + C::kBQ - 1) / C::kBQ;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(a.B * a.H, q_tiles);
  fn<<<grid, C::kThreads, a.smem, a.stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(a.o), a.lse, a.Sq, a.Sk, a.H,
      a.Hkv, a.hd_v, a.kind, a.window, a.scale_log2);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; hd and hd_v multiples of 8 whose padded pair (each rounded
// up to 64) is a `Tile`; strides: nine element strides (head, row,
// batch of q, then k, then v), each a multiple of 8; o contiguous
// (B, Sq, H, hd_v); lse null, or (B, H, Sq) f32 for each row's
// log-sum-exp.  scale_log2 = hd^-0.5 * log2(e).  Returns a
// cudaError_t (0 on success).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, float* lse,
                                         int B, int Sq, int Sk, int H,
                                         int Hkv, int hd, int hd_v, int kind,
                                         int window, float scale_log2,
                                         const long long* strides, int smem,
                                         void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0 || hd <= 0 || hd_v <= 0 ||
      hd % 8 != 0 || hd_v % 8 != 0)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, hd_v, kind, window,
               scale_log2, strides, smem, static_cast<cudaStream_t>(stream)};
  const int hq = (hd + 63) / 64 * 64, hv = (hd_v + 63) / 64 * 64;
  if (hq == 64 && hv == 64) return launch<64, 64>(a);
  if (hq == 128 && hv == 64) return launch<128, 64>(a);
  if (hq == 128 && hv == 128) return launch<128, 128>(a);
  if (hq == 192 && hv == 128) return launch<192, 128>(a);
  if (hq == 256 && hv == 256) return launch<256, 256>(a);
  return cudaErrorInvalidValue;
}
