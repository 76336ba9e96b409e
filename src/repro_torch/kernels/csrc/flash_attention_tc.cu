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
// f32 inputs, and bf16 at other head widths, go to flash_attention.cu
// (f32 CUDA-core math; a tensor-core product of f32 would be TF32,
// which the port does not use).
//
// Layout: q (B, Sq, H, hd), k (B, Sk, Hkv, hd), v (B, Sk, Hkv, hd),
// o (B, Sq, H, hd), contiguous bf16, read and written with strides;
// hd = hd_v in {64, 256}, the served configs' widths.
//
// What bounds it on this card: operations.  recurrentgemma-2b's prefill
// (B 2, S 4,096, 10 heads, MQA, hd 256, window 2,048) needs ~1.3e11
// flops of unmasked pairs against ~0.1 GB of q/k/v/o: ~0.13 ms at the
// bf16 tensor-core peak.  The CUDA-core kernel took ~100x that.
//
// What the design does about it:
//  * One block per (q tile, batch x head): kNC consumer warpgroups of 64
//    q rows each (four at hd 64, two at hd 256).  Blocks are issued
//    heaviest q tile first across the whole grid (the q tile is the
//    grid's slow axis, counted down): causal tiles near the end of the
//    sequence visit the most kv tiles, and the light ones fill the last
//    wave.
//  * Q and a ring of 4 (hd 64) or 2 (hd 256) stages of 64-key K and V
//    tiles come by TMA from 4-D tensor maps (rows past Sq or Sk read as
//    zeros); each copy's FULL mbarrier expects its bytes, and the
//    consumers release a stage on its EMPTY mbarrier.  Tiles land in the
//    128-byte-swizzled layout wgmma reads (64-column sub-tiles of 8-row,
//    1024-byte atoms; chunk c of row r at chunk c ^ (r % 8)).  At hd 64
//    the K/V copies from L2 bounded a block of two consumer warpgroups;
//    with four, 256 q rows share each tile.
//  * Who keeps the ring full depends on the registers.  A block's
//    registers are shared as if its threads were a multiple of 128: at
//    hd 256 (O alone is 128 registers a thread) a producer warp beside
//    the 256 consumer threads would cap every thread at 168 registers
//    (spilling ~720 bytes, with serialized wgmma), so warp 0 refills
//    each stage once every warpgroup has released it, and the 256
//    threads compile to ~190 registers with no spill.  At hd 64 the
//    registers suffice (~95 a thread), and a producer warp keeps the
//    ring full without tying warp 0 to the slowest of four warpgroups.
//    (setmaxnreg, which the compiler does not allocate by, is not used.)
//  * Each consumer warpgroup computes S = Q K^T for its 64 rows by hd/16
//    wgmma.m64n64k16 with bf16 operands from shared memory and f32
//    accumulators.  The softmax keeps the raw running max and the
//    partial sums of its two rows per thread in registers (quad shuffles
//    for the max; the sums are reduced once at the end), masks only
//    tiles that cross a mask edge, and applies hd^-0.5 after the
//    product, folded with log2(e) into one FFMA per score before ex2.
//    P is rounded to bf16 in registers: the f32 accumulator layout of S
//    is the register-A fragment layout of the next product, so
//    O += P V is 4 wgmma.m64n{hd}k16 with A from registers and V as an
//    MN-major B operand, straight from the tile the producer wrote.
//  * Each tile's products run one after the other within a warpgroup;
//    the other warpgroups' softmax and products fill the gaps.  Keeping
//    S of tile j+1 and P V of tile j in flight together measured no
//    faster at either width (and needs registers hd 64's four
//    warpgroups do not have).
//  * Shared memory: Q (64 kNC) x hd, and the stages of K and V (64 x hd),
//    bf16, +1 KB alignment and 128 B of mbarriers: 197,760 bytes at
//    hd 256 and 99,456 at hd 64; one block per SM.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;

enum Kind { kCausal = 0, kLocal = 1, kFull = 2 };

// D (+)= A B: A (64 x 16), B (16 x 64), both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n64k16(
    float (&d)[32], uint64_t da, uint64_t db,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += P V: A (64 x 16) from registers, B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_m64n64k16(
    float (&d)[32], uint32_t a0, uint32_t a1,
    uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D += P V: A (64 x 16) from registers, B (16 x 256) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_m64n256k16(
    float (&d)[128], uint32_t a0, uint32_t a1,
    uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// Keeps the compiler from moving register reads or writes of an
// accumulator across the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// The arrival of the one thread that issues a stage's copies, with the
// bytes they will bring (the phase completes when all have landed).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
// Waits for the completion of the barrier phase of parity `parity`.  A
// wait that outlasts any legitimate run (a broken hand-off: ~5 s of
// cycles) traps, so a fault ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}
// TMA: the (64-column, rows) box at (c0, c1, c2, c3) of a 4-D tensor map
// into shared memory at dst, 128-byte swizzled as the map says; its
// bytes complete on the mbarrier `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&acc)[HD / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  if constexpr (HD == 64) {
    wgmma_rs_m64n64k16(acc, a0, a1, a2, a3, db);
  } else {
    wgmma_rs_m64n256k16(acc, a0, a1, a2, a3, db);
  }
}

template <int HD>
struct Config {
  static_assert(HD == 64 || HD == 256, "the served head widths");
  // consumer warpgroups (64 q rows each): four at hd 64, so that 256 q
  // rows share each K/V tile copied from L2 and four warpgroups' softmax
  // and products interleave; two at hd 256, where O alone is 128
  // registers a thread
  static constexpr int kNC = HD == 64 ? 4 : 2;
  // keys per kv tile
  static constexpr int kBK = 64;
  // K/V ring depth: two is what fits the opt-in beside the Q tile at
  // hd 256; at hd 64, 7 stages measured no faster than 4
  static constexpr int kStages = HD == 64 ? 4 : 2;
  static_assert(8 * (1 + 2 * kStages) <= 128,
                "the Q, FULL and EMPTY mbarriers fit their 128 bytes");
  // a producer warp keeps the K/V ring full (hd 64); else warp 0 refills
  // each stage as the warpgroups release it, and the block's 256
  // threads get up to 255 registers each (hd 256: O alone is 128)
  static constexpr bool kProducerWarp = HD == 64;
  static constexpr int kBQ = 64 * kNC;
  static constexpr int kConsumers = 128 * kNC;
  static constexpr int kThreads = kConsumers + (kProducerWarp ? 32 : 0);
  static constexpr uint32_t kQBytes = kBQ * HD * 2;
  static constexpr uint32_t kKVBytes = kBK * HD * 2;
  static constexpr uint32_t kSmem =
      kQBytes + kStages * 2 * kKVBytes + 1024 + 128;
};

// One consumer warpgroup's state: 64 q rows, two per thread (a, b).
template <int HD>
struct Rows {
  static constexpr int kBK = Config<HD>::kBK;
  float acc[HD / 2];
  float m_a, m_b, l_a, l_b;   // running max (raw scores) and partial sums
  uint32_t p[kBK / 4];        // P in bf16, the A fragments of O += P V
};

// Scores of one tile -> P (bf16 fragments) and the rows' new running
// state; returns the correction factors of the old state in (corr_a,
// corr_b).  `edge`: the tile crosses a mask edge for these rows.
template <int HD>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[Config<HD>::kBK / 2], Rows<HD>& R, bool edge, int k_lo,
    int qa, int qb, int col0, int kind, int window, int Sk,
    float scale_log2, float& corr_a, float& corr_b) {
  constexpr int N = Config<HD>::kBK / 2;
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

template <int HD>
__device__ __forceinline__ void rescale_and_pack(
    const float (&sc)[Config<HD>::kBK / 2], Rows<HD>& R, float corr_a,
    float corr_b) {
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) R.acc[r] *= (r & 2) ? corr_b : corr_a;
#pragma unroll
  for (int r = 0; r < Config<HD>::kBK / 2; r += 2)
    R.p[r / 2] = pack_bf16(sc[r], sc[r + 1]);
}

template <int HD>
__global__ void __launch_bounds__(Config<HD>::kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          bf16* __restrict__ o, int Sq, int Sk, int H,
                          int Hkv, int kind, int window, float scale_log2) {
  using C = Config<HD>;
  constexpr int kBK = C::kBK, kStages = C::kStages, kBQ = C::kBQ;
  constexpr int kConsumers = C::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = sQ + C::kQBytes;     // stage s: K, then V
  const uint32_t bars = sKV + kStages * 2 * C::kKVBytes;
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
  // FULL barrier (one thread).
  auto load_kv = [&](int kt) {
    const int s = (kt - kt_begin) % kStages;
    const uint32_t sK = sKV + s * 2 * C::kKVBytes, full = bar_full + 8 * s;
    mbar_arrive_expect_tx(full, 2 * C::kKVBytes);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {          // 64-column sub-tiles
      tma_load_4d(sK + c * kBK * 128, &tm_k, full, 64 * c, hk, kt * kBK, b);
      tma_load_4d(sK + C::kKVBytes + c * kBK * 128, &tm_v, full, 64 * c, hk,
                  kt * kBK, b);
    }
  };
  if (threadIdx.x == 0) {   // Q; without a producer warp, the first fill
    mbar_arrive_expect_tx(bar_q, C::kQBytes);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c)
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
    auto k_tile = [&](int kt) {
      return sKV + stage(kt) * 2 * C::kKVBytes;
    };
    auto issue_qk = [&](float (&sc)[kBK / 2], int kt) {
      const uint32_t sK = k_tile(kt);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss_m64n64k16(
            sc, desc_sw128(sQw + (kk >> 2) * kBQ * 128 + off, 16, 1024),
            desc_sw128(sK + (kk >> 2) * kBK * 128 + off, 16, 1024), kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };
    Rows<HD> R;
    auto issue_pv = [&](int kt) {
      const uint32_t sV = k_tile(kt) + C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_pv<HD>(R.acc, R.p[4 * kk], R.p[4 * kk + 1], R.p[4 * kk + 2],
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
    for (int i = 0; i < HD / 2; ++i) R.acc[i] = 0.f;
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
      softmax_tile<HD>(sc, R, edge(kt), kt * kBK, qa, qb, col0, kind, window,
                       Sk, scale_log2, corr_a, corr_b);
      rescale_and_pack<HD>(sc, R, corr_a, corr_b);
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
    // o = acc / max(l, 1e-30), as one reciprocal per row (the output is
    // bf16: the product's extra rounding is far below its ulp)
    const float inv_a = 1.f / fmaxf(R.l_a, 1e-30f);
    const float inv_b = 1.f / fmaxf(R.l_b, 1e-30f);
    const size_t o_row = (size_t)H * HD;
    bf16* oa = o + ((size_t)b * Sq * H + h) * HD + (size_t)qa * o_row + col0;
    bf16* ob = oa + 8 * o_row;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (qa < Sq)
        *reinterpret_cast<__nv_bfloat162*>(oa + 8 * j) = __floats2bfloat162_rn(
            R.acc[4 * j] * inv_a, R.acc[4 * j + 1] * inv_a);
      if (qb < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j) = __floats2bfloat162_rn(
            R.acc[4 * j + 2] * inv_b, R.acc[4 * j + 3] * inv_b);
    }
  }
}

// A (HD, heads, S, B) bf16 tensor map of q, k or v whose boxes are 64
// columns by `rows` rows of one (batch, head), 128-byte swizzled; rows
// past S read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int HD, int heads,
                int S, int B, int rows) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * HD, 2ull * HD * heads,
                                 2ull * HD * heads * S};   // bytes
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int Hkv, int kind, int window,
           float scale_log2, int smem, cudaStream_t stream) {
  using C = Config<HD>;
  if (smem < static_cast<int>(C::kSmem)) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(&tm_q, q, HD, H, Sq, B, C::kBQ) ||
      !tensor_map(&tm_k, k, HD, Hkv, Sk, B, C::kBK) ||
      !tensor_map(&tm_v, v, HD, Hkv, Sk, B, C::kBK))
    return cudaErrorInvalidValue;
  auto fn = flash_attention_tc_kernel<HD>;
  static int smem_set = 0;   // the opt-in is set once per size
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const int q_tiles = (Sq + C::kBQ - 1) / C::kBQ;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * H, q_tiles);
  fn<<<grid, C::kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), Sq, Sk, H, Hkv, kind,
      window, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; hd in {64, 256} for q, k and v.  scale_log2 =
// hd^-0.5 * log2(e).  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int Sq, int Sk, int H, int Hkv,
                                         int hd, int kind, int window,
                                         float scale_log2, int smem,
                                         void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Sk, H, Hkv, kind, window,
                        scale_log2, smem, s);
    case 256:
      return launch<256>(q, k, v, o, B, Sq, Sk, H, Hkv, kind, window,
                         scale_log2, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}
