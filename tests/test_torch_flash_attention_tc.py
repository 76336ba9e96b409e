"""A model of the bf16 tensor-core flash attention (B5,
csrc/flash_attention_tc.cu) against the JAX package.

These tests run a model of the kernel, not the kernel: no code of
`flash_attention_tc.cu` runs here, and a fault in it cannot show.  The
CUDA kernel runs only on the card, where chip_smoke.py holds it to the
plain version (every entry within rtol 2e-2 / atol 1e-2, and the
error's RMS at most 1 % of the plain output's).  Here a test-side
emulation repeats what the kernel's arithmetic does differently from
the reference's f32 kernel: bf16 q·k products summed in f32 (a bf16 x
bf16 product is exact in f32), the scale folded with log2(e) and
applied after the product, exponentials as powers of two, the online
softmax over the kernel's kv tiles with its tile skip, and P rounded to
bf16 before P·V.  The emulation is held to the reference's Pallas kernel
in interpret mode within the reference's unchanged bf16 tolerance
(5e-2), and to its f32 output by the card's criterion (error RMS at most
1 % of the output's RMS), which a dropped kv tile fails; causal / local
/ full masks at head widths 64 and 256.  So the tests show that the
design's roundings and tile walk can meet the card's check.  Inputs are
drawn with numpy from a seed.  Beside them: the tile reach both kernels
compute (`kv_tile_range`) against the mask itself, and the routing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.contracts import SMEM_OPTIN_BYTES  # noqa: E402

WINDOW = 40
NEG_INF = -1e30
#: chip_smoke.py's criterion on the card: the error's RMS at most 1 % of
#: the output's (bf16 rounding of P and o gives a few tenths of a
#: percent; a dropped or misplaced kv tile moves it by several percent)
RMS_RATIO = 0.01


def tc_emulation(q, k, v, *, kind, window, drop=None):
    """q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd) bf16 -> (B, Sq, H, hd)
    bf16, with the tensor-core kernel's roundings and tile walk (one
    warpgroup's rows at a time, over the kv tiles `kv_tile_range`
    gives).  drop: a (q tile start, kv tile) whose visit is skipped, to
    show what the checks see of a fault."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale_log2 = torch.tensor(hd ** -0.5 * fa.LOG2E, dtype=torch.float32)
    qf = q.float().permute(0, 2, 1, 3)                    # (B, H, Sq, hd)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    out = torch.zeros((B, H, Sq, hd), dtype=torch.float32)
    BQ, BK = fa.TC_WG_ROWS, fa.tc_tile(hd)[1]
    ok_all = fa.mask(Sq, Sk, kind=kind, window=window)
    for q0 in range(0, Sq, BQ):
        rows = torch.arange(q0, min(q0 + BQ, Sq))
        m = torch.full((B, H, len(rows), 1), NEG_INF)
        l = torch.zeros((B, H, len(rows), 1))
        acc = torch.zeros((B, H, len(rows), hd))
        begin, end = fa.kv_tile_range(q0, BQ, Sq, Sk, kind=kind,
                                      window=window, bk=BK)
        for kt in range(begin, end):
            if drop == (q0, kt):
                continue
            cols = torch.arange(kt * BK, min(kt * BK + BK, Sk))
            s = qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)
            s = s.masked_fill(~ok_all[rows][:, cols], NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2((m - m_new) * scale_log2)
            # rows with no unmasked key yet keep p = 0 (the kernel's rule)
            ms = torch.where(m_new == NEG_INF, 0.0, m_new * scale_log2)
            p = torch.exp2(torch.addcmul(-ms, s, scale_log2))
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.bfloat16().float() @ vf[:, :, cols]
            m = m_new
        out[:, :, rows] = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


# (B, Sq, Sk, H, Hkv, hd): MQA at recurrentgemma's head width with a
# ragged q tile, GQA 3 at smollm's
SHAPES = {"mqa_hd256": (1, 96, 96, 2, 1, 256),
          "gqa3_hd64": (2, 160, 160, 6, 2, 64)}


def _bf16_inputs(shape, seed):
    B, Sq, Sk, H, Hkv, hd = shape
    rng = np.random.default_rng(seed)
    draw = lambda *s: torch.as_tensor(
        rng.standard_normal(s).astype(np.float32)).bfloat16()
    return draw(B, Sq, H, hd), draw(B, Sk, Hkv, hd), draw(B, Sk, Hkv, hd)


def _reference(q, k, v, kind, dtype):
    """The reference's Pallas kernel in interpret mode on the bf16
    inputs, as `dtype`, -> f32 numpy."""
    j = lambda t: jnp.asarray(t.float().numpy(), dtype)
    ref = ref_ops.flash_attention(j(q), j(k), j(v), kind=kind, window=WINDOW,
                                  bq=16, bk=16, interpret=True)
    return np.asarray(ref, np.float32)


def _rms_ratio(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))


@pytest.mark.parametrize("kind", ["causal", "local", "full"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_tc_roundings_within_bf16_tolerance_of_reference(kind, name):
    shape = SHAPES[name]
    q, k, v = _bf16_inputs(shape, seed=sum(shape))
    got = tc_emulation(q, k, v, kind=kind, window=WINDOW)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, _reference(q, k, v, kind, jnp.bfloat16),
                               rtol=5e-2, atol=5e-2)
    assert _rms_ratio(got, _reference(q, k, v, kind, jnp.float32)) \
        <= RMS_RATIO


@pytest.mark.parametrize("name", list(SHAPES))
def test_rms_criterion_sees_a_dropped_kv_tile(name):
    """The card's criterion fails a walk that skips one kv tile: the
    last q tile's first kv tile under a causal mask."""
    shape = SHAPES[name]
    q, k, v = _bf16_inputs(shape, seed=sum(shape))
    Sq, BQ = shape[1], fa.TC_WG_ROWS
    last = (Sq - 1) // BQ * BQ
    got = tc_emulation(q, k, v, kind="causal", window=WINDOW, drop=(last, 0))
    ratio = _rms_ratio(got.float().numpy(),
                       _reference(q, k, v, "causal", jnp.float32))
    assert ratio > RMS_RATIO, ratio


# (q rows, keys per kv tile) of every walk: the CUDA-core kernel's block, and
# the tensor-core kernel's blocks and warpgroups at both head widths
GEOMETRIES = sorted({(fa.BQ, fa.BK)}
                    | {(fa.tc_tile(h)[0], fa.tc_tile(h)[1])
                       for h in fa.TC_HEAD_DIMS}
                    | {(fa.TC_WG_ROWS, fa.tc_tile(h)[1])
                       for h in fa.TC_HEAD_DIMS})


@pytest.mark.parametrize("kind", ["causal", "local", "full"])
@pytest.mark.parametrize("Sq,Sk", [(300, 300), (200, 330), (130, 77),
                                   (1, 65), (257, 257)])
def test_kv_tile_range_is_the_mask_reach(kind, Sq, Sk):
    """For every q tile, the kv tiles the kernels visit are exactly the
    tiles that hold at least one unmasked (query, key) pair of its rows:
    none is skipped that the mask reaches, none visited that it does
    not, at ragged Sq and Sk."""
    window = 100
    ok = fa.mask(Sq, Sk, kind=kind, window=window)
    for rows, bk in GEOMETRIES:
        for q0 in range(0, Sq, rows):
            blk = ok[q0:q0 + rows]
            reach = [kt for kt in range(-(-Sk // bk))
                     if bool(blk[:, kt * bk:(kt + 1) * bk].any())]
            got = fa.kv_tile_range(q0, rows, Sq, Sk, kind=kind,
                                   window=window, bk=bk)
            if reach:
                assert reach == list(range(*got)), (rows, bk, q0, got, reach)
            else:
                assert got[0] == got[1], (rows, bk, q0, got)


@pytest.mark.parametrize("hd", [64, 256])
def test_route_sends_bf16_to_tensor_cores_and_f32_to_cuda_cores(hd):
    """bf16 at the served head widths goes to the tensor-core kernel; f32,
    and bf16 at any other hd, hd_v <= 256, to the CUDA-core kernel; what
    neither takes raises."""
    assert fa.route(torch.bfloat16, hd, hd) == "tc"
    assert fa.route(torch.float32, hd, hd) == "core"
    assert fa.route(torch.float32, 32, 16) == "core"
    assert fa.route(torch.bfloat16, hd, hd // 2) == "core"
    assert fa.route(torch.bfloat16, 128, 128) == "core"
    assert fa.route(torch.bfloat16, 96, 64) == "core"
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA-core kernel"):
            fa.route(dtype, 512, 64)
    with pytest.raises(ValueError, match="not supported"):
        fa.route(torch.float16, hd, hd)


def test_tc_smem_fits_at_both_served_widths():
    """The tensor-core kernel's Q tile and K/V ring fit the opt-in at
    recurrentgemma's hd 256 (128 q rows, 2 stages of 64 keys) and
    smollm's hd 64 (256 q rows, 4 stages of 64 keys)."""
    assert fa.tc_tile(256) == (128, 64, 2) and fa.tc_tile(64) == (256, 64, 4)
    assert fa.smem_bytes_tc(256) == 2 * 256 * (128 + 2 * 2 * 64) + 1152
    assert fa.smem_bytes_tc(256) == 197_760 <= SMEM_OPTIN_BYTES
    assert fa.smem_bytes_tc(64) == 2 * 64 * (256 + 2 * 4 * 64) + 1152
    assert fa.smem_bytes_tc(64) == 99_456
    assert max(fa.smem_bytes_tc(h) for h in fa.TC_HEAD_DIMS) \
        <= SMEM_OPTIN_BYTES
