"""A model of the bf16 tensor-core flash attention (B5,
csrc/flash_attention_tc.cu) against the JAX package.

These tests run a model of the kernel, not the kernel: no code of
`flash_attention_tc.cu` runs here, and a fault in it cannot show.  The
CUDA kernel runs only on the card, where chip_smoke.py holds it to the
plain version (every entry within rtol 2e-2 / atol 1e-2, and the
error's RMS at most 1 % of the plain output's).  Here a test-side
emulation repeats what the kernel's arithmetic does differently from
the reference's f32 kernel: q, k and v padded with zero columns to the
instantiation's widths (as its TMA boxes read past the real hd and
hd_v), bf16 q·k products summed in f32 (a bf16 x bf16 product is exact
in f32), the real hd's scale folded with log2(e) and applied after the
product, exponentials as powers of two, the online softmax over the
kernel's kv tiles with its tile skip, P rounded to bf16 before P·V, and
only the columns below hd_v kept.  The emulation is held to the
reference's Pallas kernel in interpret mode within the reference's
unchanged bf16 tolerance (5e-2), and to its f32 output by the card's
criterion (error RMS at most 1 % of the output's RMS), which a dropped
kv tile fails; causal / local / full masks at every width pair the
served configs use (64, 256, 128 with GQA and MQA, 112, MLA's 192 / 128
and 96 / 64, phi-3-vision's 96 / 96), ragged Sq and Sk and Sq != Sk
(whisper's cross-attention shape among them).  So the tests show that
the design's padding, roundings and tile walk can meet the card's
check.  Inputs are drawn with numpy from a seed.  Beside them: the tile
reach both kernels compute (`kv_tile_range`) against the mask itself,
the routing, the tile table against the kernel source's, and the
strides the tensor maps take.  The file takes about 30 s on the CPU in
one process.
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.base import UNPORTED  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.contracts import SMEM_OPTIN_BYTES  # noqa: E402

WINDOW = 40
NEG_INF = -1e30
#: chip_smoke.py's criterion on the card: the error's RMS at most 1 % of
#: the output's (bf16 rounding of P and o gives a few tenths of a
#: percent; a dropped or misplaced kv tile moves it by several percent)
RMS_RATIO = 0.01
SRC = (pathlib.Path(fa.__file__).parent / "csrc"
       / "flash_attention_tc.cu").read_text()


def tc_emulation(q, k, v, *, kind, window, drop=None):
    """q (B, Sq, H, hd), k (B, Sk, Hkv, hd), v (B, Sk, Hkv, hd_v) bf16
    -> (B, Sq, H, hd_v) bf16, with the tensor-core kernel's padding,
    roundings and tile walk (one warpgroup's rows at a time, over the kv
    tiles `kv_tile_range` gives).  drop: a (q tile start, kv tile) whose
    visit is skipped, to show what the checks see of a fault."""
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    hq, hv = fa.tc_widths(hd, hd_v)
    G = H // Hkv
    scale_log2 = torch.tensor(hd ** -0.5 * fa.LOG2E, dtype=torch.float32)
    pad = lambda t, w: torch.nn.functional.pad(t.float(),
                                               (0, w - t.shape[-1]))
    qf = pad(q, hq).permute(0, 2, 1, 3)                   # (B, H, Sq, hq)
    kf = pad(k, hq).permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vf = pad(v, hv).permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    out = torch.zeros((B, H, Sq, hv), dtype=torch.float32)
    BQ, BK = fa.TC_WG_ROWS, fa.tc_tile(hd, hd_v)[1]
    ok_all = fa.mask(Sq, Sk, kind=kind, window=window)
    for q0 in range(0, Sq, BQ):
        rows = torch.arange(q0, min(q0 + BQ, Sq))
        m = torch.full((B, H, len(rows), 1), NEG_INF)
        l = torch.zeros((B, H, len(rows), 1))
        acc = torch.zeros((B, H, len(rows), hv))
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
    return out[..., :hd_v].permute(0, 2, 1, 3).to(torch.bfloat16)


# (B, Sq, Sk, H, Hkv, hd, hd_v): MQA at recurrentgemma's head width with
# a ragged q tile, GQA 3 at smollm's; hd 128 with GQA 2 and, Sq > Sk,
# MQA as granite's; kimi's hd 112 (a second box half zeros), Sq < Sk;
# deepseek's MLA 192 / 128 and minicpm3's 96 / 64, H = Hkv; phi-3-vision's
# 96 / 96 on the (128, 128) instantiation; whisper's cross-attention
# shape at hd 64, Sq > Sk with a ragged last kv tile.  Under the window
# every query keeps an unmasked key (Sq - WINDOW < Sk).
SHAPES = {"mqa_hd256": (1, 96, 96, 2, 1, 256, 256),
          "gqa3_hd64": (2, 160, 160, 6, 2, 64, 64),
          "gqa2_hd128": (1, 130, 130, 4, 2, 128, 128),
          "mqa_hd128_sq_gt_sk": (1, 150, 120, 6, 1, 128, 128),
          "gqa2_hd112_sq_lt_sk": (2, 100, 140, 4, 2, 112, 112),
          "mla_hd192_128": (1, 140, 110, 3, 3, 192, 128),
          "mla_hd96_64": (2, 120, 160, 4, 4, 96, 64),
          "mha_hd96": (1, 130, 110, 4, 4, 96, 96),
          "cross_hd64_sq_gt_sk": (1, 150, 115, 4, 4, 64, 64)}


def _bf16_inputs(shape, seed):
    B, Sq, Sk, H, Hkv, hd, hd_v = shape
    rng = np.random.default_rng(seed)
    draw = lambda *s: torch.as_tensor(
        rng.standard_normal(s).astype(np.float32)).bfloat16()
    return draw(B, Sq, H, hd), draw(B, Sk, Hkv, hd), draw(B, Sk, Hkv, hd_v)


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
    assert got.dtype == torch.bfloat16
    assert got.shape == q.shape[:3] + v.shape[-1:]
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
# the tensor-core kernel's blocks at every instantiation and its warpgroups
GEOMETRIES = sorted({(fa.BQ, fa.BK), (fa.TC_WG_ROWS, fa.TC_BK)}
                    | {fa.tc_tile(hq, hv)[:2] for hq, hv in fa.TC_HEAD_DIMS})


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


@pytest.mark.parametrize("hd,hd_v", [
    pytest.param(64, 64, id="64"), pytest.param(256, 256, id="256"),
    pytest.param(128, 128, id="128"), pytest.param(112, 112, id="112"),
    pytest.param(192, 128, id="192-128"), pytest.param(96, 64, id="96-64")])
def test_route_sends_bf16_to_tensor_cores_and_f32_to_cuda_cores(hd, hd_v):
    """bf16 at the served width pairs goes to the tensor-core kernel,
    also at 128 / 128 and 96 / 64, which went to the CUDA cores before
    the kernel took width pairs; f32, and bf16 at widths no instantiation
    covers or that TMA cannot read (not a multiple of 8), hd, hd_v <= 256,
    to the CUDA-core kernel; what neither takes raises."""
    assert fa.route(torch.bfloat16, hd, hd_v) == "tc"
    assert fa.route(torch.float32, hd, hd_v) == "core"
    assert fa.route(torch.float32, 32, 16) == "core"
    assert fa.route(torch.bfloat16, 128, 128) == "tc"
    assert fa.route(torch.bfloat16, 96, 64) == "tc"
    assert fa.route(torch.bfloat16, 192, 192) == "core"
    assert fa.route(torch.bfloat16, 64, 128) == "core"
    assert fa.route(torch.bfloat16, hd - 4, hd_v) == "core"
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA-core kernel"):
            fa.route(dtype, 512, 64)
    with pytest.raises(ValueError, match="not supported"):
        fa.route(torch.float16, hd, hd_v)


def _attention_widths(cfg):
    """(hd, hd_v) of a config's B5 launches: MLA attends at nope + rope
    with v_head_dim values (`models/attention.py` `mla_fwd`)."""
    if cfg.attention == "mla":
        return cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    return cfg.head_dim, cfg.head_dim


def _has_attention(cfg) -> bool:
    """Whether any block of the config attends (xlstm-1.3b's mLSTM and
    sLSTM blocks do not: its hd 512 never reaches B5)."""
    from repro_torch.models import lm
    head, pat, n_rep, tail = lm.layer_layout(cfg)
    return any(k in ("attn", "moe", "xattn") for k in head + pat + tail)


def test_every_served_config_routes_to_tensor_cores():
    """Every config the port serves runs its bf16 B5 launches on the
    tensor cores: no width falls back to the CUDA-core kernel.  Ten
    configs are served, nine of them with attention."""
    served = [n for n in list_archs() if n not in UNPORTED]
    assert len(served) == 10, served
    widths = {}
    for name in served:
        cfg = get_config(name)
        if not _has_attention(cfg):
            assert name == "xlstm-1.3b"
            continue
        hd, hd_v = _attention_widths(cfg)
        widths[name] = (hd, hd_v)
        assert cfg.dtype == torch.bfloat16, name
        assert fa.route(cfg.dtype, hd, hd_v) == "tc", (name, hd, hd_v)
    assert len(widths) == 9
    assert set(widths.values()) == {(256, 256), (64, 64), (128, 128),
                                    (112, 112), (192, 128), (96, 64),
                                    (96, 96)}


def test_tile_table_is_the_kernel_source():
    """`TC_HEAD_DIMS` is the `Tile` table of csrc/flash_attention_tc.cu,
    and the launcher dispatches on exactly those pairs."""
    tiles = {(int(a), int(b)): (int(c), int(d), e == "true")
             for a, b, c, d, e in re.findall(
                 r"template <> struct Tile<(\d+), (\d+)> : "
                 r"TileOf<(\d+), (\d+), (true|false)> \{\};", SRC)}
    assert tiles == fa.TC_HEAD_DIMS
    launched = {(int(a), int(b)) for a, b in re.findall(
        r"if \(hq == (\d+) && hv == (\d+)\) return launch<\1, \2>\(a\);",
        SRC)}
    assert launched == set(fa.TC_HEAD_DIMS)
    assert "constexpr int kBK = 64;" in SRC and fa.TC_BK == 64
    assert ("kQBytes + T::kStages * kStageBytes + 1024 + 128" in SRC)


def test_tc_smem_fits_at_both_served_widths():
    """The tensor-core kernel's Q tile and K/V ring fit the opt-in at
    recurrentgemma's hd 256 (128 q rows, 2 stages of 64 keys) and
    smollm's hd 64 (256 q rows, 4 stages of 64 keys), as before the
    kernel took width pairs."""
    assert fa.tc_tile(256, 256) == (128, 64, 2)
    assert fa.tc_tile(64, 64) == (256, 64, 4)
    assert fa.smem_bytes_tc(256, 256) == 2 * 256 * (128 + 2 * 2 * 64) + 1152
    assert fa.smem_bytes_tc(256, 256) == 197_760 <= SMEM_OPTIN_BYTES
    assert fa.smem_bytes_tc(64, 64) == 2 * 64 * (256 + 2 * 4 * 64) + 1152
    assert fa.smem_bytes_tc(64, 64) == 99_456


@pytest.mark.parametrize("pair", sorted(fa.TC_HEAD_DIMS))
def test_tc_smem_fits_at_every_instantiation(pair):
    """Each instantiation's Q tile and K/V ring fit the opt-in: Q (64 kNC
    rows x HQ) and kStages stages of 64 keys x (HQ + HV), bf16, + 1 KB of
    alignment and 128 bytes of mbarriers; one block per SM."""
    hq, hv = pair
    nc, stages, _ = fa.TC_HEAD_DIMS[pair]
    want = 2 * (64 * nc * hq + stages * 64 * (hq + hv)) + 1152
    assert fa.tc_tile(hq, hv) == (64 * nc, 64, stages)
    assert fa.smem_bytes_tc(hq, hv) == want <= SMEM_OPTIN_BYTES


def test_smem_at_real_widths_is_the_padded_pairs():
    """The real widths take their padded pair's block: kimi's hd 112 that
    of (128, 128), minicpm3's 96 / 64 that of (128, 64)."""
    assert fa.tc_widths(112, 112) == (128, 128)
    assert fa.tc_widths(96, 64) == (128, 64)
    assert fa.tc_widths(192, 128) == (192, 128)
    assert fa.smem_bytes_tc(112, 112) == fa.smem_bytes_tc(128, 128)
    assert fa.smem_bytes_tc(96, 64) == fa.smem_bytes_tc(128, 64)


def test_tma_strides_read_mla_v_slice_in_place():
    """MLA's v, a slice of its (B, S, H, nope + v) kv tensor, goes to the
    tensor maps with the kv tensor's strides (no copy); a size-1 head
    dimension takes the contiguous stride; columns that are not
    contiguous, or a stride that is not a multiple of 8 elements, are
    refused (the wrapper then copies)."""
    kv = torch.zeros(2, 10, 4, 64 + 64, dtype=torch.bfloat16)
    v = kv[..., 64:]
    assert fa._tma_strides(v) == [128, 4 * 128, 10 * 4 * 128]
    k = torch.zeros(2, 10, 1, 112, dtype=torch.bfloat16)
    assert fa._tma_strides(k) == [112, 112, 10 * 112]
    assert fa._tma_strides(k[:, :, :, ::2]) is None
    assert fa._tma_strides(
        torch.zeros(2, 10, 4, 100, dtype=torch.bfloat16)[..., :96]) is None
    # (B, H, S, W) seen as (B, S, H, W): the strides as they stand
    assert fa._tma_strides(kv.transpose(1, 2)) == [4 * 128, 128,
                                                    10 * 4 * 128]
