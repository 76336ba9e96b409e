"""A model of B5's tensor-core backward (csrc/flash_attention_bwd_tc.cu)
against the JAX package, and the Python mirrors of its walk, routing,
tile table and shared memory.

No code of `flash_attention_bwd_tc.cu` runs here: the CUDA kernel runs
only on the card, where chip_smoke.py holds it to
`flash_attention_bwd_plain` (bf16 rtol 2e-2 / atol 1e-2, error RMS at
most 1 % of the plain output's, two launches `torch.equal`).  Here a
test-side model repeats what the kernel's arithmetic does differently
from the plain version: each row's log-sum-exp taken from the forward
(the tensor-core forward's running max of the raw scores and its f32
sum of powers of two, a 64-key tile at a time, stored as (m scale
log2(e) + log2 l) ln 2), P = 2^(S scale log2(e) - lse log2(e)) with
the products of bf16 inputs summed in f32, D = rowsum(dO o) in f32,
dS = P (dP - D) in f32, P and dS carried into their products (dV =
P^T dO, dQ = scale dS K, dK = scale dS^T Q) as two bf16 terms each, hi
= bf16(x) and lo = bf16(x - hi) (their sum is exact in f32), f32 sums,
and, where
the dk / dv launch splits a GQA group's heads over blocks, each head's
f32 partial summed in head order.  The model is held to `jax.vjp` of
the reference's `blocked_attention` in f32 (as
`test_bwd_plain_matches_reference_vjp` runs it) at hd 64 and 256,
every mask, GQA, MQA and Sq != Sk, within the card's criterion: rtol
2e-2 / atol 1e-2 and an error RMS at most 1 % of the reference's
(measured: at most 0.51 of the elementwise bound, RMS 0.20 %; most of
it from D, which reads the forward's bf16 o); a walk that drops one kv
tile fails it.  P and dS rounded once to bf16 pass here (0.93 of the
bound) but not against the plain version at the train runs' full
shapes (1.03 at smollm's dv in this model), which the split passes
(0.33).  Beside it: the route table, the instantiations and
constants against the `.cu` source, the shared memory against the
opt-in, the two launches' walks and the head split covering every
unmasked (query, key) pair exactly once, and `FlashAttentionFn`
saving the forward's lse on the CPU.  Inputs are drawn with numpy
from a seed.  The file takes about 33 s on the CPU in
one process, most of it JAX's tracing of the reference.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import blocked_attention as ref_blocked  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.contracts import SMEM_OPTIN_BYTES  # noqa: E402

WINDOW = 40
NEG_INF = -1e30
RTOL, ATOL, RMS_RATIO = 2e-2, 1e-2, 0.01
SRC = (build.CSRC / "flash_attention_bwd_tc.cu").read_text()
BK = fa.BWD_TC_BK


def forward_lse(q, k, *, kind, window):
    """Each row's lse as the tensor-core forward writes it: the running
    max of the raw scores and the f32 sum of 2^(s c - m c) over the kv
    tiles of 64 keys its mask reaches, rescaled at each new max;
    (m c + log2 l) ln 2.  -> (B, H, Sq) f32."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    c = torch.tensor(hd ** -0.5 * fa.LOG2E, dtype=torch.float32)
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(H // Hkv, dim=1)
    ok = fa.mask(Sq, Sk, kind=kind, window=window)
    m = torch.full((B, H, Sq), NEG_INF)
    lsum = torch.zeros((B, H, Sq))
    for kt in range(-(-Sk // BK)):
        cols = slice(kt * BK, min(kt * BK + BK, Sk))
        s = (qf @ kf[:, :, cols].transpose(-1, -2)).masked_fill(
            ~ok[:, cols], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        ms = torch.where(m_new == NEG_INF, 0.0, m_new * c)
        p = torch.exp2(torch.addcmul(-ms[..., None], s, c))
        lsum = lsum * torch.exp2((m - m_new) * c) + p.sum(-1)
        m = m_new
    ms = torch.where(m == NEG_INF, 0.0, m * c)
    return (ms + torch.log2(lsum)) * torch.tensor(0.6931471805599453)


def _split(x):
    """x as the kernel's two bf16 terms, hi + lo, summed in f32."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def tc_bwd_model(q, k, v, o, do, lse, *, kind, window, drop=None):
    """(dq, dk, dv) bf16 with the tensor-core backward's roundings (see
    the module docstring).  drop: a (q tile start, kv tile) pair whose
    visit both launches skip."""
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    c = torch.tensor(hd ** -0.5 * fa.LOG2E, dtype=torch.float32)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    qf = q.float().permute(0, 2, 1, 3)                       # (B, H, Sq, hd)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    dof = do.float().permute(0, 2, 1, 3)
    D = (dof * o.float().permute(0, 2, 1, 3)).sum(-1)          # (B, H, Sq)
    L = lse * torch.tensor(fa.LOG2E, dtype=torch.float32)
    ok = fa.mask(Sq, Sk, kind=kind, window=window)
    p = torch.exp2(torch.addcmul(-L[..., None], qf @ kf.transpose(-1, -2),
                                 c)).masked_fill(~ok, 0.0)
    if drop is not None:
        q0, kt = drop
        p[:, :, q0:q0 + fa.BWD_TC_BQ, kt * BK:kt * BK + BK] = 0.0
    ds = p * (dof @ vf.transpose(-1, -2) - D[..., None])
    p16, ds16 = _split(p), _split(ds)
    dq = (ds16 @ kf) * scale
    dk_h = ds16.transpose(-1, -2) @ qf                      # (B, H, Sk, hd)
    dv_h = p16.transpose(-1, -2) @ dof
    split = fa.bwd_tc_head_split(B, Sk, H, Hkv)
    per = G // split
    # a block's heads accumulate in its sum; the chunks' f32 partials are
    # added in head order
    dk_c = dk_h.reshape(B, Hkv, split, per, Sk, hd).sum(3)
    dv_c = dv_h.reshape(B, Hkv, split, per, Sk, hd_v).sum(3)
    dk, dv = dk_c[:, :, 0], dv_c[:, :, 0]
    for j in range(1, split):
        dk, dv = dk + dk_c[:, :, j], dv + dv_c[:, :, j]
    return (dq.permute(0, 2, 1, 3).bfloat16(),
            (dk * scale).permute(0, 2, 1, 3).bfloat16(),
            dv.permute(0, 2, 1, 3).bfloat16())


# (B, Sq, Sk, H, Hkv, hd, hd_v, kinds): the two instantiations' widths
# ((64, 64): smollm, whisper; (256, 256): recurrentgemma), with GQA 3 and
# a ragged q tile, MQA (its heads split over blocks), H = Hkv with Sq !=
# Sk both ways, and a real width below the padded one (hd 56 on (64, 64))
CASES = [(2, 150, 150, 6, 2, 64, 64, ("causal", "local", "full")),
         (1, 100, 70, 4, 4, 64, 64, ("full", "causal")),
         (1, 70, 130, 2, 2, 56, 56, ("causal",)),
         (1, 130, 130, 4, 1, 256, 256, ("causal", "local")),
         (1, 90, 120, 2, 2, 256, 256, ("full",))]


def _cases():
    for c in CASES:
        for kind in c[7]:
            yield pytest.param(c[:7], kind,
                               id=f"{kind}-{'x'.join(map(str, c[:7]))}")


def _inputs(shape, seed):
    B, Sq, Sk, H, Hkv, hd, hd_v = shape
    rng = np.random.default_rng(seed)
    draw = lambda *s: torch.as_tensor(                      # noqa: E731
        rng.standard_normal(s).astype(np.float32)).bfloat16()
    return (draw(B, Sq, H, hd), draw(B, Sk, Hkv, hd), draw(B, Sk, Hkv, hd_v),
            draw(B, Sq, H, hd_v))


def _reference_vjp(q, k, v, do, kind):
    """jax.vjp of the reference's blocked attention in f32 on the bf16
    inputs -> (o, (dq, dk, dv)) as f32 numpy."""
    j = lambda t: jnp.asarray(t.float().numpy())             # noqa: E731
    qpos = jnp.arange(q.shape[1])
    o, vjp = jax.vjp(lambda a, b, c: ref_blocked(
        a, b, c, q_positions=qpos, kind=kind, window=WINDOW, chunk=16),
        j(q), j(k), j(v))
    return np.array(o), [np.asarray(g) for g in vjp(j(do))]


def _rms_ratio(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))


@pytest.mark.parametrize("shape,kind", list(_cases()))
def test_tc_bwd_model_within_card_criterion_of_reference_vjp(shape, kind):
    q, k, v, do = _inputs(shape, seed=sum(shape))
    o_ref, want = _reference_vjp(q, k, v, do, kind)
    o = torch.from_numpy(o_ref).bfloat16()      # the forward's bf16 output
    lse = forward_lse(q, k, kind=kind, window=WINDOW)
    got = tc_bwd_model(q, k, v, o, do, lse, kind=kind, window=WINDOW)
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape, name
        g = g.float().numpy()
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
        assert _rms_ratio(g, w) <= RMS_RATIO, name


@pytest.mark.parametrize("shape", [CASES[0][:7], CASES[3][:7]],
                         ids=["hd64", "hd256"])
def test_card_criterion_sees_a_dropped_kv_tile(shape):
    """The card's criterion fails a walk that skips one (q tile, kv tile)
    visit: the last q tile's first kv tile under the causal mask."""
    q, k, v, do = _inputs(shape, seed=sum(shape))
    o_ref, want = _reference_vjp(q, k, v, do, "causal")
    lse = forward_lse(q, k, kind="causal", window=WINDOW)
    last = (shape[1] - 1) // fa.BWD_TC_BQ * fa.BWD_TC_BQ
    got = tc_bwd_model(q, k, v, torch.from_numpy(o_ref).bfloat16(), do,
                       lse, kind="causal", window=WINDOW, drop=(last, 0))
    assert max(_rms_ratio(g.float().numpy(), w)
               for g, w in zip(got, want)) > RMS_RATIO


def test_forward_lse_model_is_the_logsumexp():
    """The forward's lse (its online max and sum) is the masked scores'
    log-sum-exp to f32 rounding: the tensor-core backward's P is the
    plain version's softmax before its bf16 rounding."""
    q, k, _, _ = _inputs((2, 150, 150, 6, 2, 64, 64), seed=1)
    for kind in ("causal", "local", "full"):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                         k.float().repeat_interleave(3, dim=2)) * 64 ** -0.5
        ok = fa.mask(150, 150, kind=kind, window=WINDOW)
        want = torch.logsumexp(s.masked_fill(~ok, NEG_INF), dim=-1)
        torch.testing.assert_close(forward_lse(q, k, kind=kind,
                                               window=WINDOW), want,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd,hd_v", [(64, 64), (56, 56), (64, 48),
                                     (256, 256), (200, 256), (128, 128),
                                     (112, 112), (192, 128), (96, 64),
                                     (96, 96), (64, 128), (16, 16),
                                     (60, 64)])
def test_bwd_route_sends_the_two_pairs_to_tensor_cores(hd, hd_v):
    """bf16 whose padded pair is (64, 64) or (256, 256) goes to "tc";
    f32, every other pair, and widths not a multiple of 8 go to
    "core"."""
    tc = (hd % 8 == 0 and hd_v % 8 == 0
          and fa.tc_widths(hd, hd_v) in ((64, 64), (256, 256)))
    assert fa.bwd_route(torch.bfloat16, hd, hd_v) == ("tc" if tc
                                                       else "core")
    assert fa.bwd_route(torch.float32, hd, hd_v) == "core"
    with pytest.raises(ValueError):
        fa.bwd_route(torch.float16, hd, hd_v)
    with pytest.raises(ValueError):
        fa.bwd_route(torch.float32, 264, hd_v)


def test_train_runs_route_to_tensor_cores_and_split_only_mqa():
    """The three full-width train runs' backward shapes take the tensor
    cores; only recurrentgemma's MQA (32 kv tiles) splits its 10 heads
    over blocks."""
    shapes = {"smollm": (4, 2048, 15, 5, 64, 1),
              "recurrentgemma": (1, 2048, 10, 1, 256, 10),
              "whisper": (4, 1500, 8, 8, 64, 1)}
    for name, (B, Sk, H, Hkv, hd, split) in shapes.items():
        assert fa.bwd_route(torch.bfloat16, hd, hd) == "tc", name
        assert fa.bwd_tc_head_split(B, Sk, H, Hkv) == split, name


def test_tile_table_and_constants_are_the_kernel_source():
    tiles = {(int(a), int(b)): (int(c), int(d)) for a, b, c, d in re.findall(
        r"template <> struct Tile<(\d+), (\d+)> : TileOf<(\d+), (\d+)> "
        r"\{\};", SRC)}
    assert tiles == fa.BWD_TC_PAIRS
    launched = {(int(a), int(b)) for a, b in re.findall(
        r"if \(hq == (\d+) && hv == (\d+)\) return launch<\1, \2>\(a\);",
        SRC)}
    assert launched == set(fa.BWD_TC_PAIRS)
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", SRC))
    assert (int(consts["kBQ"]), int(consts["kBK"])) == (fa.BWD_TC_BQ,
                                                        fa.BWD_TC_BK)
    assert ("(1 + T::kStages) * kPairBytes + T::kStages * kLDBytes + 1024 "
            "+ 128" in SRC)
    assert "constexpr uint32_t kLDBytes = 2 * kBQ * 4;" in SRC
    assert not re.search(r"\batomic\w*\s*\(|\b(atom|red)\.", SRC)
    assert fa.BWD_TC_SPLIT_BELOW == 132


@pytest.mark.parametrize("pair", sorted(fa.BWD_TC_PAIRS))
def test_bwd_tc_smem_under_the_opt_in(pair):
    hq, hv = pair
    stages, _ = fa.BWD_TC_PAIRS[pair]
    want = (1 + stages) * 2 * 64 * (hq + hv) + stages * 512 + 1152
    assert fa.bwd_tc_smem_bytes(hq, hv) == want <= SMEM_OPTIN_BYTES
    assert fa.bwd_tc_smem_bytes(hq - 8, hv - 8) == want
    assert {p: fa.bwd_tc_smem_bytes(*p) for p in fa.BWD_TC_PAIRS} == {
        (64, 64): 51_328, (256, 256): 198_784}


@pytest.mark.parametrize("kind", ["causal", "local", "full"])
def test_walks_and_head_split_cover_every_unmasked_pair_once(kind):
    """Launch 1 (a q tile visits `kv_tile_range`) and launch 2 (a block
    of (kv tile, batch, kv head, head chunk) visits its chunk's heads and
    the q tiles of `bwd_q_tile_range`) each visit every unmasked (head,
    query, key) pair exactly once."""
    BQ = fa.BWD_TC_BQ
    for Sq, Sk, H, Hkv, window in ((130, 130, 6, 2, 7), (64, 200, 4, 1, 70),
                                   (200, 64, 4, 4, 33), (257, 257, 8, 1, 64),
                                   (31, 31, 2, 1, 1), (100, 100, 3, 3, 2048)):
        ok = fa.mask(Sq, Sk, kind=kind, window=window).numpy()
        G = H // Hkv
        split = fa.bwd_tc_head_split(1, Sk, H, Hkv)
        assert split == (G if G > 1 else 1)      # these sizes are small
        seen1 = np.zeros((Sq, Sk), int)
        for qs in range(0, Sq, BQ):
            b, e = fa.kv_tile_range(qs, BQ, Sq, Sk, kind=kind, window=window,
                                    bk=BK)
            seen1[qs:qs + BQ, b * BK:e * BK] += 1
        seen2 = np.zeros((H, Sq, Sk), int)
        for ks in range(0, Sk, BK):
            b, e = fa.bwd_q_tile_range(ks, Sq, Sk, kind=kind, window=window,
                                       bq=BQ, bk=BK)
            for hk in range(Hkv):
                for sp in range(split):
                    for h in range(hk * G + sp * (G // split),
                                   hk * G + (sp + 1) * (G // split)):
                        seen2[h, b * BQ:e * BQ, ks:ks + BK] += 1
        assert (seen1[ok] == 1).all(), (Sq, Sk, window)
        assert (seen2[:, ok] == 1).all(), (Sq, Sk, H, Hkv, window)


def test_function_saves_the_forward_lse_on_the_cpu(monkeypatch):
    """`ops.flash_attention` with a grad recorded: the forward keeps an
    lse equal to the masked scores' logsumexp, (B, H, Sq) f32, and the
    backward equals `flash_attention_bwd_plain`; without one (no grad,
    inference mode) no lse is asked for."""
    asked = []
    real = fa.flash_attention_kernel
    monkeypatch.setattr(fa, "flash_attention_kernel", lambda *a, **kw: (
        asked.append(kw.get("with_lse", False)) or real(*a, **kw)))
    rng = np.random.default_rng(5)
    f = lambda *s: torch.from_numpy(                          # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, k, v, do = f(2, 19, 4, 8), f(2, 19, 2, 8), f(2, 19, 2, 8), \
        f(2, 19, 4, 8)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = ops.flash_attention(*leaves, kind="local", window=5)
    lse = o.grad_fn.saved_tensors[4]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, dim=2)) \
        * 8 ** -0.5
    ok = fa.mask(19, 19, kind="local", window=5)
    assert lse.shape == (2, 4, 19) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, torch.logsumexp(
        s.masked_fill(~ok, NEG_INF), dim=-1), rtol=0, atol=1e-6)
    got = torch.autograd.grad(o, leaves, do)
    want = fa.flash_attention_bwd_plain(q, k, v, o.detach(), do,
                                        kind="local", window=5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert asked == [True]
    with torch.no_grad():
        ops.flash_attention(*leaves, kind="causal")
    with torch.inference_mode():
        ops.flash_attention(q, k, v, kind="causal")
    assert asked == [True, False, False]
