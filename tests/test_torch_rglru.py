"""The port's RG-LRU (B6 and the recurrent block) against the JAX package.

On the CPU `repro_torch.kernels.ops.rglru_scan` runs the kernel's plain
version.  It is held to the reference's oracle `kernels/ref.py`
`rglru_ref` and to its Pallas kernel in interpret mode at the sizes of
tests/test_kernels.py, with that file's tolerances: rtol 1e-5, atol 1e-6
in f32, 3e-2 in bf16.  The port's RG-LRU block (prefill, decode, and the
prefill cache's f32 final state) is held to the reference's, whose scan
is an associative scan over the same recurrence: f32 within rtol 1e-5,
atol 1e-5 (measured at most 2.4e-7 abs at these sizes).  The prefill
block runs the scan once and returns the decode state from it; a whole
prefill calls the scan once per RG-LRU layer.  A numpy walk of the CUDA
kernel's tiling (producers fill a ring of T tiles, a chain warp walks
them, ragged last tile and channel group) is held bitwise to the plain
version, which the kernel equals bitwise on the card: it stands in for
the index arithmetic only the card runs.  Inputs are drawn with numpy
from a seed.
"""
import dataclasses
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_smoke  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_kref  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import recurrent as ref_rec  # noqa: E402
from repro.models.layers import materialize  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402


def _inputs(T, D, seed, B=None):
    rng = np.random.default_rng(seed)
    lead = (T, D) if B is None else (B, T, D)
    x, ga, gx = (rng.standard_normal(lead).astype(np.float32)
                 for _ in range(3))
    a_log = (-np.abs(rng.standard_normal(D)) * .1).astype(np.float32)
    h0 = (rng.standard_normal(D if B is None else (B, D)) * 0.1).astype(
        np.float32)
    return x, a_log, ga, gx, h0


def _t(*arrs, dtype=torch.float32):
    return [torch.as_tensor(a).to(dtype) if a.dtype == np.float32 and
            a.ndim > 1 else torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("T,D,bt", [
    (64, 128, 16), (128, 128, 128), (256, 256, 64), (32, 8, 8),
])
def test_plain_matches_oracle_and_reference_kernel(T, D, bt):
    x, a_log, ga, gx, h0 = _inputs(T, D, seed=T + D)
    h, h_last = ops.rglru_scan(*_t(x, a_log, ga, gx, h0))
    j = [jnp.asarray(a) for a in (x, a_log, ga, gx, h0)]
    hr = ref_kref.rglru_ref(*j)
    hk = ref_ops.rglru_scan(*j, block_t=bt, interpret=True)
    for ref in (hr, hk):
        np.testing.assert_allclose(h.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    assert h_last.shape == (D,) and torch.equal(h_last, h[-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtypes_match_oracle(dtype):
    T, D = 64, 128
    x, a_log, ga, gx, _ = _inputs(T, D, seed=0)
    h0 = np.zeros(D, np.float32)
    tdt = getattr(torch, dtype)
    h, h_last = ops.rglru_scan(*_t(x, a_log, ga, gx, h0, dtype=tdt))
    # the oracle on the inputs as the port saw them (rounded to dtype)
    xr, gar, gxr = (np.asarray(jnp.asarray(a, getattr(jnp, dtype)),
                               np.float32) for a in (x, ga, gx))
    hr = ref_kref.rglru_ref(jnp.asarray(xr), jnp.asarray(a_log),
                            jnp.asarray(gar), jnp.asarray(gxr),
                            jnp.asarray(h0))
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert h.dtype == tdt and h_last.dtype == torch.float32
    np.testing.assert_allclose(h.float().numpy(), np.asarray(hr), rtol=tol,
                               atol=tol)
    # the final state is the f32 recurrence, never rounded to dtype
    np.testing.assert_allclose(h_last.numpy(), np.asarray(hr)[-1],
                               rtol=1e-5, atol=1e-6)


def test_batched_equals_per_row():
    B, T, D = 3, 40, 16
    x, a_log, ga, gx, h0 = _inputs(T, D, seed=5, B=B)
    h, h_last = ops.rglru_scan(*_t(x, a_log, ga, gx, h0))
    for b in range(B):
        hb, lb = ops.rglru_scan(*_t(x[b], a_log, ga[b], gx[b], h0[b]))
        assert torch.equal(h[b], hb) and torch.equal(h_last[b], lb)


def test_port_scan_matches_reference_associative_scan():
    """The port's `_rglru_scan` (B6's plain version on the CPU) against
    the reference block's associative scan, which B6 replaces on the
    port's path."""
    B, T, D = 2, 512, 64
    x, a_log, ga, gx, h0 = _inputs(T, D, seed=9, B=B)
    h, h_last = rec._rglru_scan(*_t(x, a_log, ga, gx, h0))
    hr, lr = ref_rec._rglru_scan(*(jnp.asarray(a) for a in
                                   (x, a_log, ga, gx, h0)))
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(lr), rtol=1e-5,
                               atol=1e-6)


def _block_params(seed):
    jcfg = dataclasses.replace(ref_smoke("recurrentgemma-2b"),
                               dtype=jnp.float32)
    cfg = dataclasses.replace(get_smoke("recurrentgemma-2b"),
                              dtype=torch.float32)
    p = materialize(ref_rec.rglru_block_specs(jcfg), jax.random.PRNGKey(seed))
    p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    pt = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    return jcfg, cfg, p, pt


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


def test_block_fwd_and_prefill_state_match_reference():
    """The block's output and the decode state it returns from its one
    scan against the reference's block and its `_rec_prefill_cache`."""
    jcfg, cfg, p, pt = _block_params(1)
    x = _x(2, 40, cfg.d_model, 2)
    y, c = rec.rglru_block_fwd(pt, torch.as_tensor(x), cfg)
    yr = ref_rec.rglru_block_fwd(p, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-5,
                               atol=1e-5)
    cr = ref_lm._rec_prefill_cache(p, jnp.asarray(x), jcfg)
    assert c["h"].dtype == torch.float32 and c["conv"].dtype == torch.bfloat16
    np.testing.assert_allclose(c["h"].numpy(), np.asarray(cr["h"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(c["conv"].float().numpy(),
                                  np.asarray(cr["conv"], np.float32))


def test_block_decode_matches_reference():
    jcfg, cfg, p, pt = _block_params(3)
    rng = np.random.default_rng(4)
    x = _x(2, 1, cfg.d_model, 5)
    h = rng.standard_normal((2, cfg.rglru_dim)).astype(np.float32)
    conv = rng.standard_normal((2, 3, cfg.rglru_dim)).astype(np.float32)
    conv_bf = jnp.asarray(conv, jnp.bfloat16)
    y, c = rec.rglru_block_decode(
        pt, torch.as_tensor(x),
        {"h": torch.as_tensor(h),
         "conv": torch.as_tensor(conv).to(torch.bfloat16)}, cfg)
    yr, cr = ref_rec.rglru_block_decode(
        p, jnp.asarray(x), {"h": jnp.asarray(h), "conv": conv_bf}, jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(c["h"].numpy(), np.asarray(cr["h"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(c["conv"].float().numpy(),
                                  np.asarray(cr["conv"], np.float32))


def test_decode_recurrence_equals_prefill():
    """Token-by-token decode from the zero state reproduces the prefill
    block's outputs and its final state.  Decode keeps the conv window
    in bf16, as the reference does, while prefill convolves in f32: that
    rounding (2^-9 relative per tap, measured 2.8e-3 abs here) sets the
    tolerance, 1e-2."""
    _, cfg, _, pt = _block_params(6)
    B, S = 2, 24
    x = torch.as_tensor(_x(B, S, cfg.d_model, 7))
    y, c_pre = rec.rglru_block_fwd(pt, x, cfg)
    cache = {"h": torch.zeros((B, cfg.rglru_dim)),
             "conv": torch.zeros((B, 3, cfg.rglru_dim))}
    outs = []
    for t in range(S):
        o, cache = rec.rglru_block_decode(pt, x[:, t:t + 1], cache, cfg)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), y.numpy(),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(cache["h"].numpy(), c_pre["h"].numpy(),
                               rtol=1e-2, atol=1e-2)


class _OtherDevice(torch.Tensor):
    """A CPU tensor that says it lives on a device the port has no route
    for (`meta` is the dry run's shape-only route)."""
    @property
    def device(self):
        return torch.device("xpu")


def test_wrapper_rejects_other_devices():
    x = torch.zeros((1, 4, 8)).as_subclass(_OtherDevice)
    with pytest.raises(ValueError, match="unsupported device"):
        rglru.rglru_kernel(x, torch.zeros(8), x, x, torch.zeros((1, 8)))
    m = torch.zeros((1, 4, 8), device="meta")
    h, h_last = rglru.rglru_kernel(m, torch.zeros(8, device="meta"), m, m,
                                   torch.zeros((1, 8), device="meta"))
    assert (h.device.type, h.shape, h_last.shape) == ("meta", m.shape, (1, 8))


def _two_pass_cache(p, h, cfg):
    """The decode state as prefill once computed it, in a second pass
    after the block: projections, conv and the whole scan again, for the
    final state only."""
    xb = h @ p["w_x"]
    xb_c, conv_state = rec._causal_conv(xb, p["conv_w"], p["conv_b"])
    ga, gx = xb_c @ p["gate_a_w"], xb_c @ p["gate_x_w"]
    h0 = torch.zeros((h.shape[0], cfg.rglru_dim), dtype=torch.float32)
    _, h_last = rec._rglru_scan(xb_c, rec._a_log(p["a_param"]), ga, gx, h0)
    return {"h": h_last, "conv": conv_state.to(torch.bfloat16)}


@pytest.mark.parametrize("n_layers", [3, 5])
def test_prefill_scans_once_per_rec_layer(monkeypatch, n_layers):
    """A smoke-size prefill (3 layers: rec, rec, attn; 5: two more rec)
    calls the RG-LRU scan once per rec layer, and each rec layer's cache
    equals the two-pass computation's bitwise."""
    cfg = dataclasses.replace(get_smoke("recurrentgemma-2b"),
                              n_layers=n_layers, dtype=torch.float32)
    head, pat, n_rep, tail = lm.layer_layout(cfg)
    n_rec = sum(k == "rec" for k in head + pat * n_rep + tail)
    assert n_rec == n_layers - n_layers // 3
    scans, blocks = [], []
    scan, block = ops.rglru_scan, rec.rglru_block_fwd

    def counted_scan(*args):
        scans.append(args[0].shape)
        return scan(*args)

    def recorded_block(p, x, c):
        out = block(p, x, c)
        blocks.append((p, x, out[1]))
        return out

    monkeypatch.setattr(ops, "rglru_scan", counted_scan)
    monkeypatch.setattr(rec, "rglru_block_fwd", recorded_block)
    params = tree_map(lambda t: t.float(),
                      steps.init_params(cfg, seed=0, device="cpu"))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 24)))
    with torch.inference_mode():
        _, cache = lm.forward(params, toks, cfg, mode="prefill")
        assert len(scans) == n_rec == len(blocks)
        rec_caches = [c for c in _lm_caches(cache) if "conv" in c]
        assert len(rec_caches) == n_rec
        for (p, h, state), c in zip(blocks, rec_caches):
            want = _two_pass_cache(p, h, cfg)
            assert c is state
            assert c["h"].dtype == torch.float32
            assert c["conv"].dtype == torch.bfloat16
            assert torch.equal(c["h"], want["h"])
            assert torch.equal(c["conv"], want["conv"])


def _lm_caches(cache):
    """The per-layer caches of `lm.forward` in layer order."""
    out = list(cache["head"])
    for blk in cache["blocks"]:
        out += [blk[k] for k in sorted(blk, key=int)]
    return out + list(cache["tail"])


# -- the CUDA kernel's tiling, walked in numpy --------------------------------

SRC = (pathlib.Path(rglru.__file__).parent / "csrc" / "rglru.cu").read_text()


def test_python_constants_match_the_kernel_source():
    """`rglru.GROUP`, `CHUNK`, `PRODUCER_WARPS`, `STAGES` and `TILE`
    mirror the kernel's constants."""
    got = {n: int(re.search(rf"constexpr int {n} = (\d+);", SRC).group(1))
           for n in ("kGroup", "kChunk", "kProducerWarps", "kStages")}
    assert got == {"kGroup": rglru.GROUP, "kChunk": rglru.CHUNK,
                   "kProducerWarps": rglru.PRODUCER_WARPS,
                   "kStages": rglru.STAGES}
    assert "constexpr int kTile = kProducers * kChunk / kGroup;" in SRC
    assert rglru.TILE == 32 * rglru.PRODUCER_WARPS * rglru.CHUNK \
        // rglru.GROUP == 64


def _tiled_walk(x, a_log, ga, gx, h0):
    """`csrc/rglru.cu`'s schedule in numpy, block by block: producer
    thread p owns step p // (GROUP / CHUNK) of every tile and CHUNK
    channels from (p % (GROUP / CHUNK)) CHUNK, fills ring stage k %
    STAGES with tile k's a_t and b_t once the chain has walked tile k -
    STAGES and its h is stored, and stores the h the chain left in the
    stage; the chain walks a tile's steps over its GROUP lanes, writing h
    over b.  Producers run as far ahead as the ring lets them.  Unfilled
    cells are NaN, so a wrong index shows in the output.  The gates are
    the plain version's (`rglru_gates`): the walk's arithmetic is the
    chain's f32 multiply and add."""
    G, C, S, TT = rglru.GROUP, rglru.CHUNK, rglru.STAGES, rglru.TILE
    NP = 32 * rglru.PRODUCER_WARPS
    a, bb = (t.numpy() for t in rglru.rglru_gates(x, a_log, ga, gx))
    B, T, D = x.shape
    out = np.full((B, T, D), np.nan, np.float32)
    h_last = np.full((B, D), np.nan, np.float32)
    ntiles = -(-T // TT)
    for b in range(B):
        for cg in range(0, D, G):
            ring = np.full((2, S, TT, G), np.nan, np.float32)
            lanes = min(G, D - cg)
            h = np.zeros(G, np.float32)
            h[:lanes] = h0[b, cg:cg + lanes].numpy()
            walked = []

            def items(k):
                for p in range(NP):
                    row, col = p // (G // C), p % (G // C) * C
                    nc = min(C, D - cg - col)
                    if nc > 0 and k * TT + row < T:
                        yield row, col, nc

            def walk_to(k):
                nonlocal h
                while len(walked) <= k:
                    j = len(walked)
                    for t in range(min(TT, T - j * TT)):
                        h = ring[0, j % S, t] * h + ring[1, j % S, t]
                        ring[1, j % S, t] = h
                    walked.append(j)

            def store(k):
                walk_to(k)
                for row, col, nc in items(k):
                    c0 = cg + col
                    out[b, k * TT + row, c0:c0 + nc] = \
                        ring[1, k % S, row, col:col + nc]

            for k in range(ntiles):
                if k >= S:
                    store(k - S)
                for row, col, nc in items(k):
                    t, c0 = k * TT + row, cg + col
                    ring[0, k % S, row, col:col + nc] = a[b, t, c0:c0 + nc]
                    ring[1, k % S, row, col:col + nc] = bb[b, t, c0:c0 + nc]
            for k in range(max(ntiles - S, 0), ntiles):
                store(k)
            h_last[b, cg:cg + lanes] = h[:lanes]
    return torch.from_numpy(out).to(x.dtype), torch.from_numpy(h_last)


@pytest.mark.parametrize("D", [8, 80])
@pytest.mark.parametrize("T", [1, 5, rglru.TILE - 1, rglru.TILE,
                               3 * rglru.TILE + 7])
def test_tiled_walk_equals_plain_bitwise(T, D):
    """T: one step, below a tile, a tile less one, one tile, and three
    tiles and a ragged fourth (more tiles than ring stages); D: below one
    16-channel group, and five groups (80 is no multiple of 32)."""
    x, a_log, ga, gx, h0 = _inputs(T, D, seed=T * 100 + D, B=2)
    args = _t(x, a_log, ga, gx, h0)
    hw, lw = _tiled_walk(*args)
    hp, lp = rglru.rglru_plain(*args)
    assert torch.equal(hw, hp) and torch.equal(lw, lp)

