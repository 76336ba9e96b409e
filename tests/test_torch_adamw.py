"""The port's AdamW (`repro_torch.optim.adamw`) against the reference's
(`repro.optim.adamw.apply`, run eagerly), for f32, bf16 and int8
moments, three steps on one tree from numpy seeds.

The tree holds what decides the numbers: a stacked repeated block
(`blocks`: the reference's (n_rep, d) gain and (n_rep, d, f) matrix are
the port's n_rep dicts of a (d,) gain and a (d, f) matrix), a head
block's (d,) gain, an unstacked matrix and a bf16 matrix.  Weight decay
goes by the reference's rank, so the stacked gain is decayed and the
head's is not (`test_decay_goes_by_the_reference_rank` pins it with zero
gradients, where decay is the whole update).

Tolerances: parameters, f32 and bf16 moments, the step and the gradient
norm within rtol 2e-6, with an atol of 2e-6 of the leaf's largest
magnitude for entries that cancel to near zero (the elementwise update
is the reference's operation for operation, IEEE in both; the norm's
sums and the f32 power run in other orders or implementations:
measured 1.1e-6 relative on parameters, 8.3e-8 on the norm, 3.7e-9 abs
on a moment); int8 moments: scales alike, and quantised values within
one step of each other (a value an ulp from a rounding boundary may
round either way; measured equal).  The update is in place, and a leaf
updated a chunk of rows at a time gets the whole leaf's bits.  CPU
seconds: about 14.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as ref  # noqa: E402
from repro_torch.checkpoint import restore_tree, save_tree  # noqa: E402
from repro_torch.models.layers import tree_items, tree_map_path  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

N_REP, D, F, V = 3, 8, 12, 20
RTOL = 2e-6
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": ("int8", "int8")}


def _ref_tree(rng, scale=1.0):
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731,E501
    return {"blocks": {"0": {"ln": {"g": f(N_REP, D)}, "w": f(N_REP, D, F)}},
            "embed": f(V, D), "head_blocks": [{"ln": {"g": f(D)}}],
            "w16": f(D, F)}


def _port_tree(t):
    """The reference's numpy tree as the port's tensors: the stacked
    block unstacked into n_rep dicts, `w16` in bf16."""
    T = lambda a: torch.from_numpy(np.array(a))              # noqa: E731
    blk = t["blocks"]["0"]
    out = {"blocks": [{"0": {"ln": {"g": T(blk["ln"]["g"][r])},
                             "w": T(blk["w"][r])}} for r in range(N_REP)],
           "embed": T(t["embed"]),
           "head_blocks": [{"ln": {"g": T(t["head_blocks"][0]["ln"]["g"])}}],
           "w16": T(t["w16"])}
    out["w16"] = out["w16"].to(torch.bfloat16)
    return out


def _jax_tree(t):
    out = jax.tree.map(jnp.asarray, t)
    out["w16"] = out["w16"].astype(jnp.bfloat16)
    return out


def _pairs(port, reft):
    """(port leaf, reference leaf as numpy) in the port's order, the
    stacked block's rows unstacked."""
    blk = reft["blocks"]["0"]
    for r in range(N_REP):
        b = port["blocks"][r]["0"]
        yield b["ln"]["g"], blk["ln"]["g"][r]
        yield b["w"], blk["w"][r]
    yield port["embed"], reft["embed"]
    yield port["head_blocks"][0]["ln"]["g"], \
        reft["head_blocks"][0]["ln"]["g"]
    yield port["w16"], reft["w16"]


def _np(a):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a)
    return a.astype(np.float32)


def _close(got, want):
    """Within RTOL of the reference, or of its leaf's largest magnitude
    where an entry cancels to near zero."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _moment_close(got, want):
    if isinstance(got, adamw.QMoment):
        _close(got.scale, want.scale)
        dq = np.abs(got.q.numpy().astype(np.int32)
                    - np.asarray(want.q).astype(np.int32))
        assert dq.max() <= 1 and got.q.dtype == torch.int8
    else:
        _close(got, want)


def _moment_pairs(port_m, ref_m):
    """Like `_pairs` for a moment tree (QMoment leaves: the reference's
    stacked q and scale rows unstacked)."""
    def rows(m, r):
        if isinstance(m, ref.QMoment):
            return ref.QMoment(m.q[r], m.scale[r])
        return m[r]
    blk = ref_m["blocks"]["0"]
    for r in range(N_REP):
        b = port_m["blocks"][r]["0"]
        yield b["ln"]["g"], rows(blk["ln"]["g"], r)
        yield b["w"], rows(blk["w"], r)
    yield port_m["embed"], ref_m["embed"]
    yield port_m["head_blocks"][0]["ln"]["g"], \
        ref_m["head_blocks"][0]["ln"]["g"]
    yield port_m["w16"], ref_m["w16"]


@pytest.mark.parametrize("moments", list(DTYPES))
def test_apply_matches_reference(moments):
    rng = np.random.default_rng(0)
    p0 = _ref_tree(rng)
    jdt, tdt = DTYPES[moments]
    jcfg = ref.AdamWConfig(state_dtype=jdt, lr=1e-2)
    tcfg = adamw.AdamWConfig(state_dtype=tdt, lr=1e-2)
    jp, tp = _jax_tree(p0), _port_tree(p0)
    js, ts = ref.init(jp, jcfg), adamw.init(tp, tcfg)
    for step in range(3):
        g = _ref_tree(rng, scale=0.5 if step != 1 else 3.0)   # clipped
        jp, js, jm = ref.apply(jp, _jax_tree(g), js, jcfg)
        tp, ts, tm = adamw.apply(tp, _port_tree(g), ts, tcfg)
        _close(tm["grad_norm"], jm["grad_norm"])
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        for a, b in _pairs(tp, jax.tree.map(np.asarray, jp)):
            assert a.dtype == (torch.bfloat16 if a is tp["w16"]
                               else torch.float32)
            _close(a, b)
        for mine, theirs in ((ts.mu, js.mu), (ts.nu, js.nu)):
            for a, b in _moment_pairs(mine, theirs):
                _moment_close(a, b)


def test_init_matches_reference_shapes_and_dtypes():
    p0 = _ref_tree(np.random.default_rng(1))
    for name, (jdt, tdt) in DTYPES.items():
        js = ref.init(_jax_tree(p0), ref.AdamWConfig(state_dtype=jdt))
        ts = adamw.init(_port_tree(p0), adamw.AdamWConfig(state_dtype=tdt))
        assert int(ts.step) == 0
        for a, b in _moment_pairs(ts.mu, js.mu):
            if name == "int8":
                assert a.q.dtype == torch.int8 and a.q.shape == b.q.shape
                assert a.scale.shape == b.scale.shape
                assert (a.scale.numpy() == np.asarray(b.scale)).all()
            else:
                assert a.dtype == tdt and a.shape == b.shape
                assert not a.any()


def test_decay_goes_by_the_reference_rank():
    """With zero gradients AdamW's update is the decoupled decay alone:
    the stacked block's (d,) gain (the reference's (n_rep, d)) and every
    matrix shrink by lr * wd * p, the head block's (d,) gain does not;
    both packages agree."""
    p0 = _ref_tree(np.random.default_rng(2))
    zero = jax.tree.map(np.zeros_like, p0)
    jcfg, tcfg = ref.AdamWConfig(lr=0.5), adamw.AdamWConfig(lr=0.5)
    jp, _, _ = ref.apply(_jax_tree(p0), _jax_tree(zero),
                         ref.init(_jax_tree(p0), jcfg), jcfg)
    tp0 = _port_tree(p0)
    tp, _, _ = adamw.apply(tree_clone(tp0), _port_tree(zero),
                           adamw.init(tp0, tcfg), tcfg)
    g_blk = tp["blocks"][1]["0"]["ln"]["g"]
    g0 = tp0["blocks"][1]["0"]["ln"]["g"]
    torch.testing.assert_close(g_blk, g0 - 0.5 * (0.1 * g0), rtol=1e-6,
                               atol=0)
    assert torch.equal(tp["head_blocks"][0]["ln"]["g"],
                       tp0["head_blocks"][0]["ln"]["g"])
    assert not torch.equal(tp["embed"], tp0["embed"])
    assert adamw.ref_ndim(("blocks", 1, "0", "ln", "g"), g0) == 2
    assert adamw.ref_ndim(("head_blocks", 0, "ln", "g"), g0) == 1
    for a, b in _pairs(tp, jax.tree.map(np.asarray, jp)):
        _close(a, b)


def test_int8_state_checkpoints_bitwise(tmp_path):
    """The AdamW state (a step tensor and QMoment leaves) saves and
    restores bit for bit, the named tuples rebuilt."""
    p0 = _port_tree(_ref_tree(np.random.default_rng(3)))
    cfg = adamw.AdamWConfig(state_dtype="int8")
    st = adamw.init(p0, cfg)
    _, st, _ = adamw.apply(p0, _port_tree(_ref_tree(
        np.random.default_rng(4))), st, cfg)
    save_tree(tmp_path / "s", (p0, st))
    (p1, st1), _ = restore_tree(tmp_path / "s", (p0, adamw.init(p0, cfg)),
                                device="cpu")
    assert isinstance(st1, adamw.AdamWState)
    assert isinstance(st1.mu["embed"], adamw.QMoment)
    got, want = _flat((p1, st1)), _flat((p0, st))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("moments", list(DTYPES))
def test_update_is_in_place(moments):
    """The update writes into the given parameters and moments (no new
    tensors; a QMoment's q and scale too), with the bits of the same step
    taken on copies."""
    rng = np.random.default_rng(5)
    p0, g = _port_tree(_ref_tree(rng)), _port_tree(_ref_tree(rng))
    cfg = adamw.AdamWConfig(state_dtype=DTYPES[moments][1], lr=1e-2)
    st0 = adamw.apply(p0, g, adamw.init(p0, cfg), cfg)[1]
    p1 = tree_clone(p0)
    s1 = adamw.AdamWState(st0.step, tree_clone(st0.mu), tree_clone(st0.nu))
    before = [t.data_ptr() for t in _flat((p0, st0.mu, st0.nu))]
    want_p, want_s, _ = adamw.apply(p0, g, st0, cfg)
    assert [t.data_ptr() for t in _flat((want_p, want_s.mu, want_s.nu))] \
        == before
    got_p, got_s, _ = adamw.apply(p1, g, s1, cfg)
    for a, b in zip(_flat((got_p, got_s.mu, got_s.nu)),
                    _flat((want_p, want_s.mu, want_s.nu)), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("moments", list(DTYPES))
def test_chunked_update_gives_the_whole_leaf_bits(monkeypatch, moments):
    """The update writes into the given tensors, and a leaf updated in
    chunks of rows (CHUNK_ELEMS cut to 16 elements, so every matrix takes
    several) gets the bits of the whole-leaf update."""
    rng = np.random.default_rng(5)
    p0, g = _port_tree(_ref_tree(rng)), _port_tree(_ref_tree(rng))
    cfg = adamw.AdamWConfig(state_dtype=DTYPES[moments][1], lr=1e-2)
    st0 = adamw.apply(p0, g, adamw.init(p0, cfg), cfg)[1]
    p1 = tree_clone(p0)
    s1 = adamw.AdamWState(st0.step, tree_clone(st0.mu), tree_clone(st0.nu))
    want_p, want_s, _ = adamw.apply(p0, g, st0, cfg)
    assert want_p["embed"] is p0["embed"]
    monkeypatch.setattr(adamw, "CHUNK_ELEMS", 16)
    assert len(adamw._row_chunks(p1["embed"])) > 1
    got_p, got_s, _ = adamw.apply(p1, g, s1, cfg)
    for a, b in zip(_flat((got_p, got_s.mu, got_s.nu)),
                    _flat((want_p, want_s.mu, want_s.nu)), strict=True):
        assert torch.equal(a, b)


def _flat(tree) -> list:
    """Every tensor of a tree in the reference's order (a QMoment's q and
    scale as two)."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_clone(tree):
    return tree_map_path(lambda _p, t: t.clone(), tree)
