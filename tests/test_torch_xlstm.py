"""The port's xLSTM blocks (mLSTM, sLSTM) and xlstm-1.3b against the JAX
package.

Units (`repro_torch.models.recurrent` against `repro.models.recurrent`)
on parameters drawn by the reference's own `materialize` (1/sqrt(d) per
matrix) and inputs drawn with numpy from a seed, in f32:
  * `mlstm_fwd` over 40 tokens in one chunk and over 64 in two chunks of
    32, `slstm_fwd` over both: the block's output within rtol 1e-5,
    atol 1e-5 (measured max abs 1.9e-6 at outputs up to 2.1, mLSTM;
    2.4e-7, sLSTM);
  * the prefill's final state against the reference's decode cache
    (`lm._xlstm_prefill_cache`, its decode step run over the prompt):
    sLSTM's (c, n, m, h) directly, mLSTM's C and n after the rescale
    exp(m_port - m_ref) (the reference starts that scan at m = 0, the
    port's chunkwise carry at -1e30; the state is the same), within
    rtol 1e-4, atol 1e-5 (measured 1.7e-6 at |C| up to 1.9);
  * `mlstm_decode` and `slstm_decode` from a seeded state: output and
    state within rtol 1e-5, atol 1e-5 (measured 3.0e-7 at outputs up to
    1.4).
The whole smoke config (2 layers: one mLSTM, one sLSTM; d 64, 2 heads)
with the reference's `init_params` carried over by
`repro_torch.convert.lm_params_from_reference`, in f32: prefill logits
within rtol 1e-4, atol 3e-4 (measured 1.3e-5 at logits up to 0.66;
the reference's stacked specs draw std 1 here, fan_in read off the
stacking axis), every cache leaf within rtol 1e-4, atol 1e-3 (measured
8.0e-5, sLSTM's h; mLSTM's C rescaled as above, 3.8e-5 at |C| up to
74), and the same 8 greedy tokens.  In bf16 the logits agree within
0.1 abs (measured 0.047).  The file takes about 20 s on the CPU in one
process.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_smoke  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import recurrent as ref_rec  # noqa: E402
from repro.models.layers import materialize as ref_materialize  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import _tensor, lm_params_from_reference  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402

NAME = "xlstm-1.3b"
B, PROMPT, STEPS = 2, 40, 8
TOL_UNIT = dict(rtol=1e-5, atol=1e-5)
TOL_STATE = dict(rtol=1e-4, atol=1e-5)
TOL_LOGITS = dict(rtol=1e-4, atol=3e-4)
TOL_LEAF = dict(rtol=1e-4, atol=1e-3)
BF16_ATOL = 0.1
SPECS = {"mlstm": ref_rec.mlstm_specs, "slstm": ref_rec.slstm_specs}


def _t(a):
    return _tensor(np.asarray(a), "cpu")


def _cfgs(**kw):
    jcfg = dataclasses.replace(ref_smoke(NAME), dtype=jnp.float32, **kw)
    cfg = dataclasses.replace(get_smoke(NAME), dtype=torch.float32, **kw)
    return jcfg, cfg


def _core(kind, jcfg, seed=3):
    """The reference's parameters of one block core in f32, as numpy
    (for JAX) and as tensors (for the port)."""
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      ref_materialize(SPECS[kind](jcfg),
                                      jax.random.PRNGKey(seed)))
    return jp, tree_map(_t, jax.tree.map(np.asarray, jp))


def _x(S, d, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def _rescaled(state, ref_m):
    """mLSTM's (C, n) carried to the reference's stabilizer."""
    s = torch.exp(state["m"] - _t(ref_m))
    return state["C"] * s[..., None, None], state["n"] * s[..., None]


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S,chunk", [(40, 512), (64, 32)],
                         ids=["one-chunk", "two-chunks"])
def test_prefill_matches_reference_and_its_decode_cache(kind, S, chunk):
    jcfg, cfg = _cfgs(attn_chunk=chunk)
    jp, p = _core(kind, jcfg)
    x = _x(S, cfg.d_model)
    ref_out = getattr(ref_rec, f"{kind}_fwd")(jp, jnp.asarray(x), jcfg)
    ref_st = ref_lm._xlstm_prefill_cache(jp, jnp.asarray(x), jcfg, kind)
    out, st = getattr(rec, f"{kind}_fwd")(p, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL_UNIT)
    assert set(st) == set(ref_st)
    if kind == "mlstm":
        C, n = _rescaled(st, ref_st["m"])
        np.testing.assert_allclose(C.numpy(), np.asarray(ref_st["C"]),
                                   **TOL_STATE)
        np.testing.assert_allclose(n.numpy(), np.asarray(ref_st["n"]),
                                   **TOL_STATE)
    else:
        for k, t in st.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(ref_st[k]),
                                       **TOL_STATE)


def test_mlstm_prefill_needs_whole_chunks():
    _, cfg = _cfgs(attn_chunk=32)
    _, p = _core("mlstm", _cfgs()[0])
    with pytest.raises(ValueError, match="chunk"):
        rec.mlstm_fwd(p, torch.as_tensor(_x(40, cfg.d_model)), cfg)


def _state(kind, cfg, seed=5):
    rng = np.random.default_rng(seed)
    shapes = (rec.mlstm_cache_shape if kind == "mlstm"
              else rec.slstm_cache_shape)(cfg, B)
    st = {k: rng.standard_normal(s.shape).astype(np.float32)
          for k, s in shapes.items()}
    st["n"] = np.abs(st["n"]) + 0.5
    return st


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_step_matches_reference(kind):
    jcfg, cfg = _cfgs()
    jp, p = _core(kind, jcfg)
    x = _x(1, cfg.d_model, seed=6)
    st = _state(kind, cfg)
    ref_out, ref_st = getattr(ref_rec, f"{kind}_decode")(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()}, jcfg)
    out, new = getattr(rec, f"{kind}_decode")(
        p, torch.as_tensor(x), {k: torch.as_tensor(v) for k, v in st.items()},
        cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL_UNIT)
    assert set(new) == set(ref_st)
    for k, t in new.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(ref_st[k]),
                                   **TOL_UNIT)


def _setup(*, f32=True, seed=0):
    jcfg, cfg = ref_smoke(NAME), get_smoke(NAME)
    jp = ref_steps.init_params(jcfg, jax.random.PRNGKey(seed))
    if f32:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    params = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, cfg, jp, params


def _tokens(cfg, S=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def test_prefill_logits_and_caches_match_reference_f32():
    jcfg, cfg, jp, params = _setup()
    toks = _tokens(cfg)
    jl, jc = ref_lm.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                            mode="prefill")
    logits, cache = lm.forward(params, torch.as_tensor(toks), cfg,
                               mode="prefill")
    assert logits.shape == (B, PROMPT, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL_LOGITS)
    assert cache["head"] == [] and cache["tail"] == []
    assert len(cache["blocks"]) == cfg.n_layers // 2
    for r, sb in enumerate(cache["blocks"]):
        for name, leaves in sb.items():
            ref = {k: np.asarray(v)[r] for k, v in jc["blocks"][name].items()}
            assert set(leaves) == set(ref)
            got = {k: t for k, t in leaves.items()}
            if "C" in got:
                got["C"], got["n"] = _rescaled(leaves, ref["m"])
                del got["m"]
            for k, t in got.items():
                assert t.dtype == torch.float32
                np.testing.assert_allclose(t.numpy(), ref[k], **TOL_LEAF)


def _ref_generate(jp, toks, jcfg, gen):
    """The reference's serve loop (prefill, greedy decode) on given
    parameters; xLSTM's caches have no sequence axis to widen."""
    logits, cache = ref_lm.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                                   mode="prefill")
    raw = ref_steps.make_decode_step(jcfg)
    decode = jax.jit(lambda p, t, c, pos: raw(
        p, {"tokens": t, "cache": c, "pos": pos}))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(gen - 1):
        tok, cache = decode(jp, tok, cache, jnp.int32(toks.shape[1] + i))
        tok = tok[:, None]
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


def test_greedy_decode_matches_reference_f32():
    jcfg, cfg, jp, params = _setup(seed=1)
    toks = _tokens(cfg, seed=1)
    ref = _ref_generate(jp, toks, jcfg, STEPS + 1)
    got = serve_lib.generate(params, torch.as_tensor(toks), cfg, STEPS + 1)
    assert got.shape == (B, STEPS + 1)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_prefill_logits_match_reference_bf16():
    jcfg, cfg, jp, params = _setup(f32=False)
    toks = _tokens(cfg)
    jl, _ = ref_lm.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                           mode="prefill")
    logits, _ = lm.forward(params, torch.as_tensor(toks), cfg, mode="prefill")
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(),
                               np.asarray(jl, np.float32), rtol=0,
                               atol=BF16_ATOL)


def test_decode_matches_forward():
    """Decode through the prefill's final states reproduces the port's
    full forward position by position (teacher forcing); tolerances of
    the reference's tests/test_models.py::test_decode_matches_forward."""
    cfg = get_smoke(NAME)
    params = steps.init_params(cfg, seed=2, device="cpu")
    S = 16
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S)))
    full, _ = lm.forward(params, toks, cfg, mode="prefill")
    S0 = S // 2
    pre, cache = lm.forward(params, toks[:, :S0], cfg, mode="prefill")
    cache = serve_lib.widen_cache(cache, cfg, B, S)
    np.testing.assert_allclose(pre[:, S0 - 1].float().numpy(),
                               full[:, S0 - 1].float().numpy(),
                               rtol=2e-2, atol=2e-2)
    for t in range(S0, S):
        lt, cache = lm.forward(params, toks[:, t:t + 1], cfg, mode="decode",
                               cache=cache, pos=t)
        np.testing.assert_allclose(lt[:, 0].float().numpy(),
                                   full[:, t].float().numpy(),
                                   rtol=5e-2, atol=5e-2)


def test_serve_on_cpu_returns_ids():
    cfg = get_smoke(NAME)
    stats = {}
    ids = serve_lib.serve(cfg, batch=2, prompt_len=20, gen=5, seed=0,
                          device="cpu", verbose=False, stats=stats)
    assert ids.shape == (2, 5) and ids.dtype == torch.int64
    assert bool(((ids >= 0) & (ids < cfg.padded_vocab)).all())
    assert stats["param_bytes"] > 0 and "encode_s" not in stats
    again = serve_lib.serve(cfg, batch=2, prompt_len=20, gen=5, seed=0,
                            device="cpu", verbose=False)
    assert torch.equal(ids, again)


def test_blocks_have_no_mlp_and_no_attention_kernel(monkeypatch):
    """d_ff 0: an xLSTM block is its norm and its core; serving it runs
    no attention (B5's entry is never called)."""
    from repro_torch.kernels import ops
    cfg = get_smoke(NAME)
    specs = lm.param_specs(cfg)
    assert [sorted(b) for b in specs["blocks"][0].values()] == [
        ["core", "ln1"], ["core", "ln1"]]
    calls = []
    orig = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    serve_lib.serve(cfg, batch=1, prompt_len=8, gen=2, device="cpu",
                    verbose=False)
    assert calls == []
