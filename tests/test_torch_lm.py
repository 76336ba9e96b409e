"""The port's LM serving path against the JAX package.

recurrentgemma-2b-smoke (RG-LRU + local attention, window 16) and
smollm-360m-smoke (causal GQA) with the reference's own parameters
(`repro.launch.steps.init_params`) carried over by
`repro_torch.convert.lm_params_from_reference`.

In f32 (parameters and `cfg.dtype` cast on both sides), tolerances
measured on these inputs and stated with margin:
  * prefill logits: atol 3e-4, rtol 1e-4 (measured max abs 1.05e-4,
    recurrentgemma; 1.2e-5, smollm).  The reference's stacked block
    specs draw with std 1 at this size (its fan_in is read off the
    stacking axis), so activations reach ~4e3 and f32 rounding
    differences of the two frameworks (exp, gelu, reduction order) grow
    with them;
  * the f32 RG-LRU state: rtol 1e-4, atol 1e-3 (measured 2.6e-4 abs at
    |h| up to 15);
  * bf16 cache leaves: one bf16 ulp (rtol 2^-7): they are f32 values
    rounded to bf16, and two f32 values a few ulps apart can round to
    neighbouring bf16 values;
  * greedy decode: the same tokens for 8 steps, prompt 40 > window 16 so
    the ring cache is exercised.
In bf16 the logits agree within 0.1 abs (measured 0.035 and 0.017).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke as ref_smoke  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.configs import get_config, get_smoke, list_archs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402

ARCHS = ["recurrentgemma-2b", "smollm-360m"]
B, PROMPT, STEPS = 2, 40, 8


def _setup(name, *, f32=True, seed=0):
    jcfg, cfg = ref_smoke(name), get_smoke(name)
    jp = ref_steps.init_params(jcfg, jax.random.PRNGKey(seed))
    if f32:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    params = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, cfg, jp, params


def _tokens(cfg, S=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _f32(a):
    return np.asarray(a, np.float32)


def _check_leaf(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    want = (torch.bfloat16 if ref.dtype.name == "bfloat16"
            else torch.float32)
    assert got.dtype == want and tuple(got.shape) == ref.shape
    if want == torch.bfloat16:
        np.testing.assert_allclose(got.float().numpy(), _f32(ref),
                                   rtol=2 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-3)


def _compare_caches(cache, jcache):
    jb = jcache["blocks"]
    for r, sb in enumerate(cache["blocks"]):
        for name, leaves in sb.items():
            for k, t in leaves.items():
                _check_leaf(t, np.asarray(jb[name][k])[r])
    for part in ("head", "tail"):
        assert len(cache[part]) == len(jcache[part])
        for c, jc in zip(cache[part], jcache[part]):
            for k, t in c.items():
                _check_leaf(t, jc[k])


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_logits_and_caches_match_reference_f32(name):
    jcfg, cfg, jp, params = _setup(name)
    toks = _tokens(cfg)
    jl, jc = ref_lm.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                            mode="prefill")
    logits, cache = lm.forward(params, torch.as_tensor(toks), cfg,
                               mode="prefill")
    assert logits.shape == (B, PROMPT, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=3e-4)
    _compare_caches(cache, jc)


def _ref_generate(jp, toks, jcfg, gen):
    """The reference's serve loop (prefill, widen, greedy decode) on
    given parameters."""
    Bn, P = toks.shape
    logits, cache = ref_lm.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                                   mode="prefill")
    shapes = ref_lm.cache_shapes(jcfg, Bn, P + gen)

    def widen(c, s):
        pad = [(0, ds - dc) for dc, ds in zip(c.shape, s.shape)]
        return jnp.pad(c, pad).astype(s.dtype)

    cache = {"head": [jax.tree.map(widen, c, s)
                      for c, s in zip(cache["head"], shapes["head"])],
             "blocks": jax.tree.map(widen, cache["blocks"],
                                    shapes["blocks"]),
             "tail": [jax.tree.map(widen, c, s)
                      for c, s in zip(cache["tail"], shapes["tail"])]}
    raw = ref_steps.make_decode_step(jcfg)
    decode = jax.jit(lambda p, t, c, pos: raw(
        p, {"tokens": t, "cache": c, "pos": pos}))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(gen - 1):
        tok, cache = decode(jp, tok, cache, jnp.int32(P + i))
        tok = tok[:, None]
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_decode_matches_reference_f32(name):
    jcfg, cfg, jp, params = _setup(name, seed=1)
    toks = _tokens(cfg, seed=1)
    ref = _ref_generate(jp, toks, jcfg, STEPS + 1)
    got = serve_lib.generate(params, torch.as_tensor(toks), cfg, STEPS + 1)
    assert got.shape == (B, STEPS + 1)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_logits_match_reference_bf16(name):
    jcfg, cfg, jp, params = _setup(name, f32=False)
    toks = _tokens(cfg)
    jl, _ = ref_lm.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                           mode="prefill")
    logits, _ = lm.forward(params, torch.as_tensor(toks), cfg, mode="prefill")
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(), _f32(jl), atol=0.1,
                               rtol=0)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_forward(name):
    """The port's greedy decode through its caches reproduces its full
    forward (a prefill of all S tokens) position by position (teacher
    forcing); tolerances of the reference's
    tests/test_models.py::test_decode_matches_forward."""
    cfg = get_smoke(name)
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


def test_local_attention_ring_cache_equals_full():
    """Ring decode (cache == window) equals full-sequence local attention
    (the reference's test_models.py test of the same name)."""
    cfg = dataclasses.replace(get_smoke("recurrentgemma-2b"), window=8)
    params = steps.init_params(cfg, seed=4, device="cpu")
    S = 24
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, S)))
    full, _ = lm.forward(params, toks, cfg, mode="prefill")
    cache = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                     lm.cache_shapes(cfg, 1, S))
    assert cache["blocks"][0]["2"]["k"].shape[1] == 8
    for t in range(S):
        lt, cache = lm.forward(params, toks[:, t:t + 1], cfg, mode="decode",
                               cache=cache, pos=t)
    np.testing.assert_allclose(lt[:, 0].float().numpy(),
                               full[:, -1].float().numpy(), rtol=5e-2,
                               atol=5e-2)


def test_ring_prefill_cache_slots():
    """S > window: the prefill cache keeps the last W keys at slot
    (abs_pos % W), the layout decode's pos % W writes continue."""
    cfg = dataclasses.replace(get_smoke("recurrentgemma-2b"),
                              dtype=torch.float32)
    params = steps.init_params(cfg, seed=6, device="cpu")
    p = params["blocks"][0]["2"]["attn"]
    S, W = 37, cfg.window
    h = torch.randn((1, S, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16)
    c = lm._prefill_cache(p, h, cfg, torch.arange(S))
    full = lm._prefill_cache(p, h, dataclasses.replace(cfg, window=S),
                             torch.arange(S))
    assert c["k"].shape[1] == W
    for pos in range(S - W, S):
        assert torch.equal(c["k"][:, pos % W], full["k"][:, pos])
        assert torch.equal(c["v"][:, pos % W], full["v"][:, pos])


@pytest.mark.parametrize("name", ARCHS)
def test_serve_on_cpu_returns_ids(name):
    cfg = get_smoke(name)
    stats = {}
    ids = serve_lib.serve(cfg, batch=2, prompt_len=20, gen=5, seed=0,
                          device="cpu", verbose=False, stats=stats)
    assert ids.shape == (2, 5) and ids.dtype == torch.int64
    assert bool(((ids >= 0) & (ids < cfg.padded_vocab)).all())
    assert stats["param_bytes"] > 0 and stats["decode_s"] >= 0
    again = serve_lib.serve(cfg, batch=2, prompt_len=20, gen=5, seed=0,
                            device="cpu", verbose=False)
    assert torch.equal(ids, again)


def test_prefill_step_returns_last_position():
    cfg = get_smoke("smollm-360m")
    params = steps.init_params(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(_tokens(cfg, S=12))
    last, cache = steps.make_prefill_step(cfg)(params, {"tokens": toks})
    full, _ = lm.forward(params, toks, cfg, mode="prefill")
    assert torch.equal(last, full[:, -1:])
    assert len(cache["blocks"]) == cfg.n_layers


def test_serve_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lib.serve(get_smoke("smollm-360m"), batch=1, prompt_len=4,
                        gen=2, verbose=False)


@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_reference_field_for_field(name):
    for ref, port in ((ref_config(name), get_config(name)),
                      (ref_smoke(name), get_smoke(name))):
        for f in dataclasses.fields(port):
            want = getattr(ref, f.name)
            got = getattr(port, f.name)
            if f.name == "dtype":
                assert str(got).split(".")[-1] == jnp.dtype(want).name
            else:
                assert got == want, (name, f.name)


@pytest.mark.parametrize("name", ARCHS)
def test_param_count_matches_reference(name):
    assert get_config(name).param_count() == ref_config(name).param_count()
    assert get_smoke(name).param_count() == ref_smoke(name).param_count()


def test_registry_serves_two_archs_and_names_the_rest():
    assert list_archs() == ARCHS
    with pytest.raises(NotImplementedError, match="A16"):
        get_config("kimi-k2-1t-a32b")
    with pytest.raises(NotImplementedError, match="A16"):
        get_smoke("xlstm-1.3b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_unported_blocks_raise():
    cfg = dataclasses.replace(get_smoke("smollm-360m"), n_experts=4)
    with pytest.raises(NotImplementedError, match="A16"):
        lm.param_specs(cfg)
    cfg = dataclasses.replace(get_smoke("recurrentgemma-2b"),
                              block_pattern=("mlstm",))
    with pytest.raises(NotImplementedError, match="A16"):
        lm.param_specs(cfg)


def test_params_from_reference_keep_dtypes_and_unstack():
    name = "recurrentgemma-2b"
    jp = ref_steps.init_params(ref_smoke(name), jax.random.PRNGKey(0))
    params = lm_params_from_reference(jax.tree.map(np.asarray, jp),
                                      get_smoke(name))
    specs = lm.param_specs(get_smoke(name))
    for t, s in zip(tree_leaves(params), tree_leaves(specs)):
        assert t.dtype == s.dtype and tuple(t.shape) == s.shape
    wq = np.asarray(jp["blocks"]["2"]["attn"]["wq"][0], np.float32)
    np.testing.assert_array_equal(
        params["blocks"][0]["2"]["attn"]["wq"].float().numpy(), wq)
    bad = jax.tree.map(np.asarray, jp)
    bad["embed"] = bad["embed"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_reference(bad, get_smoke(name))


def test_init_params_follow_specs():
    cfg = get_smoke("recurrentgemma-2b")
    p = steps.init_params(cfg, seed=0, device="cpu")
    q = steps.init_params(cfg, seed=0, device="cpu")
    specs = lm.param_specs(cfg)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(q)))
    checked = tree_map(lambda t, s: (t.dtype == s.dtype
                                     and tuple(t.shape) == s.shape), p, specs)
    assert all(tree_leaves(checked))
    rec = p["blocks"][0]["0"]["rec"]
    assert torch.equal(rec["a_param"], torch.ones(cfg.rglru_dim))
    assert torch.equal(rec["conv_b"], torch.zeros(cfg.rglru_dim))
    # normal x 1/sqrt(fan_in) of the matrix's own input width
    std = float(rec["gate_a_w"].float().std())
    assert abs(std - cfg.rglru_dim ** -0.5) < 0.02
    assert abs(float(p["embed"].float().std()) - 0.02) < 0.002
