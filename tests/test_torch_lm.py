"""The port's LM serving path against the JAX package.

The spec-level tests (fields, parameter counts, the initializer's bits,
the registry) cover all ten configs; the whole-model ones here, the
seven decoder-only smoke configs (xlstm-1.3b's are in
tests/test_torch_xlstm.py, whisper-base's and phi-3-vision-4.2b's in
tests/test_torch_encdec.py):
recurrentgemma-2b (RG-LRU + local attention, window 16), smollm-360m,
internlm2-20b and granite-20b (causal GQA, granite MQA), minicpm3-4b
(MLA with q-LoRA), deepseek-v2-lite-16b (MLA + MoE, a dense first
layer) and kimi-k2-1t-a32b (GQA + MoE), with the reference's own
parameters (`repro.launch.steps.init_params`) carried over by
`repro_torch.convert.lm_params_from_reference`.

In f32 (parameters and `cfg.dtype` cast on both sides), tolerances
measured on these inputs and stated with margin:
  * prefill logits: atol 3e-4, rtol 1e-4 (measured max abs 1.05e-4,
    recurrentgemma; 1.2e-5, smollm; 6.6e-6 to 3.0e-5 for the five
    others, kimi the largest).  The reference's stacked block
    specs draw with std 1 at this size (its fan_in is read off the
    stacking axis), so activations reach ~4e3 and f32 rounding
    differences of the two frameworks (exp, gelu, reduction order) grow
    with them;
  * the f32 RG-LRU state: rtol 1e-4, atol 1e-3 (measured 2.6e-4 abs at
    |h| up to 15);
  * bf16 cache leaves: one bf16 ulp (rtol 2^-7): they are f32 values
    rounded to bf16, and two f32 values a few ulps apart can round to
    neighbouring bf16 values.  In the two MoE configs the f32 values
    themselves differ by more behind a MoE layer (its grouped products
    and the sum of a token's k outputs are ordered differently; 4.2e-5
    abs at outputs up to 78, tests/test_torch_moe.py), so there a leaf
    also gets atol 2e-5 of its largest magnitude (measured 5.9e-6);
  * greedy decode: the same tokens for 8 steps, prompt 40 > window 16 so
    the ring cache is exercised.
In bf16 the logits agree within 0.1 abs (measured 0.035 and 0.017 for
recurrentgemma and smollm, 0.020 to 0.035 for internlm2, granite and
minicpm3).  The MoE configs' routers see the bf16 residual streams of
the two frameworks, which differ by bf16 roundings of activations that
the reference's std-1 blocks make large: gate weights move by up to
0.5 and tokens whose k-th and (k+1)-th experts are near a tie pick
another expert (printed with their margins, 0.0006 to 0.053 in
probability), which moves a few logits by up to 0.34.  What holds in
bf16 there: given the reference's own routing (its gate weights and
experts, layer by layer), the port's logits agree within 0.15 abs
(measured 0.108 and 0.127, at 5 and 8 of 40,960 logits above 0.1): the
expert products add bf16 roundings of their own (tests/test_torch_moe.py
measures one MoE layer at 2^-7.2 of its largest output) to three layers
where the dense configs have two.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke as ref_smoke  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config, get_smoke, list_archs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "granite-20b", "internlm2-20b",
         "kimi-k2-1t-a32b", "minicpm3-4b", "recurrentgemma-2b",
         "smollm-360m"]
#: the configs whose whole-model comparisons are in
#: tests/test_torch_xlstm.py and tests/test_torch_encdec.py; the
#: spec-level tests here cover all ten
ALL_ARCHS = sorted(ARCHS + ["phi-3-vision-4.2b", "whisper-base",
                            "xlstm-1.3b"])
MOE_ARCHS = ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b")
#: bf16 prefill logits, abs: the dense configs, and the MoE configs given
#: the reference's routing
BF16_ATOL = 0.1
BF16_MOE_ATOL = 0.15
#: MoE configs' f32 cache leaves: atol of a leaf's largest magnitude
MOE_LEAF_ATOL = 2e-5
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


def _check_leaf(got: torch.Tensor, ref, moe: bool = False):
    ref = np.asarray(ref)
    want = (torch.bfloat16 if ref.dtype.name == "bfloat16"
            else torch.float32)
    assert got.dtype == want and tuple(got.shape) == ref.shape
    if want == torch.bfloat16:
        atol = MOE_LEAF_ATOL * np.abs(_f32(ref)).max() if moe else 1e-6
        np.testing.assert_allclose(got.float().numpy(), _f32(ref),
                                   rtol=2 ** -7, atol=atol)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-3)


def _compare_caches(cache, jcache, moe: bool = False):
    jb = jcache["blocks"]
    for r, sb in enumerate(cache["blocks"]):
        for name, leaves in sb.items():
            for k, t in leaves.items():
                _check_leaf(t, np.asarray(jb[name][k])[r], moe)
    for part in ("head", "tail"):
        assert len(cache[part]) == len(jcache[part])
        for c, jc in zip(cache[part], jcache[part]):
            for k, t in c.items():
                _check_leaf(t, jc[k], moe)


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
    _compare_caches(cache, jc, moe=name in MOE_ARCHS)


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


def _record_ref_routing(routes: list):
    """A stand-in for the reference's `moe_apply` that first records its
    routing on this input: the top-k of its router's f32 softmax, the
    weights renormalised, and the probabilities (the reference's own
    three lines, in JAX), then runs it."""
    orig = ref_moe.moe_apply

    def spy(p, x, cfg, **kw):
        xt = x.reshape(-1, cfg.d_model).astype(jnp.float32)
        probs = jax.nn.softmax(xt @ p["router"], axis=-1)
        w, ids = jax.lax.top_k(probs, cfg.top_k)
        w = w / jnp.maximum(w.sum(-1, keepdims=True), 1e-9)
        routes.append((np.asarray(w), np.asarray(ids), np.asarray(probs)))
        return orig(p, x, cfg, **kw)

    return spy


def _print_router_ties(ref_routes, own_ids, k):
    """Every token whose expert set differs between the two packages,
    with the margin between its k-th and (k+1)-th probability in the
    reference's router."""
    for layer, ((_, ids, probs), got) in enumerate(zip(ref_routes, own_ids)):
        top = -np.sort(-probs, axis=-1)
        for t in np.flatnonzero([set(a) != set(b) for a, b in
                                 zip(ids.tolist(), got.tolist())]):
            print(f"MoE layer {layer} token {t}: reference experts "
                  f"{ids[t].tolist()}, port {got[t].tolist()}, top-{k} "
                  f"margin {top[t, k - 1] - top[t, k]:.3g}")


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_logits_match_reference_bf16(name, monkeypatch):
    jcfg, cfg, jp, params = _setup(name, f32=False)
    toks = _tokens(cfg)
    routes = []
    if name in MOE_ARCHS:       # layers unrolled: the MoE blocks run eagerly
        jcfg = dataclasses.replace(jcfg, unroll_layers=True)
        monkeypatch.setattr(ref_moe, "moe_apply", _record_ref_routing(routes))
    jl, _ = ref_lm.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                           mode="prefill")
    logits, _ = lm.forward(params, torch.as_tensor(toks), cfg, mode="prefill")
    if name in MOE_ARCHS:
        own, route = [], moe.route

        def spy(xt, router, k):
            out = route(xt, router, k)
            own.append(out[1].numpy())
            return out

        monkeypatch.setattr(moe, "route", spy)
        lm.forward(params, torch.as_tensor(toks), cfg, mode="prefill")
        _print_router_ties(routes, own, cfg.top_k)
        given = iter(routes)
        monkeypatch.setattr(moe, "route", lambda xt, router, k: tuple(
            torch.tensor(a) for a in next(given)[:2]))
        logits, _ = lm.forward(params, torch.as_tensor(toks), cfg,
                               mode="prefill")
        assert next(given, None) is None and len(routes) == len(own) > 0
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(
        logits.float().numpy(), _f32(jl), rtol=0,
        atol=BF16_MOE_ATOL if name in MOE_ARCHS else BF16_ATOL)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_forward(name):
    """The port's greedy decode through its caches reproduces its full
    forward (a prefill of all S tokens) position by position (teacher
    forcing); tolerances of the reference's
    tests/test_models.py::test_decode_matches_forward.  MoE configs run
    dropless, as the reference's test does: a full-sequence pass drops
    tokens beyond an expert's capacity, a one-token decode never does."""
    cfg = get_smoke(name)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_capacity=float(cfg.n_experts))
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


@pytest.mark.parametrize("name", ALL_ARCHS)
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


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_param_count_matches_reference(name):
    assert get_config(name).param_count() == ref_config(name).param_count()
    assert get_smoke(name).param_count() == ref_smoke(name).param_count()


def test_registry_serves_two_archs_and_names_the_rest():
    """The registry serves all ten of the reference's configs, each the
    reference's own; an unknown name raises KeyError."""
    assert list_archs() == ALL_ARCHS == sorted(ref_list_archs())
    for name in ALL_ARCHS:
        assert get_config(name).name == name
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_unported_blocks_raise():
    """An unknown block kind raises ValueError, as in the reference;
    every kind of the ten configs builds its specs and cache shapes."""
    cfg = dataclasses.replace(get_smoke("smollm-360m"),
                              block_pattern=("attn", "mamba"))
    with pytest.raises(ValueError, match="unknown block kind 'mamba'"):
        lm.param_specs(cfg)
    with pytest.raises(ValueError, match="unknown block kind 'mamba'"):
        lm.cache_shapes(cfg, 1, 8)
    with pytest.raises(ValueError, match="unknown block kind 'mamba'"):
        ref_lm.param_specs(dataclasses.replace(
            ref_smoke("smollm-360m"), block_pattern=("attn", "mamba")))
    for name in ALL_ARCHS:
        lm.cache_shapes(get_smoke(name), 1, 8)


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


def _old_materialize(specs, gen):
    """The initializer as it was before the in-place scale: normal in
    f32, times std, then cast."""
    def draw(sp):
        if sp.init == "zeros":
            return torch.zeros(sp.shape, dtype=sp.dtype)
        if sp.init == "ones":
            return torch.ones(sp.shape, dtype=sp.dtype)
        fan_in = sp.shape[0] if len(sp.shape) > 1 else sp.shape[-1]
        std = sp.scale if sp.scale is not None else 1.0 / np.sqrt(fan_in)
        w = torch.randn(sp.shape, generator=gen, dtype=torch.float32)
        return (w * std).to(sp.dtype)
    return tree_map(draw, specs)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_initializer_draws_randn_times_std_bitwise(name):
    """`ParamSpec.initializer` scales its f32 draw in place; every leaf
    is still `(randn * std).to(dtype)` bit for bit."""
    cfg = get_smoke(name)
    got = steps.init_params(cfg, seed=7, device="cpu")
    want = _old_materialize(lm.param_specs(cfg),
                            torch.Generator().manual_seed(7))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _digest(params) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in tree_leaves(params):
        t = t.contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16
                  else t).numpy().tobytes())
    return h.hexdigest()


#: sha256 of the CPU draws (seed 0) that the two configs served before
#: MoE and MLA were ported are drawn with, leaves in the port's order
SERVED_DIGESTS = {
    ("recurrentgemma-2b", "smoke"):
        "257ec187098bcdd9260964c6266cc75a0904b426c421c10d995f77be4a51b339",
    ("smollm-360m", "smoke"):
        "1ff38d522d0f58eb84eecb20983c667a5a5519e894516c4a3fbf7b7b603b5c66",
    ("smollm-360m", "full"):
        "b070ae9068107af3fee192b707a2ad54124d47b067ac5e9478a306568b129851",
}


@pytest.mark.parametrize("name,size", list(SERVED_DIGESTS),
                         ids=["-".join(k) for k in SERVED_DIGESTS])
def test_served_weights_unchanged(name, size):
    """recurrentgemma-2b's and smollm-360m's weights are bitwise the ones
    served before this slice (smollm-360m at full size too: 362 M
    parameters, ~6 s on the CPU)."""
    cfg = get_smoke(name) if size == "smoke" else get_config(name)
    params = steps.init_params(cfg, seed=0, device="cpu")
    assert _digest(params) == SERVED_DIGESTS[(name, size)]
