"""The port's encoder-decoder (whisper-base) and vision frontend
(phi-3-vision-4.2b) against the JAX package.

Units in f32, on parameters drawn by the reference's own `materialize`
and inputs drawn with numpy from a seed: `layernorm` (within rtol 1e-6,
atol 1e-6; measured 9.5e-7 at outputs up to 7.3), cross-attention
`gqa_fwd(kv_x=)` over 24 encoder frames from 40 queries (rtol 1e-5,
atol 1e-5; measured 3.3e-7 at outputs up to 1.4) and `encoder_fwd` on
the whisper smoke config's parameters (the same; measured 9.5e-7 at
outputs up to 3.5).

The two smoke configs with the reference's `init_params` carried over by
`repro_torch.convert.lm_params_from_reference` (whisper: 2 encoder + 2
decoder layers, d 64, 24 frames drawn with numpy, learned positions,
LayerNorm, a plain GELU MLP; phi-3-vision: 2 layers, d 64, 16 patches).
In f32:
  * prefill logits within rtol 1e-4, atol 3e-4 (measured 1.6e-5,
    whisper, at logits up to 0.70, and 1.1e-4 on other frames: the
    reference's stacked decoder specs draw std 0.71, fan_in read off
    the stacking axis, so its residual stream reaches ~350; 3.8e-6,
    phi-3-vision);
  * every cache leaf (self-attention K/V, whisper's cross K/V from the
    encoder's output) within one bf16 ulp (rtol 2^-7: f32 values a few
    ulps apart may round to neighbouring bf16 values) and atol
    LEAF_ATOL = 2e-5 of the leaf's largest magnitude: the f32 values
    themselves differ by the two frameworks' f32 roundings, relative to
    the leaf's scale (up to ~22), so an entry near 0 can differ by more
    than its own ulp (measured 3.3e-6 of the largest magnitude beyond
    one ulp, whisper's self-attention v through the prefill step);
  * the same 8 greedy tokens, whisper decoding over its cached frames;
  * the prefill step with `frames` (whisper) and `patches` (phi-3-vision
    ahead of 40 tokens) within the logits' tolerance, caches as above.
In bf16 the logits agree within 0.1 abs for phi-3-vision (measured
0.017) and 0.3 for whisper (measured 0.176; 450 of its 40,960 logits
are above 0.05, all at 7 of its 80 positions, where a causal softmax
over scores of several hundred is close to a tie and the bf16
roundings of the two frameworks, GELU's among them, pick other keys;
one decoder block's output agrees within half a bf16 ulp of its
residual, 0.5 at 241).  The file takes about 40 s on the CPU in one
process.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_smoke  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import _tensor, lm_params_from_reference  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402

WHISPER, PHI3 = "whisper-base", "phi-3-vision-4.2b"
ARCHS = [WHISPER, PHI3]
B, PROMPT, STEPS = 2, 40, 8
TOL_UNIT = dict(rtol=1e-5, atol=1e-5)
TOL_LOGITS = dict(rtol=1e-4, atol=3e-4)
LEAF_ATOL = 2e-5
BF16_ATOL = {WHISPER: 0.3, PHI3: 0.1}


def _t(a):
    return _tensor(np.asarray(a), "cpu")


def _f32(a):
    return np.asarray(a, np.float32)


def _smoke_f32(name):
    return (dataclasses.replace(ref_smoke(name), dtype=jnp.float32),
            dataclasses.replace(get_smoke(name), dtype=torch.float32))


def test_layernorm_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 4 + 1).astype(np.float32)
    g, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    want = ref_layers.layernorm(jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(b))
    got = layers.layernorm(*(torch.as_tensor(a) for a in (x, g, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    assert layers.layernorm(xb, torch.as_tensor(g),
                            torch.as_tensor(b)).dtype == torch.bfloat16


def test_cross_attention_matches_reference():
    """q from 40 decoder positions, k and v from 24 encoder frames (Sq !=
    Sk, full, no RoPE on either side)."""
    jcfg, cfg = _smoke_f32(WHISPER)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), ref_layers.materialize(
        ref_attn.gqa_specs(jcfg, cross=True), jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, PROMPT, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    want = ref_attn.gqa_fwd(jp, jnp.asarray(x), jcfg,
                            positions=jnp.arange(PROMPT), kind="full",
                            kv_x=jnp.asarray(enc), use_rope=False)
    got = attn.gqa_fwd(tree_map(_t, jax.tree.map(np.asarray, jp)),
                       torch.as_tensor(x), cfg,
                       positions=torch.arange(PROMPT), kind="full",
                       kv_x=torch.as_tensor(enc), use_rope=False)
    assert got.shape == (B, PROMPT, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_UNIT)


def _setup(name, *, f32=True, seed=0):
    jcfg, cfg = ref_smoke(name), get_smoke(name)
    jp = ref_steps.init_params(jcfg, jax.random.PRNGKey(seed))
    if f32:
        jcfg, cfg = _smoke_f32(name)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    params = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, cfg, jp, params


def _frames(cfg, seed=0):
    return np.random.default_rng(seed + 100).standard_normal(
        (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _tokens(cfg, S=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _encoded(jp, params, jcfg, cfg, seed=0):
    """(the reference's, the port's) encoder output on the same frames,
    or (None, None) for a config without an audio frontend."""
    if cfg.frontend != "audio":
        return None, None
    fr = _frames(cfg, seed)
    return (ref_lm.encoder_fwd(jp, jnp.asarray(fr), jcfg),
            lm.encoder_fwd(params, torch.as_tensor(fr), cfg))


def test_encoder_matches_reference():
    jcfg, cfg, jp, params = _setup(WHISPER)
    je, e = _encoded(jp, params, jcfg, cfg)
    assert e.shape == (B, cfg.enc_seq, cfg.d_model) and len(
        params["enc_blocks"]) == cfg.n_enc_layers
    np.testing.assert_allclose(e.numpy(), np.asarray(je), **TOL_UNIT)


def _check_leaf(got, ref):
    ref = np.asarray(ref)
    assert got.dtype == torch.bfloat16 and ref.dtype.name == "bfloat16"
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.float().numpy(), _f32(ref),
                               rtol=2 ** -7,
                               atol=LEAF_ATOL * np.abs(_f32(ref)).max())


def _compare_caches(cache, jcache):
    assert cache["head"] == [] and cache["tail"] == []
    for r, sb in enumerate(cache["blocks"]):
        for name, leaves in sb.items():
            ref = jax.tree.map(lambda a: np.asarray(a)[r],
                               jcache["blocks"][name])
            assert set(leaves) == set(ref)
            for k, t in leaves.items():
                if isinstance(t, dict):          # xattn's "self"
                    for kk, tt in t.items():
                        _check_leaf(tt, ref[k][kk])
                else:
                    _check_leaf(t, ref[k])


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_logits_and_caches_match_reference_f32(name):
    jcfg, cfg, jp, params = _setup(name)
    je, e = _encoded(jp, params, jcfg, cfg)
    toks = _tokens(cfg)
    jl, jc = ref_lm.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                            mode="prefill", enc_out=je)
    logits, cache = lm.forward(params, torch.as_tensor(toks), cfg,
                               mode="prefill", enc_out=e)
    assert logits.shape == (B, PROMPT, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL_LOGITS)
    _compare_caches(cache, jc)


def _ref_generate(jp, toks, jcfg, gen, enc_out):
    """The reference's serve loop (prefill, widen, greedy decode) on given
    parameters and encoder output."""
    P = toks.shape[1]
    logits, cache = ref_lm.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                                   mode="prefill", enc_out=enc_out)
    shapes = ref_lm.cache_shapes(jcfg, toks.shape[0], P + gen)

    def widen(c, s):
        pad = [(0, ds - dc) for dc, ds in zip(c.shape, s.shape)]
        return jnp.pad(c, pad).astype(s.dtype)

    cache = {"head": [], "tail": [],
             "blocks": jax.tree.map(widen, cache["blocks"], shapes["blocks"])}
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
    je, e = _encoded(jp, params, jcfg, cfg, seed=1)
    toks = _tokens(cfg, seed=1)
    ref = _ref_generate(jp, toks, jcfg, STEPS + 1, je)
    got = serve_lib.generate(params, torch.as_tensor(toks), cfg, STEPS + 1,
                             enc_out=e)
    assert got.shape == (B, STEPS + 1)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_logits_match_reference_bf16(name):
    jcfg, cfg, jp, params = _setup(name, f32=False)
    je, e = _encoded(jp, params, jcfg, cfg)
    toks = _tokens(cfg)
    jl, _ = ref_lm.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                           mode="prefill", enc_out=je)
    logits, _ = lm.forward(params, torch.as_tensor(toks), cfg,
                           mode="prefill", enc_out=e)
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(), _f32(jl), rtol=0,
                               atol=BF16_ATOL[name])


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_step_with_frontend_inputs_matches_reference(name):
    """`make_prefill_step` with whisper's `frames` (through the encoder)
    and phi-3-vision's `patches` (ahead of the tokens, positions over
    both) against the reference's step."""
    jcfg, cfg, jp, params = _setup(name, seed=2)
    rng = np.random.default_rng(7)
    toks = _tokens(cfg, seed=2)
    if cfg.frontend == "audio":
        key, extra = "frames", (B, cfg.enc_seq, cfg.d_model)
    else:
        key, extra = "patches", (B, cfg.n_patches, cfg.d_model)
    side = rng.standard_normal(extra).astype(np.float32)
    jl, jc = ref_steps.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32), key: jnp.asarray(side)})
    last, cache = steps.make_prefill_step(cfg)(
        params, {"tokens": torch.as_tensor(toks), key: torch.as_tensor(side)})
    assert last.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(last.numpy(), np.asarray(jl), **TOL_LOGITS)
    _compare_caches(cache, jc)
    k = cache["blocks"][0]["0"]
    seq = (k["self"] if cfg.is_encoder_decoder else k)["k"].shape[1]
    assert seq == PROMPT + (cfg.n_patches if key == "patches" else 0)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_forward(name):
    """The port's greedy decode through its caches reproduces its full
    forward position by position (teacher forcing); tolerances of the
    reference's tests/test_models.py::test_decode_matches_forward.
    whisper's decoder attends to the same encoded frames both ways."""
    cfg = get_smoke(name)
    params = steps.init_params(cfg, seed=2, device="cpu")
    enc = None
    if cfg.frontend == "audio":
        enc = lm.encoder_fwd(params, torch.as_tensor(_frames(cfg, 3)), cfg)
    S = 16
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S)))
    full, _ = lm.forward(params, toks, cfg, mode="prefill", enc_out=enc)
    S0 = S // 2
    pre, cache = lm.forward(params, toks[:, :S0], cfg, mode="prefill",
                            enc_out=enc)
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


@pytest.mark.parametrize("name", ARCHS)
def test_serve_on_cpu_returns_ids(name):
    cfg = get_smoke(name)
    stats = {}
    ids = serve_lib.serve(cfg, batch=2, prompt_len=20, gen=5, seed=0,
                          device="cpu", verbose=False, stats=stats)
    assert ids.shape == (2, 5) and ids.dtype == torch.int64
    assert bool(((ids >= 0) & (ids < cfg.padded_vocab)).all())
    assert stats["param_bytes"] > 0 and stats["decode_s"] >= 0
    assert ("encode_s" in stats) == (cfg.frontend == "audio")
    again = serve_lib.serve(cfg, batch=2, prompt_len=20, gen=5, seed=0,
                            device="cpu", verbose=False)
    assert torch.equal(ids, again)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_draws_the_references_inputs(name, monkeypatch):
    """`serve` draws whisper's frames first and the prompt after them from
    `np.random.default_rng(seed)`, as the reference's `serve` does: the
    frames the encoder gets and the tokens the prefill gets are the
    reference's, value for value; phi-3-vision gets tokens only."""
    seen = {"ref": {}, "port": {}}

    def spy(side, mod, fn_name, arg):
        orig = getattr(mod, fn_name)

        def f(params, x, cfg, **kw):
            if kw.get("mode", "prefill") == "prefill":
                seen[side].setdefault(arg, np.asarray(
                    x.cpu() if hasattr(x, "cpu") else x))
            return orig(params, x, cfg, **kw)
        monkeypatch.setattr(mod, fn_name, f)

    spy("ref", ref_lm, "encoder_fwd", "frames")
    spy("ref", ref_lm, "forward", "tokens")
    spy("port", lm, "encoder_fwd", "frames")
    spy("port", lm, "forward", "tokens")
    kw = dict(batch=2, prompt_len=12, gen=2, seed=5, verbose=False)
    ref_serve.serve(ref_smoke(name), **kw)
    serve_lib.serve(get_smoke(name), device="cpu", **kw)
    assert set(seen["ref"]) == set(seen["port"])
    assert ("frames" in seen["port"]) == (name == WHISPER)
    for k, want in seen["ref"].items():
        np.testing.assert_array_equal(seen["port"][k], want)
