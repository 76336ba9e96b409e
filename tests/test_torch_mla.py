"""The port's multi-head latent attention against the JAX package's.

`repro_torch.models.attention` `mla_fwd`, `mla_decode` and the MLA
prefill cache against `repro.models.attention` / `repro.models.lm` on
the CPU in f32, with q-LoRA (minicpm3-4b's smoke shape: 4 heads, nope 16
+ rope 8, v 16, kv_lora 32, q_lora 48) and without (deepseek-v2-lite's),
on the reference's own parameters and inputs drawn from a numpy seed.

Tolerances, measured on these inputs and stated with margin:
  * `mla_fwd`: rtol 1e-5, atol 1e-5 (measured max abs 6.0e-7 at outputs
    up to 4.0): the same products and softmax, the reference's blocked
    scan against the port's (B5's plain path on the CPU);
  * `mla_decode` and the prefill cache: the latent c_kv and k_rope are
    stored in bf16, so a cache leaf is within one bf16 ulp (rtol 2^-7:
    f32 values a few ulps apart may round to neighbouring bf16
    values), and the decode output within rtol 1e-4, atol 1e-5
    (measured 3.0e-7 at outputs up to 1.3);
  * decode against the port's own forward at the last position: the
    forward attends over f32 keys, the decode over the bf16 latent, so
    rtol 2e-2, atol 2e-2 (the reference's own decode-vs-forward
    tolerance; measured max abs 1.9e-3).
The module-scoped fixture runs the reference once a config (the file
takes ~20 s on the CPU).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_smoke  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models.layers import materialize as ref_materialize  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import _tensor  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402

MLA_ARCHS = ["minicpm3-4b", "deepseek-v2-lite-16b"]
B, S = 2, 24
TOL_FWD = dict(rtol=1e-5, atol=1e-5)
TOL_DECODE = dict(rtol=1e-4, atol=1e-5)
TOL_BF16_LEAF = dict(rtol=2 ** -7, atol=1e-6)
TOL_SELF = dict(rtol=2e-2, atol=2e-2)


def _t(a):
    return _tensor(np.asarray(a), "cpu")


def _ref_case(name):
    """The reference's MLA on f32 parameters: the forward over S tokens,
    the prefill cache of the first S - 1, widened to S, and one decode
    step at position S - 1 from it."""
    jcfg = dataclasses.replace(ref_smoke(name), dtype=jnp.float32)
    cfg = dataclasses.replace(get_smoke(name), dtype=torch.float32)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), ref_materialize(
        ref_attn.mla_specs(jcfg), jax.random.PRNGKey(3)))
    x = np.random.default_rng(4).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    jx, pos = jnp.asarray(x), jnp.arange(S)
    fwd = ref_attn.mla_fwd(jp, jx, jcfg, positions=pos)
    pre = ref_lm._prefill_cache(jp, jx[:, :S - 1], jcfg, pos[:S - 1])
    wide = jax.tree.map(lambda c: jnp.pad(c, ((0, 0), (0, 1), (0, 0))), pre)
    dec, dcache = ref_attn.mla_decode(jp, jx[:, S - 1:], wide, jcfg,
                                      pos=jnp.int32(S - 1))
    return {"name": name, "cfg": cfg,
            "p": tree_map(_t, jax.tree.map(np.asarray, jp)),
            "x": torch.as_tensor(x), "fwd": np.asarray(fwd),
            "pre": jax.tree.map(np.asarray, pre),
            "wide": jax.tree.map(np.asarray, wide),
            "dec": np.asarray(dec),
            "dcache": jax.tree.map(np.asarray, dcache)}


@pytest.fixture(scope="module", params=MLA_ARCHS)
def case(request):
    return _ref_case(request.param)


def _leaf(got, ref):
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **TOL_BF16_LEAF)


def test_specs_and_cache_shape_follow_the_reference(case):
    cfg = case["cfg"]
    specs = attn.mla_specs(cfg)
    ref = ref_attn.mla_specs(ref_smoke(case["name"]))
    assert set(specs) == set(ref)
    for k, s in specs.items():
        assert s.shape == ref[k].shape and s.init == ref[k].init
    assert ("wq_a" in specs) == bool(cfg.q_lora_rank)
    shp = attn.mla_cache_shape(cfg, B, S)
    assert shp["c_kv"].shape == (B, S, cfg.kv_lora_rank)
    assert shp["k_rope"].shape == (B, S, cfg.qk_rope_dim)
    assert {s.dtype for s in shp.values()} == {torch.bfloat16}


def test_mla_fwd_matches_reference(case):
    out = attn.mla_fwd(case["p"], case["x"], case["cfg"],
                       positions=torch.arange(S))
    assert out.shape == (B, S, case["cfg"].d_model)
    np.testing.assert_allclose(out.numpy(), case["fwd"], **TOL_FWD)


def test_prefill_cache_matches_reference(case):
    c = lm._prefill_cache(case["p"], case["x"][:, :S - 1], case["cfg"],
                          torch.arange(S - 1))
    assert set(c) == {"c_kv", "k_rope"}
    for k in c:
        _leaf(c[k], case["pre"][k])


def test_mla_decode_matches_reference(case):
    cache = {k: _t(v) for k, v in case["wide"].items()}
    out, new = attn.mla_decode(case["p"], case["x"][:, S - 1:], cache,
                               case["cfg"], pos=S - 1)
    assert new is cache                     # written in place
    np.testing.assert_allclose(out.numpy(), case["dec"], **TOL_DECODE)
    for k in new:
        _leaf(new[k], case["dcache"][k])


def test_decode_equals_forward_last_position(case):
    """The port alone: its prefill cache of S - 1 tokens, widened by
    `serve.widen_cache`'s rule, then one decode step, against its own
    forward's last position."""
    cfg, p, x = case["cfg"], case["p"], case["x"]
    full = attn.mla_fwd(p, x, cfg, positions=torch.arange(S))
    pre = lm._prefill_cache(p, x[:, :S - 1], cfg, torch.arange(S - 1))
    cache = tree_map(lambda c, s: torch.cat([c, torch.zeros(
        (B, 1, s.shape[-1]), dtype=c.dtype)], dim=1), pre,
        attn.mla_cache_shape(cfg, B, S))
    out, _ = attn.mla_decode(p, x[:, S - 1:], cache, cfg, pos=S - 1)
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, -1].numpy(),
                               **TOL_SELF)


def test_widen_cache_widens_the_latent_caches(case):
    """`serve.widen_cache` pads c_kv and k_rope along the sequence to the
    cache's max length, keeping the prefill's entries."""
    cfg = get_smoke(case["name"])
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, 6)))
    params = steps.init_params(cfg, seed=0, device="cpu")
    _, cache = lm.forward(params, toks, cfg, mode="prefill")
    wide = serve_lib.widen_cache(cache, cfg, B, 10)
    leaves = tree_leaves(wide)
    assert len(leaves) == 2 * cfg.n_layers
    for c, w in zip(tree_leaves(cache), leaves):
        assert w.shape[:2] == (B, 10) and w.dtype == torch.bfloat16
        assert torch.equal(w[:, :6], c) and not w[:, 6:].any()
