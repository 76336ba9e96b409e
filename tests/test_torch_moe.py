"""The port's mixture of experts against the JAX package's, on the CPU.

`repro_torch.models.moe` against `repro.models.moe` at the
deepseek-v2-lite and kimi-k2 smoke shapes (d 64, 8 experts, top-2; 2
shared experts and 1), on the reference's own parameters and a
(2, 40, d) input drawn from a numpy seed.  The reference's integers
(its top-k ids, the stable argsort `order`, `keep`, `slot` and the
tokens `src_tok`) are read out of its own traced program (`_ref_ints`),
and the port's must equal them exactly.

Tolerances, measured on these inputs and stated with margin:
  * f32: rtol 1e-5, atol 1e-4 (measured max abs 1.6e-5 and 4.2e-5 at
    outputs up to 54 and 78; the reference draws the experts with std
    1/sqrt(E), E being its fan_in): the same products, summed in other
    orders by XLA and by PyTorch;
  * bf16: every entry within 2^-6 of the output's largest magnitude and
    the error's RMS within 1 % of the output's (measured 2^-7.2 and
    0.44-0.47 %; 46-47 % of the entries equal): the two frameworks
    round the bf16 expert products' outputs differently, and the
    reference sums a token's k weighted outputs through its scatter-add
    where the port gathers them back to (T, k) and adds them in
    ascending expert id, each add rounded to bf16, so the two differ by
    bf16 roundings that cancellation can make large against a small
    entry.
The combine accumulates into no index (no `index_add_`, `scatter_add_`,
accumulating `index_put_` or `bincount`), so two calls are bitwise
equal; a dispatch-mode recorder shows the aten ops a call runs.
The module-scoped fixtures trace and run the reference once a config
(the file takes ~20 s on the CPU).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_smoke as ref_smoke  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.layers import materialize as ref_materialize  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import _tensor  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402

MOE_ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]
SHAPE = (2, 40)
#: a capacity factor that drops tokens: C = 8 slots an expert for 160
#: (token, expert) pairs over 8 experts
DROP_FACTOR = 0.25
TOL_F32 = dict(rtol=1e-5, atol=1e-4)
TOL_BF16_MAX = 2 ** -6        # of the output's largest magnitude
TOL_BF16_RMS = 0.01           # of the output's RMS


def _ref_ints(p, x, cfg):
    """The reference's `moe_apply(p, x, cfg)` and the integers of its
    slot assignment, read from its own jaxpr: the top-k ids, `order`
    (the argsort's output), `keep` (the mask of its `where`), `slot`
    (the index of its float scatter-add) and `src_tok` (its floor
    division)."""
    closed = jax.make_jaxpr(lambda p, x: ref_moe.moe_apply(p, x, cfg))(p, x)
    jx = closed.jaxpr
    want = {}
    for e in jx.eqns:
        name = e.params.get("name", "")
        if e.primitive.name == "top_k":
            want["gate_ids"] = e.outvars[1]
        elif name == "argsort":
            want["order"] = e.outvars[0]
        elif name == "_where" and "keep" not in want:
            want["keep"] = e.invars[0]
        elif name == "floor_divide":
            want["src_tok"] = e.outvars[0]
        elif (e.primitive.name == "scatter-add"
              and jnp.issubdtype(e.invars[0].aval.dtype, jnp.floating)
              and "slot" not in want):
            want["slot"] = e.invars[1]
    assert set(want) == {"gate_ids", "order", "keep", "src_tok", "slot"}
    keys = sorted(want)
    outs = jax.core.eval_jaxpr(jx.replace(outvars=list(jx.outvars) + [
        want[k] for k in keys]), closed.consts,
        *jax.tree.leaves((p, x)))
    ints = {k: np.asarray(v).reshape(-1) if k != "gate_ids"
            else np.asarray(v) for k, v in zip(keys, outs[1:])}
    return np.asarray(outs[0]), ints


def _setup(name, dtype, factor=None):
    jcfg, cfg = ref_smoke(name), get_smoke(name)
    if factor is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity=factor)
        cfg = dataclasses.replace(cfg, moe_capacity=factor)
    jp = ref_materialize(ref_moe.moe_specs(jcfg), jax.random.PRNGKey(0))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jax.tree.map(lambda a: a if a.dtype == jnp.float32 and a.ndim == 2
                      and a.shape[1] == jcfg.n_experts else a.astype(jdt),
                      jp)
    x = np.random.default_rng(1).standard_normal(
        SHAPE + (jcfg.d_model,)).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    out, ints = _ref_ints(jp, jx, jcfg)
    p = tree_map(lambda a: _tensor(np.asarray(a), "cpu"),
                 jax.tree.map(np.asarray, jp))
    return {"cfg": cfg, "p": p, "x": _tensor(np.asarray(jx), "cpu"),
            "ref": out, "ints": ints}


@pytest.fixture(scope="module", params=MOE_ARCHS)
def f32_case(request):
    return _setup(request.param, torch.float32)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def drop_case(request):
    return _setup(request.param, torch.float32, DROP_FACTOR)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def bf16_case(request):
    return _setup(request.param, torch.bfloat16)


def _port_ints(case):
    cfg, p, x = case["cfg"], case["p"], case["x"]
    xt = x.reshape(-1, cfg.d_model)
    C = moe.capacity(xt.shape[0], cfg.n_experts, cfg.top_k, cfg.moe_capacity)
    _, ids = moe.route(xt, p["router"], cfg.top_k)
    return ids, moe.dispatch_slots(ids, cfg.n_experts, C)


def _assert_slots_equal(case):
    ids, (order, slot, keep, src_tok) = _port_ints(case)
    ref = case["ints"]
    np.testing.assert_array_equal(ids.numpy(), ref["gate_ids"])
    np.testing.assert_array_equal(order.numpy(), ref["order"])
    np.testing.assert_array_equal(slot.numpy(), ref["slot"])
    np.testing.assert_array_equal(keep.numpy(), ref["keep"])
    np.testing.assert_array_equal(src_tok.numpy(), ref["src_tok"])
    return keep


def test_slots_integer_exact(f32_case):
    keep = _assert_slots_equal(f32_case)
    assert bool(keep.all())          # the default factor drops none here


def test_dispatch_slots_on_given_ids_equal_reference(f32_case):
    """The slot assignment alone, fed the reference's own top-k ids."""
    cfg, ref = f32_case["cfg"], f32_case["ints"]
    T = SHAPE[0] * SHAPE[1]
    C = moe.capacity(T, cfg.n_experts, cfg.top_k, cfg.moe_capacity)
    got = moe.dispatch_slots(torch.tensor(ref["gate_ids"]).long(),
                             cfg.n_experts, C)
    for name, t in zip(("order", "slot", "keep", "src_tok"), got):
        np.testing.assert_array_equal(t.numpy(), ref[name], err_msg=name)


@pytest.mark.parametrize("tokens,experts,k,factor", [
    (80, 8, 2, 1.25), (4096, 64, 6, 1.25), (2048, 384, 8, 1.25),
    (1, 384, 8, 1.25), (80, 8, 2, 0.25), (160, 8, 2, 8.0)])
def test_capacity_matches_reference(tokens, experts, k, factor):
    assert moe.capacity(tokens, experts, k, factor) == ref_moe.capacity(
        tokens, experts, k, factor)


def test_moe_apply_matches_reference_f32(f32_case):
    c = f32_case
    out = moe.moe_apply(c["p"], c["x"], c["cfg"], act=c["cfg"].act)
    assert out.shape == c["x"].shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), c["ref"], **TOL_F32)


def test_capacity_drops_tokens_as_the_reference(drop_case):
    c = drop_case
    keep = _assert_slots_equal(c)
    assert 0 < int((~keep).sum()) < keep.numel()
    out = moe.moe_apply(c["p"], c["x"], c["cfg"], act=c["cfg"].act)
    np.testing.assert_allclose(out.numpy(), c["ref"], **TOL_F32)
    # the dropped pairs contribute nothing: a dropless run differs
    full = dataclasses.replace(c["cfg"], moe_capacity=8.0)
    assert not torch.allclose(out, moe.moe_apply(c["p"], c["x"], full))


def test_moe_apply_bf16_within_two_ulps(bf16_case):
    c = bf16_case
    _assert_slots_equal(c)
    out = moe.moe_apply(c["p"], c["x"], c["cfg"], act=c["cfg"].act)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(c["ref"], np.float32)
    err = out.float().numpy() - ref
    assert np.abs(err).max() <= TOL_BF16_MAX * np.abs(ref).max()
    assert np.sqrt((err ** 2).mean()) <= TOL_BF16_RMS * np.sqrt(
        (ref ** 2).mean())


class _Ops(TorchDispatchMode):
    """Records the aten ops a call runs."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket.__name__)
        if name.startswith("index_put") and (
                kwargs.get("accumulate") or (len(args) > 3 and args[3])):
            name += "(accumulate)"
        self.ops.append(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_bitwise_across_calls_and_no_accumulating_index_op(
        f32_case, dtype):
    c = f32_case
    p = tree_map(lambda t: t if t.dtype == torch.float32 and t.dim() == 2
                 and t.shape[1] == c["cfg"].n_experts else t.to(dtype),
                 c["p"])
    x = c["x"].to(dtype)
    with _Ops() as rec:
        a = moe.moe_apply(p, x, c["cfg"])
    b = moe.moe_apply(p, x, c["cfg"])
    assert torch.equal(a, b)
    bad = [o for o in rec.ops if o.startswith(("index_add", "scatter_add",
                                               "scatter_reduce", "bincount"))
           or o.endswith("(accumulate)")]
    assert not bad, bad
    assert "bmm" in rec.ops and "sort" in rec.ops
