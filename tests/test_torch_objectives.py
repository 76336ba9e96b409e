"""The port's objectives against `repro.core.objectives` over (m, a, y, q)
sweeps, plus the int8 wire compression against `repro.optim`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from repro.core import objectives as jobj                # noqa: E402
from repro.optim import compression as jcomp             # noqa: E402
from repro_torch.core import objectives as tobj          # noqa: E402
from repro_torch.optim import compression as tcomp       # noqa: E402


def _sweep(name, seed=0, n=4000):
    rng = np.random.default_rng(seed)
    m = rng.normal(scale=3.0, size=n).astype(np.float32)
    q = np.concatenate([np.zeros(8), rng.exponential(2.0, n - 8)]
                       ).astype(np.float32)
    if name == "ridge":
        y = rng.normal(size=n).astype(np.float32)
        a = rng.normal(size=n).astype(np.float32)
    else:
        y = rng.choice([-1.0, 1.0], size=n).astype(np.float32)
        b = rng.uniform(0.0, 1.0, size=n)
        b[:16] = [0.0, 1.0] * 8                        # domain edges
        a = (y * b).astype(np.float32)
    return m, a, y, q


def _both(name, fn, *args):
    j = getattr(jobj.get_objective(name), fn)(*(jnp.asarray(x) for x in args))
    t = getattr(tobj.get_objective(name), fn)(*(torch.as_tensor(x)
                                                for x in args))
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("name", ["ridge", "hinge"])
def test_delta_ridge_hinge(name):
    # basic IEEE ops in the same order: rtol 1e-6 covers XLA's freedom to
    # contract a multiply-add
    j, t = _both(name, "delta", *_sweep(name))
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


def test_delta_logistic():
    # 40-step bisection on [1e-6, 1-1e-6]: the end interval is ~1e-12,
    # so the bound is libm: log/log1p of XLA-CPU vs PyTorch may differ by
    # an ulp and flip a late bisection step — abs 1e-5
    j, t = _both("logistic", "delta", *_sweep("logistic"))
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["ridge", "hinge", "logistic"])
def test_loss_and_conjugate(name):
    m, a, y, _ = _sweep(name, seed=1)
    for fn, args in (("loss", (m, y)), ("conj_neg", (a, y))):
        j, t = _both(name, fn, *args)
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["ridge", "hinge", "logistic"])
def test_primal_dual_gap(name):
    rng = np.random.default_rng(2)
    d, n = 12, 300
    X = rng.normal(size=(d, n)).astype(np.float32)
    m, a, y, _ = _sweep(name, seed=3, n=n)
    v = (X @ a / (1e-2 * n)).astype(np.float32)
    jo, to = jobj.get_objective(name), tobj.get_objective(name)
    J = [jnp.asarray(x) for x in (a, v, X, y)]
    T = [torch.as_tensor(x) for x in (a, v, X, y)]
    # (d x n) products summed in another order: rtol 1e-5
    np.testing.assert_allclose(
        float(tobj.primal_value(to, T[1], T[2], T[3], 1e-2)),
        float(jobj.primal_value(jo, J[1], J[2], J[3], 1e-2)), rtol=1e-5)
    np.testing.assert_allclose(
        float(tobj.dual_value(to, T[0], T[1], T[3], 1e-2)),
        float(jobj.dual_value(jo, J[0], J[1], J[3], 1e-2)), rtol=1e-5)
    np.testing.assert_allclose(
        float(tobj.duality_gap(to, *T, 1e-2)),
        float(jobj.duality_gap(jo, *J, 1e-2)), rtol=1e-4, atol=1e-6)


def test_get_objective_unknown():
    with pytest.raises(ValueError, match="unknown objective"):
        tobj.get_objective("poisson")


@pytest.mark.parametrize("axis", [None, 1])
def test_compress_matches_reference(axis):
    # the reference's compress as its programs run it, compiled: the
    # scale a multiply by f32(1/127), the residual one fused
    # multiply-add; the same IEEE ops (max, multiply, divide,
    # round-half-even, clip): exact
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 257)).astype(np.float32)
    jq, jerr = jax.jit(lambda t: jcomp.compress(t, axis=axis))(
        jnp.asarray(x))
    tq, terr = tcomp.compress(torch.as_tensor(x), axis=axis)
    assert np.array_equal(np.asarray(jq.q), tq.q.numpy())
    np.testing.assert_array_equal(np.asarray(jq.scale), tq.scale.numpy())
    np.testing.assert_array_equal(np.asarray(jcomp.dequantize(jq)),
                                  tcomp.dequantize(tq).numpy())
    np.testing.assert_array_equal(np.asarray(jerr), terr.numpy())
