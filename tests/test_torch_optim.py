"""The Fig 6 baselines against the reference's `repro.optim.lbfgs`:
`glm_objective`'s value and gradient against `jax.value_and_grad` for
ridge, hinge and logistic (rtol 1e-5); the histories of `lbfgs` and
`gradient_descent` against the reference's on the same seed-made data
(iterations equal; the objective within rtol 1e-5 on every row, the
gradient norm within 1e-4 of the first row's, plus one example's
subgradient for hinge: past the float floor the two packages' last bits
wander, and the norm with them); and L-BFGS's optimum against the port's
SDCA after 6 epochs (the weights as `tests/test_optim.py`'s
`test_lbfgs_matches_sdca_optimum` holds the reference's, the objective
within rtol 1e-5).  About 12 s on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.core import objectives as jobj                     # noqa: E402
from repro.optim import lbfgs as jlb                          # noqa: E402
from repro_torch.api import Session                           # noqa: E402
from repro_torch.core import objectives as tobj               # noqa: E402
from repro_torch.core.config import EngineConfig              # noqa: E402
from repro_torch.data import make_dense_classification       # noqa: E402
from repro_torch.optim import lbfgs as tlb                    # noqa: E402

LAM = 1e-2


def _data(d=16):
    return make_dense_classification(n=512, d=d, seed=5)


@pytest.mark.parametrize("name", ["ridge", "hinge", "logistic"])
def test_glm_objective_matches_reference(name):
    X, y = _data()
    w = np.random.default_rng(0).standard_normal(16).astype(np.float32)
    jf, jg = jlb.glm_objective(jobj.get_objective(name), jnp.asarray(X),
                               jnp.asarray(y), LAM)(jnp.asarray(w))
    tf, tg = tlb.glm_objective(tobj.get_objective(name), X, y, LAM,
                               device="cpu")(w)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jg).max()))


def _same_history(jh, th, g_atol):
    assert len(jh) == len(th)
    j, t = np.array(jh), np.array(th)
    np.testing.assert_array_equal(j[:, 0], t[:, 0])
    np.testing.assert_allclose(t[:, 2], j[:, 2], rtol=1e-5)
    np.testing.assert_allclose(t[:, 3], j[:, 3], rtol=0,
                               atol=1e-4 * j[0, 3] + g_atol)


@pytest.mark.parametrize("name", ["ridge", "hinge", "logistic"])
def test_histories_match_reference(name):
    X, y = _data()
    jv = jlb.glm_objective(jobj.get_objective(name), jnp.asarray(X),
                           jnp.asarray(y), LAM)
    tv = tlb.glm_objective(tobj.get_objective(name), X, y, LAM, device="cpu")
    # the hinge subgradient jumps by one example's x_i / n (|x_i| = 1)
    # where a margin lands on the kink in one package and not the other
    g_atol = 1.0 / y.shape[0] if name == "hinge" else 0.0
    _, jh = jlb.lbfgs(jv, jnp.zeros(16), max_iters=40, tol=1e-9)
    _, th = tlb.lbfgs(tv, np.zeros(16, np.float32), max_iters=40, tol=1e-9)
    _same_history(jh, th, g_atol)
    _, jh = jlb.gradient_descent(jv, jnp.zeros(16), max_iters=40)
    _, th = tlb.gradient_descent(tv, np.zeros(16, np.float32), max_iters=40)
    _same_history(jh, th, g_atol)


def test_stopping_rule_and_device():
    """Both stop at |g| < tol and report it in their last row; the
    objective defaults to the card, which raises without one."""
    X, y = _data()
    tv = tlb.glm_objective(tobj.LOGISTIC, X, y, LAM, device="cpu")
    w, h = tlb.lbfgs(tv, np.zeros(16, np.float32), max_iters=200, tol=1e-4)
    assert h[-1][3] < 1e-4 < h[-2][3] and len(h) < 201
    assert w.shape == (16,) and w.dtype == torch.float32
    _, h = tlb.gradient_descent(tv, np.zeros(16, np.float32), tol=1e-3)
    assert h[-1][3] < 1e-3 < h[-2][3]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlb.glm_objective(tobj.LOGISTIC, X, y, LAM)


def test_lbfgs_matches_sdca_optimum():
    """Both solvers find the same regularized-logistic optimum (the
    reference's test, on the port's Session)."""
    X, y = _data()
    vg = tlb.glm_objective(tobj.LOGISTIC, X, y, LAM, device="cpu")
    w, _ = tlb.lbfgs(vg, np.zeros(16, np.float32), max_iters=200, tol=1e-9)
    s = Session(X, y, objective="logistic", lam=LAM,
                cfg=EngineConfig.make(bucket=8), device="cpu")
    s.fit(max_epochs=6, tol=1e-6)
    np.testing.assert_allclose(s.v.numpy(), w.numpy(), rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(s.primal(), float(vg(w)[0]), rtol=1e-5)
