"""The port's public API against the reference's (tests/test_api.py).

Same seeded numpy data through both packages; the port runs on the CPU
(`device="cpu"`: the plain versions), the reference on its XLA route
with the planner off.  Tolerances:

  * estimators after 5 epochs: `coef_` rtol 1e-4, atol 1e-5 (the bounds
    of tests/test_torch_session.py: the two sides order their sums
    differently); `predict` equal wherever the reference's |margin| >
    1e-4; Ridge's real-valued predictions rtol 1e-4, atol 1e-4; scores
    within 1e-6 (classifiers) / 1e-5 (R^2); probabilities atol 1e-5;
  * inside the port (resume, shims, batching, CSR against its padded
    pair, checkpoints read back): bitwise;
  * across packages through a checkpoint: the loader's labels equal the
    saver's (margins within rtol 1e-5, atol 1e-6);
  * sklearn parity: score within 1e-2, agreement >= 0.99 (the
    reference's own bar).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import LinearSVC as JLinearSVC                 # noqa: E402
from repro.api import LogisticRegression as JLogReg           # noqa: E402
from repro.api import Ridge as JRidge                         # noqa: E402
from repro.api import load as jload                           # noqa: E402
from repro.data import synthetic as jsynth                    # noqa: E402
from repro_torch.api import (BenchmarkRecorder,               # noqa: E402
                             CheckpointHook, EarlyStopping,
                             GapLogger, HealthPolicy, LinearSVC,
                             LogisticRegression, NotFittedError,
                             ReproDeprecationWarning, Ridge, Session)
from repro_torch.api import load as tload                     # noqa: E402
from repro_torch.api.deprecation import \
    reset_deprecation_registry                                # noqa: E402
from repro_torch.api.estimators import _csr_to_padded          # noqa: E402
from repro_torch.core import engine                           # noqa: E402
from repro_torch.core.config import EngineConfig              # noqa: E402
from repro_torch.launch.serve import glm_predict_batch        # noqa: E402

DET = dict(pods=1, lanes=2, bucket=8, chunks=2, partition="hierarchical",
           deterministic=True)
CPU = dict(device="cpu")
PAIRS = {"LogisticRegression": (LogisticRegression, JLogReg),
         "LinearSVC": (LinearSVC, JLinearSVC), "Ridge": (Ridge, JRidge)}


@pytest.fixture(autouse=True)
def _plan_off(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN", "off")
    monkeypatch.delenv("REPRO_LOCAL_SOLVER", raising=False)


def _dense(n=512, d=32, seed=0):
    X, y = jsynth.make_dense_classification(n=n, d=d, seed=seed)
    return np.asarray(X), np.asarray(y)


def _sparse(n=512, d=128, nnz=8, seed=3):
    (idx, val), y, d = jsynth.make_sparse_classification(n=n, d=d, nnz=nnz,
                                                         seed=seed)
    return (np.asarray(idx), np.asarray(val)), np.asarray(y), d


def _regression(n=400, d=12):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    return X, X @ w + 0.01 * rng.standard_normal(n).astype(np.float32)


# -- the sklearn protocol ----------------------------------------------------

def test_estimator_sklearn_protocol():
    est = LogisticRegression(lam=1e-2, lanes=4, max_epochs=7, **CPU)
    params = est.get_params()
    assert params["lanes"] == 4 and params["max_epochs"] == 7
    assert params["device"] == "cpu"
    assert set(params) == set(JLogReg().get_params()) | {"device"}
    clone = LogisticRegression(**params)
    assert clone.get_params() == params
    est.set_params(lanes=2, tol=1e-5)
    assert est.lanes == 2 and est.tol == 1e-5
    with pytest.raises(ValueError, match="invalid parameter"):
        est.set_params(nope=1)
    with pytest.raises(NotFittedError):
        est.predict(np.zeros((3, 4)))


def test_sklearn_clone():
    pytest.importorskip("sklearn")
    from sklearn.base import clone
    est = Ridge(lam=1e-4, bucket=8, max_epochs=3, **CPU)
    twin = clone(est)
    assert type(twin) is Ridge and twin is not est
    assert twin.get_params() == est.get_params()


def test_fit_without_gpu_raises_naming_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _dense(n=64, d=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LogisticRegression().fit(X.T, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LogisticRegression.load("unused")


@pytest.mark.parametrize("knob", ["health", "journal_dir"])
def test_resilience_knobs_reach_the_session(knob, tmp_path):
    """``health=`` and ``journal_dir=`` are estimator parameters that
    reach the `Session`; a fault-free fit through them is bitwise a
    plain one."""
    X, y = _dense(n=64, d=8)
    value = {"health": HealthPolicy(retries=2),
             "journal_dir": tmp_path / "j"}[knob]
    kw = dict(max_epochs=2, bucket=8, tol=0.0, **CPU)
    plain = LogisticRegression(**kw).fit(X.T, y)
    est = LogisticRegression(**kw, **{knob: value}).fit(X.T, y)
    np.testing.assert_array_equal(est.coef_, plain.coef_)
    assert est.get_params()[knob] is value
    s = est.session_
    if knob == "health":
        assert s._health is value and s._journal is None
    else:
        assert s._journal.root == value and (value / "epoch").is_dir()


def test_session_x_is_contiguous_from_sklearn_layout():
    X, y = _dense(n=256, d=16)
    Xsk = np.ascontiguousarray(X.T)           # a user's C-order (n, d)
    est = LogisticRegression(max_epochs=1, bucket=8, **CPU).fit(Xsk, y)
    assert est.session_.X.is_contiguous()
    assert torch.equal(est.session_.X, torch.from_numpy(X))


# -- against the reference estimators ----------------------------------------

def _margins_mask(jest, Xsk):
    return np.abs(np.asarray(jest.decision_function(Xsk))) > 1e-4


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_estimator_matches_reference(name):
    tcls, jcls = PAIRS[name]
    if name == "Ridge":
        Xsk, y = _regression()
    else:
        X, y = _dense()
        Xsk, y = X.T, (y > 0).astype(int)          # arbitrary labels
    kw = dict(lam=1e-3, bucket=8, lanes=2, max_epochs=5, tol=0.0)
    t = tcls(**kw, **CPU).fit(Xsk, y)
    j = jcls(**kw).fit(Xsk, y)
    assert t.n_iter_ == j.n_iter_ == 5
    np.testing.assert_allclose(t.coef_, np.asarray(j.coef_), rtol=1e-4,
                               atol=1e-5)
    tp, jp = t.predict(Xsk), np.asarray(j.predict(Xsk))
    if name == "Ridge":
        np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-4)
        assert abs(t.score(Xsk, y) - j.score(Xsk, y)) <= 1e-5
        return
    assert list(t.classes_) == list(j.classes_) == [0, 1]
    mask = _margins_mask(j, Xsk)
    np.testing.assert_array_equal(tp[mask], jp[mask])
    assert abs(t.score(Xsk, y) - j.score(Xsk, y)) <= 1e-6 + 1 - mask.mean()
    if name == "LogisticRegression":
        np.testing.assert_allclose(t.predict_proba(Xsk),
                                   np.asarray(j.predict_proba(Xsk)),
                                   atol=1e-5)
        np.testing.assert_allclose(t.predict_proba(Xsk).sum(axis=1), 1.0,
                                   atol=1e-6)
        assert np.all(np.isfinite(t.predict_log_proba(Xsk)))


@pytest.mark.parametrize("form", ["pair", "csr"])
def test_sparse_input_matches_reference(form):
    sp = pytest.importorskip("scipy.sparse")
    (idx, val), y, d = _sparse()
    kw = dict(lam=1e-3, bucket=8, lanes=2, max_epochs=5, tol=0.0,
              n_features=d)
    if form == "pair":
        Xin = (idx, val)
    else:
        n, nnz = idx.shape
        Xin = sp.csr_matrix((val.ravel(), idx.ravel(),
                             np.arange(0, n * nnz + 1, nnz)), shape=(n, d))
    t = LogisticRegression(**kw, **CPU).fit(Xin, y)
    j = JLogReg(**kw).fit(Xin, y)
    assert t.coef_.shape == (d,)
    np.testing.assert_allclose(t.coef_, np.asarray(j.coef_), rtol=1e-4,
                               atol=1e-5)
    mask = _margins_mask(j, Xin)
    np.testing.assert_array_equal(t.predict(Xin)[mask],
                                  np.asarray(j.predict(Xin))[mask])


def test_csr_rows_padded_back_unchanged_fit_bitwise():
    """CSR built from the padded pair's own rows: `_csr_to_padded`
    gives them back, and the fit is bitwise the pair's."""
    sp = pytest.importorskip("scipy.sparse")
    (idx, val), y, d = _sparse(n=256, d=64)
    n, nnz = idx.shape
    mat = sp.csr_matrix((val.ravel(), idx.ravel(),
                         np.arange(0, n * nnz + 1, nnz)), shape=(n, d))
    i2, v2 = _csr_to_padded(mat)
    assert np.array_equal(i2, idx) and np.array_equal(v2, val)
    kw = dict(lam=1e-2, max_epochs=3, tol=0.0, n_features=d, **DET, **CPU)
    a = LogisticRegression(**kw).fit(mat, y)
    b = LogisticRegression(**kw).fit((idx, val), y)
    np.testing.assert_array_equal(a.coef_, b.coef_)
    np.testing.assert_array_equal(a.predict(mat), b.predict((idx, val)))


def test_registry_name_matches_reference():
    kw = dict(bucket=8, lanes=2, max_epochs=2, tol=0.0)
    t = LogisticRegression(**kw, **CPU).fit("synthetic-sparse")
    j = JLogReg(**kw).fit("synthetic-sparse")
    assert list(t.classes_) == [-1.0, 1.0]
    np.testing.assert_allclose(t.coef_, np.asarray(j.coef_), rtol=1e-4,
                               atol=1e-5)


# -- whole-estimator checkpointing ------------------------------------------

def _resume_case(kind):
    common = dict(lam=1e-2, tol=0.0, **DET, **CPU)
    if kind == "dense":
        X, y = _dense(n=256, d=16)
        return (X.T, y), common
    (idx, val), y, d = _sparse(n=256, d=64, seed=1)
    return ((idx, val), y), dict(common, n_features=d)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_estimator_checkpoint_resume_bitwise(tmp_path, kind):
    """fit(3) -> save -> load -> fit(8) == one straight fit(8), bitwise."""
    fit_args, common = _resume_case(kind)
    straight = LogisticRegression(max_epochs=8, **common).fit(*fit_args)
    half = LogisticRegression(max_epochs=3, **common).fit(*fit_args)
    half.save(tmp_path / "est")

    resumed = tload(tmp_path / "est", device="cpu")
    assert type(resumed) is LogisticRegression and resumed.n_iter_ == 3
    np.testing.assert_array_equal(resumed.predict(fit_args[0]),
                                  half.predict(fit_args[0]))
    resumed.set_params(max_epochs=8)
    resumed.fit(*fit_args)
    assert resumed.n_iter_ == 8
    np.testing.assert_array_equal(resumed.coef_, straight.coef_)
    assert torch.equal(resumed.session_.alpha, straight.session_.alpha)


def test_loaded_estimator_fit_without_budget_reports_state(tmp_path):
    X, y = _dense(n=256, d=16)
    est = LogisticRegression(bucket=8, max_epochs=3, tol=0.0, **CPU)
    est.fit(X.T, y)
    est.save(tmp_path / "est")
    again = tload(tmp_path / "est", device="cpu")
    again.fit(X.T, y)
    assert again.n_iter_ == 3
    assert np.isfinite(again.fit_result_.final_gap)
    np.testing.assert_array_equal(again.coef_, est.coef_)


def test_resume_rejects_different_n(tmp_path):
    X, y = _dense(n=256, d=16)
    est = LogisticRegression(bucket=8, max_epochs=2, tol=0.0, **CPU)
    est.fit(X.T, y)
    est.save(tmp_path / "est")
    X2, y2 = _dense(n=512, d=16, seed=1)
    with pytest.raises(ValueError, match="checkpoint n="):
        tload(tmp_path / "est", device="cpu").fit(X2.T, y2)


def test_save_warns_on_unserializable_params(tmp_path):
    X, y = _dense(n=256, d=16)
    est = LogisticRegression(bucket=8, max_epochs=2, tol=0.0,
                             callbacks=[lambda m: None], **CPU)
    est.fit(X.T, y)
    with pytest.warns(UserWarning, match="callbacks"):
        est.save(tmp_path / "est")
    again = tload(tmp_path / "est", device="cpu")
    assert again.callbacks is None and again.device == torch.device("cpu")


def test_estimator_load_rejects_wrong_class(tmp_path):
    X, y = _dense(n=256, d=16)
    est = LogisticRegression(bucket=8, max_epochs=2, tol=0.0, **CPU)
    est.fit(X.T, y)
    est.save(tmp_path / "est")
    with pytest.raises(ValueError, match="LogisticRegression"):
        Ridge.load(tmp_path / "est", device="cpu")


@pytest.mark.parametrize("saver,solver,kind", [
    ("reference", "xla", "dense"), ("reference", "auto", "sparse"),
    ("port", "torch", "dense"), ("port", "kernel", "sparse")])
def test_checkpoint_crosses_packages(tmp_path, saver, solver, kind):
    """An estimator one package saves loads in the other and predicts
    what the saver predicts; the solver name is carried across."""
    fit_args, common = _resume_case(kind)
    jcommon = {k: v for k, v in common.items() if k != "device"}
    Xin = fit_args[0]
    to_port = {"xla": "torch", "pallas": "kernel", "auto": "auto"}
    if saver == "reference":
        src = JLogReg(max_epochs=3, local_solver=solver, **jcommon)
        src.fit(*fit_args)
        src.save(tmp_path / "est")
        dst = tload(tmp_path / "est", device="cpu")
        assert dst.local_solver == to_port[solver]
        assert dst.device == torch.device("cpu")
    else:
        src = LogisticRegression(max_epochs=3, **common)
        src.fit(*fit_args)
        src.set_params(local_solver=solver)      # "kernel" never runs here
        src.save(tmp_path / "est")
        dst = jload(tmp_path / "est")
        assert to_port[dst.local_solver] == solver
    assert type(dst).__name__ == "LogisticRegression" and dst.n_iter_ == 3
    np.testing.assert_array_equal(np.asarray(dst.coef_),
                                  np.asarray(src.coef_))
    np.testing.assert_allclose(np.asarray(dst.decision_function(Xin)),
                               np.asarray(src.decision_function(Xin)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(dst.predict(Xin)),
                                  np.asarray(src.predict(Xin)))


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's 3 epochs, then the port's 2 more: within the
    session tolerances of the reference's own 5."""
    fit_args, common = _resume_case("dense")
    jcommon = {k: v for k, v in common.items() if k != "device"}
    JLogReg(max_epochs=3, **jcommon).fit(*fit_args).save(tmp_path / "est")
    full = JLogReg(max_epochs=5, **jcommon).fit(*fit_args)
    est = tload(tmp_path / "est", device="cpu").set_params(max_epochs=5)
    est.fit(*fit_args)
    assert est.n_iter_ == 5
    np.testing.assert_allclose(est.coef_, np.asarray(full.coef_),
                               rtol=1e-4, atol=1e-5)


# -- callbacks ----------------------------------------------------------------

def test_callbacks_early_stop_logger_recorder():
    X, y = _dense()
    logger = GapLogger(every=1, printer=None)
    rec = BenchmarkRecorder()
    stop = EarlyStopping(monitor="gap", threshold=1e-3)
    ses = Session((X, y), lam=1e-2, cfg=EngineConfig.make(**DET), **CPU)
    res = ses.fit(until=50, tol=0.0, callbacks=[logger, stop, rec])
    assert res.epochs < 50                      # certificate stop fired
    assert logger.trace and logger.trace[-1][1] < 1e-3
    assert len(rec.records) == res.epochs
    assert rec.wall_time > 0


def test_gap_logger_every_and_patience_stop():
    X, y = _dense()
    lines = []
    logger = GapLogger(every=2, printer=lines.append)
    stop = EarlyStopping(monitor="rel_change", patience=2, min_delta=1.0)
    ses = Session((X, y), lam=1e-2, cfg=EngineConfig.make(**DET), **CPU)
    res = ses.fit(until=50, tol=0.0, callbacks=[logger, stop])
    assert res.epochs == 3                      # 1 best, 2 stale
    assert [ep for ep, _ in logger.trace] == [2] and len(lines) == 1


def test_bare_callable_callback_stops():
    X, y = _dense()
    ses = Session((X, y), lam=1e-2, cfg=EngineConfig.make(**DET), **CPU)
    res = ses.fit(until=50, tol=0.0,
                  callbacks=[lambda m: m["epoch"] >= 2])
    assert res.epochs == 2


def test_checkpoint_hook_saves_steps(tmp_path):
    X, y = _dense()
    hook = CheckpointHook(tmp_path / "ck", every=2, keep_n=2)
    ses = Session((X, y), lam=1e-2, cfg=EngineConfig.make(**DET), **CPU)
    ses.fit(until=5, tol=0.0, callbacks=[hook])
    hook.mgr.wait()
    assert hook.mgr.all_steps() == [2, 4]
    st, meta = hook.mgr.restore(ses.state_dict())
    assert meta == {"epoch": 4, "step": 4} and int(st["epoch"]) == 4


def test_estimator_callbacks_param():
    X, y = _dense(n=256, d=16)
    rec = BenchmarkRecorder()
    est = LogisticRegression(bucket=8, max_epochs=4, tol=0.0,
                             callbacks=[rec], **CPU)
    est.fit(X.T, y)
    assert [r["epoch"] for r in rec.records] == [1, 2, 3, 4]


# -- legacy shims ---------------------------------------------------------------

def test_legacy_entry_points_warn_once():
    from repro_torch.core import (GLMTrainer, SolverConfig, cocoa,
                                  fit_dataset)
    from repro_torch.core.bucketing import make_plan
    from repro_torch.core.objectives import LOGISTIC
    from repro_torch.core.partition import PartitionPlan

    X, y = _dense(n=128, d=8)
    reset_deprecation_registry()
    with pytest.warns(ReproDeprecationWarning, match="GLMTrainer"):
        tr = GLMTrainer(X, y, cfg=SolverConfig(bucket=8), **CPU)
    with warnings.catch_warnings():           # once per process
        warnings.simplefilter("error", ReproDeprecationWarning)
        GLMTrainer(X, y, cfg=SolverConfig(bucket=8), **CPU)

    with pytest.warns(ReproDeprecationWarning, match="fit_dataset"):
        res, ses = fit_dataset("synthetic-dense", n=128, d=16,
                               max_epochs=1, tol=0.0, return_trainer=True,
                               **CPU)
    assert res.epochs == 1 and ses.epochs_done == 1

    plan = PartitionPlan(n_buckets=16, pods=1, lanes=2)
    bplan = make_plan(128, 8, force=8)
    cfg = SolverConfig(lanes=2, bucket=8)
    args = (LOGISTIC, X, y, tr.alpha * 0, tr.v * 0, 1e-3, plan, bplan, cfg,
            0)
    with pytest.warns(ReproDeprecationWarning, match="epoch_sim"):
        a, v = cocoa.epoch_sim(*args, **CPU)
    a2, v2 = engine.sim_epoch_dense(*args, **CPU)
    assert torch.equal(a, a2) and torch.equal(v, v2)

    (idx, val), ys, d = _sparse(n=128, d=32, nnz=4, seed=0)
    sargs = (LOGISTIC, idx, val, ys, np.zeros(128, np.float32),
             np.zeros(d, np.float32), 1e-3,
             PartitionPlan(n_buckets=16, pods=1, lanes=2),
             make_plan(128, d, force=8), cfg, 0)
    with pytest.warns(ReproDeprecationWarning, match="epoch_sim_sparse"):
        a, v = cocoa.epoch_sim_sparse(*sargs, **CPU)
    a2, v2 = engine.sim_epoch_sparse(*sargs, **CPU)
    assert torch.equal(a, a2) and torch.equal(v, v2)


def test_epoch_sim_matches_reference():
    import jax.numpy as jnp
    from repro.core import SolverConfig as JSolverConfig
    from repro.core import cocoa as jcocoa
    from repro.core.bucketing import make_plan as jmake_plan
    from repro.core.objectives import LOGISTIC as JLOGISTIC
    from repro.core.partition import PartitionPlan as JPartitionPlan
    from repro_torch.core import SolverConfig, cocoa
    from repro_torch.core.bucketing import make_plan
    from repro_torch.core.objectives import LOGISTIC
    from repro_torch.core.partition import PartitionPlan

    X, y = _dense(n=128, d=8)
    kw = dict(n_buckets=16, pods=1, lanes=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        a, v = cocoa.epoch_sim(LOGISTIC, X, y, np.zeros(128, np.float32),
                               np.zeros(8, np.float32), 1e-3,
                               PartitionPlan(**kw), make_plan(128, 8, force=8),
                               SolverConfig(lanes=2, bucket=8), 0, **CPU)
        ja, jv = jcocoa.epoch_sim(JLOGISTIC, jnp.asarray(X), jnp.asarray(y),
                                  jnp.zeros(128), jnp.zeros(8), 1e-3,
                                  JPartitionPlan(**kw),
                                  jmake_plan(128, 8, force=8),
                                  JSolverConfig(lanes=2, bucket=8),
                                  jnp.int32(0))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-5)


def test_glm_trainer_equals_session_bitwise():
    from repro_torch.core import GLMTrainer
    X, y = _dense()
    cfg = EngineConfig.make(**DET)
    ses = Session((X, y), objective="logistic", lam=1e-2, cfg=cfg, **CPU)
    ses.fit(max_epochs=3, tol=0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReproDeprecationWarning)
        tr = GLMTrainer(X, y, objective="logistic", lam=1e-2, cfg=cfg, **CPU)
    tr.fit(max_epochs=3, tol=0.0)
    assert tr.epoch == 3 and tr.plan.n_buckets == ses.plan.n_buckets
    assert torch.equal(ses.v, tr.v) and torch.equal(ses.alpha, tr.alpha)
    assert tr.gap() == ses.gap()


def test_streamed_trainer_shim_warns_then_trains(tmp_path):
    from repro_torch.core import EngineConfig, StreamedGLMTrainer
    from repro_torch.data import registry
    cache = registry.materialize("synthetic-dense", tmp_path, bucket=8,
                                 n=256, d=16)
    reset_deprecation_registry()
    with pytest.warns(ReproDeprecationWarning, match="StreamedGLMTrainer"):
        tr = StreamedGLMTrainer(cache, cfg=EngineConfig.make(bucket=8),
                                **CPU)
    res = tr.fit(max_epochs=2, tol=0.0)
    assert tr.streamed and res.epochs == 2
    assert float(torch.abs(tr.v).max()) > 0


def test_solver_config_use_kernel_and_session_accepts_it():
    from repro_torch.core import SolverConfig
    assert SolverConfig(use_kernel=True).to_engine().algo.local_solver \
        == "kernel"
    X, y = _dense(n=128, d=8)
    cfg = SolverConfig(lanes=2, bucket=8)
    ses = Session((X, y), cfg=cfg, **CPU)
    assert ses.spec == cfg.to_engine()
    ses.fit(max_epochs=1, tol=0.0)


# -- batch prediction -----------------------------------------------------------

@pytest.fixture(scope="module")
def _fitted():
    X, y = _dense(n=500, d=16)
    dense = LogisticRegression(bucket=8, max_epochs=3, **CPU).fit(X.T, y)
    (idx, val), ys, d = _sparse(n=500, d=64)
    sparse = LogisticRegression(bucket=8, max_epochs=3, n_features=d,
                                **CPU).fit((idx, val), ys)
    return {"dense": (dense, X.T), "sparse": (sparse, (idx, val))}


@pytest.mark.parametrize("batch", [1, 50, 100, 500, 8192])
@pytest.mark.parametrize("kind", ["dense", "sparse", "csr"])
def test_glm_predict_batch_equals_predict(_fitted, kind, batch):
    est, Xin = _fitted["sparse" if kind == "csr" else kind]
    if kind == "csr":
        sp = pytest.importorskip("scipy.sparse")
        idx, val = Xin
        n, nnz = idx.shape
        Xin = sp.csr_matrix((val.ravel(), idx.ravel(),
                             np.arange(0, n * nnz + 1, nnz)), shape=(n, 64))
    out = glm_predict_batch(est, Xin, batch=batch)
    np.testing.assert_array_equal(out, est.predict(Xin))
    proba = glm_predict_batch(est, Xin, batch=batch, proba=True)
    assert proba.shape == (500, 2)
    np.testing.assert_allclose(proba, est.predict_proba(Xin), atol=1e-6)


def test_glm_predict_batch_empty_input(_fitted):
    est, _ = _fitted["dense"]
    assert glm_predict_batch(est, np.zeros((0, 16), np.float32)).shape \
        == (0,)


# -- sklearn parity (the acceptance criterion) ------------------------------

def test_sklearn_parity_on_registry_dataset():
    pytest.importorskip("sklearn")
    from sklearn.linear_model import LogisticRegression as SkLR
    from repro_torch.data import registry

    ds = registry.get_dataset("synthetic-dense")   # 2048 x 64
    Xsk, y = ds.X.T, ds.y
    lam = 1e-3
    ours = LogisticRegression(lam=lam, bucket=8, lanes=4,
                              partition="dynamic", max_epochs=100,
                              tol=1e-5, **CPU)
    ours.fit(Xsk, y)
    theirs = SkLR(C=1.0 / (lam * y.shape[0]), fit_intercept=False,
                  solver="lbfgs", max_iter=1000, tol=1e-8)
    theirs.fit(Xsk, y)
    assert abs(ours.score(Xsk, y) - theirs.score(Xsk, y)) <= 1e-2
    assert np.mean(ours.predict(Xsk) == theirs.predict(Xsk)) >= 0.99
