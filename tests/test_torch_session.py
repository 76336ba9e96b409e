"""The whole slice: the port's `Session` against the JAX `Session`.

Same data (numpy, from a seed) through both packages, pods=2, lanes=2,
bucket=8, 3 epochs, every objective, dense and sparse.  The reference
runs its XLA route on the CPU with the planner off; the port runs its
plain PyTorch route (`device="cpu"`).  Tolerances: alpha and v rtol
1e-4, atol 1e-5, gap relative 1e-3 — three epochs of sub-epochs whose
per-step sums are ordered differently (matmul and reduction order) on
the two sides.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import Session as JSession                     # noqa: E402
from repro.core.config import EngineConfig as JConfig         # noqa: E402
from repro.data import synthetic as jsynth                    # noqa: E402
from repro_torch import convert                               # noqa: E402
from repro_torch.api import Session                           # noqa: E402
from repro_torch.core.config import EngineConfig              # noqa: E402
from repro_torch.core import engine                           # noqa: E402
from repro_torch.launch.mesh import DistMesh                  # noqa: E402
from repro_torch.resilience import FaultInjector              # noqa: E402

OBJS = ["ridge", "hinge", "logistic"]
CFG = dict(pods=2, lanes=2, bucket=8)


@pytest.fixture(autouse=True)
def _plan_off(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN", "off")
    monkeypatch.delenv("REPRO_LOCAL_SOLVER", raising=False)


def _data(kind):
    # n = 250 pads to 256 (pods*lanes*lanes*chunks*bucket = 64): the
    # lam rescale and the inert rows are part of what is compared
    if kind == "dense":
        X, y = jsynth.make_dense_classification(n=250, d=12, seed=3)
        return (X, y), {}
    (idx, val), y, d = jsynth.make_sparse_classification(
        n=250, d=64, nnz=8, seed=4, skew=1.0)
    return ((idx, val), y), {"d": d}


def _assert_close(js, ts):
    np.testing.assert_allclose(ts.alpha.numpy(), np.asarray(js.alpha),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v),
                               rtol=1e-4, atol=1e-5)
    jg, tg = js.gap(), ts.gap()
    assert abs(tg - jg) <= 1e-3 * abs(jg), (tg, jg)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("name", OBJS)
def test_session_matches_reference(kind, name):
    data, kw = _data(kind)
    js = JSession(data, objective=name, cfg=JConfig.make(**CFG), **kw)
    ts = Session(data, objective=name, cfg=EngineConfig.make(**CFG),
                 device="cpu", **kw)
    geom = lambda s: (s.n, s.d, s.lam, s.bplan.bucket, s.bplan.n_buckets)
    assert geom(ts) == geom(js)
    for _ in range(3):
        js.epoch()
        ts.epoch()
    _assert_close(js, ts)


@pytest.mark.parametrize("partition", ["static", "dynamic", "rotation",
                                       "alltoall"])
def test_session_partitions_match_reference(partition):
    data, kw = _data("dense")
    cfg = dict(CFG, partition=partition, chunks=2, compress_sync=True,
               compress_pod=True)
    js = JSession(data, objective="logistic", cfg=JConfig.make(**cfg), **kw)
    ts = Session(data, objective="logistic", cfg=EngineConfig.make(**cfg),
                 device="cpu", **kw)
    for _ in range(3):
        js.epoch()
        ts.epoch()
    _assert_close(js, ts)


@pytest.mark.parametrize("chunks", [2, 4])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_session_chunks_match_reference(kind, chunks):
    """The hierarchical, deterministic epoch that the streamed path runs,
    resident, at 2 and 4 chunks."""
    data, kw = _data(kind)
    cfg = dict(CFG, partition="hierarchical", chunks=chunks,
               deterministic=True)
    js = JSession(data, objective="logistic", cfg=JConfig.make(**cfg), **kw)
    ts = Session(data, objective="logistic", cfg=EngineConfig.make(**cfg),
                 device="cpu", **kw)
    for _ in range(3):
        js.epoch()
        ts.epoch()
        _assert_close(js, ts)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_carry_over_from_reference(kind):
    """JAX epochs 1-2 -> convert -> epoch 3 on both packages."""
    data, kw = _data(kind)
    jcfg = JConfig.make(**CFG, partition="dynamic", aggregation="adding")
    js = JSession(data, objective="logistic", cfg=jcfg, **kw)
    js.fit(until=2, tol=0.0)
    tcfg = convert.engine_config(dataclasses.asdict(jcfg))
    assert tcfg == EngineConfig.make(**CFG, partition="dynamic")
    ts = Session(data, objective="logistic", cfg=tcfg, device="cpu", **kw)
    ts.load_state_dict(convert.session_state(js.state_dict()))
    assert ts.epochs_done == 2
    js.epoch()
    ts.epoch()
    _assert_close(js, ts)


def test_registry_session_matches_reference():
    js = JSession("synthetic-sparse", n=500, cfg=JConfig.make(**CFG))
    ts = Session("synthetic-sparse", n=500, cfg=EngineConfig.make(**CFG),
                 device="cpu")
    assert (ts.n, ts.d, ts.lam, ts.obj.name) == (js.n, js.d, js.lam,
                                                 js.obj.name)
    res_j = js.fit(max_epochs=2, tol=0.0, gap_every=1)
    res_t = ts.fit(max_epochs=2, tol=0.0, gap_every=1)
    assert res_t.epochs == res_j.epochs == 2
    _assert_close(js, ts)


def test_fit_callbacks_and_tol_stop():
    data, kw = _data("dense")
    seen = []

    class Stop:
        needs_gap = True

        def on_epoch_end(self, rec):
            seen.append(rec)
            return rec["epoch"] >= 2

    ts = Session(data, cfg=EngineConfig.make(**CFG), device="cpu", **kw)
    res = ts.fit(max_epochs=5, tol=0.0, callbacks=[Stop()])
    assert res.epochs == 2 and [r["epoch"] for r in seen] == [1, 2]
    assert all("gap" in r for r in seen) and np.isfinite(res.final_gap)
    res = ts.fit(max_epochs=50, tol=0.5)
    assert res.converged and res.epochs < 52


def test_convert_solver_names():
    cfg = convert.engine_config({"local_solver": "pallas", "lanes": 2})
    assert cfg.algo.local_solver == "kernel" and cfg.deployment.lanes == 2
    assert convert.engine_config(
        {"algo": {"local_solver": "xla"}}).algo.local_solver == "torch"


def test_session_requires_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    data, kw = _data("dense")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(data, cfg=EngineConfig.make(**CFG), **kw)


def test_kernel_solver_on_cpu_raises():
    data, kw = _data("dense")
    ts = Session(data, cfg=EngineConfig.make(**CFG, local_solver="kernel"),
                 device="cpu", **kw)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ts.epoch()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        engine.make_local_solver("kernel", ts.obj, 1.0, 1.0, device="cpu")
    assert engine.resolve_auto_solver("cpu") == "torch"
    assert engine.resolve_auto_solver("cuda") == "kernel"


# a process mesh whose model axis carries slices (dense tensor
# parallelism) was the front door's last unported option (ROADMAP A11,
# then A11b); it is taken now.  The mesh is only described here:
# building the Session runs no collective.
@pytest.mark.parametrize("kw,item", [(
    {"mesh": DistMesh(1, 1, 2, 0, torch.device("cpu"), "gloo", {}),
     "streamed": True,
     "cfg": EngineConfig.make(pods=1, lanes=1, bucket=8,
                              feature_shard=True)}, "A11")])
def test_unported_options_name_their_queue_item(kw, item):
    """The option ROADMAP `item` held is taken: the Session streams this
    rank's model lane of a tensor-parallel worker, its feed gathering
    only the lane's feature rows; its epochs run on 2 processes
    (`tests/test_torch_dist_slices.py`)."""
    data, dkw = _data("dense")
    s = Session(data, device="cpu", **dkw, **kw)
    assert s.mesh_feed.rows == (0, s.d // 2)
    assert s._epoch_fn.schedule.lanes == 1


@pytest.mark.parametrize("knob", ["health", "journal_dir", "faults"])
def test_resilience_options_are_taken(knob, tmp_path):
    """``health=``, ``journal_dir=`` and ``faults=`` (here an empty
    schedule) build the resilience runtime, and a fault-free fit through
    it is bitwise a plain one."""
    data, dkw = _data("dense")
    value = {"health": True, "journal_dir": tmp_path / "j",
             "faults": FaultInjector("")}[knob]
    kw = dict(cfg=EngineConfig.make(**CFG), device="cpu", **dkw)
    plain = Session(data, **kw)
    s = Session(data, **kw, **{knob: value})
    plain.fit(until=2, tol=0)
    res = s.fit(until=2, tol=0)
    assert torch.equal(s.alpha, plain.alpha) and torch.equal(s.v, plain.v)
    assert not res.diverged and s.epochs_done == 2
    if knob == "journal_dir":
        assert json.loads((value / "epoch" / "meta.json").read_text()) == \
            {"epochs_done": 2}
    else:
        assert (s._health if knob == "health" else s._faults) is value


@pytest.mark.parametrize("bad", [-1, 64])
def test_sparse_feature_ids_out_of_range_raise(bad):
    ((idx, val), y), kw = _data("sparse")
    idx = idx.copy()
    idx[3, 2] = bad
    with pytest.raises(ValueError, match=r"feature ids must lie in \[0, d=64\)"):
        Session(((idx, val), y), device="cpu", **kw)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_sim_worker_data_is_what_the_solver_gets(kind, monkeypatch):
    """`engine.sim_worker_data` (which the on-card smoke script feeds to
    the kernels) gives, flattened to workers, exactly the arguments the
    one-chunk epoch hands its local solver.  Exact: pure data movement."""
    data, kw = _data(kind)
    ts = Session(data, cfg=EngineConfig.make(**CFG), device="cpu", **kw)
    ts.epoch()
    W = ts.spec.workers
    _, block, yl, al = engine.sim_worker_data(
        (ts.idx, ts.val) if ts.sparse else ts.X, ts.y, ts.alpha, ts.plan,
        ts.bplan.bucket, ts.epochs_done)
    seen = []
    make = engine.make_local_solver

    def recording(*a, **k):
        solve = make(*a, **k)

        def rec(data, y, al_, v):
            seen.append((data, y, al_, v))
            return solve(data, y, al_, v)
        return rec

    monkeypatch.setattr(engine, "make_local_solver", recording)
    ts.epoch()
    flat = lambda t: t.reshape((W,) + tuple(t.shape[2:]))
    (got, gy, ga, gv), = seen
    want = (tuple(map(flat, (block.idx, block.val))) if ts.sparse
            else (flat(block.X),))
    for g, w in zip(got if ts.sparse else (got,), want):
        assert torch.equal(g, w)
    assert torch.equal(gy, flat(yl)) and torch.equal(ga, flat(al))
