"""The port's solver planner against the reference's `repro.core.planner`.

Mirrors `tests/test_planner.py` where the two packages share a contract:
fingerprints, `$REPRO_PLAN` parsing, the byte and cost models, the
candidate enumeration and its ranking, probes, the plan cache,
`Session` under each mode and `scale_for_dataset`, all compared
exactly (the routes' names mapped through `_names`).  The packages'
predicates differ by design (the reference routes unaligned shapes and
VMEM-sized ones to XLA; the card's kernels take them), so the shared
tables hold only signatures whose every candidate both packages route
to a kernel, and the port's own answers are pinned separately.
Training compares within `tests/test_torch_session.py`'s tolerances.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import Session as JSession                     # noqa: E402
from repro.core import planner as jp                          # noqa: E402
from repro.core.config import EngineConfig as JConfig         # noqa: E402
from repro.data import synthetic as jsynth                    # noqa: E402
from repro.kernels.sdca_sparse_bucket import (                # noqa: E402
    V_VMEM_BUDGET_BYTES)
from repro.launch.glm import scale_for_dataset as j_scale     # noqa: E402
from repro_torch.api import Session                           # noqa: E402
from repro_torch.core import engine                           # noqa: E402
from repro_torch.core import planner as tp                    # noqa: E402
from repro_torch.core.config import EngineConfig              # noqa: E402
from repro_torch.core.objectives import LOGISTIC              # noqa: E402
from repro_torch.data.registry import REGISTRY                # noqa: E402
from repro_torch.kernels import ops as kops                   # noqa: E402
from repro_torch.kernels.contracts import SMEM_OPTIN_BYTES    # noqa: E402
from repro_torch.launch.glm import scale_for_dataset          # noqa: E402

ROUTES = {"pallas-replicated": "kernel", "pallas-sharded": "kernel-sharded",
          "xla": "torch"}
SOLVERS = {"pallas": "kernel", "xla": "torch"}


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_PLAN", raising=False)
    monkeypatch.delenv("REPRO_LOCAL_SOLVER", raising=False)
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))


def _names(plan) -> tuple:
    """A plan's geometry, route and score, the reference's names mapped
    to the port's."""
    return (SOLVERS.get(plan.solver, plan.solver),
            ROUTES.get(plan.route, plan.route), plan.bucket, plan.chunks,
            plan.nnz_multiple, plan.feature_shard, plan.score, plan.origin)


def _topos(backend="cpu", **kw):
    """(port, reference) topologies on the reference's budgets."""
    return (tp.Topology(backend=backend, l2_bytes=V_VMEM_BUDGET_BYTES, **kw),
            jp.Topology(backend=backend, **kw))


def _sigs(fields):
    return tp.WorkloadSignature(**fields), jp.WorkloadSignature(**fields)


def _plan(sig, topo, **kw):
    kw.setdefault("use_cache", False)
    return tp.resolve_plan(sig, topo, **kw)


SIGNATURES = [
    dict(n=4096, d=28),
    dict(n=11_010_048, d=28, name="higgs"),
    dict(n=409_600, d=2000, name="epsilon", density=1.0),
    dict(n=4096, d=1024, nnz=40, sparse=True),
    dict(n=45_088_768, d=1_048_576, nnz=40, sparse=True,
         name="criteo-kaggle-sub"),
    dict(n=360_448, d=16_609_280, nnz=3728, sparse=True, name="webspam",
         streamed=True),
    dict(n=8192, d=64, dtype_bytes=2, streamed=True),
]


@pytest.mark.parametrize("fields", SIGNATURES)
def test_workload_fingerprint_matches_reference(fields):
    t, j = _sigs(fields)
    assert t.fingerprint() == j.fingerprint()


@pytest.mark.parametrize("value", [None, "", "off", "on", "search",
                                   "probe", " Search ", "bogus"])
def test_plan_mode_matches_reference(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("REPRO_PLAN", raising=False)
    else:
        monkeypatch.setenv("REPRO_PLAN", value)
    if value == "bogus":
        for mod in (tp, jp):
            with pytest.raises(ValueError, match="REPRO_PLAN"):
                mod.plan_mode()
    else:
        assert tp.plan_mode() == jp.plan_mode()


@pytest.mark.parametrize("backend,kw", [
    ("cpu", {}), ("tpu", dict(device_count=4, model_lanes=2)),
    ("cpu", dict(pods=2, lanes=16))])
def test_topology_fingerprint_key_format(backend, kw):
    """The reference's key, its total budget read as the card's opt-in
    shared memory."""
    t, _ = _topos(backend, **kw)
    j = jp.Topology(backend=backend, vmem_total_budget=SMEM_OPTIN_BYTES,
                    **kw)
    assert t.fingerprint() == j.fingerprint()
    assert t.v_budget() == j.v_budget()


def test_topology_hopper_defaults_and_detect_on_cpu():
    topo = tp.Topology.detect(EngineConfig.make(pods=2, lanes=4),
                              model_lanes=2, device="cpu")
    assert topo == tp.Topology(backend="cpu", pods=2, lanes=4, model_lanes=2)
    assert topo.workers == 8
    assert topo.v_budget() == tp.L2_BYTES == 50 * 2 ** 20
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.Topology.detect()


STREAM_CASES = [
    (dict(n=65_536, d=28, streamed=True), dict(pods=2, lanes=4), {}),
    (dict(n=65_536, d=2000, streamed=True), dict(lanes=4, model_lanes=4),
     dict(feature_shard=True)),
    (dict(n=65_536, d=1024, nnz=40, sparse=True, streamed=True),
     dict(lanes=8), {}),
    (dict(n=65_536, d=1024, nnz=37, sparse=True, streamed=True),
     dict(lanes=2, model_lanes=4), dict(feature_shard=True, nnz_multiple=8)),
    (dict(n=65_536, d=1024, nnz=37, sparse=True, streamed=True),
     dict(lanes=2, model_lanes=4), dict(feature_shard=True)),
]


@pytest.mark.parametrize("fields,topo_kw,plan_kw", STREAM_CASES)
def test_streamed_transfer_bytes_matches_reference(fields, topo_kw,
                                                   plan_kw):
    (ts, js), (tt, jt) = _sigs(fields), _topos(**topo_kw)
    base = dict(bucket=16, chunks=2, nnz_multiple=0, feature_shard=False)
    base.update(plan_kw)
    tplan = tp.SolverPlan(solver="torch", route="torch", **base)
    jplan = jp.SolverPlan(solver="xla", route="xla", **base)
    assert tp.streamed_transfer_bytes(ts, tt, tplan) == \
        jp.streamed_transfer_bytes(js, jt, jplan)


@pytest.mark.parametrize("fields,topo_kw,plan_kw", STREAM_CASES + [
    (dict(n=65_536, d=1024, nnz=40, sparse=True), dict(lanes=8), {}),
    (dict(n=65_536, d=28), dict(pods=2, lanes=16), {})])
@pytest.mark.parametrize("route", ["pallas-replicated", "pallas-sharded",
                                   "xla"])
@pytest.mark.parametrize("solver", ["pallas", "xla"])
def test_plan_cost_matches_reference(fields, topo_kw, plan_kw, route,
                                     solver, monkeypatch):
    """The score's float, term by term; for streamed signatures with the
    card's bandwidths set to the reference's."""
    monkeypatch.setattr(tp, "HBM_BW", jp._HBM_BW)
    monkeypatch.setattr(tp, "H2D_BW", jp.H2D_BW)
    (ts, js), (tt, jt) = _sigs(fields), _topos(**topo_kw)
    base = dict(bucket=32, chunks=4, nnz_multiple=0, feature_shard=False)
    base.update(plan_kw)
    tplan = tp.SolverPlan(solver=SOLVERS[solver], route=ROUTES[route],
                          **base)
    jplan = jp.SolverPlan(solver=solver, route=route, **base)
    assert tp.plan_cost(ts, tt, tplan) == jp.plan_cost(js, jt, jplan)


# signatures and topologies whose every candidate both packages route
# to a kernel (asserted in the test), so plans must agree exactly
SHARED = [
    (dict(n=4096, d=28), dict(pods=2, lanes=2)),
    (dict(n=65_536, d=64), dict(pods=2, lanes=16)),
    (dict(n=8192, d=1024, nnz=40, sparse=True), dict(lanes=4)),
    (dict(n=8192, d=1024, nnz=8, sparse=True), dict(lanes=2, model_lanes=2)),
    (dict(n=131_072, d=100_000, nnz=16, sparse=True), dict(pods=2, lanes=8)),
]


@pytest.mark.parametrize("fields,topo_kw", SHARED)
def test_candidates_and_search_match_reference(fields, topo_kw):
    (ts, js), (tt, jt) = _sigs(fields), _topos(**topo_kw)
    tc, jc = tp.candidate_plans(ts, tt), jp.candidate_plans(js, jt)
    assert all(c.route == "pallas-replicated" for c in jc)
    assert all(c.route == "kernel" for c in tc)
    assert [_names(c) for c in tc] == [_names(c) for c in jc]
    # the unforced bucket is 1 at these n (the sparse B = 1 is an
    # ALIGNMENT misfit for the reference only)
    assert tp.static_plan(ts, tt).bucket == jp.static_plan(js, jt).bucket
    assert _names(tp.static_plan(ts, tt, bucket=16, chunks=2)) == \
        _names(jp.static_plan(js, jt, bucket=16, chunks=2))
    assert [_names(c) for c in tp.search_plans(ts, tt, top_k=6)] == \
        [_names(c) for c in jp.search_plans(js, jt, top_k=6)]
    assert [_names(c) for c in tp.search_plans(ts, tt, chunks=2)] == \
        [_names(c) for c in jp.search_plans(js, jt, chunks=2)]


@pytest.mark.parametrize("fields,topo_kw", SHARED[:3])
@pytest.mark.parametrize("mode", ["on", "search"])
def test_resolve_plan_matches_reference(fields, topo_kw, mode, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN", mode)
    (ts, js), (tt, jt) = _sigs(fields), _topos(**topo_kw)
    # "on" keeps the geometry a Session fixes; "search" opens it
    kw = dict(bucket=8, chunks=2) if mode == "on" else {}
    t = tp.resolve_plan(ts, tt, use_cache=False, **kw)
    j = jp.resolve_plan(js, jt, use_cache=False, **kw)
    assert _names(t) == _names(j)


@pytest.mark.parametrize("fields,bucket,topo_kw,route,jroute", [
    # unaligned row width and bucket: the reference's ALIGNMENT misfit
    (dict(n=4096, d=1024, nnz=39, sparse=True), 8, {}, "kernel", "xla"),
    (dict(n=4096, d=1024, nnz=40, sparse=True), 12, {}, "kernel", "xla"),
    # v above the reference's 8 MiB on one lane: its VMEM_V misfit; the
    # card keeps v in global memory behind its L2
    (dict(n=4096, d=(8 << 20) // 4 + 8, nnz=8, sparse=True), 8, {},
     "kernel", "xla"),
    # webspam's full width: the reference's VMEM_TOTAL on every kernel;
    # a bucket's stages exceed shared memory, so two lanes shard
    (dict(n=4096, d=16_609_280, nnz=3728, sparse=True), 16,
     dict(model_lanes=2), "kernel-sharded", "xla"),
    (dict(n=4096, d=16_609_280, nnz=3728, sparse=True), 16, {}, "kernel",
     "xla"),
    # dense: any B up to the recursion cap of 512 (the reference pads B)
    (dict(n=8192, d=64), 12, {}, "kernel", "pallas-replicated"),
    (dict(n=8192, d=64), 512, {}, "kernel", "pallas-replicated"),
    (dict(n=8 * 520, d=64), 520, {}, "torch", "xla"),
])
def test_port_routes_where_predicates_differ(fields, bucket, topo_kw, route,
                                             jroute):
    sig = tp.WorkloadSignature(**fields)
    topo = tp.Topology(backend="cuda", **topo_kw)
    plan = _plan(sig, topo, bucket=bucket, chunks=1)
    assert plan.route == route
    assert plan.solver == ("torch" if route == "torch" else "kernel")
    if sig.sparse:
        want = kops.sparse_solver_plan(bucket, sig.nnz, sig.d, bucket,
                                       model_lanes=topo.model_lanes)
        assert tp.route_sparse(bucket, sig.nnz, sig.d, bucket,
                               model_lanes=topo.model_lanes) == want
        assert plan.route == want[0]
    else:
        want = kops.dense_kernel_misfit(sig.d, bucket, bucket)
        assert tp.route_dense(sig.d, bucket, bucket) == want
        if route == "torch":
            assert plan.reason == want and plan.reason_code == want.code
    jplan = jp.resolve_plan(jp.WorkloadSignature(**fields),
                            jp.Topology(backend="tpu", **topo_kw),
                            bucket=bucket, chunks=1, use_cache=False)
    assert jplan.route == jroute


def test_backend_picks_solver():
    sig = tp.WorkloadSignature(n=4096, d=1024, nnz=40, sparse=True)
    card = _plan(sig, tp.Topology(backend="cuda"), bucket=8, chunks=1)
    cpu = _plan(sig, tp.Topology(backend="cpu"), bucket=8, chunks=1)
    assert (card.solver, card.route) == ("kernel", "kernel")
    assert (cpu.solver, cpu.route) == ("torch", "kernel")


D_V_FIT = V_VMEM_BUDGET_BYTES // 4


@pytest.mark.parametrize("fields", [
    dict(n=1, d=D_V_FIT, nnz=8, sparse=True),
    dict(n=1, d=D_V_FIT + 8, nnz=8, sparse=True),
    dict(n=1, d=D_V_FIT + 1, nnz=8, sparse=True),
    dict(n=1, d=511), dict(n=1, d=512)])
def test_feature_shard_default_at_reference_budget(fields):
    (ts, js), (tt, _) = _sigs(fields), _topos()
    assert tp.feature_shard_default(ts, tt) == jp.feature_shard_default(js)


def test_feature_shard_default_hopper_budget():
    fit = tp.L2_BYTES // 4
    sparse = lambda d: tp.WorkloadSignature(n=1, d=d, nnz=8, sparse=True)
    assert not tp.feature_shard_default(sparse(fit))
    assert tp.feature_shard_default(sparse(fit + 8))
    # every registry dataset, sub and full, keeps the reference's layout
    layout = {}
    for name, spec in REGISTRY.items():
        for n, d, nnz in ((spec.full_n, spec.full_d, spec.nnz),
                          (spec.sub_n, spec.sub_d, spec.sub_nnz)):
            f = dict(n=n, d=d, nnz=nnz, sparse=spec.kind == "sparse")
            t, j = _sigs(f)
            assert tp.feature_shard_default(t) == \
                jp.feature_shard_default(j), (name, f)
        layout[name] = tp.feature_shard_default(
            tp.WorkloadSignature(n=spec.full_n, d=spec.full_d,
                                 nnz=spec.nnz,
                                 sparse=spec.kind == "sparse"))
    # webspam's 16.6M f32 features (66 MB) exceed the 50 MB L2; criteo's
    # 1M (4 MB) do not; epsilon is TP-wide
    assert layout["webspam"] and layout["epsilon"]
    assert not layout["criteo-kaggle-sub"] and not layout["higgs"]


# -- probes -----------------------------------------------------------------


def _probe(seen, fail_first=False):
    def probe(plan):
        seen.append((plan.bucket, plan.chunks))
        if fail_first and len(seen) == 1:
            raise RuntimeError("first candidate crashes")
        return 0.5 / plan.bucket + 0.01 * plan.chunks
    return probe


def test_probe_fastest_wins_as_in_reference(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN", "probe")
    (ts, js), (tt, jt) = _sigs(dict(n=8192, d=1024, nnz=40, sparse=True)), \
        _topos(lanes=4)
    t_seen, j_seen = [], []
    t = tp.resolve_plan(ts, tt, probe_fn=_probe(t_seen), use_cache=False)
    j = jp.resolve_plan(js, jt, probe_fn=_probe(j_seen), use_cache=False)
    assert t_seen == j_seen and len(t_seen) == 3
    assert _names(t) == _names(j) and t.origin == "probe"
    assert t.probe_s == min(0.5 / b + 0.01 * c for b, c in t_seen)


def test_failing_probe_skipped_on_cpu():
    sig = tp.WorkloadSignature(n=8192, d=1024, nnz=40, sparse=True)
    topo = tp.Topology(backend="cpu", lanes=4)
    ranked = tp.search_plans(sig, topo)
    seen = []
    with pytest.warns(UserWarning, match="probe failed"):
        best = tp.probe_plans(ranked, _probe(seen, fail_first=True),
                              topo=topo)
    assert (best.bucket, best.chunks) != seen[0]
    assert best.probe_s == min(0.5 / b + 0.01 * c for b, c in seen[1:])


def test_failing_probe_propagates_on_cuda(monkeypatch):
    """On a CUDA topology a probe runs the kernels: what it raises is
    never skipped, and resolve_plan does not degrade it to a static
    plan."""
    sig = tp.WorkloadSignature(n=8192, d=1024, nnz=40, sparse=True)
    topo = tp.Topology(backend="cuda", lanes=4)
    ranked = tp.search_plans(sig, topo)
    assert ranked[0].solver == "kernel"
    with pytest.raises(RuntimeError, match="first candidate crashes"):
        tp.probe_plans(ranked, _probe([], fail_first=True), topo=topo)
    monkeypatch.setenv("REPRO_PLAN", "probe")
    with pytest.raises(RuntimeError, match="first candidate crashes"):
        tp.resolve_plan(sig, topo, probe_fn=_probe([], fail_first=True),
                        use_cache=False)


# -- the plan cache -----------------------------------------------------------


def _unit(**kw):
    return tp.WorkloadSignature(**{**dict(n=4096, d=1024, nnz=40,
                                          sparse=True, name="unit"), **kw})


CARD = tp.Topology(backend="cuda")


def test_plan_cache_roundtrip(tmp_path):
    sig = _unit()
    plan = tp.static_plan(sig, CARD, bucket=8, chunks=2)
    path = tp.store_plan(sig, CARD, plan, cache_dir=tmp_path)
    assert path.parent == tmp_path / "plans_torch"
    got = tp.load_cached_plan(sig, CARD, cache_dir=tmp_path)
    assert got is not None and got.origin == "cache"
    assert dataclasses.replace(got, origin=plan.origin) == plan
    assert tp.load_cached_plan(sig, tp.Topology(backend="cuda",
                                                model_lanes=2),
                               cache_dir=tmp_path) is None
    assert tp.load_cached_plan(_unit(d=2048), CARD,
                               cache_dir=tmp_path) is None


def test_plan_cache_version_bump_invalidates(tmp_path, monkeypatch):
    sig = _unit()
    plan = tp.static_plan(sig, CARD, bucket=8, chunks=2)
    path = tp.store_plan(sig, CARD, plan, cache_dir=tmp_path)
    monkeypatch.setattr(tp, "PLAN_VERSION", tp.PLAN_VERSION + 1)
    assert tp.load_cached_plan(sig, CARD, cache_dir=tmp_path) is None
    monkeypatch.undo()
    doc = json.loads(path.read_text())
    doc["version"] = tp.PLAN_VERSION + 1
    path.write_text(json.dumps(doc))
    assert tp.load_cached_plan(sig, CARD, cache_dir=tmp_path) is None
    path.write_text("{not json")
    assert tp.load_cached_plan(sig, CARD, cache_dir=tmp_path) is None


def test_search_caches_and_rehits(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN", "search")
    sig = _unit()
    first = tp.resolve_plan(sig, CARD, cache_dir=tmp_path)
    assert first.origin == "search"
    again = tp.resolve_plan(sig, CARD, cache_dir=tmp_path)
    assert again.origin == "cache"
    assert dataclasses.replace(again, origin="x") == \
        dataclasses.replace(first, origin="x")


def test_plan_off_never_touches_disk(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN", "off")
    tp.resolve_plan(_unit(), CARD, cache_dir=tmp_path / "nope")
    assert not (tmp_path / "nope").exists()


def test_cached_plan_rechecks_feasibility(tmp_path):
    """A cached kernel plan the predicates no longer accept is ignored:
    a dense bucket past the recursion cap, and a sharded route on a
    topology whose single lane takes the replicated kernel."""
    dense = tp.WorkloadSignature(n=8192, d=64, name="unit")
    good = tp.static_plan(dense, CARD, bucket=512, chunks=1)
    assert (good.solver, good.route) == ("kernel", "kernel")
    tp.store_plan(dense, CARD, dataclasses.replace(good, bucket=520),
                  cache_dir=tmp_path)
    assert tp.load_cached_plan(dense, CARD, cache_dir=tmp_path) is None
    sig = _unit()
    plan = tp.static_plan(sig, CARD, bucket=8, chunks=1)
    tp.store_plan(sig, CARD, dataclasses.replace(plan, route="kernel-sharded"),
                  cache_dir=tmp_path)
    assert tp.load_cached_plan(sig, CARD, cache_dir=tmp_path) is None


def test_resolve_plan_degrades_warn_and_safe(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("cache exploded")
    monkeypatch.setattr(tp, "load_cached_plan", boom)
    with pytest.warns(UserWarning, match="falling"):
        plan = tp.resolve_plan(_unit(), CARD, bucket=8, chunks=2)
    assert plan.origin == "static" and (plan.bucket, plan.chunks) == (8, 2)


def test_shared_cache_dir_keeps_both_packages_plans(tmp_path, monkeypatch):
    """One $REPRO_CACHE_DIR for both packages: each writes its own
    directory under its own magic, and each re-reads its own plan."""
    monkeypatch.setenv("REPRO_PLAN", "search")
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    fields = dict(n=8192, d=1024, nnz=40, sparse=True, name="shared")
    (ts, js), (tt, jt) = _sigs(fields), _topos(lanes=4)
    j1 = jp.resolve_plan(js, jt)
    t1 = tp.resolve_plan(ts, tt)
    files = {p.relative_to(tmp_path).parts[0]: p.read_bytes()
             for p in tmp_path.rglob("*.json")}
    assert sorted(files) == ["plans", "plans_torch"]
    t2 = tp.resolve_plan(ts, tt)
    j2 = jp.resolve_plan(js, jt)
    assert (t2.origin, j2.origin) == ("cache", "cache")
    assert _names(dataclasses.replace(t2, origin="x")) == \
        _names(dataclasses.replace(t1, origin="x"))
    assert _names(dataclasses.replace(j2, origin="x")) == \
        _names(dataclasses.replace(j1, origin="x"))
    assert {p.relative_to(tmp_path).parts[0]: p.read_bytes()
            for p in tmp_path.rglob("*.json")} == files


# -- Session ------------------------------------------------------------------

CFG = dict(pods=2, lanes=2)


def _arrays(kind, n=1000):
    if kind == "dense":
        X, y = jsynth.make_dense_classification(n=n, d=16, seed=5)
        return (X, y), {}
    (idx, val), y, d = jsynth.make_sparse_classification(
        n=n, d=128, nnz=8, seed=6, skew=1.0)
    return ((idx, val), y), {"d": d}


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_session_planner_on_equals_off(kind, monkeypatch):
    data, kw = _arrays(kind)

    def run(mode):
        if mode is None:
            monkeypatch.delenv("REPRO_PLAN", raising=False)
        else:
            monkeypatch.setenv("REPRO_PLAN", mode)
        s = Session(data, cfg=EngineConfig.make(**CFG, bucket=8),
                    device="cpu", **kw)
        states = []
        for _ in range(3):
            s.epoch()
            states.append((s.alpha.clone(), s.v.clone()))
        return s, states

    (on, s_on), (off, s_off) = run(None), run("off")
    assert off.solver_plan is None
    assert on.solver_plan is not None and on.solver_plan.origin == "static"
    assert (on.solver_plan.solver, on.solver_plan.bucket) == ("torch", 8)
    assert (on.n, on.bplan.bucket, on.spec) == (off.n, off.bplan.bucket,
                                                off.spec)
    for (a1, v1), (a2, v2) in zip(s_on, s_off):
        assert torch.equal(a1, a2) and torch.equal(v1, v2)


def test_session_search_sets_reference_geometry(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN", "search")
    data, kw = _arrays("dense", n=4096)
    js = JSession(data, objective="logistic", cfg=JConfig.make(**CFG), **kw)
    ts = Session(data, objective="logistic", cfg=EngineConfig.make(**CFG),
                 device="cpu", **kw)
    assert ts.solver_plan.origin == js.solver_plan.origin == "search"
    assert _names(ts.solver_plan) == _names(js.solver_plan)
    geom = lambda s: (s.n, s.lam, s.bplan.bucket, s.bplan.n_buckets,
                      s.spec.algo.chunks)
    assert geom(ts) == geom(js) and ts.bplan.bucket > 1
    for _ in range(3):
        js.epoch()
        ts.epoch()
    np.testing.assert_allclose(ts.alpha.numpy(), np.asarray(js.alpha),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v),
                               rtol=1e-4, atol=1e-5)
    jg, tg = js.gap(), ts.gap()
    assert abs(tg - jg) <= 1e-3 * abs(jg), (tg, jg)
    pinned = Session(data, cfg=EngineConfig.make(**CFG), bucket=8,
                     device="cpu", **kw)
    assert pinned.bplan.bucket == 8 and pinned.spec.algo.chunks == 1
    assert pinned.solver_plan.bucket == 8


def test_session_search_open_sparse_geometry(monkeypatch):
    """Sparse arrays under search: the plan's bucket and chunks are the
    session's, n is padded to their multiple, and the epoch trains."""
    monkeypatch.setenv("REPRO_PLAN", "search")
    data, kw = _arrays("sparse", n=4000)
    s = Session(data, cfg=EngineConfig.make(**CFG), device="cpu", **kw)
    plan = s.solver_plan
    assert (s.bplan.bucket, s.spec.algo.chunks) == (plan.bucket, plan.chunks)
    assert s.n % (2 * 2 * 2 * plan.chunks * plan.bucket) == 0
    s.epoch()
    assert np.isfinite(s.gap())


# -- consumers ------------------------------------------------------------------

DATASETS = ["criteo-kaggle-sub", "higgs", "epsilon", "webspam",
            "synthetic-dense", "synthetic-sparse"]


@pytest.mark.parametrize("mode", ["off", None])
def test_scale_for_dataset_matches_reference(mode, monkeypatch):
    if mode is not None:
        monkeypatch.setenv("REPRO_PLAN", mode)
    for name in DATASETS:
        t = dataclasses.asdict(scale_for_dataset(name, device="cpu"))
        j = dataclasses.asdict(j_scale(name))
        assert j.pop("local_solver") == t.pop("local_solver") == "auto"
        assert t == j, name


def test_scale_for_dataset_search_and_overrides(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN", "search")
    assert scale_for_dataset("webspam", device="cpu").feature_shard
    got = scale_for_dataset("webspam", device="cpu", bucket=32, chunks=2,
                            feature_shard=False)
    assert (got.bucket, got.chunks, got.feature_shard) == (32, 2, False)
    higgs = scale_for_dataset("higgs", device="cpu")
    assert higgs.bucket in tp.BUCKET_CANDIDATES
    assert higgs.chunks in tp.CHUNK_CANDIDATES


def test_ops_plan_solver_entry(tmp_path, monkeypatch):
    plan = kops.plan_solver(4096, 1024, nnz=40, sparse=True, bucket=8,
                            chunks=2, cache_dir=tmp_path, device="cpu")
    assert isinstance(plan, tp.SolverPlan)
    assert (plan.bucket, plan.chunks, plan.solver) == (8, 2, "torch")
    # a deployment's workers rank the sync interval: one worker (the
    # reference's door) prefers one chunk, 2 x 16 more of them
    monkeypatch.setenv("REPRO_PLAN", "search")
    for spec, chunks in ((None, 1), (EngineConfig.make(pods=2, lanes=16),
                                     8)):
        got = kops.plan_solver(4_194_304, 28, spec=spec, cache_dir=tmp_path,
                               device="cpu")
        assert got.chunks == chunks


@pytest.mark.parametrize("sparse", [False, True])
def test_engine_misfit_goes_through_planner_and_raises(sparse, monkeypatch):
    """The kernel solvers' misfit checks are `planner.route_*`; a misfit
    raises before anything launches (no reroute to the plain version)."""
    seen = []
    why = kops.Misfit(kops.MisfitCode.BUCKET_CAP, "stand-in misfit")

    def dense(*a):
        seen.append(a)
        return why

    def sparse_route(*a, **k):
        seen.append(a)
        return "torch", why

    monkeypatch.setattr(tp, "route_dense", dense)
    monkeypatch.setattr(tp, "route_sparse", sparse_route)
    W, n, d = 2, 16, 12
    y, a = torch.ones(W, n), torch.zeros(W, n)
    v = torch.zeros(W, d)
    if sparse:
        data = (torch.zeros(W, n, 4, dtype=torch.int32), torch.ones(W, n, 4))
        solve = engine.sparse_sharded_kernel_solver(LOGISTIC, 1.0, 2.0, 8, 2)
    else:
        data = torch.ones(W, d, n)
        solve = engine.dense_kernel_solver(LOGISTIC, 1.0, 2.0, 8)
    with pytest.raises(ValueError, match="BUCKET_CAP"):
        solve(data, y, a, v)
    assert len(seen) == 1
