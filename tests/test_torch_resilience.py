"""The port's resilience runtime (`repro_torch.resilience`) on the CPU:
deterministic fault injection, crash-safe streamed epochs, typed
corruption recovery and the health rollback.

Against itself, every recovery path must end BITWISE where an
uninterrupted run ends (`torch.equal` on alpha and v): schedules are
pure functions of (seed, epoch), and every recovery resumes from an
exact snapshot.  Against the reference (`repro.resilience`, its XLA
route on the CPU, planner off):
  * schedules parse to the same `FaultSpec`s and fire in the same order;
  * `apply_disk_faults` flips the same bytes of one cache;
  * a faulted run writes the same event-log lines, once the reference's
    solver names are mapped to the port's (`convert.SOLVER_NAMES`);
  * journals cross packages both ways: the records read back with the
    writer's bits, and a port fit resumed from a reference journal ends
    within rtol 1e-4 / atol 1e-5 of the reference's uninterrupted fit,
    its gap within rel 1e-3 (tests/test_torch_streamed.py's tolerances).
Every cache and journal goes under `tmp_path`.
"""
import dataclasses
import types
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import HealthMonitor as JMonitor              # noqa: E402
from repro.api import HealthPolicy as JPolicy                # noqa: E402
from repro.api import Session as JSession                    # noqa: E402
from repro.core.config import EngineConfig as JConfig        # noqa: E402
from repro.data import registry as jreg                      # noqa: E402
from repro.resilience import EpochJournal as JJournal        # noqa: E402
from repro.resilience import FaultInjector as JInjector      # noqa: E402
from repro.resilience import SimulatedCrash as JCrash        # noqa: E402
from repro.resilience import parse_schedule as jparse        # noqa: E402
from repro_torch.api import (HealthMonitor, HealthPolicy,     # noqa: E402
                             LogisticRegression, Session)
from repro_torch.convert import SOLVER_NAMES                 # noqa: E402
from repro_torch.core import engine                          # noqa: E402
from repro_torch.core.config import EngineConfig             # noqa: E402
from repro_torch.core.objectives import get_objective        # noqa: E402
from repro_torch.core.trainer import StreamedGLMTrainer      # noqa: E402
from repro_torch.data import (make_dense_classification,     # noqa: E402
                              make_sparse_classification, registry)
from repro_torch.data.cache import TileCorruptionError       # noqa: E402
from repro_torch.launch.mesh import make_host_mesh             # noqa: E402
from repro_torch.data.formats import \
    raise_on_duplicate_nonzeros                               # noqa: E402
from repro_torch.resilience import (EpochJournal,             # noqa: E402
                                    FaultInjectedIOError, FaultInjector,
                                    FaultyFeed, KernelBuildError,
                                    ResilientChunkFeed, SimulatedCrash,
                                    parse_schedule)

CPU = dict(device="cpu")
TOPO = dict(bucket=8, partition="hierarchical", deterministic=True)
CFG = EngineConfig.make(pods=2, lanes=2, chunks=4, local_solver="torch",
                        **TOPO)
RES_CFG = EngineConfig.make(pods=1, lanes=2, chunks=2, local_solver="torch",
                            **TOPO)
JCFG = JConfig.make(pods=2, lanes=2, chunks=4, local_solver="xla", **TOPO)
EPOCHS = 3
KINDS = ["dense", "sparse"]
SCHEDULES = ["fetch-error@n3x2; kill@e1c2; flip-tile@t5",
             "kill@e1;kill@e2c1;nan-chunk@n2x3;kernel-fail@x2",
             "nan-epoch@e1;flip-tile@t7:val;fetch-error@n1x5"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("REPRO_FAULTS", "REPRO_SEED", "REPRO_FAULT_LOG",
                "REPRO_LOCAL_SOLVER"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("REPRO_PLAN", "off")


def _maker(kind, root, reg=registry):
    """Cache (re)builder for one synthetic dataset; builds are
    byte-stable, so a rebuild after quarantine equals the original."""
    def mk():
        return reg.materialize(f"synthetic-{kind}", root, bucket=8, pods=2,
                               n=512, d=64, pad_multiple=256)
    return mk


def _resident_source(kind):
    if kind == "dense":
        X, y = make_dense_classification(n=256, d=32, seed=0)
        return dict(data=(X, y))
    (idx, val), y, d = make_sparse_classification(n=256, d=64, nnz=8,
                                                  seed=1)
    return dict(data=((idx, val), y), d=d)


def _resident_kw(kind):
    src = _resident_source(kind)
    return src.pop("data"), dict(cfg=RES_CFG, lam=1e-3,
                                 objective="logistic", **src, **CPU)


def _fit(source, *, cfg=CFG, until=EPOCHS, **kw):
    s = Session(source, cfg=cfg, lam=1e-3, objective="logistic", **CPU,
                **kw)
    res = s.fit(until=until, tol=0)
    return s, res


def _equal(s, ref):
    assert torch.equal(s.v, ref.v) and torch.equal(s.alpha, ref.alpha)


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """clean(kind) / clean(kind, resident=True): the uninterrupted run's
    final state (alpha, v as attributes), computed once per module."""
    runs = {}

    def get(kind, resident=False):
        key = (kind, resident)
        if key not in runs:
            if resident:
                data, kw = _resident_kw(kind)
                s = Session(data, **kw)
                s.fit(until=EPOCHS, tol=0)
            else:
                root = tmp_path_factory.mktemp(f"clean-{kind}")
                s, _ = _fit(_maker(kind, root)(), streamed=True)
            runs[key] = types.SimpleNamespace(alpha=s.alpha, v=s.v)
        return runs[key]
    return get


def _jfit(source, *, until=EPOCHS, **kw):
    s = JSession(source, cfg=JCFG, lam=1e-3, objective="logistic", **kw)
    s.fit(until=until, tol=0)
    return s


def _log(path):
    return path.read_text().splitlines() if path.exists() else []


def _port_names(line: str) -> str:
    """A reference event-log line with its solver names the port's."""
    e = json.loads(line)
    if str(e.get("action", "")).startswith("fallback:"):
        e["action"] = "fallback:" + SOLVER_NAMES[e["action"][9:]]
    return json.dumps(e, sort_keys=True)


# -- fault grammar ----------------------------------------------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedules_parse_and_fire_as_the_reference(schedule):
    """Same FaultSpecs, and the same probe sequence fires the same
    faults in the same order."""
    specs, jspecs = parse_schedule(schedule), jparse(schedule)
    assert [dataclasses.asdict(s) for s in specs] == \
        [dataclasses.asdict(s) for s in jspecs]

    def drive(inj):
        fired = []
        for epoch in range(3):
            for probe in (lambda: inj.maybe_kill(epoch),
                          lambda: inj.maybe_kernel_fail(epoch),
                          lambda: fired.append(
                              ("nan-epoch", inj.nan_epoch(epoch)))):
                try:
                    probe()
                except BaseException as e:     # kills are BaseException
                    fired.append((epoch, type(e).__name__))
            for c in range(4):
                try:
                    inj.maybe_kill(epoch, c)
                    fired.append(("fetch", inj.on_fetch()))
                except BaseException as e:
                    fired.append((epoch, c, type(e).__name__))
        return fired

    assert drive(FaultInjector(schedule)) == drive(JInjector(schedule))


def test_grammar_rejects_unknown_kinds_and_tokens():
    for bad in ("melt-cpu@e1", "kill@q9", "kill@e1zz"):
        with pytest.raises(ValueError):
            parse_schedule(bad)


def test_injector_from_env_is_none_when_unset():
    """No $REPRO_FAULTS: no injector, no journal on a default Session."""
    assert FaultInjector.from_env() is None
    data, kw = _resident_kw("dense")
    s = Session(data, **kw)
    assert s._faults is None and s._journal is None


def test_fault_types():
    assert issubclass(FaultInjectedIOError, OSError)
    assert not issubclass(SimulatedCrash, Exception)
    assert issubclass(KernelBuildError, RuntimeError)
    assert not issubclass(TileCorruptionError, OSError)   # not transient


# -- tile corruption: quarantine, bitwise rebuild ---------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_disk_faults_flip_the_reference_bytes(tmp_path, kind):
    """One cache, copied; the same schedule and seed flip the same byte
    of the same tile in both packages."""
    cache = _maker(kind, tmp_path / "c")()
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    import shutil
    shutil.copytree(cache.path, ours)
    shutil.copytree(cache.path, theirs)
    schedule = "flip-tile@t5;flip-tile@t2:y"
    assert FaultInjector(schedule, seed=7).apply_disk_faults(ours) == 2
    assert JInjector(schedule, seed=7).apply_disk_faults(theirs) == 2
    changed = [f.name for f in sorted(cache.path.glob("*.bin"))
               if f.read_bytes() != (ours / f.name).read_bytes()]
    assert len(changed) == 2
    for f in sorted(cache.path.glob("*.bin")):
        assert (ours / f.name).read_bytes() == \
            (theirs / f.name).read_bytes()


@pytest.mark.parametrize("kind", KINDS)
def test_corruption_quarantine_rebuild_bitwise(tmp_path, kind, clean):
    """The rebuilt cache is byte-identical to a clean build (so a sparse
    one keeps the CSR invariant), and training ends bitwise a clean
    run's."""
    mk = _maker(kind, tmp_path)
    ref = clean(kind)
    clean = {f.name: f.read_bytes() for f in mk().path.glob("*.bin")}
    FaultInjector("flip-tile@t5", seed=7).apply_disk_faults(mk().path)
    feed = ResilientChunkFeed(mk().feed(verify=True, **CPU), rebuild=mk,
                              sleep=lambda t: None)
    s, _ = _fit(feed)
    _equal(s, ref)
    assert list(tmp_path.glob(".quarantine.*")), \
        "the corrupt cache dir is kept for forensics"
    rebuilt = mk()
    rebuilt.verify_tiles()
    assert {f.name: f.read_bytes()
            for f in rebuilt.path.glob("*.bin")} == clean
    assert feed.device == torch.device("cpu") and feed.feed.verify
    if kind == "sparse":
        raise_on_duplicate_nonzeros(
            np.asarray(rebuilt.arrays["idx"]).reshape(-1, rebuilt.meta.nnz),
            np.asarray(rebuilt.arrays["val"]).reshape(-1, rebuilt.meta.nnz),
            "rebuilt tiles")


def test_corruption_without_rebuilder_raises(tmp_path):
    mk = _maker("dense", tmp_path)
    FaultInjector("flip-tile@t2", seed=7).apply_disk_faults(mk().path)
    feed = ResilientChunkFeed(mk().feed(verify=True, **CPU))
    with pytest.raises(TileCorruptionError):
        _fit(feed)


# -- crash-safe epochs: kill mid-epoch / at an epoch boundary, resume -------

@pytest.mark.parametrize("kind", KINDS)
def test_kill_and_resume_streamed_bitwise(tmp_path, kind, clean):
    """A kill between chunk 1 and 2 of epoch 1: a fresh Session resumes
    from the journal at the chunk boundary and ends bitwise the
    uninterrupted run."""
    mk = _maker(kind, tmp_path / "c")
    ref = clean(kind)
    jd = tmp_path / "journal"
    with pytest.raises(SimulatedCrash):
        _fit(mk(), streamed=True, journal_dir=jd,
             faults=FaultInjector("kill@e1c2"))
    s2 = Session(mk(), cfg=CFG, lam=1e-3, objective="logistic",
                 streamed=True, journal_dir=jd, **CPU)
    assert s2.epochs_done == 1                 # epoch 0 was committed
    stats = {}
    s2.epoch(stats=stats)
    assert stats["chunks"] == CFG.algo.chunks - 2   # resumed at chunk 2
    s2.fit(until=EPOCHS, tol=0)
    _equal(s2, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_kill_and_resume_resident_bitwise(tmp_path, kind, clean):
    """An epoch-boundary kill on the resident path: the committed-epoch
    record alone resumes bitwise."""
    data, kw = _resident_kw(kind)
    ref = clean(kind, resident=True)
    jd = tmp_path / "journal"
    crashing = Session(data, **kw, journal_dir=jd,
                       faults=FaultInjector("kill@e2"))
    with pytest.raises(SimulatedCrash):
        crashing.fit(until=EPOCHS, tol=0)
    resumed = Session(data, **kw, journal_dir=jd)
    assert resumed.epochs_done == 2
    resumed.fit(until=EPOCHS, tol=0)
    _equal(resumed, ref)


def test_faults_env_arms_the_port_and_logs_stable_lines(tmp_path,
                                                        fault_env):
    """$REPRO_FAULTS arms the Session, and the event log is sorted-key,
    timestamp-free JSON lines."""
    log = fault_env("kill@e1c1")
    mk = _maker("dense", tmp_path / "c")
    jd = tmp_path / "journal"
    with pytest.raises(SimulatedCrash):
        _fit(mk(), streamed=True, journal_dir=jd)
    lines = _log(log)
    events = [json.loads(ln) for ln in lines]
    names = [e["event"] for e in events]
    assert "journal.chunk" in names and "inject.kill" in names
    for raw, e in zip(lines, events):
        assert raw == json.dumps(e, sort_keys=True)
        assert "time" not in e and "timestamp" not in e


# -- transient I/O errors: retry with backoff -------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_retry_after_transient_bitwise(tmp_path, kind, clean):
    mk = _maker(kind, tmp_path)
    ref = clean(kind)
    delays = []
    feed = ResilientChunkFeed(
        FaultyFeed(mk().feed(**CPU), FaultInjector("fetch-error@n3x2")),
        retries=3, backoff=0.01, sleep=delays.append)
    s, _ = _fit(feed)
    _equal(s, ref)
    assert delays == [0.01, 0.02]              # capped exponential


def test_retry_with_a_timeout_thread_bitwise(tmp_path, clean):
    """``timeout=`` runs each fetch on a worker thread; a clean run
    through it ends bitwise the direct one."""
    mk = _maker("dense", tmp_path)
    ref = clean("dense")
    feed = ResilientChunkFeed(
        FaultyFeed(mk().feed(**CPU), FaultInjector("fetch-error@n2")),
        timeout=60.0, sleep=lambda t: None)
    s, _ = _fit(feed)
    _equal(s, ref)
    assert feed._pool is not None


def test_transient_retries_exhausted_raises(tmp_path):
    mk = _maker("dense", tmp_path)
    feed = ResilientChunkFeed(
        FaultyFeed(mk().feed(**CPU), FaultInjector("fetch-error@n1x5")),
        retries=2, sleep=lambda t: None)
    with pytest.raises(FaultInjectedIOError):
        _fit(feed)


# -- numerical health: rollback + remediate ---------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_nan_chunk_rollback_streamed_bitwise(tmp_path, kind, clean):
    """A NaN-poisoned chunk trips the guard at epoch end; it rolls back
    to the last healthy snapshot and the retry (the fault is one-shot)
    ends bitwise the clean run."""
    mk = _maker(kind, tmp_path)
    ref = clean(kind)
    monitor = HealthMonitor(HealthPolicy(retries=1))
    s, res = _fit(FaultyFeed(mk().feed(**CPU), FaultInjector("nan-chunk@n6")),
                  health=monitor)
    _equal(s, ref)
    assert not res.diverged and monitor.trips == 1
    assert "non-finite" in monitor.events[0]["reason"]
    assert [r.get("health") for r in res.history].count(
        monitor.events[0]) == 1


@pytest.mark.parametrize("kind", KINDS)
def test_nan_epoch_rollback_resident_bitwise(kind, clean):
    data, kw = _resident_kw(kind)
    ref = clean(kind, resident=True)
    monitor = HealthMonitor(HealthPolicy(retries=1))
    s = Session(data, **kw, faults=FaultInjector("nan-epoch@e1"))
    res = s.fit(until=EPOCHS, tol=0, health=monitor)
    _equal(s, ref)
    assert not res.diverged and monitor.trips == 1


def test_rollback_is_a_copy(tmp_path):
    """The snapshot and the restored state share no memory with the
    session: writing the session's tensors in place after a snapshot
    (and after a rollback) leaves the rollback's bits intact."""
    data, kw = _resident_kw("dense")
    s = Session(data, **kw)
    s.fit(until=1, tol=0)
    monitor = HealthMonitor(HealthPolicy(retries=5))
    monitor.bind(s)
    a1, v1 = s.alpha.clone(), s.v.clone()
    s.alpha.fill_(7.0)                 # in place, as a streamed step does
    s.v.mul_(float("nan"))
    s.epochs_done += 1
    assert monitor.on_epoch_end({"rel_change": 1.0}) is False
    assert torch.equal(s.alpha, a1) and torch.equal(s.v, v1)
    s.alpha.fill_(3.0)                 # the restored tensors are fresh
    s.v.fill_(float("inf"))
    s.epochs_done += 1
    monitor.on_epoch_end({"rel_change": 1.0})
    assert torch.equal(s.alpha, a1) and torch.equal(s.v, v1)
    assert monitor.trips == 2 and s.epochs_done == 1


def test_health_gives_up_past_max_trips():
    """A fault that fires every epoch spends the policy; fit reports
    divergence instead of looping forever."""
    data, kw = _resident_kw("dense")
    monitor = HealthMonitor(HealthPolicy(retries=0, remedy="fallback",
                                         max_trips=2))
    s = Session(data, **kw, faults=FaultInjector("nan-epoch@x99"))
    res = s.fit(until=EPOCHS, tol=0, health=monitor)
    assert monitor.gave_up and res.diverged
    assert monitor.events[-1]["action"] == "give-up"


def test_health_policy_validates_remedy():
    with pytest.raises(ValueError):
        HealthPolicy(remedy="reboot")
    assert HealthPolicy() == HealthPolicy(
        diverge_above=1e8, divergence_streak=3, retries=1,
        remedy="fallback", damp_factor=0.5, max_trips=5, snapshot_every=1)


@pytest.mark.parametrize("kind", KINDS)
def test_damped_streamed_equals_damped_resident(tmp_path, kind):
    """The "damp" remedy's dv_scale multiplier: a damped streamed epoch
    is bitwise the damped resident one, and differs from an undamped
    one."""
    cache = _maker(kind, tmp_path)()
    mem = Session(cache, cfg=CFG, **CPU)
    st = Session(cache, cfg=CFG, streamed=True, **CPU)
    plain = Session(cache, cfg=CFG, streamed=True, **CPU)
    for s in (mem, st):
        s._damp = 0.5
        s._rebuild_epoch_fn()
    for _ in range(2):
        for s in (mem, st, plain):
            s.epoch()
    _equal(mem, st)
    assert not torch.equal(st.v, plain.v)


def test_damp_remedy_rebuilds_the_epoch():
    data, kw = _resident_kw("dense")
    monitor = HealthMonitor(HealthPolicy(retries=0, remedy="damp"))
    s = Session(data, **kw, faults=FaultInjector("nan-epoch@e1"))
    s.fit(until=EPOCHS, tol=0, health=monitor)
    assert s._damp == 0.5 and monitor.events[0]["action"] == "damp:0.5"
    assert s.epochs_done == EPOCHS


# -- kernel failures: retry, then fall back to the plain solver -------------

def test_auto_kernel_fail_falls_back_to_torch(tmp_path, monkeypatch, clean):
    """kernel-fail keys on the configured name: "auto" fires it on the
    CPU too, so a persistent failure spends the retry and the fallback
    reroutes to "torch", which ends bitwise a straight "torch" run.
    The fallback shows in the events, in an epoch record and in the
    event log."""
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("REPRO_FAULT_LOG", str(log))
    mk = _maker("dense", tmp_path / "c")
    ref = clean("dense")
    auto = dataclasses.replace(CFG, algo=dataclasses.replace(
        CFG.algo, local_solver="auto"))
    monitor = HealthMonitor(HealthPolicy(retries=1))
    s = Session(mk(), cfg=auto, lam=1e-3, objective="logistic",
                streamed=True, faults=FaultInjector("kernel-fail@x99"), **CPU)
    res = s.fit(until=EPOCHS, tol=0, health=monitor)
    assert s.spec.algo.local_solver == "torch" and not res.diverged
    _equal(s, ref)
    assert [e["action"] for e in monitor.events] == ["retry",
                                                     "fallback:torch"]
    assert res.history[0]["health"]["action"] == "fallback:torch"
    trips = [json.loads(ln) for ln in _log(log)
             if json.loads(ln)["event"] == "health.trip"]
    assert [t["action"] for t in trips] == ["retry", "fallback:torch"]


def test_kernel_fail_without_monitor_raises(tmp_path):
    mk = _maker("dense", tmp_path)
    auto = dataclasses.replace(CFG, algo=dataclasses.replace(
        CFG.algo, local_solver="auto"))
    s = Session(mk(), cfg=auto, lam=1e-3, objective="logistic",
                streamed=True, faults=FaultInjector("kernel-fail@e0"), **CPU)
    with pytest.raises(KernelBuildError):
        s.fit(until=1, tol=0)
    assert s.spec.algo.local_solver == "auto" and s.epochs_done == 0


@pytest.mark.parametrize("trip", ["error", "non-finite"])
def test_fallback_is_refused_off_the_cpu(monkeypatch, tmp_path, trip):
    """Off the CPU the "fallback" remedy would run the plain version
    around a failing kernel: the monitor spends its retry, then records
    "fallback-refused", keeps the solver and raises: the kernel's own
    error, or a RuntimeError for a non-finite state.  (A stand-in
    session on the meta device: the refusal keys on the device type.)"""
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("REPRO_FAULT_LOG", str(log))
    switched = []
    s = types.SimpleNamespace(
        alpha=torch.zeros(8), v=torch.ones(4), epochs_done=0,
        device=torch.device("cpu"), _switch_local_solver=switched.append)
    monitor = HealthMonitor(HealthPolicy(retries=1))
    monitor.bind(s)
    s.device = torch.device("meta")
    err = KernelBuildError("injected")
    for n in range(2):
        s.epochs_done = 1
        if trip == "error":
            if n:
                with pytest.raises(KernelBuildError):
                    monitor.on_epoch_error(err)
            else:
                monitor.on_epoch_error(err)
        else:
            s.alpha, s.v = torch.full((8,), float("nan")), torch.ones(4)
            if n:
                with pytest.raises(RuntimeError, match="non-finite"):
                    monitor.on_epoch_end({"rel_change": 1.0})
            else:
                assert monitor.on_epoch_end({"rel_change": 1.0}) is False
        assert s.epochs_done == 0 and s.alpha.device.type == "meta"
    assert [e["action"] for e in monitor.events] == ["retry",
                                                     "fallback-refused"]
    assert monitor.gave_up and switched == []
    assert [json.loads(ln)["action"] for ln in _log(log)] == [
        "retry", "fallback-refused"]


def test_torch_solver_never_fires_kernel_fail():
    data, kw = _resident_kw("dense")
    s = Session(data, **kw, faults=FaultInjector("kernel-fail@x99"))
    s.fit(until=1, tol=0)
    assert s.epochs_done == 1 and s._faults.specs[0].fired == 0


# -- the front door and the shims -------------------------------------------

def test_estimator_fit_with_health_and_journal(tmp_path):
    """`LogisticRegression(health=, journal_dir=)`: the fit commits every
    epoch, and a new estimator on the same journal resumes and ends
    bitwise a straight fit."""
    X, y = make_dense_classification(n=256, d=16, seed=3)
    kw = dict(bucket=8, lanes=2, deterministic=True, tol=0.0, **CPU)
    straight = LogisticRegression(max_epochs=3, **kw).fit(X.T, y)
    jd = tmp_path / "journal"
    first = LogisticRegression(max_epochs=2, health=HealthPolicy(),
                               journal_dir=jd, **kw).fit(X.T, y)
    assert first.session_._journal is not None
    assert json.loads((jd / "epoch" / "meta.json").read_text()) == \
        {"epochs_done": 2}
    resumed = LogisticRegression(max_epochs=3, health=True,
                                 journal_dir=jd, **kw).fit(X.T, y)
    assert resumed.session_.epochs_done == 3
    assert np.array_equal(resumed.coef_, straight.coef_)


def test_streamed_trainer_takes_journal_and_health(tmp_path, clean):
    from repro_torch.api import ReproDeprecationWarning
    mk = _maker("sparse", tmp_path / "c")
    ref = clean("sparse")
    jd = tmp_path / "journal"
    with pytest.warns(ReproDeprecationWarning):
        tr = StreamedGLMTrainer(mk(), objective="logistic", lam=1e-3,
                                cfg=CFG, journal_dir=jd,
                                health=HealthPolicy(), **CPU)
    tr.fit(max_epochs=EPOCHS, tol=0)
    _equal(tr._session, ref)
    assert (jd / "epoch" / "keys.json").exists()
    assert not (jd / "inflight").exists()      # cleared at each commit


def test_journal_every_sets_the_inflight_cadence(tmp_path, monkeypatch):
    """``journal_every=2`` at 4 chunks writes one inflight record per
    epoch (after chunk 2): the log shows it."""
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("REPRO_FAULT_LOG", str(log))
    mk = _maker("dense", tmp_path / "c")
    with pytest.raises(SimulatedCrash):
        _fit(mk(), streamed=True, journal_dir=tmp_path / "j",
             journal_every=2, faults=FaultInjector("kill@e0c3"))
    chunks = [json.loads(ln)["chunk"] for ln in _log(log)
              if json.loads(ln)["event"] == "journal.chunk"]
    assert chunks == [2]


# -- against the reference --------------------------------------------------

@pytest.fixture(scope="module")
def jkill(tmp_path_factory):
    """The reference, dense, killed at e1c2 with a journal, its event
    log, and its uninterrupted run."""
    root = tmp_path_factory.mktemp("jkill")
    mk = _maker("dense", root / "c", reg=jreg)
    ref = _jfit(mk(), streamed=True)
    log = root / "events.jsonl"
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_FAULT_LOG", str(log))
    mp.setenv("REPRO_PLAN", "off")
    try:
        with pytest.raises(JCrash):
            _jfit(mk(), streamed=True, journal_dir=root / "j",
                  faults=JInjector("kill@e1c2"))
    finally:
        mp.undo()
    return dict(root=root, ref=ref, journal=root / "j", log=_log(log),
                v=np.asarray(ref.v), alpha=np.asarray(ref.alpha),
                gap=ref.gap())


def test_reference_journal_resumes_in_the_port(tmp_path, jkill):
    """The reference's records read back with its bits, and the port's
    fit resumed from them lands on the reference's uninterrupted run."""
    import shutil
    jd = tmp_path / "j"
    shutil.copytree(jkill["journal"], jd)
    mk = _maker("dense", tmp_path / "c")
    s = Session(mk(), cfg=CFG, lam=1e-3, objective="logistic",
                streamed=True, journal_dir=jd, **CPU)
    assert s.epochs_done == 1
    P, d = CFG.deployment.pods, s.d
    tmpl = (np.zeros(s.n, np.float32), np.zeros((P, d), np.float32),
            np.zeros((P, d), np.float32))
    jj = JJournal(jkill["journal"])
    want_c, *want = jj.load_inflight(1, *tmpl)
    got_c, *got = EpochJournal(jd).load_inflight(1, *map(torch.from_numpy,
                                                         tmpl), **CPU)
    assert got_c == want_c == 2
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and np.array_equal(g.numpy(),
                                                         np.asarray(w))
    ja, jv, jdone = jj.load_epoch(tmpl[0], np.zeros(d, np.float32))
    assert jdone == 1 and np.array_equal(s.alpha.numpy(), ja) \
        and np.array_equal(s.v.numpy(), jv)
    res = s.fit(until=EPOCHS, tol=0)
    np.testing.assert_allclose(res.v, jkill["v"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.alpha, jkill["alpha"], rtol=1e-4,
                               atol=1e-5)
    assert abs(s.gap() - jkill["gap"]) <= 1e-3 * abs(jkill["gap"])


def test_port_journal_is_read_by_the_reference(tmp_path):
    mk = _maker("dense", tmp_path / "c")
    jd = tmp_path / "j"
    with pytest.raises(SimulatedCrash):
        _fit(mk(), streamed=True, journal_dir=jd,
             faults=FaultInjector("kill@e1c2"))
    n, d, P = 512, 64, CFG.deployment.pods
    tmpl = (np.zeros(n, np.float32), np.zeros((P, d), np.float32),
            np.zeros((P, d), np.float32))
    want_c, *want = EpochJournal(jd).load_inflight(1, *tmpl)
    got_c, *got = JJournal(jd).load_inflight(1, *tmpl)
    assert got_c == want_c == 2
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), w)
    ja, jv, jdone = JJournal(jd).load_epoch(tmpl[0], np.zeros(d, np.float32))
    pa, pv, pdone = EpochJournal(jd).load_epoch(
        torch.zeros(n), torch.zeros(d), **CPU)
    assert jdone == pdone == 1
    assert np.array_equal(ja, pa.numpy()) and np.array_equal(jv, pv.numpy())


def test_kill_event_log_equals_the_reference(tmp_path, monkeypatch, jkill):
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("REPRO_FAULT_LOG", str(log))
    mk = _maker("dense", tmp_path / "c")
    with pytest.raises(SimulatedCrash):
        _fit(mk(), streamed=True, journal_dir=tmp_path / "j",
             faults=FaultInjector("kill@e1c2"))
    assert _log(log) == [_port_names(ln) for ln in jkill["log"]]
    assert any('"inject.kill"' in ln for ln in _log(log))


def test_health_events_and_log_equal_the_reference(tmp_path, monkeypatch):
    """kernel-fail under "auto" (retry, then the fallback) and a
    nan-epoch rollback: the monitors' events and the event logs agree
    once "fallback:xla" reads "fallback:torch"."""
    schedule = "kernel-fail@x2;nan-epoch@e1"
    data, kw = _resident_kw("dense")
    logs = {}
    events = {}
    for pkg in ("port", "reference"):
        log = tmp_path / f"{pkg}.jsonl"
        monkeypatch.setenv("REPRO_FAULT_LOG", str(log))
        if pkg == "port":
            cfg = dataclasses.replace(RES_CFG, algo=dataclasses.replace(
                RES_CFG.algo, local_solver="auto"))
            mon = HealthMonitor(HealthPolicy(retries=1))
            s = Session(data, **{**kw, "cfg": cfg},
                        faults=FaultInjector(schedule))
        else:
            jcfg = JConfig.make(pods=1, lanes=2, chunks=2,
                                local_solver="auto", **TOPO)
            mon = JMonitor(JPolicy(retries=1))
            s = JSession(data, cfg=jcfg, lam=1e-3, objective="logistic",
                         faults=JInjector(schedule))
        s.fit(until=EPOCHS, tol=0, health=mon)
        assert s.epochs_done == EPOCHS
        logs[pkg], events[pkg] = _log(log), mon.events
    assert [e["action"] for e in events["port"]] == \
        ["retry", "fallback:torch", "fallback:torch"]
    assert events["port"] == [json.loads(_port_names(json.dumps(e)))
                              for e in events["reference"]]
    assert logs["port"] == [_port_names(ln) for ln in logs["reference"]]


# -- the engine's journal hook ----------------------------------------------

def test_journal_threads_into_the_streamed_epoch(tmp_path):
    """`make_streamed_epoch(journal=)` writes the inflight record at the
    chunk boundaries and a second call resumes from it: the resumed
    epoch runs only the chunks after the cursor and ends bitwise."""
    cache = _maker("dense", tmp_path)()
    s = Session(cache, cfg=CFG, streamed=True, **CPU)
    obj = get_objective("logistic")
    plain = engine.make_streamed_epoch(obj, CFG, s.plan, s.feed, lam=s.lam,
                                       **CPU)
    want = plain(s.alpha, s.v, 0)
    journal = EpochJournal(tmp_path / "j", injector=FaultInjector(
        "kill@e0c3"))
    fn = engine.make_streamed_epoch(obj, CFG, s.plan, s.feed, lam=s.lam,
                                    journal=journal, **CPU)
    with pytest.raises(SimulatedCrash):
        fn(s.alpha, s.v, 0)
    meta = json.loads((tmp_path / "j" / "inflight" / "meta.json").read_text())
    assert meta == {"epoch": 0, "chunk": 3}
    stats = {}
    got = fn(s.alpha, s.v, 0, stats=stats)
    assert stats["chunks"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert journal.load_inflight(1, s.alpha, s.v.expand(2, -1),
                                 s.v.expand(2, -1), **CPU) is None


# -- the mesh-streamed path: the same guarantees on a stacked mesh ----------

MESH_CFG = EngineConfig.make(pods=1, lanes=2, bucket=8, chunks=4,
                             partition="alltoall", deterministic=True,
                             local_solver="torch", compress_pod=False)
MESH_CASES = {
    # kind: (cache, EngineConfig, (pod, data, model))
    "dense": ("dense", MESH_CFG, (1, 2, 1)),
    "sparse-sharded": ("sparse", dataclasses.replace(
        MESH_CFG, deployment=dataclasses.replace(MESH_CFG.deployment,
                                                 feature_shard=True)),
        (1, 2, 2)),
}


def _mesh_kw(case):
    _, cfg, (pod, data, model) = MESH_CASES[case]
    return dict(cfg=cfg, lam=1e-3, objective="logistic",
                mesh=make_host_mesh(pod=pod, data=data, model=model, **CPU),
                **CPU)


def test_kill_and_resume_mesh_streamed_bitwise(tmp_path):
    """A kill between chunk 1 and 2 of epoch 1 on the MESH-streamed path:
    a fresh Session resumes from the journal at the chunk boundary and
    ends bitwise the uninterrupted run (`MeshSchedule` is pure in (seed,
    epoch), so the resumed epoch replays the chunks not yet applied)."""
    mk = _maker("dense", tmp_path / "c")
    kw = dict(_mesh_kw("dense"), streamed=True)
    ref = Session(mk(), **kw)
    ref.fit(until=EPOCHS, tol=0)
    jd = tmp_path / "journal"
    with pytest.raises(SimulatedCrash):
        Session(mk(), **kw, journal_dir=jd,
                faults=FaultInjector("kill@e1c2")).fit(until=EPOCHS, tol=0)
    s2 = Session(mk(), **kw, journal_dir=jd)
    assert s2.epochs_done == 1                 # epoch 0 was committed
    stats = {}
    s2.epoch(stats=stats)
    assert stats["chunks"] == MESH_CFG.algo.chunks - 2
    s2.fit(until=EPOCHS, tol=0)
    _equal(s2, ref)
    assert isinstance(s2.mesh_feed, engine.MeshChunkFeed)


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_corruption_quarantine_rebuild_mesh_streamed(tmp_path, case):
    """A `ResilientChunkFeed` around the mesh pipeline keeps its
    quarantine and rebuild: the corrupt cache is swapped out through
    `MeshChunkFeed.rebind`, so the mesh feed (its layout, and for
    feature-sharded data its compaction width) survives the rebuild, and
    training ends bitwise the clean run."""
    kind = MESH_CASES[case][0]
    mk = _maker(kind, tmp_path)
    kw = _mesh_kw(case)
    ref = Session(mk(), streamed=True, **kw)
    ref.fit(until=EPOCHS, tol=0)
    width = ref.mesh_feed.width
    FaultInjector("flip-tile@t5", seed=7).apply_disk_faults(mk().path)
    feed = ResilientChunkFeed(mk().feed(verify=True, **CPU), rebuild=mk,
                              sleep=lambda t: None)
    s = Session(feed, **kw)
    s.fit(until=EPOCHS, tol=0)
    _equal(s, ref)
    assert list(tmp_path.glob(".quarantine.*"))
    assert isinstance(feed.feed, engine.MeshChunkFeed)
    assert feed.feed.verify and feed.feed.width == width
    assert feed.feed.sliced == (case == "sparse-sharded")
    mk().verify_tiles()                        # the rebuilt cache is clean
