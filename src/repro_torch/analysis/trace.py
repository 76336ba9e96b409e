"""The trace layer: run the epoch programs and watch what they execute.

The reference abstract-traces its shard_map programs and walks the
jaxprs; the port's programs are eager, so this layer runs them at test
sizes and records what they do:

* TORCH-SUM-EXCHANGE (`sum_exchange`) — the registry-workload x route
  matrix on a process mesh (`build_cases`: dense examples on (2, 2, 1);
  dense TP, sparse replicated and sparse slices on (1, 2, 2); the
  "torch" and "kernel" routes; resident and streamed; deterministic True
  and False), through the real builders (`launch.glm.make_dense_epoch`
  / `make_sparse_epoch`, `make_streamed_epoch_mesh`), one epoch on a
  world of gloo ranks that this module spawns (``python -m
  repro_torch.analysis.trace rank``).  Each rank wraps the
  `torch.distributed` collectives in a recorder (installed here, no
  hook in the program), and under deterministic=True an all_reduce,
  reduce or reduce_scatter with ReduceOp.SUM on a floating tensor is a
  finding.  On the CPU the kernels' route runs through
  `engine.kernel_solver`, whose wrappers run their plain versions.
* TORCH-NONDET-OP (`nondet_gate`) — the deterministic single-process
  paths (`Session` dense, sparse and sharded, the stacked mesh's
  `make_dense_epoch`/`make_sparse_epoch` with deterministic=True), each
  run twice under ``torch.use_deterministic_algorithms(True)`` with a
  dispatch-mode recorder of aten ops: an op the mode refuses, a
  floating-point accumulate into indices (`config.ACCUMULATE_OPS`, which
  the mode refuses or replaces on the card and which run as atomics
  outside it) and a state that differs between the runs are findings.
  On CUDA the mode needs ``CUBLAS_WORKSPACE_CONFIG`` before the first
  cuBLAS handle, so there the gate runs in a subprocess that sets it
  (``python -m repro_torch.analysis.trace gate``); on the CPU it runs in
  this process and restores the mode after.

A case that fails to run is itself a finding: the audit never skips a
case silently.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Optional, Sequence

from . import config, rules
from .rules import Finding

__all__ = ["SumCase", "build_cases", "sum_exchange", "nondet_gate",
           "GATE_PATHS", "GATE_SIZES", "ROLE_MESH", "run_trace"]

#: model role -> (kind, feature_shard, mesh shape per world size)
ROLE_MESH = {
    "examples": ("dense", False, {4: (2, 2, 1), 2: (1, 2, 1)}),
    "tp": ("dense", True, {4: (1, 2, 2), 2: (1, 1, 2)}),
    "replicated": ("sparse", False, {4: (1, 2, 2), 2: (1, 1, 2)}),
    "slices": ("sparse", True, {4: (1, 2, 2), 2: (1, 1, 2)}),
}
#: the registry workload each role is for (`build_cases(reduced=True)`)
ROLE_WORKLOAD = {"examples": "higgs", "tp": "epsilon",
                 "replicated": "criteo-kaggle-sub", "slices": "webspam"}
ROUTES = ("torch", "kernel")
MODES = ("resident", "streamed")
#: the matrix's rows (cut from the registry's sub shapes), bucket, chunks
N_ROWS, BUCKET, CHUNKS = 128, 8, 2
#: seconds for a spawned world (or the gate's subprocess) to finish
TIMEOUT = 600
_DIST_TIMEOUT = 120           # a rank's rendezvous and each collective
_CUBLAS_WORKSPACE = ":4096:8"


@dataclasses.dataclass(frozen=True)
class SumCase:
    """One program on a process mesh: a registry workload in a model
    role, a route, resident or streamed, under a determinism flag; or a
    probe (``workload="probe"``, ``role`` its variant) for the
    self-tests."""
    workload: str
    role: str
    route: str = "torch"
    mode: str = "resident"
    deterministic: bool = True

    @property
    def name(self) -> str:
        tag = "det" if self.deterministic else "nondet"
        return f"{self.workload}/{self.role}/{self.route}/{self.mode}/{tag}"

    def mesh(self, world: int) -> tuple[int, int, int]:
        if self.workload == "probe":
            return (1, world, 1)
        return ROLE_MESH[self.role][2][world]


def build_cases(workloads: Optional[Sequence[str]] = None, *,
                reduced: bool = False) -> list[SumCase]:
    """The matrix: every registry workload (or `workloads`) x its kind's
    roles x routes x modes x both determinism flags.  ``reduced``
    (without `workloads`): one case per role ("kernel", resident,
    deterministic), on the role's `ROLE_WORKLOAD`."""
    from repro_torch.data.registry import REGISTRY
    if reduced:
        if workloads is not None:
            raise ValueError("reduced matrix: one ROLE_WORKLOAD per role")
        return [SumCase(w, role, "kernel")
                for role, w in ROLE_WORKLOAD.items()]
    names = list(workloads) if workloads is not None else sorted(REGISTRY)
    return [SumCase(w, role, r, m, det)
            for role, (kind, _, _) in ROLE_MESH.items()
            for w in names if REGISTRY[w].kind == kind
            for r in ROUTES for m in MODES for det in (True, False)]


# ---------------------------------------------------------------------------
# Where a recorded call came from
# ---------------------------------------------------------------------------


def _caller() -> str:
    """repo-relative file:line of the innermost frame of the port outside
    this analysis package."""
    pkg = config.REPO_ROOT / config.PACKAGE
    here = pathlib.Path(__file__).resolve().parent
    for fr in reversed(traceback.extract_stack()):
        p = pathlib.Path(fr.filename).resolve()
        if p.is_relative_to(pkg) and not p.is_relative_to(here):
            return f"{p.relative_to(config.REPO_ROOT)}:{fr.lineno}"
    return ""


#: the SDCA kernels' launch counters, (module, attribute)
_COUNTERS = (("sdca_bucket", "launches"),
             ("sdca_bucket", "tp_step_launches"),
             ("sdca_sparse_bucket", "launches"),
             ("sdca_sparse_bucket", "gather_launches"),
             ("sdca_sparse_bucket", "sharded_launches"))


def _launches() -> dict[str, int]:
    """The SDCA kernels' launch counters of this process."""
    import importlib
    out = {}
    for mod, attr in _COUNTERS:
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        out[f"{mod}.{attr}"] = getattr(m, attr)
    return out


def _delta(before: dict, after: dict) -> dict[str, int]:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


# ---------------------------------------------------------------------------
# TORCH-SUM-EXCHANGE: collectives recorded on spawned gloo ranks
# ---------------------------------------------------------------------------

#: where the ReduceOp sits among a sum collective's positional arguments
_OP_ARG = {"all_reduce": 1, "reduce": 2, "reduce_scatter": 2,
           "reduce_scatter_tensor": 2}


class CollectiveRecorder:
    """Wraps this process's `torch.distributed` collectives: each call
    is recorded as [name, op, dtype, floating, where] and then made."""

    def __init__(self):
        self.calls: list[list] = []
        self._orig: dict = {}

    def __enter__(self):
        import torch.distributed as dist
        for name in sorted(config.COLLECTIVE_CALL_NAMES):
            fn = getattr(dist, name, None)
            if fn is not None:
                self._orig[name] = fn
                setattr(dist, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self._orig.items():
            setattr(dist, name, fn)
        self._orig.clear()

    def _wrap(self, name, fn):
        def recorded(*args, **kw):
            op, dtype, floating = "", "", False
            if name in _OP_ARG:
                i = _OP_ARG[name]
                op = kw.get("op", args[i] if len(args) > i else "SUM")
                op = str(op).rsplit(".", 1)[-1]
                t = args[0] if args else kw.get("tensor", kw.get("output"))
                dtype, floating = str(t.dtype), bool(t.is_floating_point())
            self.calls.append([name, op, dtype, floating, _caller()])
            return fn(*args, **kw)
        return recorded


def audit_calls(calls: list, case: str, *, deterministic: bool,
                ) -> list[Finding]:
    """TORCH-SUM-EXCHANGE over one case's recorded calls."""
    if not deterministic:
        return []
    found, seen = [], set()
    for name, op, dtype, floating, where in calls:
        if name in config.SUM_REDUCE_CALLS and op == "SUM" and floating:
            if (name, where) in seen:
                continue
            seen.add((name, where))
            found.append(Finding(
                rules.TORCH_SUM_EXCHANGE,
                f"dist.{name} with ReduceOp.SUM on a {dtype} tensor in a "
                f"deterministic=True program; the contract requires an "
                f"all-gather and a sum in rank order", where=where,
                case=case))
    return found


def _env() -> dict:
    src = str(config.REPO_ROOT / "src")
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=src + (os.pathsep + path if path
                                              else ""))


def _wait(procs: list, timeout: float) -> bool:
    """Join `procs` within `timeout` seconds; kill them all on expiry."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        return True
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        return False


def sum_exchange(cases: Sequence[SumCase], *, device="cuda", world: int = 4,
                 strict: bool = False, timeout: float = TIMEOUT,
                 launches: Optional[dict] = None,
                 ) -> dict[str, list[Finding]]:
    """Run `cases` on `world` gloo ranks on `device` (the card unless
    the caller asks for the CPU; a missing GPU raises) -> {case name:
    findings}.  Every rank runs every case; a rank's error, or a world
    that does not finish in `timeout` seconds, is a finding.  Cases with
    deterministic=False are held to the contract only when ``strict``
    (how a test shows the detector sees their unordered sums).  A given
    ``launches`` dict receives each case's SDCA kernel launches, summed
    over the ranks."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    root = pathlib.Path(tempfile.mkdtemp(prefix="audit-trace-"))
    try:
        spec = {"device": dev.type, "world": world,
                "cases": [dataclasses.asdict(c) for c in cases]}
        (root / "spec.json").write_text(json.dumps(spec))
        procs, logs = [], []
        for r in range(world):
            logs.append(open(root / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.analysis.trace", "rank",
                 str(root), str(r)], stdout=logs[-1],
                stderr=subprocess.STDOUT, env=_env()))
        finished = _wait(procs, timeout)
        for f in logs:
            f.close()
        out: dict[str, list[Finding]] = {c.name: [] for c in cases}
        for r, p in enumerate(procs):
            res = root / f"rank{r}.json"
            if not finished or p.returncode != 0 or not res.exists():
                tail = (root / f"rank{r}.log").read_text()[-2000:]
                why = ("did not finish in " f"{timeout:g} s" if not finished
                       else f"exited {p.returncode}")
                for c in cases:
                    out[c.name].append(Finding(
                        rules.TORCH_SUM_EXCHANGE,
                        f"rank {r} of {world} {why}; the case was not "
                        f"audited:\n{tail}", case=c.name))
                continue
            got = json.loads(res.read_text())
            for c in cases:
                rec = got[c.name]
                if launches is not None:
                    mine = launches.setdefault(c.name, {})
                    for k, n in rec["launches"].items():
                        mine[k] = mine.get(k, 0) + n
                if rec["error"]:
                    out[c.name].append(Finding(
                        rules.TORCH_SUM_EXCHANGE,
                        f"rank {r}: the case failed to run; the audit "
                        f"must cover it: {rec['error']}", case=c.name))
                for f in audit_calls(rec["calls"], c.name,
                                     deterministic=c.deterministic
                                     or strict):
                    if str(f) not in {str(g) for g in out[c.name]}:
                        out[c.name].append(f)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def kernel_route_on_cpu():
    """``local_solver="kernel"`` on the CPU: `engine.make_local_solver`
    refuses it there, so the audit (not the program) puts
    `engine.kernel_solver` in its place for CPU devices, whose wrappers
    run the kernels' plain versions on CPU tensors."""
    import torch

    from repro_torch.core import engine
    orig = engine.make_local_solver

    def make(kind, obj, lam_n, sig, *, device="cuda", **kw):
        if kind == "kernel" and torch.device(device).type == "cpu":
            return engine.kernel_solver(obj, lam_n, sig, **kw)
        return orig(kind, obj, lam_n, sig, device=device, **kw)

    engine.make_local_solver = make
    try:
        yield
    finally:
        engine.make_local_solver = orig


def _case_data(case: SumCase):
    """(GLMScale, arrays) of a matrix case: the registry workload's sub
    shape cut to `N_ROWS` rows."""
    import numpy as np

    from repro_torch.data.registry import get_dataset
    from repro_torch.launch import glm
    kind, shard, _ = ROLE_MESH[case.role]
    ds = get_dataset(case.workload, n=N_ROWS)
    nnz = ds.idx.shape[1] if kind == "sparse" else 0
    scale = glm.GLMScale(
        f"audit-{case.workload}", kind, n=N_ROWS, d=ds.d, nnz=nnz,
        bucket=BUCKET, chunks=CHUNKS, feature_shard=shard,
        compress_pod=False, local_solver=case.route,
        deterministic=case.deterministic)
    arrays = ((np.asarray(ds.X, np.float32), ds.y) if kind == "dense"
              else (ds.idx, ds.val, ds.y))
    return scale, arrays


def _run_case(case: SumCase, mesh) -> None:
    """One epoch of a matrix case (or one probe) on this rank."""
    import numpy as np
    import torch

    from repro_torch.core import engine
    from repro_torch.core.objectives import LOGISTIC
    from repro_torch.data.cache import ArrayFeed
    from repro_torch.launch import glm
    if case.workload == "probe":
        # the engine's own lane sum over 'data': the unordered all_reduce
        # (deterministic=False) in a case held to the contract, or its
        # all-gather and ordered-sum twin
        dv = torch.arange(4, dtype=torch.float32, device=mesh.device)
        coll = engine.MeshCollectives(
            mesh=mesh, deterministic=case.role == "all_gather")
        coll.lane_sum((dv * (0.1 * (mesh.rank + 1)))[None, None])
        return
    scale, arrays = _case_data(case)
    sparse = scale.kind == "sparse"
    if case.mode == "resident":
        specs = glm.glm_input_specs(scale, mesh)
        st = tuple(glm.local_shard(t, s, mesh) for t, s in zip(
            (*arrays, np.zeros(scale.n, np.float32),
             np.zeros(scale.d, np.float32)), specs))
        make = glm.make_sparse_epoch if sparse else glm.make_dense_epoch
        make(scale, mesh, LOGISTIC)(*st, 0)
        return
    feed = (ArrayFeed(arrays[2], idx=arrays[0], val=arrays[1], d=scale.d,
                      bucket=scale.bucket, device=mesh.device) if sparse
            else ArrayFeed(arrays[1], X=arrays[0], bucket=scale.bucket,
                           device=mesh.device))
    em = glm.make_streamed_epoch_mesh(scale, mesh, feed, LOGISTIC)
    em(torch.zeros(scale.n), torch.zeros(scale.d), 0)


def _rank_main(root: pathlib.Path, rank: int) -> None:
    import torch

    from repro_torch.launch.mesh import make_dist_mesh
    torch.set_num_threads(1)
    spec = json.loads((root / "spec.json").read_text())
    world, device = spec["world"], spec["device"]
    cases = [SumCase(**c) for c in spec["cases"]]
    meshes = {}
    for c in cases:                # every rank: the same groups, in order
        shape = c.mesh(world)
        if shape not in meshes:
            meshes[shape] = make_dist_mesh(
                pod=shape[0], data=shape[1], model=shape[2],
                backend="gloo", device=device,
                init_method=f"file://{root}/store", rank=rank,
                world_size=world, timeout=_DIST_TIMEOUT)
    out = {}
    with kernel_route_on_cpu(), CollectiveRecorder() as rec:
        for c in cases:
            rec.calls.clear()
            err, before = None, _launches()
            try:
                _run_case(c, meshes[c.mesh(world)])
            # audit: except-ok a case that fails IS reported, as a finding
            except Exception as e:
                err = f"{type(e).__name__}: {e}"
            out[c.name] = {"calls": list(rec.calls), "error": err,
                           "launches": _delta(before, _launches())}
    (root / f"rank{rank}.json").write_text(json.dumps(out))


# ---------------------------------------------------------------------------
# TORCH-NONDET-OP: the deterministic paths under the deterministic mode
# ---------------------------------------------------------------------------

#: the gate's sizes: "test" (CPU tests; ridge, whose delta is
#: closed-form, keeps the recorded op count small), "check" (chip_smoke's
#: check phase: 4 workers x 32 buckets of 16, HIGGS's d 28, criteo's d 1M
#: and 40 nonzeros; the sharded pair on (1, 4, 4) at 256 nonzeros)
GATE_SIZES = {
    "test": dict(objective="ridge", lanes=2, model=2, bucket=8, chunks=2,
                 n=256, d=16, d_sparse=64, nnz=8, n_sharded=128,
                 nnz_sharded=8),
    "check": dict(objective="logistic", lanes=4, model=4, bucket=16,
                  chunks=2, n=2048, d=28, d_sparse=1_000_000, nnz=40,
                  n_sharded=256, nnz_sharded=256),
}
#: the gate's single-process paths, and its self-test probes
GATE_PATHS = ("session-dense", "session-sparse", "session-sharded",
              "mesh-dense", "mesh-sparse")
_PROBES = ("probe-index-add", "probe-ordered")


def _gate_run(path: str, route: str, device, size: dict):
    """One run of a gate path -> its state tensors."""
    import torch

    from repro_torch.api import Session
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.objectives import get_objective
    from repro_torch.data.synthetic import (make_dense_classification,
                                            make_sparse_classification)
    from repro_torch.launch import glm
    from repro_torch.launch.mesh import make_host_mesh
    if path in _PROBES:
        idx = torch.tensor([0, 1, 1, 2, 1, 0], device=device)
        src = torch.linspace(0.1, 0.6, 6, device=device)
        if path == "probe-index-add":
            return (torch.zeros(3, device=device).index_add_(0, idx, src),)
        out = torch.zeros(3, device=device)
        for i in range(idx.shape[0]):      # the ordered twin
            out[idx[i]] = out[idx[i]] + src[i]
        return (out,)
    s = size
    sharded = path == "session-sharded"
    sparse = path in ("session-sparse", "mesh-sparse") or sharded
    n = s["n_sharded"] if sharded else s["n"]
    if sparse:
        (idx, val), y, d = make_sparse_classification(
            n=n, d=s["d_sparse"], nnz=s["nnz_sharded"] if sharded
            else s["nnz"], seed=1, skew=1.1)
    else:
        X, y = make_dense_classification(n=n, d=s["d"], seed=2)
        d = s["d"]
    if path.startswith("session"):
        cfg = EngineConfig.make(
            pods=1, lanes=s["lanes"], bucket=s["bucket"],
            chunks=s["chunks"], partition="alltoall", deterministic=True,
            compress_pod=False, feature_shard=sharded,
            local_solver=route)
        data = ((idx, val), y) if sparse else (X, y)
        kw = {"d": d} if sparse else {}
        if sharded:
            kw.update(streamed=True, mesh=make_host_mesh(
                pod=1, data=s["lanes"], model=s["model"], device=device))
        ses = Session(data, objective=s["objective"], lam=1e-3, cfg=cfg,
                      device=device, **kw)
        for _ in range(2):
            ses.epoch()
        return ses.alpha.cpu(), ses.v.cpu()
    scale = glm.GLMScale(
        f"gate-{path}", "sparse" if sparse else "dense", n=n, d=d,
        nnz=s["nnz"] if sparse else 0, bucket=s["bucket"],
        chunks=s["chunks"], compress_pod=False, local_solver=route,
        deterministic=True)
    mesh = make_host_mesh(pod=1, data=s["lanes"], device=device)
    arrays = (idx, val, y) if sparse else (X, y)
    make = glm.make_sparse_epoch if sparse else glm.make_dense_epoch
    ep = make(scale, mesh, get_objective(s["objective"]))
    st = tuple(torch.as_tensor(t, device=device) for t in arrays) + (
        torch.zeros(n, device=device), torch.zeros(d, device=device))
    for e in range(2):
        st = ep(*st, e)
    return tuple(t.cpu() for t in st)


def _op_recorder():
    """A dispatch mode that records the floating-point accumulates into
    indices (`config.ACCUMULATE_OPS`) it sees, with their callers."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpRecorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.hits: list[tuple[str, str]] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__.rstrip("_")
            if name in config.ACCUMULATE_OPS and args:
                accumulate = True
                if name in ("index_put", "_index_put_impl"):
                    accumulate = bool(kwargs.get(
                        "accumulate", args[3] if len(args) > 3 else False))
                t = args[0]
                if accumulate and getattr(t, "is_floating_point",
                                          lambda: False)():
                    self.hits.append((str(func), _caller()))
            return func(*args, **kwargs)

    return OpRecorder()


def _gate_path(path: str, route: str, device, size: dict) -> list[Finding]:
    """TORCH-NONDET-OP over one path: two runs under the mode, the ops
    of the first recorded (the second runs the same code)."""
    import torch
    case = f"{path}/{route}"
    found: list[Finding] = []

    def emit(msg: str, where: str = "") -> None:
        found.append(Finding(rules.TORCH_NONDET_OP, msg, where=where,
                             case=case))

    states = []
    for run in range(2):
        rec = _op_recorder()
        try:
            with rec if run == 0 else contextlib.nullcontext():
                states.append(_gate_run(path, route, device, size))
        # audit: except-ok a refused op or a failed run IS the finding
        except Exception as e:
            refused = "deterministic" in str(e)
            emit(("an op the deterministic mode refuses ran: " if refused
                  else "the path failed to run; the gate must cover it: ")
                 + f"{type(e).__name__}: {e}")
            return found
        for op, where in dict.fromkeys(rec.hits):
            emit(f"{op} accumulates a floating tensor into indices: "
                 f"atomics on the card outside the deterministic mode",
                 where=where)
        if found:
            return found
    if not all(torch.equal(a, b) for a, b in zip(*states)):
        emit("the state differs between two runs of the same path")
    return found


def _gate_local(paths, routes, device, size, launches: dict,
                ) -> dict[str, list[Finding]]:
    import torch
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    out = {}
    try:
        with kernel_route_on_cpu():
            for p in paths:
                for r in routes if p not in _PROBES else ("-",):
                    before = _launches()
                    out[f"{p}/{r}"] = _gate_path(p, r, device, size)
                    launches[f"{p}/{r}"] = _delta(before, _launches())
        return out
    finally:
        torch.use_deterministic_algorithms(was)


def nondet_gate(paths: Sequence[str] = GATE_PATHS, *, device="cuda",
                routes: Sequence[str] = ("kernel",), size: str = "test",
                timeout: float = TIMEOUT, launches: Optional[dict] = None,
                ) -> dict[str, list[Finding]]:
    """TORCH-NONDET-OP over `paths` x `routes` at `GATE_SIZES[size]` on
    `device` (the card unless the caller asks for the CPU; a missing GPU
    raises) -> {"path/route": findings}.  On CUDA in a subprocess that
    sets ``CUBLAS_WORKSPACE_CONFIG`` (the caller's cuBLAS workspace is
    left as it is).  A given ``launches`` dict receives each path's SDCA
    kernel launches over its two runs."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    paths, routes = list(paths), list(routes)
    launches = {} if launches is None else launches
    if dev.type == "cpu":
        return _gate_local(paths, routes, dev, GATE_SIZES[size], launches)
    root = pathlib.Path(tempfile.mkdtemp(prefix="audit-gate-"))
    try:
        (root / "spec.json").write_text(json.dumps(
            {"paths": paths, "routes": routes, "size": size,
             "device": str(dev)}))
        env = dict(_env(), CUBLAS_WORKSPACE_CONFIG=_CUBLAS_WORKSPACE)
        with open(root / "gate.log", "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.analysis.trace", "gate",
                 str(root)], stdout=log, stderr=subprocess.STDOUT, env=env)
            finished = _wait([proc], timeout)
        res = root / "gate.json"
        if not finished or proc.returncode != 0 or not res.exists():
            tail = (root / "gate.log").read_text()[-2000:]
            return {"gate": [Finding(
                rules.TORCH_NONDET_OP,
                f"the gate's subprocess did not finish cleanly (exit "
                f"{proc.returncode}); no path was audited:\n{tail}")]}
        got = json.loads(res.read_text())
        launches.update(got["launches"])
        return {k: [Finding(**f) for f in v]
                for k, v in got["findings"].items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _gate_main(root: pathlib.Path) -> None:
    spec = json.loads((root / "spec.json").read_text())
    launches: dict = {}
    got = _gate_local(spec["paths"], spec["routes"], spec["device"],
                      GATE_SIZES[spec["size"]], launches)
    (root / "gate.json").write_text(json.dumps(
        {"findings": {k: [f.to_json() for f in v] for k, v in got.items()},
         "launches": launches}))


def run_trace(workloads: Optional[Sequence[str]] = None, *, device="cuda",
              world: int = 4, log=None,
              ) -> tuple[list[Finding], list[str]]:
    """Both checks of the layer: the matrix on `world` gloo ranks and
    the gate ("torch" and "kernel" on the CPU, "kernel" on the card).
    -> (findings, case names)."""
    import torch
    cases = build_cases(workloads)
    routes = ROUTES if torch.device(device).type == "cpu" else ("kernel",)
    found: list[Finding] = []
    names: list[str] = []
    for name, got in sum_exchange(cases, device=device, world=world).items():
        names.append(name)
        found += got
        if log:
            log(f"  trace {name}: "
                f"{'clean' if not got else f'{len(got)} finding(s)'}")
    for name, got in nondet_gate(device=device, routes=routes).items():
        names.append(name)
        found += got
        if log:
            log(f"  gate {name}: "
                f"{'clean' if not got else f'{len(got)} finding(s)'}")
    return found, names


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        _rank_main(pathlib.Path(sys.argv[2]), int(sys.argv[3]))
    elif sys.argv[1] == "gate":
        _gate_main(pathlib.Path(sys.argv[2]))
    else:
        raise SystemExit(f"usage: python -m repro_torch.analysis.trace "
                         f"rank ROOT RANK | gate ROOT (got {sys.argv[1:]})")
