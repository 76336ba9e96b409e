"""`Session`: the owner of GLM solver state for every front end.

    s = Session((X, y), objective="logistic", lam=1e-3, cfg=cfg)
    s.epoch()                 # run exactly one epoch, get metrics back
    s.fit(until=10)           # train up to absolute epoch 10
    s.fit(max_epochs=5)       # ... or 5 more epochs from wherever we are

`fit` drives a callback protocol (`on_epoch_end(metrics) -> stop?`).

Data sources accepted by the constructor, uniformly:

  * ``(X, y)``            dense arrays, engine layout ``X (d, n)``;
  * ``((idx, val), y)``   padded-CSR sparse (requires ``d=``);
  * ``"higgs"``           any `repro_torch.data.registry` name (honouring
                          ``streamed=``/``cache_dir=``/``data_dir=``);
  * a `TileCache`         in memory (``streamed=False``) or out of core;
  * a `ChunkFeed`         streamed training over any feed.

Resident sources live on the session's device; streamed ones
(``streamed=True``, or a `ChunkFeed`) keep the examples on the host and
copy a chunk at a time (`repro_torch.core.engine.run_epoch_streamed`),
bitwise equal to resident training on the same data and configuration.

The resilience runtime (`repro_torch.resilience`) is opt-in:
``journal_dir=`` makes epochs crash-safe (a new Session on the same
journal resumes at the last committed epoch, and a streamed epoch at
its last journaled chunk), ``health=`` puts a `HealthMonitor` first in
`fit`'s callbacks, and ``faults=`` (default: ``$REPRO_FAULTS``) injects
a seeded `FaultInjector`.

``mesh=`` (a `launch.mesh.StackedMesh` or a process mesh, `DistMesh`)
streams the chunks onto the mesh (`launch.glm.make_streamed_epoch_mesh`),
so it needs a streamed source; the epochs are bitwise resident training
on the same mesh, and on a process mesh every rank's `alpha` and `v`
are the stacked mesh's, in every role of the model axis (a feature-
sharded config runs one model lane a rank).  There each rank journals
under ``journal_dir/rank{r}`` (`resilience.MeshJournal`).

Examples are PADDED (x=0, y=+1 — inert, a zero row never moves v) up
to the multiple the chosen topology needs; ``n_examples`` records the
true count.

With ``local_solver="auto"`` resident and streamed arrays go through
the planner (`repro_torch.core.planner`, ``$REPRO_PLAN``), which
records its `SolverPlan` in ``solver_plan`` and, in search or probe
mode with the bucket left open, picks the bucket and chunks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import engine, objectives, planner
from repro_torch.core.bucketing import BucketPlan, make_plan
from repro_torch.core.config import EngineConfig, as_engine_config
from repro_torch.core.objectives import Objective, get_objective
from repro_torch.core.partition import PartitionPlan
from repro_torch.core.trainer import FitResult
from repro_torch.data.cache import ArrayFeed, pad_examples
from repro_torch.device import resolve_device, same_device
from repro_torch.resilience import (EpochJournal, FaultInjector,
                                    HealthMonitor, HealthPolicy,
                                    MeshJournal)

Tensor = torch.Tensor

__all__ = ["Session", "margins"]


def margins(v: Tensor, data) -> Tensor:
    """Decision margins x_i^T v for dense ``X (d, n)`` or a padded-CSR
    ``(idx, val)`` pair; returns ``(n,)``."""
    if isinstance(data, (tuple, list)):
        idx, val = data
        return torch.sum(v[idx.long()] * val, dim=1)
    return data.T @ v


def _to_device(data, device):
    """Host arrays (a dense block or an (idx, val) pair) -> tensors on
    `device`."""
    if isinstance(data, (tuple, list)):
        return tuple(_to_device(a, device) for a in data)
    return torch.from_numpy(np.ascontiguousarray(data)).to(device)


def _pad_multiple(spec: EngineConfig, bucket: int) -> int:
    """Example-count multiple every partition mode divides."""
    dep, algo = spec.deployment, spec.algo
    return dep.pods * dep.lanes * dep.lanes * algo.chunks * max(bucket, 1)


def _feed_nnz(feed) -> Optional[int]:
    """The padded row width of a sparse feed: a mesh feed's own, an
    array feed's idx, or a cache's (through a ResilientChunkFeed too)."""
    nnz = getattr(feed, "nnz", None)
    if nnz:
        return int(nnz)
    inner = getattr(feed, "feed", feed)
    fidx = getattr(inner, "idx", None)
    if fidx is not None:
        return int(np.shape(fidx)[-1])
    cache = getattr(inner, "cache", None)
    return int(cache.meta.nnz) if cache is not None else None


class Session:
    """Engine state + epoch control over one resolved data source.

    ``device`` defaults to ``"cuda"``: without a GPU the constructor
    raises unless the caller passes ``device="cpu"``.  On the card TF32
    is turned off (`torch.backends.cuda.matmul.allow_tf32` and
    `torch.backends.cudnn.allow_tf32` are set False), so every fp32
    product — margins, Gram matrices, the duality gap — stays fp32.
    """

    def __init__(self, data, y=None, *, objective: str | Objective | None
                 = None, lam: Optional[float] = None, cfg: Any = None,
                 d: Optional[int] = None, bucket: Optional[int] = None,
                 n: Optional[int] = None, data_dir=None, pad: bool = True,
                 device="cuda", streamed: bool = False, mesh=None,
                 cache_dir=None, nnz_multiple: Optional[int] = None,
                 health=None, journal_dir=None, journal_every: int = 1,
                 faults=None):
        self.device = resolve_device(device)
        if mesh is not None:
            if not same_device(mesh.device, self.device):
                raise ValueError(f"the mesh lives on {mesh.device}; the "
                                 f"session runs on {self.device}")
            self.device = mesh.device
        self._mesh = mesh
        self.spec = as_engine_config(cfg) if cfg is not None \
            else EngineConfig()
        self.streamed = streamed
        self.cache = None
        self.feed = None
        self.solver_plan = None      # set when "auto" routes via planner
        self.history: list[dict[str, float]] = []
        # the resilience runtime, all opt-in: `health` is a
        # HealthPolicy/HealthMonitor (or True for the defaults) that
        # fit() puts first among its callbacks; `journal_dir` makes
        # epochs crash-safe; `faults` is a FaultInjector (by default
        # from $REPRO_FAULTS)
        self._health = health
        self._damp = 1.0
        self._faults = (faults if faults is not None
                        else FaultInjector.from_env())
        self._journal = (EpochJournal(journal_dir, every=journal_every,
                                      injector=self._faults)
                         if journal_dir is not None else None)
        if self._journal is not None and hasattr(mesh, "rank"):
            # a process mesh: one journal a rank, the world agreeing on
            # the cursor it resumes at
            self._journal = MeshJournal.on_mesh(self._journal, mesh)

        # `Session((X, y))` / `Session(((idx, val), y))` sugar — only
        # when the second element is labels-shaped (1-D)
        if (y is None and isinstance(data, (tuple, list))
                and len(data) == 2 and not hasattr(data[0], "fetch")
                and np.ndim(data[1]) == 1):
            data, y = data

        if isinstance(data, str):
            self._init_from_registry(data, objective=objective, lam=lam,
                                     bucket=bucket, n=n, d=d,
                                     data_dir=data_dir, streamed=streamed,
                                     cache_dir=cache_dir,
                                     nnz_multiple=nnz_multiple)
        elif hasattr(data, "fetch"):               # ChunkFeed
            self._init_from_feed(data, objective=objective, lam=lam)
        elif hasattr(data, "gather_buckets"):      # TileCache
            self._init_from_cache(data, objective=objective, lam=lam,
                                  streamed=streamed)
        else:
            if y is None:
                raise TypeError("array data requires labels: "
                                "Session((X, y)) or Session(X, y)")
            self._init_from_arrays(data, y, objective=objective, lam=lam,
                                   d=d, bucket=bucket, pad=pad)
        if self._mesh is not None and self.feed is None:
            raise ValueError(
                "mesh= streams chunks onto the mesh, so it needs a "
                "streamed source: pass streamed=True (arrays/registry/"
                "cache) or a ChunkFeed")
        if self._journal is not None:
            # restart: continue from the last committed epoch (a
            # mid-epoch record is consumed by the streamed loop itself)
            got = self._journal.load_epoch(self.alpha, self.v,
                                           device=self.device)
            if got is not None:
                self.alpha, self.v, self.epochs_done = got

    # -- construction: one per data source ----------------------------------

    def _resolve_obj(self, objective, lam, default_obj="logistic",
                     default_lam=1e-3) -> None:
        objective = objective or default_obj
        self.obj = (objective if isinstance(objective, Objective)
                    else get_objective(objective))
        self.lam = float(default_lam if lam is None else lam)

    def _kernel_runs(self) -> bool:
        kind = self.spec.algo.local_solver
        if kind == "auto":
            kind = engine.resolve_auto_solver(self.device)
        return kind == "kernel"

    def _init_from_arrays(self, data, y, *, objective, lam, d, bucket, pad,
                          trusted_rows: bool = False) -> None:
        """Resident-array setup (or, with ``streamed=True``, an
        `ArrayFeed` over the host arrays).  When padding grows n -> n',
        lam is rescaled by n/n' so the padded objective keeps the USER's
        argmin exactly (lam*n, the dual scaling, is unchanged)."""
        self._resolve_obj(objective, lam)
        sparse = isinstance(data, (tuple, list))
        y = np.asarray(y, np.float32)
        self.n_examples = y.shape[0]
        algo = self.spec.algo
        force = bucket if bucket is not None else (algo.bucket or None)
        B = force if force else 1
        # local_solver="auto" routes through the planner (core.planner).
        # Under $REPRO_PLAN=on the geometry stays the static one (the
        # plan only records the route); search|probe pick the bucket
        # and chunks when the caller left them open (no bucket kwarg,
        # algo.bucket <= 1), before n is padded to their multiple.
        self.solver_plan = None
        mode = planner.plan_mode() if algo.local_solver == "auto" else "off"
        if mode != "off" and (not sparse or d is not None):
            open_geom = (mode in ("search", "probe") and bucket is None
                         and (algo.bucket or 1) == 1)
            sig = planner.WorkloadSignature(
                n=int(y.shape[0]),
                d=int(d) if sparse else int(np.shape(data)[0]),
                nnz=int(np.shape(data[0])[1]) if sparse else 0,
                sparse=sparse)
            self.solver_plan = planner.resolve_plan(
                sig, planner.Topology.detect(self.spec, device=self.device),
                bucket=None if open_geom else B,
                chunks=None if open_geom else algo.chunks)
            if open_geom:
                force = B = self.solver_plan.bucket
                if self.solver_plan.chunks != algo.chunks:
                    algo = dataclasses.replace(
                        algo, chunks=self.solver_plan.chunks)
                    self.spec = dataclasses.replace(self.spec, algo=algo)
        if sparse:
            idx = np.asarray(data[0], np.int32)
            val = np.asarray(data[1], np.float32)
            if d is None:
                raise ValueError("sparse array data requires d")
            if idx.size and (idx.min() < 0 or idx.max() >= d):
                # the kernel would read outside v; the reference clamps
                raise ValueError(
                    f"sparse feature ids must lie in [0, d={d}), got "
                    f"[{idx.min()}, {idx.max()}]")
            if not trusted_rows and self._kernel_runs():
                # the kernel's bitwise contract is stated for rows that
                # hold the CSR invariant; check them while on the host
                from repro_torch.data.formats import \
                    raise_on_duplicate_nonzeros
                raise_on_duplicate_nonzeros(idx, val, "ad-hoc sparse rows")
            if pad:
                y, _, idx, val = pad_examples(
                    y, _pad_multiple(self.spec, B), idx=idx, val=val)
            self.n, self.d = int(y.shape[0]), int(d)
        else:
            X = np.asarray(data, np.float32)
            self.d = int(X.shape[0])
            if pad:
                y, X, _, _ = pad_examples(y, _pad_multiple(self.spec, B), X=X)
            self.n = int(y.shape[0])
        if self.n > self.n_examples:
            self.lam *= self.n_examples / self.n

        if self.streamed:
            # drive the out-of-core loop over the HOST arrays: only
            # alpha, v and a chunk at a time go to the device
            feed = (ArrayFeed(y, idx=idx, val=val, d=self.d, bucket=B,
                              device=self.device) if sparse
                    else ArrayFeed(y, X=X, bucket=B, device=self.device))
            self._init_from_feed(feed, objective=self.obj, lam=self.lam,
                                 rows_checked=True, lam_scaled=True)
            return

        if sparse:
            self.idx = torch.as_tensor(idx, device=self.device)
            self.val = torch.as_tensor(val, device=self.device)
        else:
            # an sklearn-layout caller hands in X.T, a transposed view:
            # the tiling and the gap read X as a contiguous (d, n)
            self.X = torch.as_tensor(X, device=self.device).contiguous()
        self.y = torch.as_tensor(y, device=self.device)
        self.sparse = sparse

        dep = self.spec.deployment
        self.bplan = make_plan(self.n, self.d, force=force or 1)
        if self.bplan.bucket != algo.bucket:
            # the plan's bucket is authoritative (run_epoch chunks by it)
            algo = dataclasses.replace(algo, bucket=self.bplan.bucket)
            self.spec = dataclasses.replace(self.spec, algo=algo)
        self.plan = PartitionPlan(
            n_buckets=self.bplan.n_buckets, pods=dep.pods,
            lanes=dep.lanes, mode=algo.partition, seed=algo.seed,
            redeal_frac=algo.redeal_frac)
        self._init_state()

    def _init_from_cache(self, cache, *, objective, lam, streamed) -> None:
        """A `TileCache`: loaded whole onto the device, or streamed
        through its `TileFeed`.  Cache tiles arrive pre-padded, so the
        padded-objective lam rescale of `_init_from_arrays` is applied
        here (n_examples / n)."""
        meta = cache.meta
        self._resolve_obj(objective, lam, default_obj=meta.objective)
        if meta.n > meta.n_examples:
            self.lam *= meta.n_examples / meta.n
        algo = self.spec.algo
        if algo.bucket not in (0, 1, meta.bucket):
            raise ValueError(
                f"cfg bucket={algo.bucket} != cache bucket={meta.bucket}; "
                f"rebuild the cache at the training bucket size")
        self.cache = cache
        if not streamed:
            arrays, y = cache.load_arrays()
            # writable copies where the arrays are views of the read-only
            # mmap (a CPU tensor would alias them)
            arrays, y = (tuple(np.require(a, requirements="W")
                               for a in arrays) if meta.kind == "sparse"
                         else np.require(arrays, requirements="W"),
                         np.require(y, requirements="W"))
            # the registry's caches hold deduped rows: don't re-sort the
            # whole dataset to prove it again
            kw = dict(objective=self.obj, lam=self.lam, bucket=meta.bucket,
                      pad=False, trusted_rows=True)
            self._init_from_arrays(
                arrays, y, d=meta.d if meta.kind == "sparse" else None, **kw)
            self.n_examples = meta.n_examples
            return
        self.streamed = True
        self._init_from_feed(cache.feed(device=self.device),
                             objective=self.obj, lam=self.lam,
                             rows_checked=True, lam_scaled=True)

    def _init_from_feed(self, feed, *, objective, lam,
                        rows_checked: bool = False,
                        lam_scaled: bool = False) -> None:
        self._resolve_obj(objective, lam)
        fdev = getattr(feed, "device", None)
        if fdev is None or not same_device(fdev, self.device):
            raise ValueError(
                f"a ChunkFeed names the device its tensors land on "
                f"(`device`); this one gives {fdev}, the session runs on "
                f"{self.device}")
        self.feed = feed
        self.streamed = True
        self.sparse = bool(feed.sparse)
        self.n, self.d = int(feed.n), int(feed.d)
        if (not rows_checked and self.sparse and self._kernel_runs()
                and getattr(feed, "cache", None) is None):
            # a user-supplied feed: check its rows here if it exposes
            # them as host arrays (ArrayFeed); opaque ChunkFeeds are
            # bound by the protocol's CSR invariant instead
            fidx = getattr(feed, "idx", None)
            fval = getattr(feed, "val", None)
            if fidx is not None and fval is not None:
                from repro_torch.data.formats import \
                    raise_on_duplicate_nonzeros
                raise_on_duplicate_nonzeros(np.asarray(fidx),
                                            np.asarray(fval),
                                            "ad-hoc sparse rows")
        src_cache = getattr(feed, "cache", None)
        if src_cache is not None:
            self.n_examples = src_cache.meta.n_examples
            if not lam_scaled and self.n > self.n_examples:
                # a cache-backed feed handed to Session directly: the
                # same rescale as _init_from_cache
                self.lam *= self.n_examples / self.n
        elif not hasattr(self, "n_examples"):
            self.n_examples = self.n
        algo, dep = self.spec.algo, self.spec.deployment
        if algo.bucket not in (0, 1, feed.bucket):
            raise ValueError(
                f"cfg bucket={algo.bucket} != feed bucket={feed.bucket}")
        self.bplan = BucketPlan(n=self.n, bucket=feed.bucket,
                                n_buckets=self.n // feed.bucket)
        self.plan = PartitionPlan(
            n_buckets=self.bplan.n_buckets, pods=dep.pods,
            lanes=dep.lanes, mode=algo.partition, seed=algo.seed,
            redeal_frac=algo.redeal_frac)
        self._init_state()
        self._rebuild_epoch_fn()

    def _init_from_registry(self, name, *, objective, lam, bucket, n, d,
                            data_dir, streamed=False, cache_dir=None,
                            nnz_multiple=None) -> None:
        from repro_torch.data import registry
        spec = registry.get_spec(name)
        objective = objective or spec.objective
        lam = spec.lam if lam is None else lam
        B = bucket or max(self.spec.algo.bucket, 1)
        if streamed or cache_dir is not None:
            # nnz_multiple pads raw svmlight rows to an aligned width
            # (part of the cache key, as in the reference)
            cache = registry.materialize(
                name, cache_dir, bucket=B, pods=self.spec.deployment.pods,
                n=n, d=d, pad_multiple=_pad_multiple(self.spec, B),
                nnz_multiple=nnz_multiple, data_dir=data_dir)
            self._init_from_cache(cache, objective=objective, lam=lam,
                                  streamed=streamed)
            return
        ds = registry.get_dataset(name, n=n, d=d, data_dir=data_dir)
        if ds.sparse:
            # registry samplers dedupe rows at the source
            self._init_from_arrays((ds.idx, ds.val), ds.y,
                                   objective=objective, lam=lam, d=ds.d,
                                   bucket=B, pad=True, trusted_rows=True)
        else:
            self._init_from_arrays(ds.X, ds.y, objective=objective,
                                   lam=lam, d=None, bucket=B, pad=True)

    def _init_state(self) -> None:
        if not hasattr(self, "n_examples"):
            self.n_examples = self.n
        self.alpha = torch.zeros(self.n, dtype=torch.float32,
                                 device=self.device)
        self.v = torch.zeros(self.d, dtype=torch.float32, device=self.device)
        self.epochs_done = 0

    def _rebuild_epoch_fn(self) -> None:
        """(Re)build the streamed epoch from the current spec and damp:
        at construction, and by the health remedies (solver reroute,
        damping) that change how an epoch runs.  The resident epochs
        read both at every call."""
        if self.feed is not None and self._mesh is not None:
            from repro_torch.launch import glm
            kw: dict[str, Any] = {}
            if self.sparse:
                kw["feature_shard"] = self.spec.deployment.feature_shard
                nnz = _feed_nnz(self.feed)
                if nnz:
                    kw["nnz"] = nnz
            scale = glm.scale_for_estimator(self, **kw)
            self._epoch_fn = glm.make_streamed_epoch_mesh(
                scale, self._mesh, self.feed, obj=self.obj,
                journal=self._journal, damp=self._damp)
        elif self.feed is not None:
            self._epoch_fn = engine.make_streamed_epoch(
                self.obj, self.spec, self.plan, self.feed, lam=self.lam,
                journal=self._journal, damp=self._damp, device=self.device)

    def _switch_local_solver(self, kind: str) -> None:
        """Reroute the local solver (the health guard's kernel -> torch
        fallback, taken on a CPU session only) and rebuild the epoch."""
        algo = dataclasses.replace(self.spec.algo, local_solver=kind)
        self.spec = dataclasses.replace(self.spec, algo=algo)
        self._rebuild_epoch_fn()

    # -- epoch-level control ------------------------------------------------

    def _run_epoch(self, alpha: Tensor, v: Tensor, epoch: int,
                   stats: Optional[dict] = None):
        if self.feed is not None:
            return self._epoch_fn(alpha, v, epoch, stats=stats)
        if self.sparse:
            return engine.sim_epoch_sparse(
                self.obj, self.idx, self.val, self.y, alpha, v, self.lam,
                self.plan, self.bplan, self.spec, epoch,
                dv_scale_mul=self._damp, device=self.device)
        return engine.sim_epoch_dense(
            self.obj, self.X, self.y, alpha, v, self.lam, self.plan,
            self.bplan, self.spec, epoch, dv_scale_mul=self._damp,
            device=self.device)

    def epoch(self, *, stats: Optional[dict] = None) -> dict[str, float]:
        """Run exactly one epoch; returns {'epoch', 'rel_change', 't'}.

        't' is this epoch's duration when called standalone; inside
        `fit` it is rewritten to the cumulative fit wall-clock.  On a
        streamed session ``stats`` receives the epoch's ingest-overlap
        metrics (`engine.run_epoch_streamed`; a device synchronize at
        the epoch's end)."""
        t0 = time.perf_counter()
        if self._faults is not None:
            # the fault probes: an epoch-boundary kill, a kernel failure
            # on any solver but "torch", and NaN poisoning after the
            # epoch (the resident twin of nan-chunk)
            self._faults.maybe_kill(self.epochs_done)
            if self.spec.algo.local_solver != "torch":
                self._faults.maybe_kernel_fail(self.epochs_done)
        v_prev = self.v
        self.alpha, self.v = self._run_epoch(self.alpha, self.v,
                                             self.epochs_done, stats=stats)
        if self._faults is not None \
                and self._faults.nan_epoch(self.epochs_done):
            self.v = self.v * float("nan")
        self.epochs_done += 1
        if self._journal is not None:
            self._journal.commit_epoch(self.alpha, self.v,
                                       self.epochs_done)
        rel = float(torch.linalg.norm(self.v - v_prev)
                    / torch.clamp_min(torch.linalg.norm(self.v), 1e-30))
        rec = {"epoch": self.epochs_done, "rel_change": rel,
               "t": time.perf_counter() - t0}
        self.history.append(rec)
        return rec

    def fit(self, *, until: Optional[int] = None,
            max_epochs: Optional[int] = None, tol: float = 1e-3,
            gap_every: int = 0, callbacks: Sequence = (),
            verbose: bool = False, diverge_above: float = 1e8,
            health=None) -> FitResult:
        """Train to `until` (absolute epoch) or `max_epochs` more epochs.

        Stops early when the relative model change drops below `tol`
        (the paper's stopping rule), when the iterate diverges, or when
        any callback's `on_epoch_end(metrics)` returns truthy.
        Re-entrant: a second `fit` continues from the current state.

        ``health`` (a `HealthPolicy`, a `HealthMonitor`, or True for the
        defaults; by default the Session's ``health=``) installs the
        numerical-health guard first in line: instead of the built-in
        stop on divergence, an unhealthy epoch, or one that raises an
        `Exception`, rolls back to the last healthy snapshot and is
        retried or remediated per the policy
        (`repro_torch.resilience.health`).  Only the monitor absorbs an
        epoch's exception; without one it propagates.  A kernel's
        failure off the CPU propagates under a monitor too, once its
        retries are spent: the monitor refuses the fallback there.
        """
        if until is None:
            until = self.epochs_done + (100 if max_epochs is None
                                        else max_epochs)
        elif max_epochs is not None:
            raise TypeError("pass either until= or max_epochs=, not both")
        cbs = list(callbacks)
        monitor = next((cb for cb in cbs
                        if isinstance(cb, HealthMonitor)), None)
        health = health if health is not None else self._health
        if monitor is None and health is not None:
            if isinstance(health, HealthMonitor):
                monitor = health
            elif isinstance(health, HealthPolicy):
                monitor = HealthMonitor(health)
            else:                      # health=True: the default policy
                monitor = HealthMonitor()
            # first in line: it must see (and repair) the state before
            # other callbacks consume the epoch record
            cbs.insert(0, monitor)
        for cb in cbs:
            bind = getattr(cb, "bind", None)
            if bind is not None:
                bind(self)
        needs_gap = any(getattr(cb, "needs_gap", False) for cb in cbs)

        history: list[dict[str, float]] = []
        t0 = time.perf_counter()
        converged = diverged = False
        while self.epochs_done < until:
            try:
                rec = self.epoch()
            except Exception as err:
                # only a health monitor may absorb an epoch's failure: it
                # rolls back and remediates, and re-raises when the
                # policy is spent (SimulatedCrash is a BaseException, so
                # it never lands here)
                if monitor is None:
                    raise
                monitor.on_epoch_error(err)
                continue
            rec["t"] = time.perf_counter() - t0
            want_gap = needs_gap or (
                gap_every and self.epochs_done % gap_every == 0)
            vmax = float(torch.max(torch.abs(self.v)))
            if not np.isfinite(vmax) or vmax > diverge_above:
                if monitor is None:
                    diverged = True
                    history.append(rec)
                    break
                want_gap = False       # no gap pass over non-finite state
            if want_gap:
                rec["gap"] = self.gap()
            history.append(rec)
            if verbose:
                print(f"epoch {self.epochs_done:4d} "
                      f"rel={rec['rel_change']:.3e} "
                      + (f"gap={rec['gap']:.3e}" if "gap" in rec else ""))
            stop = False
            for cb in cbs:
                fn = getattr(cb, "on_epoch_end", cb)
                stop = bool(fn(rec)) or stop
            if rec["rel_change"] < tol:
                converged = True
                break
            if stop:
                break
        if monitor is not None and monitor.gave_up:
            diverged = True
        if not history:
            history = [{"epoch": self.epochs_done, "rel_change": 0.0,
                        "t": 0.0, "gap": self.gap()}]
        elif "gap" not in history[-1]:
            history[-1]["gap"] = self.gap() if not diverged else float("inf")
        return FitResult(
            epochs=self.epochs_done, converged=converged,
            diverged=diverged, v=self.v.cpu().numpy(),
            alpha=self.alpha.cpu().numpy(), history=history,
            wall_time=time.perf_counter() - t0)

    # -- diagnostics ----------------------------------------------------------

    @property
    def mesh_feed(self):
        """The `engine.MeshChunkFeed` driving a mesh-streamed session (its
        ``bytes_h2d``/``fetch_s`` counters); None off the mesh path."""
        if self._mesh is None:
            return None
        return getattr(self._epoch_fn, "feed", None)

    def _streamed_primal_dual(self, gbuckets: int = 256
                              ) -> tuple[float, float]:
        """One streaming pass over the cache (or feed), `gbuckets`
        buckets at a time, never holding the examples whole on the
        device: -> (primal, dual).  Each group's loss and conjugate are
        summed on the device in f32, the groups' sums on the host in
        Python floats (as the reference does), so the value is not
        bitwise the resident gap's."""
        nb, B = self.bplan.n_buckets, self.bplan.bucket
        dev = self.device
        losses, conjs = [], []
        for start in range(0, nb, gbuckets):
            bids = np.arange(start, min(start + gbuckets, nb))
            if self.cache is not None:
                data, yb = self.cache.gather_buckets(bids)
                data, yb = _to_device(data, dev), _to_device(yb, dev)
            else:
                # a mesh feed (under a ResilientChunkFeed too, whose inner
                # feed make_streamed_epoch_mesh upgrades in place) hands
                # raw host rows: its sliced fetch gives per-lane
                # compactions the margins cannot take
                hf = getattr(self.feed, "host_fetch", None) or getattr(
                    getattr(self.feed, "feed", None), "host_fetch", None)
                if hf is not None:
                    data, yb = hf(bids)
                    data, yb = _to_device(data, dev), _to_device(yb, dev)
                else:
                    data, yb = self.feed.fetch(bids)
            m = margins(self.v, data)
            losses.append(torch.sum(self.obj.loss(m, yb)))
            a = self.alpha[start * B:start * B + yb.shape[0]]
            conjs.append(torch.sum(self.obj.conj_neg(a, yb)))
        loss_sum = sum(torch.stack(losses).tolist())
        conj_sum = sum(torch.stack(conjs).tolist())
        reg = 0.5 * self.lam * float(torch.sum(self.v ** 2))
        return loss_sum / self.n + reg, -conj_sum / self.n - reg

    def primal(self) -> float:
        """Primal objective P(v) at the current shared vector."""
        if self.streamed:
            return self._streamed_primal_dual()[0]
        if self.sparse:
            m = margins(self.v, (self.idx, self.val))
            return float(torch.sum(self.obj.loss(m, self.y)) / self.n
                         + 0.5 * self.lam * torch.sum(self.v ** 2))
        return float(objectives.primal_value(
            self.obj, self.v, self.X, self.y, self.lam))

    def gap(self) -> float:
        """Duality gap P(v) - D(alpha) — the convergence certificate."""
        if self.streamed:
            p, dval = self._streamed_primal_dual()
            return p - dval
        if self.sparse:
            dval = objectives.dual_value(self.obj, self.alpha, self.v,
                                         self.y, self.lam)
            return self.primal() - float(dval)
        return float(objectives.duality_gap(
            self.obj, self.alpha, self.v, self.X, self.y, self.lam))

    # -- checkpoint/restart ---------------------------------------------------

    def state_dict(self) -> dict[str, Any]:
        """Training state (alpha, v, epoch) as host arrays."""
        return {"alpha": self.alpha.cpu().numpy(),
                "v": self.v.cpu().numpy(),
                "epoch": np.int64(self.epochs_done)}

    def load_state_dict(self, st: dict[str, Any]) -> None:
        """Restore training state produced by `state_dict` (or by
        `repro_torch.convert.session_state` from the reference); leaves
        may be arrays or tensors on any device, and are copied."""
        self.alpha, self.v = (
            torch.as_tensor(st[k]).to(self.device, torch.float32, copy=True)
            for k in ("alpha", "v"))
        self.epochs_done = int(st["epoch"])

    def save(self, path, *, meta: Optional[dict] = None) -> None:
        """Atomic on-disk snapshot of the solver state (+ meta), in the
        reference's checkpoint layout."""
        from repro_torch.checkpoint import save_tree
        save_tree(path, self.state_dict(),
                  meta=dict(meta or {}, epochs_done=self.epochs_done))

    def load(self, path) -> dict:
        """Restore solver state saved by `save` (by either package) onto
        the session's device; returns the meta dict."""
        from repro_torch.checkpoint import restore_tree
        st, meta = restore_tree(path, self.state_dict(), device=self.device)
        self.load_state_dict(st)
        return meta
