"""System-aware choice of bucket and chunk geometry for the H100.

The paper's follow-up, SySCD (PAPERS.md), makes bucket size, worker
count and data layout functions of the machine rather than config
constants.  This is that planner for the port, the reference's
`repro.core.planner` with the card's budgets in place of the TPU's:
given a workload signature (n, d, nnz, sparsity) and a topology
(backend, device count, pods, lanes, model lanes, the L2 budget) it

  1. enumerates candidate geometries (bucket B, chunks, nnz padding,
     replicated or feature-sharded layout) and routes each through the
     kernels' own predicates (`kernels.ops.sparse_solver_plan`,
     `dense_kernel_misfit`), which the planner never loosens;
  2. scores them with an analytic bytes-per-effective-epoch model (HBM
     traffic per epoch times a mild convergence factor for shuffle
     granularity and sync interval);
  3. optionally refines the best few with timed probe epochs
     (`probe_plans`, given a ``probe_fn(plan) -> seconds``);
  4. returns a `SolverPlan`, cached on disk per (workload fingerprint,
     topology fingerprint, PLAN_VERSION) under the tile cache's root
     (`plans_torch/`), so a search is paid once per workload and
     machine.

``$REPRO_PLAN`` selects the mode, as in the reference:

    off      the static rules, nothing read or written on disk
    on       route and record; keep the static geometry unless the
             kernels cannot take it (default)
    search   the analytic model picks the geometry left open
    probe    search, then timed probe epochs when a probe_fn is given

Under ``on`` the geometry is the static rules' on every shape they
already serve.  A planner fault (a bad cache file, a search exception)
degrades to the static plan with a warning, except a probe on a CUDA
topology: a kernel that fails to build or launch there raises, and is
never dropped quietly from the search.  Nothing here reroutes a
workload to the plain version: a shape no kernel takes still raises
where the engine launches it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import pathlib
import warnings
from typing import Callable, Optional

import torch

from repro_torch.core.bucketing import choose_bucket_size
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.contracts import SMEM_OPTIN_BYTES

__all__ = [
    "PLAN_VERSION", "H2D_BW", "HBM_BW", "L2_BYTES", "WorkloadSignature",
    "Topology", "SolverPlan", "plan_mode", "static_plan",
    "candidate_plans", "plan_cost", "search_plans", "probe_plans",
    "resolve_plan", "plan_cache_dir", "load_cached_plan", "store_plan",
    "route_sparse", "route_dense", "feature_shard_default",
    "streamed_transfer_bytes",
]

#: Bump when the plan schema, the search space or the cost model
#: changes meaning: the cache key embeds it and `load_cached_plan`
#: re-checks the stored field.
PLAN_VERSION = 1

#: Candidate bucket sizes (the dense kernel caps B at MAX_BUCKET = 512).
BUCKET_CANDIDATES = (8, 16, 32, 64, 128)
#: Candidate sync intervals (v reductions per epoch).
CHUNK_CANDIDATES = (1, 2, 4, 8)

# Convergence-multiplier constants, the reference's: larger buckets
# coarsen the per-epoch shuffle, fewer chunks leave v replicas staler
# between syncs.  The score ranks candidates; probes are ground truth.
CONV_BUCKET_COST = 0.02       # per doubling of B above 8
CONV_SYNC_COST = 0.10         # x (workers-1)/workers / chunks

#: HBM bandwidth of the H100 SXM (NVIDIA's data sheet, at its 700 W
#: limit), the rate `chip_smoke.py` bounds the kernels with.
HBM_BW = 3.35e12
#: Pinned host-to-device copy rate (bytes/s), which weighs a streamed
#: plan's ingest bytes against HBM traffic in `plan_cost`: 256 MiB in
#: 0.005416 s, the median of 5 copies timed by CUDA events in
#: `chip_smoke.py`'s planner phase on an NVIDIA H100 80GB HBM3 at a
#: 700.00 W limit (PERF.md, section 6, names the run).  `launch/mesh.py`
#: re-exports both rates.
H2D_BW = 49.56e9

#: The H100 SXM's L2 cache (50 MB): the v budget.  The replicated
#: sparse kernel keeps v in global memory and relies on L2 for its hot
#: entries, so a padded f32 v above it is a feature-sharding workload.
L2_BYTES = 52_428_800


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# Inputs: workload signature and machine topology
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkloadSignature:
    """Everything about the data that shapes the plan.

    ``nnz`` is the padded-CSR row width (0 for dense), ``density`` an
    optional observed nonzero fraction (informational).  ``name`` is the
    registry name when known, so cached plans are findable on disk.
    ``streamed`` marks out-of-core workloads, whose chunks cross the
    host link every epoch: `plan_cost` then adds their ingest bytes.
    """
    n: int
    d: int
    nnz: int = 0
    sparse: bool = False
    dtype_bytes: int = 4
    name: str = ""
    density: float = 0.0
    streamed: bool = False

    def fingerprint(self) -> str:
        """Stable hash of the plan-relevant fields: the reference's key
        string, so a workload hashes alike in both packages."""
        key = (f"{self.name}|n{self.n}|d{self.d}|z{self.nnz}"
               f"|s{int(self.sparse)}|b{self.dtype_bytes}"
               + ("|st1" if self.streamed else ""))
        return hashlib.sha1(key.encode()).hexdigest()[:12]


@dataclasses.dataclass(frozen=True)
class Topology:
    """Everything about the machine that shapes the plan.

    The v budget is a field, 0 meaning the H100's `L2_BYTES`, so tests
    can set exact boundaries.  Shared memory is no field: the kernels
    size their launches from `contracts.SMEM_OPTIN_BYTES`, which
    `detect` checks the card offers, and the fingerprint embeds it.
    """
    backend: str                  # "cuda" | "cpu"
    device_count: int = 1
    pods: int = 1
    lanes: int = 1
    model_lanes: int = 1
    l2_bytes: int = 0             # v budget; 0 = L2_BYTES

    @classmethod
    def detect(cls, spec=None, *, model_lanes: int = 1,
               device="cuda") -> "Topology":
        """The topology of `device` (the card unless the caller asks for
        the CPU; a missing GPU raises), with an EngineConfig's pods and
        lanes when given.  On the card the v budget is the L2 size it
        reports; a card with less opt-in shared memory per block than
        the kernels' launch configurations were built for raises."""
        dev = resolve_device(device)
        pods = lanes = 1
        if spec is not None:
            dep = getattr(spec, "deployment", spec)
            pods = getattr(dep, "pods", 1)
            lanes = getattr(dep, "lanes", 1)
        if dev.type == "cpu":
            return cls(backend="cpu", pods=pods, lanes=lanes,
                       model_lanes=model_lanes)
        props = torch.cuda.get_device_properties(dev)
        if props.shared_memory_per_block_optin < SMEM_OPTIN_BYTES:
            raise RuntimeError(
                f"{props.name} offers "
                f"{props.shared_memory_per_block_optin} bytes of opt-in "
                f"shared memory per block; the kernels are built for "
                f"{SMEM_OPTIN_BYTES} (an H100)")
        return cls(backend="cuda", device_count=torch.cuda.device_count(),
                   pods=pods, lanes=lanes, model_lanes=model_lanes,
                   l2_bytes=int(props.L2_cache_size))

    @property
    def workers(self) -> int:
        return max(self.pods * self.lanes, 1)

    def v_budget(self) -> int:
        return self.l2_bytes or L2_BYTES

    def fingerprint(self) -> str:
        """Stable hash of the plan-relevant machine facts (the
        reference's key format, the opt-in shared memory as the total
        budget)."""
        key = (f"{self.backend}|c{self.device_count}|p{self.pods}"
               f"|l{self.lanes}|m{self.model_lanes}"
               f"|v{self.v_budget()}|t{SMEM_OPTIN_BYTES}")
        return hashlib.sha1(key.encode()).hexdigest()[:12]


# ---------------------------------------------------------------------------
# Output: the plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SolverPlan:
    """One resolved geometry and route for a (workload, topology) pair.

    ``solver`` is what ``local_solver="auto"`` resolves to ("kernel" |
    "torch"); ``route`` the kernel the shapes take ("kernel" |
    "kernel-sharded" | "torch", as `ops.sparse_solver_plan` names them);
    ``origin`` how the plan was made ("static" | "search" | "probe" |
    "cache").  ``score`` is the analytic bytes per effective epoch
    (lower is better, comparable within one workload and topology).
    ``reason`` is the misfit text of a "torch" route and "fits"
    otherwise; ``reason_code`` its `ops.MisfitCode` ("" when it fits).
    """
    solver: str
    route: str
    bucket: int
    chunks: int
    nnz_multiple: int             # 0 = no row-width padding
    feature_shard: bool
    reason: str = ""
    reason_code: str = ""
    origin: str = "static"
    score: float = 0.0
    probe_s: float = -1.0         # timed probe epoch seconds (-1 = none)
    version: int = PLAN_VERSION

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "SolverPlan":
        """Inverse of `to_json`; unknown keys are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in names})


# ---------------------------------------------------------------------------
# Mode
# ---------------------------------------------------------------------------

_MODES = ("on", "off", "search", "probe")


def plan_mode() -> str:
    """``$REPRO_PLAN`` -> "on" | "off" | "search" | "probe".  Unset or
    empty means "on"; anything else unknown raises."""
    env = os.environ.get("REPRO_PLAN", "").strip().lower()
    if not env:
        return "on"
    if env not in _MODES:
        raise ValueError(
            f"$REPRO_PLAN={env!r}: must be one of {', '.join(_MODES)}")
    return env


# ---------------------------------------------------------------------------
# Routes and feasibility: the kernels' own predicates
# ---------------------------------------------------------------------------


def route_sparse(n_local: int, nnz: int, d: int, bucket: int, *,
                 model_lanes: int = 1):
    """The sparse route and misfit (the engine's check, and the
    planner's with n_local = bucket: Session and cache padding make n
    divisible, so at plan time only the geometry can misfit).  A pure
    delegation to `ops.sparse_solver_plan`: $REPRO_PLAN never changes
    it."""
    return kops.sparse_solver_plan(n_local, nnz, d, bucket,
                                   model_lanes=model_lanes)


def route_dense(d: int, n_local: int, bucket: int):
    """The dense misfit (a reason or None), the engine's check and the
    planner's: a pure delegation to `ops.dense_kernel_misfit`."""
    return kops.dense_kernel_misfit(d, n_local, bucket)


def _plan_feasible(sig: WorkloadSignature, topo: Topology,
                   plan: SolverPlan) -> bool:
    """A kernel plan must still pass the kernels' predicates; a "torch"
    plan always runs."""
    if plan.solver != "kernel":
        return True
    nnz = _effective_nnz(sig, plan.nnz_multiple)
    if sig.sparse:
        lanes = topo.model_lanes if plan.feature_shard else 1
        route, _ = route_sparse(plan.bucket, nnz, sig.d, plan.bucket,
                                model_lanes=lanes)
        return route == plan.route
    return route_dense(sig.d, plan.bucket, plan.bucket) is None


def _effective_nnz(sig: WorkloadSignature, nnz_multiple: int) -> int:
    if not sig.sparse:
        return 0
    if nnz_multiple:
        return _round_up(max(sig.nnz, 1), nnz_multiple)
    return sig.nnz


def feature_shard_default(sig: WorkloadSignature,
                          topo: Optional[Topology] = None) -> bool:
    """The static layout rule: shard features over 'model' when the
    padded f32 v exceeds the topology's v budget (sparse), or when d is
    TP-wide (dense, d >= 512)."""
    if topo is None:
        topo = Topology(backend="cuda")
    if sig.sparse:
        d_pad = _round_up(max(sig.d, 8), 8)
        return d_pad * 4 > topo.v_budget()
    return sig.d >= 512


# ---------------------------------------------------------------------------
# Static resolution
# ---------------------------------------------------------------------------


def static_plan(sig: WorkloadSignature, topo: Topology, *,
                bucket: Optional[int] = None,
                chunks: Optional[int] = None,
                nnz_multiple: Optional[int] = None) -> SolverPlan:
    """The fixed rules as a `SolverPlan`: bucket from the caller (else
    `bucketing.choose_bucket_size`), chunks from the caller (else 1),
    layout from `feature_shard_default`, route from the kernels'
    predicates.  ``$REPRO_PLAN=off`` and every planner fault give it."""
    B = bucket if bucket else choose_bucket_size(sig.n, sig.d)
    C = chunks if chunks else 1
    return _routed_plan(sig, topo, B, C, nnz_multiple or 0,
                        feature_shard_default(sig, topo), origin="static")


def _routed_plan(sig: WorkloadSignature, topo: Topology, bucket: int,
                 chunks: int, nnz_multiple: int, feature_shard: bool,
                 origin: str) -> SolverPlan:
    """A candidate geometry with the kernels' route and its score."""
    nnz = _effective_nnz(sig, nnz_multiple)
    if sig.sparse:
        lanes = topo.model_lanes if feature_shard else 1
        route, reason = route_sparse(bucket, nnz, sig.d, bucket,
                                     model_lanes=lanes)
    else:
        reason = route_dense(sig.d, bucket, bucket)
        route = "torch" if reason else "kernel"
    solver = "torch" if route == "torch" else "kernel"
    if topo.backend != "cuda":
        # "auto" runs the plain version off the card: the route says
        # what the card would launch, the score is this machine's
        solver = "torch"
    plan = SolverPlan(
        solver=solver, route=route, bucket=bucket, chunks=chunks,
        nnz_multiple=nnz_multiple, feature_shard=feature_shard,
        reason=str(reason or "fits"),
        reason_code=getattr(reason, "code", ""), origin=origin)
    return dataclasses.replace(plan, score=plan_cost(sig, topo, plan))


# ---------------------------------------------------------------------------
# The search: candidates -> analytic score -> (optional) probe epochs
# ---------------------------------------------------------------------------


def candidate_plans(sig: WorkloadSignature, topo: Topology, *,
                    bucket: Optional[int] = None,
                    chunks: Optional[int] = None,
                    nnz_multiple: Optional[int] = None
                    ) -> list[SolverPlan]:
    """The search space, with the caller's fixed knobs kept: buckets,
    chunk counts that divide the bucket count, nnz padding to 8 where
    the row width is not a multiple of 8, and the sharded layout where
    the topology has model lanes or the static rule shards."""
    buckets = (bucket,) if bucket else BUCKET_CANDIDATES
    chunk_opts = (chunks,) if chunks else CHUNK_CANDIDATES
    if nnz_multiple is not None:
        zmults: tuple[int, ...] = (nnz_multiple,)
    elif sig.sparse and sig.nnz % 8:
        zmults = (0, 8)
    else:
        zmults = (0,)
    layouts = [False]
    if topo.model_lanes > 1 or feature_shard_default(sig, topo):
        layouts.append(True)
    out = []
    for B in buckets:
        for C in chunk_opts:
            nb = max(sig.n // max(B, 1), 1)
            if nb % C:
                continue
            for z in zmults:
                for shard in layouts:
                    out.append(_routed_plan(sig, topo, B, C, z, shard,
                                            origin="search"))
    return out


def streamed_transfer_bytes(sig: WorkloadSignature, topo: Topology,
                            plan: SolverPlan) -> float:
    """Modelled host-to-device bytes per worker per streamed epoch (the
    reference's model):

      dense replicated   n_loc * d * 4
      dense TP           n_loc * d_loc * 4
      sparse replicated  n_loc * nnz * 8          (idx + val)
      sparse sharded     n_loc * w * 12           (idx/val/pos of the
                         per-lane share w of the row width)

    plus 4 bytes of label per example."""
    n_loc = max(sig.n // max(topo.workers, 1), 1)
    y_bytes = n_loc * 4
    if sig.sparse:
        nnz = max(_effective_nnz(sig, plan.nnz_multiple), 1)
        if plan.feature_shard and topo.model_lanes > 1:
            mult = plan.nnz_multiple or 8
            w = min(_round_up(-(-nnz // topo.model_lanes), mult), nnz)
            return float(n_loc * w * 12 + y_bytes)
        return float(n_loc * nnz * 8 + y_bytes)
    d_loc = sig.d
    if plan.feature_shard and topo.model_lanes > 1:
        d_loc = -(-sig.d // topo.model_lanes)
    return float(n_loc * d_loc * sig.dtype_bytes + y_bytes)


def plan_cost(sig: WorkloadSignature, topo: Topology,
              plan: SolverPlan) -> float:
    """Analytic score: modelled HBM bytes per effective epoch, per
    worker.  Every route reads the data once; the plain scan also
    gathers and scatters v per coordinate; the replicated kernel pays v
    only at chunk syncs; the sharded pair round-trips its d/M slice per
    bucket and reads the exchanged (M, B, nnz) working set.  Streamed
    workloads add their ingest bytes at the HBM-to-host-link rate
    ratio.  The sum is multiplied by a mild convergence factor for
    coarse shuffles (large B) and stale replicas (few chunks)."""
    n_loc = max(sig.n // topo.workers, 1)
    B, C = plan.bucket, max(plan.chunks, 1)
    nnz = _effective_nnz(sig, plan.nnz_multiple)
    if sig.sparse:
        data = n_loc * nnz * (4 + sig.dtype_bytes)
        sync = C * sig.d * sig.dtype_bytes * 2
        if plan.route == "kernel":
            traffic = data + sync
        elif plan.route == "kernel-sharded":
            M = max(topo.model_lanes, 1)
            d_loc = kops.sparse_slice_width(sig.d, M)
            nb = max(n_loc // B, 1)
            traffic = (data + nb * d_loc * sig.dtype_bytes * 2
                       + nb * M * B * nnz * sig.dtype_bytes + sync)
        else:
            traffic = data + n_loc * nnz * sig.dtype_bytes * 3 + sync
    else:
        d_loc = sig.d
        data = n_loc * d_loc * sig.dtype_bytes
        sync = C * d_loc * sig.dtype_bytes * 2
        if plan.route == "kernel" and plan.solver == "kernel":
            traffic = data + sync
        else:
            # the scan re-touches v per bucket (Gram and margin carry)
            traffic = data + max(n_loc // B, 1) * d_loc \
                * sig.dtype_bytes * 2 + sync
    if sig.streamed:
        traffic += streamed_transfer_bytes(sig, topo, plan) \
            * (HBM_BW / H2D_BW)
    conv = 1.0 + CONV_BUCKET_COST * max(math.log2(max(B, 8) / 8), 0.0)
    W = topo.workers
    if W > 1:
        conv *= 1.0 + CONV_SYNC_COST * (W - 1) / W / C
    return float(traffic) * conv


def search_plans(sig: WorkloadSignature, topo: Topology, *,
                 bucket: Optional[int] = None,
                 chunks: Optional[int] = None,
                 nnz_multiple: Optional[int] = None,
                 top_k: int = 3) -> list[SolverPlan]:
    """The best `top_k` feasible plans under the analytic model.  Ties
    go to the static layout, then the smaller bucket, then the fewer
    chunks: where the model cannot tell, the static resolution wins."""
    cands = candidate_plans(sig, topo, bucket=bucket, chunks=chunks,
                            nnz_multiple=nnz_multiple)
    cands = [c for c in cands if _plan_feasible(sig, topo, c)]
    shard0 = feature_shard_default(sig, topo)
    cands.sort(key=lambda p: (p.score, p.feature_shard != shard0,
                              p.bucket, p.chunks, p.nnz_multiple))
    return cands[:max(top_k, 1)]


def probe_plans(cands: list[SolverPlan],
                probe_fn: Callable[[SolverPlan], float], *,
                topo: Topology) -> SolverPlan:
    """Time each ranked candidate with ``probe_fn(plan) -> seconds`` and
    return the fastest, with ``origin="probe"`` and its ``probe_s``.

    On a CPU topology a probe that raises disqualifies its candidate,
    with a warning, as in the reference.  On a CUDA topology it
    propagates: a probe runs the kernels, and a kernel that fails to
    build or launch must never be quietly dropped from the search."""
    best: Optional[SolverPlan] = None
    for cand in cands:
        if topo.backend == "cuda":
            dt = float(probe_fn(cand))
        else:
            try:
                dt = float(probe_fn(cand))
            # audit: except-ok a failed CPU probe is warned about and skipped
            except Exception as e:
                warnings.warn(f"plan probe failed for bucket={cand.bucket} "
                              f"chunks={cand.chunks}: {e}", stacklevel=2)
                continue
        timed = dataclasses.replace(cand, probe_s=dt, origin="probe")
        if best is None or dt < best.probe_s:
            best = timed
    if best is None:
        raise RuntimeError("every probe candidate failed")
    return best


# ---------------------------------------------------------------------------
# Disk cache, under the tile cache's root
# ---------------------------------------------------------------------------

_MAGIC = "repro_torch-solver-plan"


def plan_cache_dir(cache_dir=None) -> pathlib.Path:
    """``<tile-cache root>/plans_torch``.  The root is the one the
    reference uses, and the reference keeps its own plans in ``plans/``
    under another magic: one directory for both would have each package
    reject and overwrite the other's files."""
    from repro_torch.data.registry import cache_root
    return cache_root(cache_dir) / "plans_torch"


def _plan_path(sig: WorkloadSignature, topo: Topology,
               cache_dir=None) -> pathlib.Path:
    name = f"{sig.name}-" if sig.name else ""
    return plan_cache_dir(cache_dir) / (
        f"{name}{sig.fingerprint()}-{topo.fingerprint()}"
        f"-v{PLAN_VERSION}.json")


def store_plan(sig: WorkloadSignature, topo: Topology, plan: SolverPlan,
               cache_dir=None) -> pathlib.Path:
    """Write a plan (sorted keys, atomic rename)."""
    path = _plan_path(sig, topo, cache_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = {"magic": _MAGIC, "version": PLAN_VERSION,
           "signature": dataclasses.asdict(sig),
           "topology": dataclasses.asdict(topo),
           "plan": plan.to_json()}
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(doc, sort_keys=True, indent=1) + "\n")
    os.replace(tmp, path)
    return path


def load_cached_plan(sig: WorkloadSignature, topo: Topology,
                     cache_dir=None) -> Optional[SolverPlan]:
    """A cached plan, or None on a miss, a version skew (the file name
    and the stored field), corruption or a plan the kernels' predicates
    no longer accept."""
    path = _plan_path(sig, topo, cache_dir)
    try:
        if not path.exists():
            return None
        doc = json.loads(path.read_text())
        if doc.get("magic") != _MAGIC or doc.get("version") != PLAN_VERSION:
            return None
        plan = SolverPlan.from_json(doc["plan"])
        if plan.version != PLAN_VERSION:
            return None
        if not _plan_feasible(sig, topo, plan):
            return None
        return dataclasses.replace(plan, origin="cache")
    # audit: except-ok unreadable/stale cache entry -> plan from scratch
    except Exception:
        return None


# ---------------------------------------------------------------------------
# The front door
# ---------------------------------------------------------------------------


def resolve_plan(sig: WorkloadSignature, topo: Optional[Topology] = None,
                 *, bucket: Optional[int] = None,
                 chunks: Optional[int] = None,
                 nnz_multiple: Optional[int] = None,
                 cache_dir=None,
                 probe_fn: Optional[Callable[[SolverPlan], float]] = None,
                 use_cache: bool = True) -> SolverPlan:
    """Workload and topology -> `SolverPlan`, under ``$REPRO_PLAN``.

    Knobs the caller fixed are kept; the planner decides only what was
    left open:

      off    -> `static_plan`, nothing read or written;
      cache  -> a stored plan for this (fingerprint, topology, version)
                that the predicates still accept and that keeps the
                fixed knobs;
      on     -> the static geometry if the kernels take it, else the
                best feasible search candidate;
      search -> the best candidate under the analytic model;
      probe  -> search, then timed probes of the best candidates when
                ``probe_fn`` is given.

    A planner fault degrades to `static_plan` with a warning.  What a
    probe raises on a CUDA topology is no planner fault: it propagates.
    `topo` defaults to the card's.
    """
    if topo is None:
        topo = Topology.detect()
    mode = plan_mode()
    fixed = dict(bucket=bucket, chunks=chunks, nnz_multiple=nnz_multiple)
    if mode == "off":
        return static_plan(sig, topo, **fixed)
    probing_card = False
    try:
        if use_cache:
            cached = load_cached_plan(sig, topo, cache_dir)
            if cached is not None and _respects_fixed(cached, fixed):
                return cached
        static = static_plan(sig, topo, **fixed)
        if mode == "on":
            plan = static if _plan_feasible(sig, topo, static) else None
            if plan is None:
                ranked = search_plans(sig, topo, **fixed)
                plan = ranked[0] if ranked else static
        else:
            ranked = search_plans(sig, topo, **fixed)
            if not ranked:
                plan = static
            elif mode == "probe" and probe_fn is not None:
                probing_card = topo.backend == "cuda"
                plan = probe_plans(ranked, probe_fn, topo=topo)
                probing_card = False
            else:
                plan = ranked[0]
        if not _plan_feasible(sig, topo, plan):
            warnings.warn(
                "planner produced an infeasible plan "
                f"(bucket={plan.bucket}, route={plan.route}); using the "
                "static resolution instead", stacklevel=2)
            return static
        if use_cache and plan.origin != "static":
            store_plan(sig, topo, plan, cache_dir)
        return plan
    # audit: except-ok planner failure degrades to the static plan + warn
    except Exception as e:
        if probing_card:
            raise
        warnings.warn(
            f"solver planner failed ({type(e).__name__}: {e}); falling "
            f"back to static resolution ($REPRO_PLAN=off silences this)",
            stacklevel=2)
        return static_plan(sig, topo, **fixed)


def _respects_fixed(plan: SolverPlan, fixed: dict) -> bool:
    """A cached plan applies only when it keeps every fixed knob."""
    return all(fixed[k] is None or getattr(plan, k) == fixed[k]
               for k in ("bucket", "chunks", "nnz_multiple"))
