"""The budget layer: plans against the kernels' own shared-memory models.

`audit_plan` re-derives, for a plan that routes to a kernel, the
dynamic shared memory the kernel's launch would place — through the
shared-memory model its contract registers in `kernels.contracts`
(`smem_layout`, `smem_bytes`, `sharded_smem_bytes`,
`tp_step_smem_bytes`), choosing the in-shared-memory or the global
fallback layout as the wrapper does — and checks it against
`contracts.SMEM_OPTIN_BYTES`.  It trusts neither `planner._plan_feasible`
nor the plan's route verdict.  On a clean tree the sweep finds nothing,
because the routing predicates and the wrappers share those models; it
exists to catch drift (a model that a wrapper stopped mirroring, a
hand-edited plan cache) and forged plans (the mutation self-test).

Residency: the dense kernel keeps v in shared memory beside its tiles
when its layout puts the tiles there, so v must then fit the topology's
v budget too.  The sparse kernels keep v (or its slices) in global
memory and let L2 cache the hot entries, so their v is not budgeted
(the reference's VMEM_V misfit has no counterpart: `ops.
sparse_solver_plan` never misfits on d; it misfits on the row width,
`MisfitCode.SMEM_ROW`).

`run_budget_audit` sweeps every registry workload (sub and full shapes),
and two rows on either side of that width (`ROW_EDGE`), x card
topologies (1 and 4 cards; 1, 2 and 4 model lanes) x the planner's
candidate geometries, and the detected card's topology when given one;
then the TP step's model alone at its edges (`TP_STEP_EDGES`: every
bucket width up to the largest, at d_loc edges), since a plan names only
the buckets the planner tries.
"""
from __future__ import annotations

import importlib

from . import rules
from .rules import Finding

__all__ = ["audit_plan", "run_budget_audit", "TOPOLOGIES", "ROW_EDGE"]

#: (device_count, model_lanes) pairs swept per workload.
TOPOLOGIES = tuple((c, m) for c in (1, 4) for m in (1, 2, 4))

#: row widths on either side of the replicated kernel's widest row (its
#: products in shared memory: 58,112 nonzeros at the opt-in), where
#: the planner must route the wider one off that kernel
ROW_EDGE = (58_112, 58_113)

_DENSE = "sdca_bucket.sdca_bucket_kernel"
_TP_STEP = "sdca_bucket.sdca_bucket_tp_step"
_SPARSE = "sdca_sparse_bucket.sdca_sparse_bucket_kernel"
_SHARDED = "sdca_sparse_bucket.sdca_sparse_sharded_bucket"


def _model(key: str):
    """The shared-memory model that contract `key` registers."""
    from repro_torch.kernels.contracts import KERNEL_CONTRACTS
    mod, _, attr = KERNEL_CONTRACTS[key]["smem_estimate"].partition(":")
    return getattr(importlib.import_module(mod), attr)


def tp_step_edges() -> list[tuple[int, int]]:
    """The TP step's (B, d_loc) edges: every B up to the recursion's cap
    (its [m0 | G] leaves shared memory above 64, its stage rows fall to
    one a compute warp near 512), each at d_loc 1 and around one and two
    stages' rows."""
    from repro_torch.kernels import sdca_bucket as kd
    out = []
    for B in range(1, kd.MAX_BUCKET + 1):
        r = kd.tp_stage_rows(B)
        out += [(B, dl) for dl in (1, r - 1, r, r + 1, 2 * r + 1)
                if dl >= 1]
    return out


def audit_tp_step(B: int, d_loc: int) -> list[Finding]:
    """SMEM-PLAN-BUDGET for the TP step at (B, d_loc): its layout (a
    function of B alone) fits the opt-in, and its stages, a multiple of
    the compute warps' rows each, cover the lane's rows."""
    from repro_torch.kernels import sdca_bucket as kd
    from repro_torch.kernels.contracts import SMEM_OPTIN_BYTES
    placed = _model(_TP_STEP)(B)
    rows = kd.tp_stage_rows(B)
    stages = -(-d_loc // rows)
    bad = []
    if placed > SMEM_OPTIN_BYTES:
        bad.append(f"places {placed} B of shared memory a block; the "
                   f"opt-in is {SMEM_OPTIN_BYTES} B")
    if rows % kd.TP_COMPUTE_WARPS or stages * rows < d_loc:
        bad.append(f"{stages} stages of {rows} rows do not split "
                   f"{d_loc} rows over the compute warps")
    return [Finding(rules.SMEM_PLAN_BUDGET, f"sdca_bucket_tp_step "
                    f"(B={B}, d_loc={d_loc}) {msg}",
                    where="src/repro_torch/kernels/sdca_bucket.py:1",
                    case=f"tp-step/B={B}/d_loc={d_loc}") for msg in bad]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def audit_plan(sig, topo, plan) -> list[Finding]:
    """SMEM-PLAN-BUDGET for one (workload, topology, plan) triple."""
    from repro_torch.kernels import sdca_bucket, sdca_sparse_bucket as ks
    from repro_torch.kernels.contracts import SMEM_OPTIN_BYTES

    if plan.route not in ("kernel", "kernel-sharded"):
        return []
    found: list[Finding] = []
    case = (f"{sig.name or 'workload'}(n={sig.n},d={sig.d},nnz={sig.nnz})"
            f"/c={topo.device_count}/M={topo.model_lanes}/B={plan.bucket}")

    def emit(msg: str) -> None:
        found.append(Finding(rules.SMEM_PLAN_BUDGET, msg,
                             where="src/repro_torch/core/planner.py:1",
                             case=case))

    def over(what: str, placed: int) -> None:
        if placed > SMEM_OPTIN_BYTES:
            emit(f"{plan.route} plan: {what} places {placed} B of shared "
                 f"memory a block; the opt-in is {SMEM_OPTIN_BYTES} B")

    B = plan.bucket
    if not sig.sparse:
        if plan.route != "kernel":
            emit(f"dense plan claims route {plan.route!r}")
            return found
        if B > sdca_bucket.MAX_BUCKET:
            emit(f"dense plan bucket={B} exceeds the recursion cap "
                 f"B <= {sdca_bucket.MAX_BUCKET}")
        x_in, _, placed = _model(_DENSE)(B, sig.d)
        over(f"sdca_bucket (B={B}, d={sig.d})", placed)
        if x_in and sig.d * 4 > topo.v_budget():
            emit(f"dense plan keeps v ({sig.d * 4} B) in shared memory "
                 f"beside its tiles, above the {topo.v_budget()}-byte v "
                 f"budget")
        if plan.feature_shard:
            over(f"sdca_bucket_tp_step (B={B})", _model(_TP_STEP)(B))
        return found
    nnz = _round_up(max(sig.nnz, 1), plan.nnz_multiple) \
        if plan.nnz_multiple else sig.nnz
    if plan.route == "kernel-sharded":
        if not plan.feature_shard or topo.model_lanes <= 1:
            emit(f"plan claims route=kernel-sharded without a model axis "
                 f"(feature_shard={plan.feature_shard}, model_lanes="
                 f"{topo.model_lanes})")
            return found
        placed = _model(_SHARDED)(nnz)
        if not ks.sharded_fits_smem(nnz):
            placed -= 4 * ks.sharded_row_words(nnz)
        over(f"sdca_sparse_sharded_bucket (nnz={nnz})", placed)
    else:
        placed = _model(_SPARSE)(B, nnz)
        if not ks.fits_smem(B, nnz):
            placed = 4 * _round_up(nnz, 4)
        over(f"sdca_sparse_bucket (B={B}, nnz={nnz})", placed)
    return found


def _signatures():
    from repro_torch.core.planner import WorkloadSignature
    from repro_torch.data.registry import REGISTRY
    sigs = []
    for name in sorted(REGISTRY):
        spec = REGISTRY[name]
        sparse = spec.kind == "sparse"
        sigs.append(WorkloadSignature(
            n=spec.sub_n, d=spec.sub_d, nnz=spec.sub_nnz or 0,
            sparse=sparse, name=f"{name}-sub"))
        if (spec.full_n, spec.full_d) != (spec.sub_n, spec.sub_d):
            sigs.append(WorkloadSignature(
                n=spec.full_n, d=spec.full_d, nnz=spec.nnz or 0,
                sparse=sparse, name=name))
    sigs += [WorkloadSignature(n=4096, d=1 << 20, nnz=z, sparse=True,
                               name=f"row-edge-{z}") for z in ROW_EDGE]
    return sigs


def run_budget_audit(log=None, *, detected=None) -> tuple[list[Finding], int]:
    """Sweep registry workloads x `TOPOLOGIES` (and the `detected`
    card's topology, model lanes 1, 2 and 4, when given one) x candidate
    plans.  -> (findings, plans_swept)."""
    import dataclasses

    from repro_torch.core.planner import Topology, candidate_plans

    topos = [Topology(backend="cuda", device_count=c, model_lanes=m)
             for c, m in TOPOLOGIES]
    if detected is not None:
        topos += [dataclasses.replace(detected, model_lanes=m)
                  for m in (1, 2, 4)]
    found: list[Finding] = []
    n_plans = 0
    for sig in _signatures():
        for topo in topos:
            plans = candidate_plans(sig, topo)
            n_plans += len(plans)
            for plan in plans:
                found += audit_plan(sig, topo, plan)
    edges = tp_step_edges()
    for B, d_loc in edges:
        found += audit_tp_step(B, d_loc)
    if log is not None:
        log(f"  budget: {n_plans} candidate plans swept over "
            f"{len(topos)} topologies, the TP step at {len(edges)} "
            f"(B, d_loc) edges, {len(found)} finding(s)")
    return found, n_plans

