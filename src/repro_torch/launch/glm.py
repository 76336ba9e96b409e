"""Distributed GLM training: the engine's epoch program on a mesh.

The reference binds `core.engine`'s epoch (re-deal -> chunked local
sub-epoch -> sync -> pod reduce) to a ("pod", "data", "model") device
mesh with shard_map.  Here the mesh is stacked on one device
(`launch.mesh.make_host_mesh`) and its collectives are the ordered
tensor operations of `core.engine.StackedMeshCollectives`:

  * static partition of examples across pods; only the d-sized v delta
    crosses pods, once per epoch (int8 on the wire with compress_pod);
  * dynamic partition within a pod: every epoch each lane shuffles its
    buckets and re-deals them over 'data' (the all-to-all);
  * feature sharding over 'model' for wide data.  Dense (tensor
    parallelism): each model lane holds d/M rows of X and of v, and the
    lanes' per-bucket Gram and margin partials are summed, so one
    worker is a (pod, data) pair; on one device its tile is its lanes'
    slices stacked, and the dense CUDA kernel sums them in its
    reduction over d.  Sparse: each model lane owns a contiguous d/M
    slice of v, the working sets are exchanged once per bucket (the
    feature-sharded CUDA kernel pair), and 'model' joins the sync axes,
    so the ordered dv sum reassembles the slices.  Without
    feature_shard the model axis is more example lanes;
  * v replicas sync over 'data' (and 'model' when it carries examples
    or sparse slices) once per chunk, in f32 or, with compress_sync, by
    the int8 two-phase `engine.q_psum`.

Workers = pods x data lanes (x model lanes when features are not
sharded); sigma' = #workers (CoCoA+ adding).  `estimator_epoch` puts a
fitted estimator's epoch on a mesh.  `scale_for_dataset` sizes a
registry dataset at its real shape, its layout (and under
``$REPRO_PLAN=search|probe`` its bucket and chunks) from the planner
(`core.planner`).  `glm_input_specs` and the streamed mesh path (A11)
are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import engine, planner
from repro_torch.core.config import (AlgoConfig, DeploymentConfig,
                                     EngineConfig)
from repro_torch.core.objectives import LOGISTIC, Objective
from repro_torch.launch.mesh import StackedMesh


@dataclasses.dataclass(frozen=True)
class GLMScale:
    """One deployment-scale GLM workload (paper dataset, full size).
    Fields and defaults mirror the reference's, with the port's solver
    names ("auto" | "torch" | "kernel")."""
    name: str
    kind: str                 # dense | sparse
    n: int
    d: int
    nnz: int = 0              # sparse only (padded)
    bucket: int = 16
    chunks: int = 4           # v syncs per epoch over 'data'
    feature_shard: bool = False   # wide data: shard d over 'model'
    lam: float = 1e-3
    compress_pod: bool = True     # int8 cross-pod reduce
    compress_sync: bool = False   # int8 two-phase data-axis dv reduction
    redeal_frac: float = 1.0      # bucket fraction re-dealt per epoch
    local_solver: str = "auto"    # auto | torch | kernel
    deterministic: bool = False   # the stacked mesh's sums are ordered
    partition: str = "alltoall"   # the mesh's modes: alltoall | static
    aggregation: str = "adding"   # CoCoA(+) sigma' rule
    seed: int = 0                 # schedule/re-deal PRNG root

    def engine_config(self, mesh=None) -> EngineConfig:
        """The layered engine view of this workload's solver knobs."""
        pods = mesh.shape["pod"] if mesh is not None else 1
        dep = DeploymentConfig(
            pods=pods,
            lanes=(_worker_count(mesh, self) // pods
                   if mesh is not None else 1),
            feature_shard=self.feature_shard,
            compress_pod=self.compress_pod,
            deterministic=self.deterministic)
        return EngineConfig(
            algo=AlgoConfig(bucket=self.bucket, chunks=self.chunks,
                            aggregation=self.aggregation,
                            partition=self.partition,
                            redeal_frac=self.redeal_frac,
                            local_solver=self.local_solver,
                            compress_sync=self.compress_sync,
                            seed=self.seed),
            deployment=dep)


GLM_CONFIGS = {
    # criteo-kaggle: 45M examples, 1M features, ~39 nnz (padded to 40)
    "glm-criteo": GLMScale("glm-criteo", "sparse", n=45_088_768,
                           d=1_048_576, nnz=40, bucket=16, chunks=4),
    # HIGGS: 11M examples, 28 dense features — narrow: replicate features
    "glm-higgs": GLMScale("glm-higgs", "dense", n=11_010_048, d=28,
                          bucket=8, chunks=4, feature_shard=False),
    # epsilon: 400k examples, 2000 dense features — wide: TP over 'model'
    "glm-epsilon": GLMScale("glm-epsilon", "dense", n=409_600, d=2_000,
                            bucket=16, chunks=8, feature_shard=True),
    # webspam-trigram: 350k examples, 16.6M features, ~3727 nnz — the
    # feature-sharded sparse workload: model lanes each hold a d/M slice
    # of v and run the sharded kernel pair
    "glm-webspam": GLMScale("glm-webspam", "sparse", n=360_448,
                            d=16_609_280, nnz=3_728, bucket=16,
                            chunks=4, feature_shard=True),
    # int8 two-phase chunk reductions + 25% partial re-deal
    "glm-criteo-opt": GLMScale("glm-criteo-opt", "sparse", n=45_088_768,
                               d=1_048_576, nnz=40, bucket=16, chunks=4,
                               compress_sync=True, redeal_frac=0.25),
}


def _axes(mesh: StackedMesh, scale: GLMScale):
    """-> (example_axes, sync_axes, has_pod, model_is_tp).

    feature_shard picks the model axis's role.  Dense TP shards the v
    rows themselves (tp=True).  Sparse feature sharding keeps v whole,
    but each model lane's solver writes only its d/M slice, so 'model'
    leaves the example axes and joins the sync axes.  Without
    feature_shard the model axis is more example-parallel workers.
    """
    names = mesh.axis_names
    has_pod = "pod" in names
    if scale.feature_shard:
        ex = tuple(a for a in ("pod", "data") if a in names)
        if scale.kind == "dense":
            return ex, ("data",), has_pod, True
        sync = tuple(a for a in ("data", "model") if a in names)
        return ex, sync, has_pod, False
    ex = tuple(a for a in ("pod", "data", "model") if a in names)
    sync = tuple(a for a in ("data", "model") if a in names)
    return ex, sync, has_pod, False


def _worker_count(mesh: StackedMesh, scale: GLMScale) -> int:
    ex, _, _, _ = _axes(mesh, scale)
    n = 1
    for a in ex:
        n *= mesh.shape[a]
    return n


def _collectives(mesh: StackedMesh, scale: GLMScale
                 ) -> engine.StackedMeshCollectives:
    _, _, _, tp = _axes(mesh, scale)
    pods, model = mesh.shape["pod"], mesh.shape["model"]
    if tp and scale.d % model:
        raise ValueError(
            f"{scale.name}: dense tensor parallelism splits d={scale.d} "
            f"over model={model} lanes; d must be a multiple of it (the "
            f"reference's P('model') layout of X and v)")
    role = ("tp" if tp else "slices" if scale.feature_shard
            else "examples")
    return engine.StackedMeshCollectives(
        pods=pods, lanes=_worker_count(mesh, scale) // pods,
        compress_pod=scale.compress_pod, model=model, model_role=role)


def make_dense_epoch(scale: GLMScale, mesh: StackedMesh,
                     obj: Objective = LOGISTIC):
    """-> epoch fn over the global arrays: (X, y, a, v, epoch) -> (X, y,
    a, v), as the reference's shard_map program takes and returns them.

    X (d, n), y/a (n,), v (d,); columns are dealt to the example shards
    in (pod, data[, model]) order, and the returned X holds the re-dealt
    columns.  Arrays are moved to the mesh's device.  With
    feature_shard the model lanes split the features (tensor
    parallelism; d must be a multiple of the model axis): "torch" sums
    the lanes' partials per bucket in lane order, "kernel" (and "auto"
    on the card) launches the dense kernel on each worker's whole tile.
    """
    W = _worker_count(mesh, scale)
    spec = scale.engine_config(mesh)
    coll = _collectives(mesh, scale)
    model_lanes = mesh.shape["model"] if coll.model_role == "tp" else None
    dev = mesh.device

    def epoch_fn(X, y, a, v, epoch):
        X, y, a, v = (torch.as_tensor(t, dtype=torch.float32, device=dev)
                      for t in (X, y, a, v))
        d, n = X.shape
        P, K = coll.pods, coll.lanes
        if n % (P * K):
            raise ValueError(f"n={n} columns do not split over {P * K} "
                             f"example shards")
        blk = engine.DenseBlock(X.reshape(d, P, K, -1).permute(1, 2, 0, 3))
        blk, y, a, v = engine.sharded_epoch(
            obj, spec, coll, blk, y.reshape(P, K, -1), a.reshape(P, K, -1),
            v, int(epoch), lam=scale.lam, n_total=scale.n, workers=W,
            model_lanes=model_lanes, device=dev)
        return (blk.X.permute(2, 0, 1, 3).reshape(d, n), y.reshape(n),
                a.reshape(n), v)

    return epoch_fn


def make_sparse_epoch(scale: GLMScale, mesh: StackedMesh,
                      obj: Objective = LOGISTIC):
    """-> epoch fn over the global arrays: (idx, val, y, a, v, epoch) ->
    (idx, val, y, a, v), as the reference's shard_map program takes and
    returns them.

    idx/val (n, nnz) padded-CSR rows, y/a (n,), v (d,); rows are dealt
    to the example shards in (pod, data[, model]) order, and the
    returned rows are the re-dealt ones.  Arrays are moved to the mesh's
    device.  With feature_shard, the model lanes own slices of v and
    the local solver is the feature-sharded one ("kernel": the CUDA
    kernel pair; "torch": the masked scan).
    """
    W = _worker_count(mesh, scale)
    spec = scale.engine_config(mesh)
    coll = _collectives(mesh, scale)
    model_lanes = mesh.shape["model"] if scale.feature_shard else None
    dev = mesh.device

    def epoch_fn(idx, val, y, a, v, epoch):
        idx = torch.as_tensor(idx, dtype=torch.int32, device=dev)
        val, y, a, v = (torch.as_tensor(t, dtype=torch.float32, device=dev)
                        for t in (val, y, a, v))
        n, nnz = idx.shape
        P, K = coll.pods, coll.lanes
        if n % (P * K):
            raise ValueError(f"n={n} rows do not split over {P * K} "
                             f"example shards")
        blk = engine.SparseBlock(idx.reshape(P, K, -1, nnz),
                                 val.reshape(P, K, -1, nnz))
        blk, y, a, v = engine.sharded_epoch(
            obj, spec, coll, blk, y.reshape(P, K, -1), a.reshape(P, K, -1),
            v, int(epoch), lam=scale.lam, n_total=scale.n, workers=W,
            model_lanes=model_lanes, device=dev)
        return (blk.idx.reshape(n, nnz), blk.val.reshape(n, nnz),
                y.reshape(n), a.reshape(n), v)

    return epoch_fn


def scale_for_dataset(name: str, *, device="cuda",
                      **overrides) -> GLMScale:
    """Registry dataset -> a deployment-scale `GLMScale`.

    Sizes come from the registry's real shapes: n padded to a multiple
    of 32,768, d (from 4,096 up) to a multiple of 4,096, nnz to a
    multiple of 8, as the reference derives them.  The layout, and
    under ``$REPRO_PLAN=search|probe`` the bucket and chunks, come from
    `planner.resolve_plan` on the topology of `device` (the card unless
    the caller asks for the CPU): wide dense data (d >= 512) is
    tensor-parallel, sparse data shards its features exactly when the
    padded f32 v exceeds the card's L2.  Explicit overrides win.
    """
    from repro_torch.data.registry import get_spec

    spec = get_spec(name)
    n = -(-spec.full_n // 32_768) * 32_768
    d = -(-spec.full_d // 4_096) * 4_096 if spec.full_d >= 4_096 \
        else spec.full_d
    kw = dict(name=f"glm-{name}", kind=spec.kind, n=n, d=d,
              lam=spec.lam)
    sparse = spec.kind == "sparse"
    if sparse:
        kw["nnz"] = -(-spec.nnz // 8) * 8
    sig = planner.WorkloadSignature(n=n, d=d, nnz=kw.get("nnz", 0),
                                    sparse=sparse, name=name)
    searching = planner.plan_mode() in ("search", "probe")
    plan = planner.resolve_plan(
        sig, planner.Topology.detect(device=device),
        bucket=overrides.get("bucket", None if searching else 16),
        chunks=overrides.get("chunks", None if searching else 4))
    kw["feature_shard"] = plan.feature_shard
    if searching:
        kw["bucket"], kw["chunks"] = plan.bucket, plan.chunks
    kw.update(overrides)
    return GLMScale(**kw)


def scale_for_estimator(est, **overrides) -> GLMScale:
    """A FITTED `repro_torch.api` estimator (or a bare `Session`) ->
    `GLMScale`, from its own solver state: the data's dimensions from
    its session, the algorithm's knobs from its `EngineConfig`, so the
    mesh program runs the epoch the estimator ran."""
    ses = getattr(est, "session_", est)
    if not hasattr(ses, "spec") or not hasattr(ses, "n"):
        raise ValueError(
            "estimator_epoch needs a fitted estimator (or a Session): "
            "the mesh program is sized from its data and config")
    algo, dep = ses.spec.algo, ses.spec.deployment
    kind = "sparse" if ses.sparse else "dense"
    kw = dict(name=f"glm-{type(est).__name__.lower()}", kind=kind,
              n=ses.n, d=ses.d, bucket=ses.bplan.bucket,
              chunks=algo.chunks, lam=ses.lam,
              compress_pod=dep.compress_pod,
              compress_sync=algo.compress_sync,
              redeal_frac=algo.redeal_frac,
              local_solver=algo.local_solver,
              deterministic=dep.deterministic,
              # the mesh has two physical partition modes; every sim
              # re-dealing scheme maps onto the all-to-all re-deal
              partition=("static" if algo.partition == "static"
                         else "alltoall"),
              aggregation=algo.aggregation, seed=algo.seed)
    if kind == "sparse":
        if ses.cache is not None:
            kw["nnz"] = ses.cache.meta.nnz
        elif hasattr(ses, "idx"):
            kw["nnz"] = int(ses.idx.shape[1])
        elif "nnz" not in overrides:
            raise ValueError("sparse feed-backed session: pass nnz=...")
    else:
        kw["feature_shard"] = dep.feature_shard
    kw.update(overrides)
    return GLMScale(**kw)


def estimator_epoch(est, mesh: StackedMesh, **overrides):
    """Put a fitted `repro_torch.api` estimator's epoch on a mesh.

    Returns ``(epoch_fn, scale)``: `epoch_fn` is `make_dense_epoch`'s or
    `make_sparse_epoch`'s program for `scale`, the `GLMScale` derived by
    `scale_for_estimator`.  The estimator's knobs (bucket, chunks,
    aggregation, seed, compression, determinism) carry over; its
    partition maps onto the mesh's modes ("static" stays, every
    re-dealing scheme becomes the all-to-all re-deal).  With
    `deterministic=True` and a static or alltoall estimator, the program
    on (pod P, data K, model 1) is bitwise the stacked sim's
    (`engine.sim_sharded_dense_epoch` / `sim_sharded_sparse_epoch`).
    """
    from repro_torch.core.objectives import get_objective
    scale = scale_for_estimator(est, **overrides)
    objective = getattr(est, "_objective", None)
    obj = get_objective(objective) if objective else getattr(
        getattr(est, "session_", est), "obj", LOGISTIC)
    make = make_sparse_epoch if scale.kind == "sparse" else make_dense_epoch
    return make(scale, mesh, obj=obj), scale
