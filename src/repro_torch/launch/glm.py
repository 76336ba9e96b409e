"""Distributed GLM training: the engine's epoch program on a mesh.

The reference binds `core.engine`'s epoch (re-deal -> chunked local
sub-epoch -> sync -> pod reduce) to a ("pod", "data", "model") device
mesh with shard_map.  Here the mesh is either stacked on one device
(`launch.mesh.make_host_mesh`, the collectives the ordered tensor
operations of `core.engine.StackedMeshCollectives`) or a process mesh
(`launch.mesh.make_dist_mesh`, one worker a process, the collectives
`core.engine.MeshCollectives` over `torch.distributed`):

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
    feature_shard the model axis is more example lanes.  On a process
    mesh every role runs one model lane a rank: dense TP sums the
    lanes' packed [m0 | G] partials per bucket over 'model' between the
    split pair's two launches (`csrc/sdca_bucket_tp.cu`), and sparse
    slices all-gather each bucket's partial working sets over 'model'
    between B3's one-lane gather and B4 on the rank's lane;
  * v replicas sync over 'data' (and 'model' when it carries examples
    or sparse slices) once per chunk, in f32 or, with compress_sync, by
    the int8 two-phase `engine.q_psum`.

Workers = pods x data lanes (x model lanes when features are not
sharded); sigma' = #workers (CoCoA+ adding).  On a stacked mesh the
epoch functions take and return the global arrays; on a process mesh
each rank's takes and returns its own shards, as a shard_map body
does: `glm_input_specs` gives each input's global shape and partition,
`local_shard` cuts a rank's shard out of a global array and
`assemble_shards` puts the ranks' shards back together.
`make_streamed_epoch_mesh` streams a tile cache or host arrays onto
either mesh (`engine.MeshSchedule`, `engine.MeshChunkFeed`), bitwise
the resident epochs.  `estimator_epoch` puts a fitted estimator's epoch
on a mesh.  `scale_for_dataset` sizes a registry dataset at its real
shape, its layout (and under ``$REPRO_PLAN=search|probe`` its bucket
and chunks) from the planner (`core.planner`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.core import engine, planner
from repro_torch.core.config import (AlgoConfig, DeploymentConfig,
                                     EngineConfig)
from repro_torch.core.objectives import LOGISTIC, Objective
from repro_torch.launch.mesh import DistMesh, StackedMesh, rank_coords

Mesh = Union[StackedMesh, DistMesh]


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


def _axes(mesh: Mesh, scale: GLMScale):
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


def _worker_count(mesh: Mesh, scale: GLMScale) -> int:
    ex, _, _, _ = _axes(mesh, scale)
    n = 1
    for a in ex:
        n *= mesh.shape[a]
    return n


def _collectives(mesh: Mesh, scale: GLMScale):
    """The mesh's collectives, in every role of the model axis:
    `engine.StackedMeshCollectives` on a stacked mesh,
    `engine.MeshCollectives` on a process mesh (one worker, or one model
    lane of one, a rank)."""
    _, _, _, tp = _axes(mesh, scale)
    pods, model = mesh.shape["pod"], mesh.shape["model"]
    role = ("tp" if tp else "slices" if scale.feature_shard
            else "examples")
    if tp and scale.d % model:
        raise ValueError(
            f"{scale.name}: dense tensor parallelism splits d={scale.d} "
            f"over model={model} lanes; d must be a multiple of it (the "
            f"reference's P('model') layout of X and v)")
    if isinstance(mesh, DistMesh):
        return engine.MeshCollectives(
            mesh=mesh, compress_pod=scale.compress_pod,
            deterministic=scale.deterministic, model_role=role)
    return engine.StackedMeshCollectives(
        pods=pods, lanes=_worker_count(mesh, scale) // pods,
        compress_pod=scale.compress_pod, model=model, model_role=role)


def _model_lanes(mesh: Mesh, scale: GLMScale) -> Optional[int]:
    """The solver's `model_lanes`: the model axis's size when it carries
    slices of v (feature_shard), else None."""
    return mesh.shape["model"] if scale.feature_shard else None


def make_dense_epoch(scale: GLMScale, mesh: Mesh,
                     obj: Objective = LOGISTIC, *, split_tp: bool = False):
    """-> epoch fn (X, y, a, v, epoch) -> (X, y, a, v), as the
    reference's shard_map program takes and returns them.

    On a stacked mesh the arrays are global: X (d, n), y/a (n,), v (d,);
    columns are dealt to the example shards in (pod, data[, model])
    order, and the returned X holds the re-dealt columns.  On a process
    mesh they are this rank's shards (`glm_input_specs`, `local_shard`):
    X (d, n_local), y/a (n_local,), v (d,) replicated; under tensor
    parallelism X (d/M, n_local) and v (d/M,), the rank's model lane's
    rows.  Arrays are moved to the mesh's device.  With feature_shard
    the model lanes split the features (tensor parallelism; d must be a
    multiple of the model axis): "torch" sums the lanes' partials per
    bucket in lane order; "kernel" (and "auto" on the card) launches,
    on a stacked mesh, the dense kernel on each worker's whole tile,
    and on a process mesh the split pair, the partials summed over
    'model' between its launches.  ``split_tp`` puts a stacked mesh's
    workers on the split pair too (every lane held, the lane-ordered
    sum): the process mesh's bitwise twin.
    """
    W = _worker_count(mesh, scale)
    spec = scale.engine_config(mesh)
    coll = _collectives(mesh, scale)
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
            model_lanes=_model_lanes(mesh, scale), split_tp=split_tp,
            device=dev)
        X = blk.X.permute(2, 0, 1, 3).reshape(d, n)
        return X, y.reshape(n), a.reshape(n), v

    return epoch_fn


def make_sparse_epoch(scale: GLMScale, mesh: Mesh,
                      obj: Objective = LOGISTIC):
    """-> epoch fn (idx, val, y, a, v, epoch) -> (idx, val, y, a, v), as
    the reference's shard_map program takes and returns them.

    On a stacked mesh the arrays are global: idx/val (n, nnz) padded-CSR
    rows, y/a (n,), v (d,); rows are dealt to the example shards in
    (pod, data[, model]) order, and the returned rows are the re-dealt
    ones.  On a process mesh they are this rank's shards: idx/val
    (n_local, nnz), y/a (n_local,), v (d,) replicated (rows replicated
    over 'model' under feature_shard).  Arrays are moved to the mesh's
    device.  With feature_shard the model lanes own slices of v and the
    local solver is the feature-sharded one ("kernel": the CUDA kernel
    pair, on a process mesh B3 on the rank's slice, the working sets'
    all-gather over 'model' and B4 on the rank's lane; "torch": the
    masked scan).
    """
    W = _worker_count(mesh, scale)
    spec = scale.engine_config(mesh)
    coll = _collectives(mesh, scale)
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
            model_lanes=_model_lanes(mesh, scale), device=dev)
        return (blk.idx.reshape(n, nnz), blk.val.reshape(n, nnz),
                y.reshape(n), a.reshape(n), v)

    return epoch_fn


# ---------------------------------------------------------------------------
# The shard_map boundary on a process mesh
# ---------------------------------------------------------------------------


class InputSpec(NamedTuple):
    """One input of an epoch program: its GLOBAL shape and dtype, and
    its partition, one entry a dimension (None: replicated; a tuple of
    axis names: split over them, the first the major, as a
    PartitionSpec reads)."""
    shape: tuple
    dtype: torch.dtype
    partition: tuple


def glm_input_specs(scale: GLMScale, mesh: Mesh) -> tuple[InputSpec, ...]:
    """The epoch program's inputs, in its argument order: the
    reference's `glm_input_specs` with (global shape, dtype, partition)
    in place of ShapeDtypeStructs."""
    ex_axes, _, _, tp = _axes(mesh, scale)
    ex, f32 = (ex_axes,), torch.float32
    epoch = InputSpec((), torch.int32, ())
    if scale.kind == "sparse":
        rows = (ex_axes, None)
        return (InputSpec((scale.n, scale.nnz), torch.int32, rows),
                InputSpec((scale.n, scale.nnz), f32, rows),
                InputSpec((scale.n,), f32, ex), InputSpec((scale.n,), f32, ex),
                InputSpec((scale.d,), f32, (None,)), epoch)
    x_part = (("model",) if tp else None, ex_axes)
    return (InputSpec((scale.d, scale.n), f32, x_part),
            InputSpec((scale.n,), f32, ex), InputSpec((scale.n,), f32, ex),
            InputSpec((scale.d,), f32, (("model",),) if tp else (None,)),
            epoch)


def _block(part, coords: dict, shape: dict) -> tuple[int, int]:
    """(block index, block count) of a dimension split over `part`."""
    if part is None:
        return 0, 1
    idx = 0
    for a in part:
        idx = idx * shape[a] + coords[a]
    return idx, math.prod(shape[a] for a in part)


def _slices(spec: InputSpec, coords: dict, shape: dict) -> tuple:
    out = []
    for size, part in zip(spec.shape, spec.partition):
        i, k = _block(part, coords, shape)
        if size % k:
            raise ValueError(f"dimension {size} does not split in {k}")
        out.append(slice(i * (size // k), (i + 1) * (size // k)))
    return tuple(out)


def local_shard(x, spec: InputSpec, mesh: DistMesh) -> torch.Tensor:
    """This rank's shard of a global array, by its partition (a copy on
    the mesh's device)."""
    coords = dict(zip(mesh.axis_names, mesh.coords))
    x = torch.as_tensor(x)
    return x[_slices(spec, coords, mesh.shape)].to(
        mesh.device, spec.dtype, copy=True).contiguous()


def assemble_shards(shards: Sequence, spec: InputSpec,
                    shape: dict) -> torch.Tensor:
    """Every rank's shard (in rank order) -> the global array (on the
    first shard's device); where the partition replicates a block, the
    lowest rank's copy is taken."""
    first = torch.as_tensor(shards[0])
    out = torch.empty(spec.shape, dtype=first.dtype, device=first.device)
    done = set()
    for r, t in enumerate(shards):
        coords = dict(zip(("pod", "data", "model"), rank_coords(r, shape)))
        sl = _slices(spec, coords, shape)
        key = tuple((s.start, s.stop) for s in sl)
        if key not in done:
            out[sl] = torch.as_tensor(t).to(out.device)
            done.add(key)
    return out


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


def estimator_epoch(est, mesh: Mesh, **overrides):
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


# ---------------------------------------------------------------------------
# Streamed epochs on the mesh
# ---------------------------------------------------------------------------


def _as_mesh_feed(source, *, model_lanes, d_loc, verify, width,
                  device, lane=None, rows=None) -> engine.MeshChunkFeed:
    """Any streamable source -> a mesh chunk feed.

    Takes a `TileCache`, a `TileFeed` (its verify flag carries over), an
    `ArrayFeed`, a ready `MeshChunkFeed`, or a `ResilientChunkFeed`
    wrapping one of those: then the INNER feed is upgraded in place, so
    retry, quarantine and rebuild keep guarding the mesh path (`rebind`
    keeps the mesh feed across a cache rebuild).
    """
    from repro_torch.data.cache import ArrayFeed, TileCache, TileFeed
    from repro_torch.resilience.feed import ResilientChunkFeed

    def wrap(src, v):
        return engine.MeshChunkFeed(src, model_lanes=model_lanes,
                                    d_loc=d_loc, verify=v, width=width,
                                    lane=lane, rows=rows, device=device)

    if isinstance(source, engine.MeshChunkFeed):
        return source
    if isinstance(source, ResilientChunkFeed):
        inner = source.feed
        if not isinstance(inner, engine.MeshChunkFeed):
            if isinstance(inner, TileFeed):
                source.feed = wrap(inner.cache, verify or inner.verify)
            else:
                source.feed = _as_mesh_feed(
                    inner, model_lanes=model_lanes, d_loc=d_loc,
                    verify=verify, width=width, device=device, lane=lane,
                    rows=rows)
        return source
    if isinstance(source, (TileCache, ArrayFeed)):
        return wrap(source, verify)
    if isinstance(source, TileFeed):
        return wrap(source.cache, verify or source.verify)
    raise TypeError(
        f"cannot stream a {type(source).__name__} onto a mesh: pass a "
        f"TileCache, TileFeed, ArrayFeed, MeshChunkFeed, or a "
        f"ResilientChunkFeed wrapping one")


def make_streamed_epoch_mesh(scale: GLMScale, mesh: Mesh, source,
                             obj: Objective = LOGISTIC, *, journal=None,
                             verify: bool = False,
                             width: Optional[int] = None,
                             damp: float = 1.0):
    """-> epoch_fn(alpha, v, epoch, *, stats=None) streaming `source`
    onto the mesh.

    The mesh twin of `engine.make_streamed_epoch`: the SAME chunk loop
    (`run_epoch_streamed`: the side stream, the journal hooks, stats)
    drives the mesh's collectives, with `engine.MeshSchedule` replaying
    the resident mesh's re-deals and visit orders on the host and
    `engine.MeshChunkFeed` landing each chunk in the mesh's layout.
    The result is bitwise resident training on the same mesh
    (`make_dense_epoch`/`make_sparse_epoch`, their alpha mapped back to
    global order through `MeshSchedule.layout`), while only a
    `chunks`-th of the examples is ever on the device.

    alpha (n,) and v (d,) are global on either mesh.  On a process mesh
    each rank streams only its own buckets and the driver all-gathers
    alpha's columns at the epoch's end (`MeshStreamDriver.share_alpha`),
    so every rank holds what the stacked mesh holds.  Under tensor
    parallelism a rank streams only its lane's feature rows and trains
    its slice of v, and the slices are all-gathered over 'model' at the
    epoch's end.  Feature-sharded sparse scales stream slice-compacted
    per-lane feeds (`TileCache.slice_gather`): each model lane ships
    only its slice's entries (on a process mesh a rank compacts only
    its own lane, and the step all-gathers the lanes' compactions over
    'model'), and the step reassembles exact rows on the device.

    ``journal`` threads an `EpochJournal` (chunk-cursor crash resume,
    bitwise); on a process mesh each rank journals under
    ``root/rank{r}`` (`resilience.MeshJournal`: a save is kept until
    every rank has written the next, and a resume takes the least
    cursor every rank holds).  ``damp`` is the health guard's dv_scale
    multiplier; ``verify``/``width`` go to the feed.  The closure
    exposes ``.feed`` and ``.schedule``.
    """
    from repro_torch.kernels import ops as kops
    ex_axes, _, _, tp = _axes(mesh, scale)
    W = _worker_count(mesh, scale)
    spec = scale.engine_config(mesh)
    coll = _collectives(mesh, scale)
    dist_mesh = isinstance(mesh, DistMesh)
    if dist_mesh and journal is not None:
        from repro_torch.resilience.journal import MeshJournal
        journal = MeshJournal.on_mesh(journal, mesh)
    sparse = scale.kind == "sparse"
    sliced = sparse and scale.feature_shard
    model_lanes = _model_lanes(mesh, scale)
    lane, exchange = coll.model_exchange() if model_lanes else (None, None)
    d_loc = kops.sparse_slice_width(scale.d, model_lanes) if sliced else None
    rows = None
    if tp and lane is not None:
        d_tp = scale.d // model_lanes
        rows = (lane * d_tp, (lane + 1) * d_tp)
    feed = _as_mesh_feed(source, model_lanes=model_lanes if sliced else None,
                         d_loc=d_loc, verify=verify, width=width,
                         lane=lane if sliced else None, rows=rows,
                         device=mesh.device)
    mesh_feed = getattr(feed, "feed", feed)     # inside a ResilientChunkFeed
    if (feed.n, feed.bucket, mesh_feed.nnz) != (
            scale.n, scale.bucket, scale.nnz if sparse else 0):
        raise ValueError(
            f"feed shape mismatch: feed has n={feed.n} bucket="
            f"{feed.bucket} nnz={mesh_feed.nnz}, scale wants n={scale.n} "
            f"bucket={scale.bucket} nnz={scale.nnz if sparse else 0}")
    solver = engine.make_local_solver(
        scale.local_solver, obj, scale.lam * scale.n, spec.sigma_prime(W),
        bucket=scale.bucket, sparse=sparse, model_lanes=model_lanes,
        lane=lane, exchange=exchange, device=mesh.device)
    dv_scale = (1.0 / W if scale.aggregation == "averaging"
                else 1.0) * damp
    step = engine.make_mesh_streamed_step(
        coll, solver, spec.algo, nnz=scale.nnz if sliced else None,
        dv_scale=dv_scale,
        gather_lanes=coll.gather_model if sliced and lane is not None
        else None)
    sched = engine.MeshSchedule(
        scale.n // scale.bucket, pods=mesh.shape["pod"],
        data=mesh.shape["data"], model=mesh.shape["model"],
        model_in_lanes=("model" in ex_axes), seed=scale.seed,
        redeal=(scale.partition != "static"),
        redeal_frac=scale.redeal_frac)
    plan = sched.worker(mesh.coords[0], coll.lane) if dist_mesh else sched
    driver = engine.MeshStreamDriver(coll, sched, scale.bucket)

    def epoch_fn(alpha, v, epoch, *, stats=None):
        alpha, v = (torch.as_tensor(t, dtype=torch.float32,
                                    device=mesh.device) for t in (alpha, v))
        if rows is not None:                 # this lane's rows of v
            v = v[rows[0]:rows[1]]
        alpha, v = engine.run_epoch_streamed(
            driver, feed, step, plan, spec.algo, alpha, v, epoch,
            journal=journal, stats=stats)
        if rows is not None:
            v = coll.gather_model(v).reshape(-1)
        return driver.share_alpha(alpha, epoch), v

    epoch_fn.feed = feed
    epoch_fn.schedule = sched
    return epoch_fn


# ---------------------------------------------------------------------------
# The dry run's view of an epoch: its per-device inputs and kernel route,
# and its analytic cost (the reference's `lower_glm`, `glm_analytic` and
# `glm_model_flops`)
# ---------------------------------------------------------------------------

_BISECT_FLOPS = 40 * 12       # logistic delta: 40 bisection iters


def lower_glm(arch: str, mesh) -> dict:
    """What an epoch program of `arch` (a GLM_CONFIGS key, or a registry
    dataset sized by `scale_for_dataset` on the CPU's topology) would
    take on `mesh` (an `launch.mesh.AbstractMesh`, or any mesh with
    `axis_names` and `shape`), found without launching anything: each
    input's global shape, dtype, partition and per-device shard
    (`glm_input_specs`), the argument bytes a device holds, and the
    kernel route of a worker's local shapes (`ops.sparse_solver_plan`,
    `ops.dense_kernel_misfit`)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.specs import shard_shape
    scale = (GLM_CONFIGS[arch] if arch in GLM_CONFIGS
             else scale_for_dataset(arch, device="cpu"))
    W = _worker_count(mesh, scale)
    _, _, _, tp = _axes(mesh, scale)
    inputs = []
    for spec in glm_input_specs(scale, mesh):
        shard = shard_shape(spec.shape, spec.partition, mesh)
        inputs.append({"shape": list(spec.shape), "dtype": str(spec.dtype),
                       "partition": list(spec.partition),
                       "shard": list(shard),
                       "shard_bytes": math.prod(shard) * spec.dtype.itemsize})
    n_local = scale.n // W
    M = mesh.shape.get("model", 1)
    if scale.kind == "sparse":
        route, misfit = ops.sparse_solver_plan(
            n_local, scale.nnz, scale.d, scale.bucket,
            model_lanes=M if scale.feature_shard else 1)
    else:
        d_loc = scale.d // M if tp else scale.d
        misfit = ops.dense_kernel_misfit(d_loc, n_local, scale.bucket)
        route = "torch" if misfit else "kernel"
    return {"scale": dataclasses.asdict(scale), "workers": W,
            "n_local": n_local, "inputs": inputs,
            "argument_bytes": sum(i["shard_bytes"] for i in inputs),
            "route": route, "misfit": None if misfit is None else str(misfit)}


def glm_analytic(scale: GLMScale, mesh, *, streamed: bool = False) -> dict:
    """Per-device per-epoch {flops, bytes accessed, coll} estimates, the
    reference's closed form term for term.  An axis of size 1 carries no
    collective (so one card's record has none; the reference's meshes
    have no such axis, and there the terms are its own).

    ``streamed=True`` adds "h2d bytes", the host-to-device ingest bytes
    a device takes an epoch (`planner.streamed_transfer_bytes`, the
    planner's one model of them), kept apart from the HBM bytes: the
    host link is ~70x slower than HBM."""
    W = _worker_count(mesh, scale)
    ex_axes, sync_axes, has_pod, tp = _axes(mesh, scale)
    shape = mesh.shape
    n_local = scale.n // W
    B = scale.bucket
    nb = n_local // B
    d_loc = scale.d // shape.get("model", 1) if tp else scale.d

    if scale.kind == "dense":
        # per bucket: margins 2*d_loc*B + Gram d_loc*B^2 + v-update
        # 2*d_loc*B + recursion B * (B axpy + bisection)
        per_bucket = (2 * d_loc * B + d_loc * B * B + 2 * d_loc * B
                      + B * (2 * B + _BISECT_FLOPS))
        flops = nb * per_bucket
        x_bytes = d_loc * n_local * 4
        # X streamed once per chunked pass + rotated once (read+write)
        bytes_acc = x_bytes * 3 + scale.chunks * d_loc * 4 * 2
    else:
        per_coord = (2 * scale.nnz * 3 + _BISECT_FLOPS)
        flops = n_local * per_coord
        x_bytes = n_local * scale.nnz * 8
        bytes_acc = x_bytes * 3 + n_local * scale.nnz * 4 * 2  # v gather/scatter
    # collectives (result-shape convention, per device): the chunk
    # reductions of dv over the sync axes (f32: 4 B an element; int8
    # two-phase: ~2), the bucket re-deal (an all-to-all of redeal_frac
    # of the local shard) and the cross-pod int8 all-gather
    sync_bytes = 2 if scale.compress_sync else 4
    dv_len = scale.d if scale.kind == "sparse" else d_loc
    syncing = [a for a in sync_axes if shape[a] > 1]
    coll = scale.chunks * dv_len * sync_bytes * len(syncing)
    pods = shape.get("pod", 1)
    if W // pods > 1:
        coll += (x_bytes + n_local * 4 * 2) * scale.redeal_frac
    M = shape.get("model", 1)
    if scale.kind == "sparse" and scale.feature_shard and M > 1:
        # sharded-v solver: one working-set all-gather per bucket over
        # 'model', (M, B, nnz) f32 landing on every lane
        coll += (n_local // B) * M * B * scale.nnz * 4
    if has_pod and pods > 1:
        coll += (scale.d if scale.kind == "sparse" else d_loc) * 1 * pods
    out = {"flops": float(flops), "bytes accessed": float(bytes_acc),
           "coll": float(coll), "method": "analytic-closed-form"}
    if streamed:
        topo = planner.Topology(
            backend="cuda", device_count=math.prod(shape.values()),
            pods=pods, lanes=W // pods,
            model_lanes=M if scale.feature_shard else 1)
        sig = planner.WorkloadSignature(
            n=scale.n, d=scale.d, nnz=scale.nnz,
            sparse=scale.kind == "sparse", streamed=True)
        plan = planner.SolverPlan(
            solver="kernel", route="kernel", bucket=scale.bucket,
            chunks=scale.chunks, nnz_multiple=8,
            feature_shard=scale.feature_shard)
        out["h2d bytes"] = planner.streamed_transfer_bytes(sig, topo, plan)
    return out


def glm_model_flops(scale: GLMScale, mesh) -> float:
    """Useful work per device-epoch: one pass of coordinate updates, the
    margin and v-update inner products, 4 d (dense) or 4 nnz (sparse)
    per coordinate, divided over the workers."""
    W = _worker_count(mesh, scale)
    n_local = scale.n // W
    if scale.kind == "sparse":
        return float(n_local * 4 * scale.nnz)
    d_loc = scale.d // mesh.shape.get("model", 1) \
        if scale.feature_shard else scale.d
    return float(n_local * 4 * d_loc)
