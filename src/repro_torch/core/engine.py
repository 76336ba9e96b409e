"""The solver engine: ONE epoch program over P*K workers.

The paper's algorithm — bucketed SDCA + dynamic bucket re-dealing +
hierarchical aggregation — is a single bulk-synchronous program:

    schedule -> re-deal -> (chunked local sub-epoch) -> sync -> pod-reduce

`run_epoch` implements it once, parametrized by two seams:

  * the collectives — how workers are laid out and talk.
    `SimCollectives`: pods x lanes *virtual* workers stacked on the
    leading axes of one device's tensors.  `map_workers` hands a solver
    the whole (P*K) stack in one call, so a kernel solver runs every
    worker in one launch; reductions are explicit left-to-right adds
    over the lane and pod axes.  `StackedMeshCollectives` lays a
    (pod, data, model) mesh out the same way; `MeshCollectives` runs it
    across processes, one worker (or, when the model axis carries
    slices, one model lane of one) a process, over `torch.distributed`
    (all-to-all re-deal, all-gathers summed in rank order, the model
    lanes' per-bucket exchange), bitwise the stacked mesh when ordered.
  * `LocalSolver` — how the workers solve their chunks: the plain
    PyTorch versions (`"torch"`, `core.sdca`) or the CUDA kernels
    (`"kernel"`, `kernels.ops`).  `"auto"` picks the kernel on a CUDA
    device and the plain version on the CPU.

Out of core, `run_epoch_streamed` runs the same chunk body on chunks a
`ChunkFeed` copies in; on a mesh `MeshSchedule` replays the mesh's
re-deals and visit orders on the host and `MeshChunkFeed` lands each
chunk in the mesh's layout (slice-compacted for feature-sharded sparse
data), so a streamed mesh epoch is bitwise the resident one.

Worker PRNG streams are drawn from the threefry port `core.prng`,
integer-exact against the reference:

    worker_key = fold(fold(fold(PRNGKey(seed), epoch), pod), lane)
    re-deal perm   <- fold(worker_key, 0)
    visit-order    <- fold(worker_key, 1)

with `lane` counted data-major over the example-parallel axes.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Protocol, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device, same_device
from . import prng, sdca
from .config import AlgoConfig, EngineConfig, as_engine_config
from .objectives import Objective

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Worker-local data blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DenseBlock:
    """Dense worker-local examples: X (*w, d_shard, n_local)."""
    X: Tensor

    @property
    def n_local(self) -> int:
        return self.X.shape[-1]

    def take(self, cols: Tensor):
        return torch.take_along_dim(self.X, cols[..., None, :], dim=-1)

    def arrs(self):
        return ((self.X, -1),)

    def rebuild(self, arrs) -> "DenseBlock":
        return DenseBlock(arrs[0])


@dataclasses.dataclass(frozen=True)
class SparseBlock:
    """Padded-CSR worker-local examples: idx/val (*w, n_local, nnz)."""
    idx: Tensor
    val: Tensor

    @property
    def n_local(self) -> int:
        return self.idx.shape[-2]

    def take(self, cols: Tensor):
        c = cols[..., :, None]
        return (torch.take_along_dim(self.idx, c, dim=-2),
                torch.take_along_dim(self.val, c, dim=-2))

    def arrs(self):
        return ((self.idx, -2), (self.val, -2))

    def rebuild(self, arrs) -> "SparseBlock":
        return SparseBlock(arrs[0], arrs[1])


Block = Union[DenseBlock, SparseBlock]

# ---------------------------------------------------------------------------
# Local solvers (every worker's sub-epoch, stacked on a leading axis)
# ---------------------------------------------------------------------------


class LocalSolver(Protocol):
    """The workers' pass over their chunks: (data, y, a, v) -> (a_new, dv).

    Every argument carries a leading worker axis (W,); `data` is an X
    tile (W, d, nc) for dense solvers or an (idx, val) pair of
    (W, nc, nnz) for sparse ones; `dv` is the UNSCALED global delta.
    """

    def __call__(self, data, y: Tensor, a: Tensor, v: Tensor
                 ) -> tuple[Tensor, Tensor]: ...


def resolve_auto_solver(device) -> str:
    """What `local_solver="auto"` means on `device`: the kernel on a
    CUDA device, the plain PyTorch version on the CPU."""
    return "kernel" if torch.device(device).type == "cuda" else "torch"


def _raise_misfit(why, path):
    raise ValueError(f"local_solver='kernel': the {path} CUDA kernel "
                     f"cannot run this workload [{why.code}]: {why}")


def sparse_sharded_kernel_solver(obj: Objective, lam_n: float, sig: float,
                                 bucket: int, model_lanes: int,
                                 lane: Optional[int] = None,
                                 exchange=None) -> LocalSolver:
    """The feature-sharded CUDA kernels (`kops.sdca_sparse_sharded_subepoch`):
    every (worker, lane) block in one launch per bucket, or with
    ``lane`` (a process mesh) that lane's blocks alone, the working sets
    traded by ``exchange``.  dv (W, Mh, d) has support only on each held
    lane's slice; the duals are the first held lane's copy (every lane
    computes the same bits), as the mesh reads them.  A shape the
    kernels cannot take raises with its misfit."""
    from repro_torch.core import planner
    from repro_torch.kernels import ops as kops

    def solve(data, y, a, v):
        idx, val = data
        _, why = planner.route_sparse(idx.shape[-2], idx.shape[-1],
                                      v.shape[-1], bucket,
                                      model_lanes=model_lanes)
        if why is not None:
            _raise_misfit(why, "feature-sharded sparse")
        a_lanes, dv = kops.sdca_sparse_sharded_subepoch(
            obj, idx, val, y, a, v, lam_n, sig, bucket=bucket,
            model_lanes=model_lanes, lane=lane, exchange=exchange,
            source="resident arrays")
        return a_lanes[:, 0], dv
    return solve


def dense_tp_kernel_solver(obj: Objective, lam_n: float, sig: float,
                           bucket: int, model_lanes: int,
                           exchange=None) -> LocalSolver:
    """The dense tensor-parallel pair (`kops.sdca_bucket_tp_subepoch`):
    per bucket the held lanes' [m0 | G] partials, their sum over the
    model lanes, the recursion.  Without ``exchange`` every lane is held
    (the stacked twin of a process mesh: each worker's tile its
    `model_lanes` lanes' slices stacked, summed in lane order); with it
    one lane is held and ``exchange`` sums over 'model'.  A shape the
    pair cannot take raises with its misfit."""
    from repro_torch.core import planner
    from repro_torch.kernels import ops as kops

    def solve(X, y, a, v):
        why = planner.route_dense(X.shape[-2], X.shape[-1], bucket)
        if why is not None:
            _raise_misfit(why, "dense tensor-parallel")
        return kops.sdca_bucket_tp_subepoch(
            obj, X, y, a, v, lam_n, sig, bucket=bucket,
            model_lanes=model_lanes if exchange is None else 1,
            reduce=exchange, source="resident arrays")
    return solve


def dense_kernel_solver(obj: Objective, lam_n: float, sig: float,
                        bucket: int) -> LocalSolver:
    """The dense CUDA kernel (`kops.sdca_bucket_subepoch`): every worker
    in one launch.  Under tensor parallelism a worker's tile is its
    lanes' d/M slices stacked in lane order, which is its whole (d, B)
    tile, so the same launch serves: the kernel's reduction over d sums
    the lanes' Gram and margin partials (in its own order: within a
    tolerance of the "torch" route's lane-ordered sum).  A shape the
    kernel cannot take raises with its misfit."""
    from repro_torch.core import planner
    from repro_torch.kernels import ops as kops

    def solve(X, y, a, v):
        why = planner.route_dense(X.shape[-2], X.shape[-1], bucket)
        if why is not None:
            _raise_misfit(why, "dense")
        return kops.sdca_bucket_subepoch(obj, X, y, a, v, lam_n, sig,
                                         bucket=bucket,
                                         source="resident arrays")
    return solve


def make_local_solver(kind: str, obj: Objective, lam_n: float, sig: float,
                      *, bucket: int = 1, sparse: bool = False,
                      model_lanes: Optional[int] = None,
                      lane: Optional[int] = None, exchange=None,
                      split_tp: bool = False,
                      device="cuda") -> LocalSolver:
    """Resolve an `AlgoConfig.local_solver` name to a LocalSolver.

    "kernel" launches the CUDA kernel and needs a CUDA device: on the
    CPU it raises.  A shape the kernel cannot take raises with the
    misfit's code and reason; nothing routes quietly to the plain
    version.  `model_lanes` on the sparse path selects the
    feature-sharded layout: each of that many lanes owns a slice of v,
    and the solver returns dv (W, M, d), each lane's delta on its slice
    ("kernel": the sharded kernel pair; "torch": the masked scan).  On
    the dense path it selects tensor parallelism: each worker's d rows
    are that many lanes' d/M slices, stacked in lane order ("torch":
    `sdca.dense_tp_bucket_pass`, the lanes' Gram and margin partials
    summed per bucket in lane order; "kernel": the dense kernel on the
    worker's whole tile, whose reduction over d sums the lanes'
    partials in its own order).  The reference has no dense TP kernel
    and falls back to its plain scan; the port launches the kernel.
    The misfit checks are `core.planner.route_sparse`/`route_dense`,
    the kernels' own predicates, which ``$REPRO_PLAN`` never changes:
    the planner repairs an open geometry before anything launches, and
    a fixed geometry that misfits raises here.

    On a process mesh a solver holds ONE model lane: ``lane`` is it and
    ``exchange`` the collectives' per-bucket trade over 'model'
    (`MeshCollectives.model_exchange`).  Sparse: "kernel" runs B3 on the
    lane's slice, ``exchange`` (the working sets' all-gather), the
    owner-select and B4 on the lane; "torch" the masked scan, which
    needs no exchange; dv (W, 1, d).  Dense TP: the tile and v hold the
    lane's d/M rows, and ``exchange`` sums the packed partials over the
    lanes in lane order: "torch" in `sdca.dense_tp_bucket_pass`'s
    ``reduce`` hook, "kernel" between the split pair's two launches
    (`dense_tp_kernel_solver`).  ``split_tp`` puts the split pair on a
    stacked mesh's TP workers (every lane held, the lane-ordered sum):
    the process mesh's stacked twin; the stacked mesh's own "kernel" TP
    route stays the whole-tile B1.
    """
    from repro_torch.core import planner
    from repro_torch.kernels import ops as kops
    device = torch.device(device)
    if kind == "auto":
        kind = resolve_auto_solver(device)
    if kind not in ("torch", "kernel"):
        raise ValueError(f"unknown local_solver {kind!r}; "
                         f"have 'auto', 'torch', 'kernel'")
    if kind == "kernel" and device.type != "cuda":
        raise ValueError(
            f"local_solver='kernel' launches a CUDA kernel and needs CUDA "
            f"tensors, got device {device}; use local_solver='torch' or "
            f"'auto' on the CPU")
    lam_t = torch.tensor(lam_n, dtype=torch.float32, device=device)
    sig_t = torch.tensor(sig, dtype=torch.float32, device=device)

    if sparse and model_lanes is not None:
        if kind == "kernel":
            return sparse_sharded_kernel_solver(obj, lam_n, sig, bucket,
                                                model_lanes, lane, exchange)
        held = (torch.arange(model_lanes, device=device) if lane is None
                else torch.tensor([lane], device=device))

        def solve(data, y, a, v):
            # the kernels' plain twin on the same layout: the full scan,
            # then each held lane's dv masked to its slice (without the
            # mask the ordered model-axis sum would count dv M times)
            idx, val = data
            a_new, dv = sdca.sparse_local_subepoch(obj, idx, val, y, a, v,
                                                   lam_t, sig_t)
            d = v.shape[-1]
            owner = torch.arange(d, device=v.device) \
                // kops.sparse_slice_width(d, model_lanes)
            own = owner == held[:, None]
            return a_new, torch.where(own, dv[:, None, :],
                                      torch.zeros((), dtype=dv.dtype,
                                                  device=dv.device))
        return solve

    if sparse:
        if kind == "torch":
            def solve(data, y, a, v):
                idx, val = data
                return sdca.sparse_local_subepoch(obj, idx, val, y, a, v,
                                                  lam_t, sig_t)
            return solve

        def solve(data, y, a, v):
            idx, val = data
            _, why = planner.route_sparse(idx.shape[-2], idx.shape[-1],
                                          v.shape[-1], bucket)
            if why is not None:
                _raise_misfit(why, "sparse")
            return kops.sdca_sparse_bucket_subepoch(
                obj, idx, val, y, a, v, lam_n, sig, bucket=bucket,
                source="resident arrays")
        return solve

    if kind == "torch":
        lanes = model_lanes if lane is None else 1

        def solve(X, y, a, v):
            return sdca.dense_local_subepoch(obj, X, y, a, v, lam_t, sig_t,
                                             bucket, model_lanes=lanes,
                                             reduce=exchange)
        return solve
    if model_lanes is not None and (lane is not None or split_tp):
        return dense_tp_kernel_solver(obj, lam_n, sig, bucket, model_lanes,
                                      exchange)
    return dense_kernel_solver(obj, lam_n, sig, bucket)


# ---------------------------------------------------------------------------
# Wire compression helper
# ---------------------------------------------------------------------------


def _quantize_roundtrip(x: Tensor, axis: int) -> Tensor:
    """Model the int8 wire: per-worker quantize/dequantize along `axis`."""
    from repro_torch.optim.compression import dequantize, quantize
    return dequantize(quantize(x, axis=axis))


def q_psum(x: Tensor) -> Tensor:
    """The reference's int8 two-phase reduction (`q_psum`: a quantized
    reduce-scatter, then a quantized all-gather) over a stacked lane
    axis: x (*g, L, n), each group's L lanes' vectors in lane order ->
    (*g, n), what every lane of the group holds after it.

    Each lane's vector is padded to a multiple of L and quantized with
    one scale; in phase 1 lane j sums shard j of every lane's payload,
    q * scale, in lane order; in phase 2 each reduced shard is quantized
    with its own scale, and the dequantized shards are concatenated and
    cropped.  A single lane passes through unquantized, as there."""
    from repro_torch.optim.compression import dequantize, quantize
    L, n = x.shape[-2:]
    if L <= 1:
        return x[..., 0, :]
    pad = (-n) % L
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    qz = quantize(x, axis=-1)                             # scale (*g, L, 1)
    shards = qz.q.reshape(x.shape[:-1] + (L, -1))         # (*g, lane, shard, m)
    part = _ordered_sum(shards.float() * qz.scale[..., None], -3)
    out = dequantize(quantize(part, axis=-1))
    return out.reshape(out.shape[:-2] + (-1,))[..., :n]


def _ordered_sum(x: Tensor, dim: int) -> Tensor:
    """Sum over `dim` as explicit left-to-right adds."""
    parts = x.unbind(dim)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


# ---------------------------------------------------------------------------
# Simulated collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimCollectives:
    """pods x lanes virtual workers stacked on leading tensor axes."""
    pods: int = 1
    lanes: int = 1
    compress_pod: bool = False

    @property
    def wshape(self) -> tuple[int, ...]:
        return (self.pods, self.lanes)

    def worker_keys(self, seed: int, epoch: int) -> np.ndarray:
        """(P, K, 2) uint32 threefry keys, one per worker."""
        base = prng.fold_in(prng.PRNGKey(seed), int(epoch))
        per_pod = prng.fold_in(np.broadcast_to(base, (self.pods, 2)),
                               np.arange(self.pods))
        return prng.fold_in(
            np.broadcast_to(per_pod[:, None], (self.pods, self.lanes, 2)),
            np.arange(self.lanes)[None, :])

    def _perms(self, keys: np.ndarray, stream: int, nb_local: int,
               device) -> Tensor:
        """(P, K, nb_local) permutations drawn from fold(key, stream)."""
        sub = prng.fold_in(keys, stream).reshape(-1, 2)
        perms = np.stack([prng.permutation(k, nb_local) for k in sub])
        return torch.as_tensor(
            perms.reshape(self.pods, self.lanes, nb_local).astype(np.int64),
            device=device)

    def map_workers(self, fn: Callable, args: tuple):
        """Flatten (P, K) to one worker axis, call `fn` ONCE on the whole
        stack (one kernel launch for every worker), and unflatten."""
        W = self.pods * self.lanes

        def flat(x):
            if isinstance(x, tuple):
                return tuple(flat(t) for t in x)
            return x.reshape((W,) + tuple(x.shape[2:]))

        out = fn(*(flat(a) for a in args))
        return tuple(o.reshape((self.pods, self.lanes) + tuple(o.shape[1:]))
                     for o in out)

    def visit_perms(self, keys: np.ndarray, nb_local: int, device) -> Tensor:
        return self._perms(keys, 1, nb_local, device)

    def broadcast_ids(self, ids: Tensor) -> Tensor:
        return ids.expand(self.wshape + tuple(ids.shape))

    def _redeal_axes(self) -> tuple[int, int]:
        """(size of the re-deal axis, lanes per re-deal group): the
        lane axis is (re-deal axis, group), group-minor."""
        return self.lanes, 1

    def redeal(self, arrs, nb_local: int, keys: np.ndarray, frac: float):
        """Stacked mirror of the all-to-all bucket re-deal: each lane
        shuffles its buckets (per-worker key), the first `exch` buckets
        are split D ways and transposed across the re-deal axis (the
        lanes of one group; `_redeal_axes`)."""
        P, K = self.pods, self.lanes
        D, G = self._redeal_axes()
        if D <= 1 or frac <= 0:
            return tuple(x for x, _ in arrs)
        exch = max(int(nb_local * frac) // D * D, D)
        perms = self._perms(keys, 0, nb_local, arrs[0][0].device)

        def one(x, ax):
            xb = torch.movedim(x, ax, 2)            # (P, K, n_local, ...)
            shp = xb.shape
            rows = shp[2] // nb_local
            rest = tuple(shp[3:])
            xb = xb.reshape((P, K, nb_local, rows) + rest)
            idx = perms.reshape((P, K, nb_local) + (1,) * (xb.ndim - 3))
            xb = torch.take_along_dim(xb, idx, dim=2)
            head = xb[:, :, :exch]
            # lane j of a group receives [split_j of lane 0, ..., split_j
            # of lane D-1] concatenated in lane order == tiled all_to_all
            head = head.reshape((P, D, G, D, exch // D, rows) + rest)
            head = head.transpose(1, 3).reshape((P, K, exch, rows) + rest)
            xb = torch.cat([head, xb[:, :, exch:]], dim=2)
            return torch.movedim(xb.reshape(shp), 2, ax)

        return tuple(one(x, ax) for x, ax in arrs)

    def pod_replicate(self, v: Tensor) -> Tensor:
        if v.ndim == 1:
            return v.expand((self.pods,) + tuple(v.shape))
        return v

    def model_exchange(self):
        """-> (model lane, per-bucket exchange) of a solver that holds
        one model lane (a process mesh); stacked lanes hold them all:
        (None, None)."""
        return None, None

    def _wire_slices(self) -> int:
        """How many slices of v each carry their own int8 scale."""
        return 1

    def worker_view(self, v: Tensor) -> Tensor:
        # (P, d) pod replicas -> (P, K, d) per-worker replicas
        return v[:, None, :].expand(self.pods, self.lanes, v.shape[-1])

    def lane_sum(self, dv: Tensor, compress: bool = False) -> Tensor:
        """(P, K, d) worker deltas -> (P, d) per-pod ordered sums."""
        if compress:
            dv = _quantize_roundtrip(dv, axis=dv.ndim - 1)
        return _ordered_sum(dv, 1)

    def pod_reduce(self, v_pods: Tensor, v_in: Tensor) -> Tensor:
        if self.pods == 1:
            return v_pods[0]
        deltas = v_pods - v_in
        if self.compress_pod:
            S = self._wire_slices()
            deltas = _quantize_roundtrip(
                deltas.reshape(self.pods, S, -1), axis=2).reshape(deltas.shape)
        return v_in[0] + _ordered_sum(deltas, 0)


@dataclasses.dataclass(frozen=True)
class StackedMeshCollectives(SimCollectives):
    """Every shard of a (pod, data, model) mesh stacked on one device.

    The one-device mirror of the reference's `MeshCollectives` with
    ordered collectives (its `deterministic=True`): the same worker keys
    (per pod and example lane), the all-to-all re-deal over `data` only,
    the lane sum as ordered adds over `data` then `model` (with
    `compress`, the int8 two-phase `q_psum` on each axis in that order,
    on the reference's groups), and the pod reduce (int8 on the wire
    when `compress_pod`).  `lanes` is the example-lane count: data x
    model when the model axis carries examples, data when it carries
    features.  `model_role` names what the model axis carries:
    "examples", more example lanes; "slices", feature-sharded sparse
    data, where a solver returns each lane's slice of dv as an extra
    axis, (P, data, model, d); or "tp", dense tensor parallelism, where
    each worker's d rows are the model lanes' d/M slices in lane order,
    `data` is the only sync axis, and every int8 scale covers one lane's
    slice, as the reference's shard-local `compress` calls do.
    """
    model: int = 1
    model_role: str = "examples"

    def __post_init__(self):
        if self.model_role not in ("examples", "slices", "tp"):
            raise ValueError(f"unknown model_role {self.model_role!r}")

    @property
    def data(self) -> int:
        if self.model_role == "examples":
            return self.lanes // self.model
        return self.lanes

    def _redeal_axes(self) -> tuple[int, int]:
        return self.data, (self.model if self.model_role == "examples"
                           else 1)

    def _wire_slices(self) -> int:
        return self.model if self.model_role == "tp" else 1

    def lane_sum(self, dv: Tensor, compress: bool = False) -> Tensor:
        """(P, data*model, d), with model slices (P, data, model, d), or
        under tp (P, data, d) worker deltas -> (P, d): ordered sums over
        data, then model."""
        P, d = dv.shape[0], dv.shape[-1]
        if self.model_role == "tp":
            if not compress:
                return _ordered_sum(dv, 1)
            # each model lane reduces its own slice over data
            x = dv.reshape(P, self.data, self.model, -1).transpose(1, 2)
            return q_psum(x).reshape(P, d)
        dv = dv.reshape(P, self.data, self.model, d)
        if not compress:
            return _ordered_sum(_ordered_sum(dv, 1), 1)
        # data pass on each (pod, model lane), then model pass on each
        # (pod, data lane), whose lanes all hold the data pass's result
        if self.data > 1:
            dv = q_psum(dv.transpose(1, 2))[:, None]          # (P, 1, M, d)
        return q_psum(dv[:, 0]) if self.model > 1 else dv[:, 0, 0]


@dataclasses.dataclass(frozen=True, eq=False)
class MeshCollectives(SimCollectives):
    """Real collectives over a `launch.mesh.DistMesh`: this process is ONE
    worker of the (pod, data, model) mesh (one model lane of one when
    the model axis carries slices), and its tensors carry the stacked
    worker shape (1, 1) (``pods`` and ``lanes`` stay 1), so `run_epoch`,
    `chunk_inputs` and the solvers run unchanged, one block a launch.

    The reference's `MeshCollectives` in every role of the model axis
    (``model_role``, as `StackedMeshCollectives`'s): "examples", more
    example lanes; "slices", feature-sharded sparse data, each rank one
    lane of v's slices; "tp", dense tensor parallelism, each rank d/M
    rows of X and of v.  Worker keys come from this rank's pod and its
    data-major example lane (`lane`: under "slices" and "tp" the data
    index alone, so a worker's model lanes draw one stream, deal the same
    columns and hold the same rows); the re-deal is an
    `all_to_all_single` over `data` within the rank's (pod, model)
    group; the lane sum runs over `data`, then `model` ("tp": `data`
    only, on the rank's slice), as an `all_gather` summed in rank order
    (``deterministic``, bitwise `StackedMeshCollectives`), an
    `all_reduce` otherwise, or with ``compress`` the int8 two-phase
    `q_psum` (an `all_to_all` of int8 shards, `all_gather`s of the
    scales and the reduced shards) in the stacked `q_psum`'s rounding
    order; the pod reduce in the same three forms, int8 on the wire
    under ``compress_pod`` (one scale for the rank's v: under "tp" its
    slice, as on the stacked mesh).  Per bucket the model lanes
    exchange what the solver hands `model_exchange`'s callable: the
    working sets under "slices" (`gather_model`), the packed [m0 | G]
    partials under "tp" (`model_sum`).

    Under gloo on a CUDA device every collective (`all_gather`,
    `all_to_all_single`, `all_reduce`) stages explicitly: its input is
    copied to host memory, the op runs there, and the result is copied
    back to the rank's device; the per-bucket exchange goes through one
    pinned buffer each way.  The kernels always run on the device.
    """
    mesh: object = None
    deterministic: bool = False
    model_role: str = "examples"
    _pinned: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError("MeshCollectives needs a DistMesh")
        if self.model_role not in ("examples", "slices", "tp"):
            raise ValueError(f"unknown model_role {self.model_role!r}")

    @property
    def lane(self) -> int:
        """This rank's example lane, counted data-major over the example
        axes (the data index alone when the model axis carries slices)."""
        _, d, m = self.mesh.coords
        return d * self.mesh.model + m if self.model_role == "examples" \
            else d

    @property
    def model_lane(self) -> int:
        return self.mesh.coords[2]

    def worker_keys(self, seed: int, epoch: int) -> np.ndarray:
        base = prng.fold_in(prng.PRNGKey(seed), int(epoch))
        kp = prng.fold_in(base, self.mesh.coords[0])
        return prng.fold_in(kp, self.lane).reshape(1, 1, 2)

    # -- the three primitives, staged through the host under gloo --------

    def _host(self, t: Tensor) -> Tensor:
        return t.contiguous().cpu() if self.mesh.stages else t.contiguous()

    def gather(self, t: Tensor, axis: Optional[str]) -> list[Tensor]:
        """Every member's `t` in group-rank order (`axis` None: the
        world), on this rank's device."""
        x = self._host(t)
        out = [torch.empty_like(x) for _ in range(self.mesh.group_size(axis))]
        dist.all_gather(out, x, group=self.mesh.group(axis))
        return [o.to(t.device) for o in out]

    def _all_to_all(self, t: Tensor, axis: str) -> Tensor:
        x = self._host(t)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.mesh.group(axis))
        return out.to(t.device)

    def _all_reduce(self, t: Tensor, axis: str) -> Tensor:
        x = t.to("cpu" if self.mesh.stages else t.device, copy=True)
        dist.all_reduce(x, group=self.mesh.group(axis))
        return x.to(t.device)

    def _gather_sum(self, t: Tensor, axis: str) -> Tensor:
        return _ordered_sum(torch.stack(self.gather(t, axis)), 0)

    def _stacked_gather(self, t: Tensor, axis: str) -> Tensor:
        """Every member's `t` stacked in group-rank order, (L, *t.shape),
        on this rank's device; staged (gloo on CUDA) through one pinned
        buffer each way, reused call after call (the copies block, so
        the next call never overwrites a buffer still being read)."""
        L = self.mesh.group_size(axis)
        if L == 1:
            return t[None]
        if not self.mesh.stages:
            out = torch.empty((L,) + tuple(t.shape), dtype=t.dtype,
                              device=t.device)
            dist.all_gather(list(out.unbind(0)), t.contiguous(),
                            group=self.mesh.group(axis))
            return out
        key = (axis, tuple(t.shape), t.dtype)
        if key not in self._pinned:
            self._pinned[key] = (
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True),
                torch.empty((L,) + tuple(t.shape), dtype=t.dtype,
                            pin_memory=True))
        src, dst = self._pinned[key]
        src.copy_(t)
        dist.all_gather(list(dst.unbind(0)), src,
                        group=self.mesh.group(axis))
        return dst.to(t.device)

    def gather_model(self, t: Tensor) -> Tensor:
        """The model lanes' `t` in lane order, (M, *t.shape): the
        per-bucket exchange of the feature-sharded working sets."""
        return self._stacked_gather(t, "model")

    def model_sum(self, packed: Tensor) -> Tensor:
        """(*w, 1, B, 1 + B) this lane's packed [m0 | G] partials ->
        (*w, B, 1 + B), summed over the model lanes in lane order: the
        tensor-parallel exchange, the adds of the stacked
        `sdca.lane_ordered_sum`."""
        return _ordered_sum(self._stacked_gather(packed[..., 0, :, :],
                                                 "model"), 0)

    def model_exchange(self):
        """-> (this rank's model lane, the solver's per-bucket exchange)
        when the model axis carries slices ("slices": `gather_model`;
        "tp": `model_sum`), else (None, None)."""
        if self.model_role == "slices":
            return self.model_lane, self.gather_model
        if self.model_role == "tp":
            return self.model_lane, self.model_sum
        return None, None

    # -- the engine's seam -------------------------------------------------

    def redeal(self, arrs, nb_local: int, keys: np.ndarray, frac: float):
        """The all-to-all bucket re-deal over `data`: shuffle this rank's
        buckets, send split j of the first `exch` to data lane j, and
        take lane i's split of ours in lane order (a tiled all_to_all)."""
        D = self.mesh.data
        if D <= 1 or frac <= 0:
            return tuple(x for x, _ in arrs)
        exch = max(int(nb_local * frac) // D * D, D)
        perm = self._perms(keys, 0, nb_local, arrs[0][0].device)[0, 0]

        def one(x, ax):
            xb = torch.movedim(x, ax, 2)            # (1, 1, n_local, ...)
            shp = xb.shape
            rows = shp[2] // nb_local
            xb = xb.reshape((nb_local, rows) + tuple(shp[3:]))[perm]
            head = self._all_to_all(xb[:exch], "data")
            xb = torch.cat([head, xb[exch:]], dim=0)
            return torch.movedim(xb.reshape(shp), 2, ax)

        return tuple(one(x, ax) for x, ax in arrs)

    def _q_psum(self, x: Tensor, axis: str) -> Tensor:
        """`q_psum` over one axis's group: x (n,) -> (n,)."""
        from repro_torch.optim.compression import quantize
        L = self.mesh.shape[axis]
        n = x.shape[0]
        pad = (-n) % L
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        qz = quantize(x)
        shards = self._all_to_all(qz.q.reshape(L, -1), axis)  # lane i's shard
        scales = torch.stack(self.gather(qz.scale.reshape(1), axis))
        part = _ordered_sum(shards.float() * scales, 0)
        qz2 = quantize(part)
        q_all = torch.stack(self.gather(qz2.q, axis))
        s_all = torch.stack(self.gather(qz2.scale.reshape(1), axis))
        return (q_all.float() * s_all).reshape(-1)[:n]

    def lane_sum(self, dv: Tensor, compress: bool = False) -> Tensor:
        """(1, 1, d) this worker's delta -> (1, d): reduced over `data`,
        then `model` (under "tp" (1, 1, d/M), this lane's rows, over
        `data` only)."""
        x = dv.reshape(-1)
        axes = ("data",) if self.model_role == "tp" else ("data", "model")
        for axis in axes:
            if self.mesh.shape[axis] <= 1:
                continue
            if compress:
                x = self._q_psum(x, axis)
            elif self.deterministic:
                x = self._gather_sum(x, axis)
            else:
                x = self._all_reduce(x, axis)
        return x[None]

    def pod_reduce(self, v_pods: Tensor, v_in: Tensor) -> Tensor:
        """(1, d) this pod's v and the epoch's v_in -> (d,)."""
        if self.mesh.pod <= 1:
            return v_pods[0]
        dv = v_pods[0] - v_in[0]
        if self.compress_pod:
            from repro_torch.optim.compression import quantize
            qz = quantize(dv)
            q_all = torch.stack(self.gather(qz.q, "pod"))
            s_all = torch.stack(self.gather(qz.scale.reshape(1), "pod"))
            dv_sum = _ordered_sum(q_all.float() * s_all, 0)
        elif self.deterministic:
            dv_sum = self._gather_sum(dv, "pod")
        else:
            dv_sum = self._all_reduce(dv, "pod")
        return v_in[0] + dv_sum


# ---------------------------------------------------------------------------
# The epoch program
# ---------------------------------------------------------------------------


def _apply_chunk(coll: SimCollectives, solver: LocalSolver, algo: AlgoConfig,
                 data, yc: Tensor, ac: Tensor, v_c: Tensor, *,
                 straggler_mask: Optional[Tensor] = None,
                 dv_scale: float = 1.0) -> tuple[Tensor, Tensor]:
    """One chunk's solve/mask/sync."""
    a_new, dv = coll.map_workers(solver,
                                 (data, yc, ac, coll.worker_view(v_c)))
    if straggler_mask is not None:
        a_new = torch.where(straggler_mask[..., None], a_new, ac)
        dv = dv * straggler_mask[..., None].to(dv.dtype)
    if dv_scale != 1.0:
        dv = dv * torch.tensor(dv_scale, dtype=dv.dtype, device=dv.device)
    return a_new, v_c + coll.lane_sum(dv, compress=algo.compress_sync)


def _put_cols(a: Tensor, cols: Tensor, vals: Tensor) -> Tensor:
    """alpha[..., cols] = vals with optional leading worker axes."""
    return a.scatter(-1, cols.expand(a.shape[:-1] + cols.shape[-1:]), vals)


def epoch_layout(coll: SimCollectives, algo: AlgoConfig, block: Block,
                 y: Tensor, a: Tensor, epoch: int, *, redeal: bool = True,
                 visit_shuffle: bool = True):
    """The epoch's schedule on worker-local data: -> (block, y, a, perm).

    Re-deals buckets across lanes (`coll.redeal`) and draws each
    worker's visit order over its `nb_local` buckets, (P, K, nb_local).
    """
    n_local = block.n_local
    B = algo.bucket
    if n_local % B:
        raise ValueError(f"n_local={n_local} not divisible by bucket={B}")
    nb_local = n_local // B
    if nb_local % algo.chunks:
        raise ValueError(
            f"chunks={algo.chunks} must divide local bucket count "
            f"{nb_local}")
    keys = coll.worker_keys(algo.seed, epoch)
    if redeal:
        arrs = block.arrs() + ((y, -1), (a, -1))
        out = coll.redeal(arrs, nb_local, keys, algo.redeal_frac)
        nblk = len(block.arrs())
        block = block.rebuild(out[:nblk])
        y, a = out[nblk], out[nblk + 1]
    if visit_shuffle:
        perm = coll.visit_perms(keys, nb_local, y.device)
    else:
        perm = coll.broadcast_ids(
            torch.arange(nb_local, dtype=torch.int64, device=y.device))
    return block, y, a, perm


def chunk_inputs(algo: AlgoConfig, block: Block, y: Tensor, a: Tensor,
                 perm: Tensor, c: int):
    """Chunk `c` of an epoch, as its solver gets it: -> (cols, data, yc,
    ac), cols the (P, K, per_chunk * B) local columns in visiting order."""
    B = algo.bucket
    per_chunk = perm.shape[-1] // algo.chunks
    ids = perm[..., c * per_chunk:(c + 1) * per_chunk]
    barange = torch.arange(B, dtype=torch.int64, device=y.device)
    cols = (ids[..., None] * B + barange).reshape(
        ids.shape[:-1] + (per_chunk * B,))
    return (cols, block.take(cols), torch.take_along_dim(y, cols, dim=-1),
            torch.take_along_dim(a, cols, dim=-1))


def run_epoch(coll: SimCollectives, solver: LocalSolver, algo: AlgoConfig,
              block: Block, y: Tensor, a: Tensor, v: Tensor, epoch: int, *,
              straggler_mask: Optional[Tensor] = None, redeal: bool = True,
              visit_shuffle: bool = True, dv_scale: float = 1.0
              ) -> tuple[Block, Tensor, Tensor, Tensor]:
    """One bulk-synchronous epoch over worker-local data.

    schedule/re-deal -> per-chunk: local sub-epoch, straggler mask,
    lane sync -> per-epoch: pod reduce.  Returns the (possibly
    re-dealt) block and labels, plus updated (alpha_local, v).
    """
    block, y, a, perm = epoch_layout(coll, algo, block, y, a, epoch,
                                     redeal=redeal,
                                     visit_shuffle=visit_shuffle)
    v = coll.pod_replicate(v)
    v_in = v
    for c in range(algo.chunks):
        cols, data, yc, ac = chunk_inputs(algo, block, y, a, perm, c)
        a_new, v = _apply_chunk(coll, solver, algo, data, yc, ac, v,
                                straggler_mask=straggler_mask,
                                dv_scale=dv_scale)
        a = _put_cols(a, cols, a_new)
    v = coll.pod_reduce(v, v_in)
    return block, y, a, v


def sharded_epoch(obj: Objective, spec: EngineConfig, coll: SimCollectives,
                  block: Block, y: Tensor, a: Tensor, v: Tensor, epoch: int,
                  *, lam: float, n_total: int, workers: int,
                  model_lanes: Optional[int] = None, split_tp: bool = False,
                  device="cuda"
                  ) -> tuple[Block, Tensor, Tensor, Tensor]:
    """Epoch over a physically partitioned workload (the distributed
    layout): partition != 'static' re-deals buckets across lanes, the
    visit order is a fresh per-worker shuffle.  `model_lanes` on a
    sparse block selects the feature-sharded solver (each model lane
    owns a slice of v; `coll` must then be a `StackedMeshCollectives`
    with model_role "slices", whose lane sum reassembles the slices),
    and on a dense block tensor parallelism (`coll` then a
    `StackedMeshCollectives` with model_role "tp").  On a process mesh
    (`MeshCollectives` in those roles) the solver holds the rank's model
    lane and trades with the others through `coll.model_exchange`;
    ``split_tp`` runs a stacked mesh's TP workers through the split
    pair (`make_local_solver`)."""
    algo = spec.algo
    lane, exchange = (coll.model_exchange() if model_lanes is not None
                      else (None, None))
    solver = make_local_solver(
        algo.local_solver, obj, lam * n_total, spec.sigma_prime(workers),
        bucket=algo.bucket, sparse=isinstance(block, SparseBlock),
        model_lanes=model_lanes, lane=lane, exchange=exchange,
        split_tp=split_tp, device=device)
    dv_scale = 1.0 / workers if algo.aggregation == "averaging" else 1.0
    return run_epoch(coll, solver, algo, block, y, a, v, epoch,
                     redeal=(algo.partition != "static"),
                     visit_shuffle=True, dv_scale=dv_scale)


# ---------------------------------------------------------------------------
# Simulator entry points (global arrays, schedule-based partitioning)
# ---------------------------------------------------------------------------


def _sim_gather(plan, bucket: int, epoch: int) -> np.ndarray:
    """(P, K, n_local) global example ids for this epoch's schedule."""
    sched = plan.schedule(epoch).astype(np.int64)      # (P, K, per_lane)
    return (sched[..., None] * bucket
            + np.arange(bucket)).reshape(plan.pods, plan.lanes, -1)


def sim_worker_data(data, y: Tensor, alpha: Tensor, plan, bucket: int,
                    epoch: int) -> tuple[Tensor, Block, Tensor, Tensor]:
    """This epoch's worker-local inputs on the simulator path.

    data: X (d, n) or an (idx, val) pair of (n, nnz).  Returns (ex, block,
    y_local, alpha_local): ex (P, K, n_local) the global example ids of
    `plan.schedule(epoch)` in visiting order, and the (P, K, ...) data,
    labels and duals gathered at ex.  With one chunk, `run_epoch` hands
    the solver exactly these (the sim path neither re-deals nor
    shuffles the visit order).
    """
    ex = _as(_sim_gather(plan, bucket, epoch), y.device)   # (P, K, n_local)
    if isinstance(data, tuple):
        block = SparseBlock(data[0][ex], data[1][ex])
    else:
        block = DenseBlock(data[:, ex].permute(1, 2, 0, 3))
    return ex, block, y[ex], alpha[ex]


def _sim_coll(spec: EngineConfig) -> SimCollectives:
    dep = spec.deployment
    return SimCollectives(pods=dep.pods, lanes=dep.lanes,
                          compress_pod=dep.compress_pod)


def _as(x, device, dtype=None) -> Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def sim_epoch_dense(obj: Objective, X, y, alpha, v, lam: float, plan, bplan,
                    spec, epoch: int, straggler_mask=None, *,
                    dv_scale_mul: float = 1.0, device="cuda"
                    ) -> tuple[Tensor, Tensor]:
    """One simulated epoch over P*K virtual workers (dense path).

    X (d, n), y/alpha (n,), v (d,): tensors or arrays, moved to `device`
    (default the card; a missing GPU raises).  Partitioning comes from
    `plan.schedule`; the epoch runs `run_epoch` with every worker's
    sub-epoch in one solver call.  Returns (alpha, v).
    """
    device = resolve_device(device)
    spec = as_engine_config(spec)
    X, y, alpha, v = (_as(t, device, torch.float32)
                      for t in (X, y, alpha, v))
    n = X.shape[1]
    B = bplan.bucket
    ex, block, yl, al = sim_worker_data(X, y, alpha, plan, B, epoch)
    W = plan.pods * plan.lanes
    solver = make_local_solver(
        spec.algo.local_solver, obj, lam * n, spec.sigma_prime(W),
        bucket=B, device=device)
    # dv_scale_mul < 1 damps the aggregated update (CoCoA's gamma)
    dv_scale = (1.0 / W if spec.algo.aggregation == "averaging"
                else 1.0) * dv_scale_mul
    mask = None if straggler_mask is None else _as(straggler_mask, device)
    _, _, a_new, v_new = run_epoch(
        _sim_coll(spec), solver, spec.algo, block, yl, al, v, epoch,
        straggler_mask=mask, redeal=False,
        visit_shuffle=False, dv_scale=dv_scale)
    alpha = alpha.clone()
    alpha[ex.reshape(-1)] = a_new.reshape(-1)
    return alpha, v_new


def sim_epoch_sparse(obj: Objective, idx, val, y, alpha, v, lam: float,
                     plan, bplan, spec, epoch: int, straggler_mask=None, *,
                     dv_scale_mul: float = 1.0, device="cuda"
                     ) -> tuple[Tensor, Tensor]:
    """Sparse-path simulated epoch: idx/val (n, nnz) padded CSR, v (d,)."""
    device = resolve_device(device)
    spec = as_engine_config(spec)
    idx = _as(idx, device, torch.int32)
    val, y, alpha, v = (_as(t, device, torch.float32)
                        for t in (val, y, alpha, v))
    n = y.shape[0]
    B = bplan.bucket
    ex, block, yl, al = sim_worker_data((idx, val), y, alpha, plan, B, epoch)
    W = plan.pods * plan.lanes
    solver = make_local_solver(
        spec.algo.local_solver, obj, lam * n, spec.sigma_prime(W),
        bucket=B, sparse=True, device=device)
    dv_scale = (1.0 / W if spec.algo.aggregation == "averaging"
                else 1.0) * dv_scale_mul
    mask = None if straggler_mask is None else _as(straggler_mask, device)
    _, _, a_new, v_new = run_epoch(
        _sim_coll(spec), solver, spec.algo, block, yl, al, v, epoch,
        straggler_mask=mask, redeal=False,
        visit_shuffle=False, dv_scale=dv_scale)
    alpha = alpha.clone()
    alpha[ex.reshape(-1)] = a_new.reshape(-1)
    return alpha, v_new


def sim_sharded_dense_epoch(obj: Objective, spec, X, y, a, v, epoch: int,
                            *, lam: float, n_total: int, device="cuda"):
    """Distributed-layout dense epoch on stacked sim workers (replicated
    v): X (P, K, d, n_local), y/a (P, K, n_local), v (d,).  The sim side
    of the sim-equals-mesh contract: with a deterministic stacked mesh
    whose example lanes mirror K (model 1), `launch.glm.make_dense_epoch`
    gives the same bits.  Returns the re-dealt (X, y), and (a, v)."""
    device = resolve_device(device)
    spec = as_engine_config(spec)
    X, y, a, v = (_as(t, device, torch.float32) for t in (X, y, a, v))
    blk, y, a, v = sharded_epoch(
        obj, spec, _sim_coll(spec), DenseBlock(X), y, a, v, epoch,
        lam=lam, n_total=n_total, workers=spec.workers, device=device)
    return blk.X, y, a, v


def sim_sharded_sparse_epoch(obj: Objective, spec, idx, val, y, a, v,
                             epoch: int, *, lam: float, n_total: int,
                             device="cuda"):
    """Distributed-layout sparse epoch on stacked sim workers (replicated
    v): idx/val (P, K, n_local, nnz), y/a (P, K, n_local), v (d,).
    Returns the re-dealt (idx, val, y), and (a, v)."""
    device = resolve_device(device)
    spec = as_engine_config(spec)
    idx = _as(idx, device, torch.int32)
    val, y, a, v = (_as(t, device, torch.float32) for t in (val, y, a, v))
    blk, y, a, v = sharded_epoch(
        obj, spec, _sim_coll(spec), SparseBlock(idx, val), y, a, v, epoch,
        lam=lam, n_total=n_total, workers=spec.workers, device=device)
    return blk.idx, blk.val, y, a, v


# ---------------------------------------------------------------------------
# Out-of-core streaming: ChunkFeed + the streamed chunk loop
# ---------------------------------------------------------------------------


class ChunkFeed(Protocol):
    """Host-side supplier of worker-shaped example chunks.

    The engine asks for GLOBAL bucket ids laid out (*wshape, nb_chunk)
    and gets back (data, y) on ``device`` covering those buckets'
    examples in schedule order:

        dense:   data (*wshape, d, nb_chunk*B) f32
        sparse:  data = (idx int32, val f32), each (*wshape, nb_chunk*B, nnz)
        labels:  y (*wshape, nb_chunk*B) f32

    `fetch` is called one chunk ahead from a worker thread (double
    buffering), so implementations must tolerate concurrent calls.  On
    a CUDA device that thread's current stream is the loop's side
    stream: `fetch` issues its copies there and returns; the loop
    records an event after it and makes the compute stream wait on
    that event.  Implementations live in `repro_torch.data.cache`
    (`TileFeed` over the mmap'd bucket-tile cache, `ArrayFeed` over
    host arrays).

    Contract on sparse rows: no feature id may repeat with a NONZERO
    value within a row (the CSR invariant the sparse kernel's bitwise
    guarantee rests on — sanitize with `data.formats.zero_duplicates`
    when building a custom feed; chunks reach the solver without a
    host-side check).
    """
    n: int          # global example count (padded)
    d: int
    bucket: int
    sparse: bool
    device: torch.device

    def fetch(self, bids: np.ndarray): ...


def make_streamed_step(coll: SimCollectives, solver: LocalSolver,
                       algo: AlgoConfig, *, dv_scale: float = 1.0):
    """One streamed chunk: gather alpha at the chunk's columns, run
    `_apply_chunk` (the SAME body as `run_epoch`'s resident loop), and
    write alpha back at those columns, in place (`run_epoch_streamed`
    hands the step the epoch's own copy of alpha; the columns of a
    chunk are distinct, so the write is deterministic)."""

    def step(data, yc, cols, a, v_c):
        a_new, v_c = _apply_chunk(coll, solver, algo, data, yc, a[cols],
                                  v_c, dv_scale=dv_scale)
        a[cols] = a_new
        return a, v_c

    return step


def run_epoch_streamed(
    coll: SimCollectives,
    feed: ChunkFeed,
    step,                      # from make_streamed_step
    plan,                      # PartitionPlan (host-evaluated schedule)
    algo: AlgoConfig,
    alpha: Tensor,             # (n,) global dual, on the device
    v: Tensor,                 # (d,) shared vector, on the device
    epoch: int,
    journal=None,
    stats: Optional[dict] = None,   # out: ingest-overlap metrics
) -> tuple[Tensor, Tensor]:
    """One epoch where `run_epoch`'s chunked sub-epoch loop consumes
    host-resident chunks instead of a device-resident block.

    The schedule is the same pure function of (seed, epoch) the
    simulator uses (`plan.schedule`, evaluated on the host), and each
    chunk's compute is `_apply_chunk` — so the chunk's solver call gets
    the bytes the resident loop hands it, and the result is bitwise
    `sim_epoch_dense`/`sim_epoch_sparse`'s on the same data, while only
    a `chunks`-th of the examples (two, while the next one is copied)
    is ever on the device.

    Double buffering: a one-thread executor fetches chunk c+1 while
    chunk c computes.  On a CUDA device the fetch runs under
    ``torch.cuda.stream(side)`` (the current stream is per thread), so
    the feed's host-to-device copies and the chunk's column ids go on a
    side stream; an event recorded after them is what the compute
    stream waits on, and every fetched tensor is marked used by the
    compute stream (`record_stream`), so the caching allocator cannot
    hand its memory to a later chunk's copy while the step still reads
    it.  A failure in the fetch re-raises here, from the future.  The
    loop never synchronizes the device.

    A ``stats`` dict receives the epoch's ingest-overlap metrics:
    ``epoch_s`` wall time, ``fetch_s`` the prefetch thread's time in
    `fetch`, ``ingest_wait_s`` the time the chunk loop spent BLOCKED on
    it (host gather and copy issue not hidden behind compute),
    ``chunks`` (those this call ran), and ``transfer_hidden_frac = 1 -
    ingest_wait_s / epoch_s``.  Passing one adds a device synchronize
    at the epoch's end; None keeps the epoch free of any.

    With a ``journal`` (`repro_torch.resilience.EpochJournal`) the loop
    is crash-safe: state is snapshotted at chunk boundaries, and a
    re-entered epoch resumes at the journaled chunk cursor with the
    journaled alpha and (P, d) v and v_in, as they are; the schedule is
    pure in (seed, epoch), so the resumed epoch replays exactly the
    chunks not yet applied and ends bitwise an uninterrupted one.  Each
    journal write reads the state back to the host (a device
    synchronize).  Without one the loop adds two ``is not None`` tests
    per chunk and nothing else.
    """
    B = feed.bucket
    per_lane = plan.per_lane
    if per_lane % algo.chunks:
        raise ValueError(f"chunks={algo.chunks} must divide per-lane "
                         f"bucket count {per_lane}")
    per_chunk = per_lane // algo.chunks
    ep = int(epoch)
    sched = np.asarray(plan.schedule(ep), np.int64)  # (P, K, pl)
    dev = alpha.device
    cuda = dev.type == "cuda"
    barange = torch.arange(B, dtype=torch.int64, device=dev)
    side = None
    if cuda:            # the side stream starts after what is enqueued
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
    fetch_s = [0.0]

    def fetch(c):
        t0 = time.perf_counter()
        bids = sched[..., c * per_chunk:(c + 1) * per_chunk]
        ready = None
        if cuda:
            with torch.cuda.stream(side):
                data, yc = feed.fetch(bids)
                ids = torch.from_numpy(np.ascontiguousarray(
                    bids)).pin_memory().to(dev, non_blocking=True)
                cols = (ids[..., None] * B + barange).flatten(-2)
                ready = torch.cuda.Event()
                ready.record(side)
        else:
            data, yc = feed.fetch(bids)
            cols = (torch.from_numpy(bids)[..., None] * B
                    + barange).flatten(-2)
        fetch_s[0] += time.perf_counter() - t0
        return cols, data, yc, ready

    v = coll.pod_replicate(v)
    v_in = v
    alpha = alpha.clone()          # the caller's alpha survives a failure
    start = 0
    if journal is not None:
        got = journal.load_inflight(ep, alpha, v, v_in, device=dev)
        if got is not None:
            start, alpha, v, v_in = got
    compute = torch.cuda.current_stream(dev) if cuda else None
    t_start = time.perf_counter()
    wait_s = 0.0
    # a BaseException (an injected kill) raised below leaves through the
    # executor's exit, which waits for the fetch in flight
    with ThreadPoolExecutor(max_workers=1) as ex:
        nxt = ex.submit(fetch, start)
        for c in range(start, algo.chunks):
            if journal is not None:
                journal.pre_chunk(ep, c)
            t0 = time.perf_counter()
            cols, data, yc, ready = nxt.result()
            wait_s += time.perf_counter() - t0
            if c + 1 < algo.chunks:
                nxt = ex.submit(fetch, c + 1)
            tensors = (*(data if isinstance(data, tuple) else (data,)),
                       yc, cols)
            for t in tensors:
                if not isinstance(t, Tensor) or t.device != dev:
                    raise ValueError(
                        f"the feed handed chunk {c} as "
                        f"{getattr(t, 'device', type(t).__name__)}; the "
                        f"step runs on {dev}")
            if ready is not None:
                compute.wait_event(ready)
                for t in tensors:
                    t.record_stream(compute)
            alpha, v = step(data, yc, cols, alpha, v)
            if journal is not None:
                journal.post_chunk(ep, c, alpha, v, v_in, algo.chunks)
    v = coll.pod_reduce(v, v_in)
    if stats is not None:
        if cuda:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t_start
        stats.update(
            epoch_s=wall, fetch_s=fetch_s[0], ingest_wait_s=wait_s,
            chunks=algo.chunks - start,
            transfer_hidden_frac=(max(0.0, 1.0 - wait_s / wall)
                                  if wall > 0 else 0.0))
    return alpha, v


def make_streamed_epoch(obj: Objective, spec, plan, feed: ChunkFeed, *,
                        lam: float, journal=None, damp: float = 1.0,
                        device="cuda"):
    """-> epoch_fn(alpha, v, epoch, *, stats=None) for out-of-core
    training.

    The streamed twin of `sim_epoch_dense`/`sim_epoch_sparse`: same
    solver, same sigma', same schedule, but examples arrive chunk by
    chunk through `feed`, whose tensors must land on ``device`` (default
    the card; a missing GPU raises).  ``journal`` threads an
    `EpochJournal` into the chunk loop (crash safety); ``damp`` is the
    health guard's multiplier on dv_scale (`sim_epoch_*`'s
    ``dv_scale_mul``).
    """
    device = resolve_device(device)
    fdev = getattr(feed, "device", None)
    if fdev is None or not same_device(fdev, device):
        raise ValueError(f"the feed's tensors land on {fdev}; the epoch "
                         f"runs on {device}")
    spec = as_engine_config(spec)
    coll = _sim_coll(spec)
    W = plan.pods * plan.lanes
    solver = make_local_solver(
        spec.algo.local_solver, obj, lam * feed.n, spec.sigma_prime(W),
        bucket=feed.bucket, sparse=feed.sparse, device=device)
    dv_scale = (1.0 / W if spec.algo.aggregation == "averaging"
                else 1.0) * damp
    step = make_streamed_step(coll, solver, spec.algo, dv_scale=dv_scale)

    def epoch_fn(alpha, v, epoch, *, stats=None):
        alpha, v = (_as(t, device, torch.float32) for t in (alpha, v))
        return run_epoch_streamed(coll, feed, step, plan, spec.algo,
                                  alpha, v, epoch, journal=journal,
                                  stats=stats)

    return epoch_fn


# ---------------------------------------------------------------------------
# Mesh streaming: the streamed loop on a mesh
# ---------------------------------------------------------------------------
#
# `run_epoch_streamed` needs a schedule, a feed, a step and the
# collectives' pod_replicate/pod_reduce.  The classes below supply them
# for a mesh, so the SAME loop (side stream, events, journal hooks,
# stats) streams host-resident tiles onto a stacked or a process mesh:
#
#   MeshSchedule     — host replay of the mesh's re-deal and visit PRNG
#                      streams: which GLOBAL buckets each worker trains
#                      on, in which order, each epoch.
#   MeshChunkFeed    — host gather and copy of a chunk in the mesh's
#                      worker-major layout, slice-compacted per model
#                      lane for feature-sharded sparse data.
#   MeshStreamDriver — pod_replicate/pod_reduce, and on a process mesh
#                      the epoch-end exchange of alpha.
#
# plus `make_mesh_streamed_step`, which reassembles compacted rows.


class MeshSchedule:
    """Host-side replay of the mesh epoch's bucket schedule.

    The resident mesh re-deals buckets on the device (`redeal`: a
    per-worker shuffle, then an all-to-all over `data`) and visits them
    in a per-worker shuffled order.  To stream, the host must know which
    GLOBAL bucket ids each worker holds every epoch, so this class
    replays the same threefry streams (`core.prng`):

        worker_key = fold(fold(fold(PRNGKey(seed), epoch), pod), lane)
        re-deal perm <- fold(worker_key, 0);  visit <- fold(worker_key, 1)

    applies the all-to-all's index permutation to a persistent bucket
    LAYOUT (initially contiguous, as a flat global array is dealt to the
    example shards) and composes the re-deals epoch over epoch, as the
    resident layout persists.  `schedule(e)` is a pure function of
    (seed, e), so a resumed epoch replays the resident bucket order.

    `lane` is counted data-major over the example axes: when the model
    axis carries examples lane = data_idx * M + model_idx and the
    re-deal exchanges within each (pod, model) column over the D data
    lanes; when it carries slices (feature sharding, dense TP) lane =
    data_idx.  Integer for integer the reference's `MeshSchedule`.
    """

    def __init__(self, n_buckets: int, *, pods: int = 1, data: int = 1,
                 model: int = 1, model_in_lanes: bool = True,
                 seed: int = 0, redeal: bool = True,
                 redeal_frac: float = 1.0, visit_shuffle: bool = True):
        self.n_buckets = int(n_buckets)
        self.pods, self.data, self.model = int(pods), int(data), int(model)
        self.model_in_lanes = bool(model_in_lanes)
        self.lanes = self.data * self.model if model_in_lanes else self.data
        if self.n_buckets % (self.pods * self.lanes):
            raise ValueError(
                f"n_buckets={n_buckets} not divisible by "
                f"{self.pods} pods x {self.lanes} lanes")
        self.seed = int(seed)
        self.redeal = bool(redeal)
        self.redeal_frac = float(redeal_frac)
        self.visit_shuffle = bool(visit_shuffle)
        self._base = np.arange(self.n_buckets, dtype=np.int32).reshape(
            self.pods, self.lanes, self.per_lane)
        self._layouts: list[np.ndarray] = []   # post-redeal, per epoch

    @property
    def per_lane(self) -> int:
        return self.n_buckets // (self.pods * self.lanes)

    def _keys(self, epoch: int) -> np.ndarray:
        return SimCollectives(self.pods, self.lanes).worker_keys(self.seed,
                                                                 epoch)

    def _perm(self, key, stream: int) -> np.ndarray:
        return prng.permutation(prng.fold_in(key, stream), self.per_lane)

    def _redeal(self, layout: np.ndarray, keys) -> np.ndarray:
        """One epoch's re-deal: shuffle each lane's buckets and exchange
        the first `exch` over `data` by the tiled all_to_all's index
        permutation."""
        D = self.data
        nb = self.per_lane
        if D <= 1 or self.redeal_frac <= 0:
            return layout
        exch = max(int(nb * self.redeal_frac) // D * D, D)
        g = exch // D
        out = layout.copy()
        cols = self.model if self.model_in_lanes else 1
        for p in range(self.pods):
            for m in range(cols):
                lanes = [i * cols + m for i in range(D)]
                shuf = [out[p, ln][self._perm(keys[p, ln], 0)]
                        for ln in lanes]
                for j, lnj in enumerate(lanes):
                    head = np.concatenate(
                        [shuf[i][j * g:(j + 1) * g] for i in range(D)])
                    out[p, lnj] = np.concatenate([head, shuf[j][exch:]])
        return out

    def layout(self, epoch: int) -> np.ndarray:
        """(pods, lanes, per_lane) GLOBAL bucket ids each worker holds
        AFTER epoch `epoch`'s re-deal: the layout the resident mesh
        trains on during that epoch (tests map resident state back to
        global order with it)."""
        if not self.redeal:
            return self._base
        while len(self._layouts) <= epoch:
            r = len(self._layouts)
            prev = self._layouts[r - 1] if r else self._base
            self._layouts.append(self._redeal(prev, self._keys(r)))
        return self._layouts[epoch]

    def schedule(self, epoch) -> np.ndarray:
        """(pods, lanes, per_lane) bucket ids in VISIT order: the
        `plan.schedule` contract `run_epoch_streamed` consumes."""
        e = int(epoch)
        lay = self.layout(e)
        if not self.visit_shuffle:
            return lay.copy()
        keys = self._keys(e)
        out = np.empty_like(lay)
        for p in range(self.pods):
            for ln in range(self.lanes):
                out[p, ln] = lay[p, ln][self._perm(keys[p, ln], 1)]
        return out

    def worker(self, pod: int, lane: int) -> "WorkerSchedule":
        """One worker's view, for a process that streams only its own
        buckets."""
        return WorkerSchedule(self, pod, lane)


@dataclasses.dataclass(frozen=True)
class WorkerSchedule:
    """One worker's rows of a `MeshSchedule`: `schedule(e)` is (1, 1,
    per_lane), the stacked shape of a process mesh's worker."""
    mesh_schedule: MeshSchedule
    pod: int
    lane: int

    @property
    def per_lane(self) -> int:
        return self.mesh_schedule.per_lane

    def schedule(self, epoch) -> np.ndarray:
        return self.mesh_schedule.schedule(epoch)[self.pod, self.lane][
            None, None]


class MeshChunkFeed:
    """`ChunkFeed` that lands each chunk in a mesh's layout.

    The host gathers a chunk's buckets (from a `TileCache`'s mmap'd
    tiles or an `ArrayFeed`'s host arrays) in the shape of the bucket
    ids it is asked for, (*wshape, nb): worker-major, the order a flat
    global array is dealt to the mesh's example shards.  On a stacked
    mesh that is every worker's rows in one pinned copy; on a process
    mesh each rank asks for, gathers and copies only its own.  Copies
    go through `PinnedStaging` (on the calling thread's current stream:
    the streamed loop's side stream).

    Feature-sharded sparse data (``model_lanes`` and ``d_loc`` set)
    uses the slice-compacted feed: each row is compacted to each model
    lane's [m*d_loc, (m+1)*d_loc) slice (`TileCache.slice_gather` /
    `data.cache.compact_slice_rows` with ``positions=True``), and the
    feed ships (M, *wshape, rows, w) idx/val/pos stacks, each lane
    only its slice's entries; the step reassembles exact rows on the
    device (`reassemble_rows`).  The width `w` is fixed at construction
    (one scan over the nonzeros, or ``width=``), so every chunk has one
    shape.

    On a process mesh a rank asks only for its own lane: ``lane`` m
    ships lane m's compaction alone, (1, *wshape, rows, w), and the step
    gathers the other lanes' over 'model' before it reassembles; for
    dense tensor parallelism ``rows`` (lo, hi) gathers and copies only
    the rank's feature rows, (*wshape, hi - lo, rows).

    ``verify=True`` crc-checks the touched tiles of a cache per fetch
    (as `TileFeed`); `rebind(cache)` swaps in a rebuilt `TileCache`
    after a quarantine, so `ResilientChunkFeed` keeps the mesh layout
    and the width.  ``bytes_h2d``, ``fetch_s`` and ``fetches`` count the
    bytes copied and the host seconds of every fetch.
    """

    def __init__(self, source, *, model_lanes: Optional[int] = None,
                 d_loc: Optional[int] = None, verify: bool = False,
                 width: Optional[int] = None, nnz_multiple: int = 8,
                 lane: Optional[int] = None, rows=None, device="cuda"):
        from repro_torch.data.cache import PinnedStaging
        if hasattr(source, "meta"):                  # TileCache
            self.cache, self.host = source, None
            m = source.meta
            self.n, self.d, self.bucket = m.n, m.d, m.bucket
            self.sparse = m.kind == "sparse"
            self.nnz = m.nnz if self.sparse else 0
        else:                                        # ArrayFeed
            self.cache, self.host = None, source
            self.n, self.d = int(source.n), int(source.d)
            self.bucket, self.sparse = source.bucket, source.sparse
            self.nnz = int(source.idx.shape[-1]) if self.sparse else 0
        self.verify = bool(verify)
        self.nnz_multiple = int(nnz_multiple)
        self.sliced = model_lanes is not None and self.sparse
        self.model_lanes = model_lanes
        self.d_loc = d_loc
        if self.sliced and d_loc is None:
            raise ValueError("slice-compacted feed needs d_loc")
        self.width = ((int(width) if width else self._scan_width())
                      if self.sliced else None)
        self.lanes = (tuple(range(model_lanes)) if lane is None
                      else (int(lane),)) if self.sliced else None
        self.rows = (None if rows is None or self.sparse
                     else (int(rows[0]), int(rows[1])))
        self.staging = PinnedStaging(device)
        self.device = self.staging.device
        self.reset_stats()

    @property
    def _src(self):
        return self.cache if self.cache is not None else self.host

    def rebind(self, cache) -> None:
        """Swap in a rebuilt TileCache (recovery after a quarantine)."""
        if self.cache is None:
            raise ValueError("rebind() only applies to cache-backed feeds")
        self.cache = cache

    def reset_stats(self) -> None:
        self.bytes_h2d, self.fetch_s, self.fetches = 0, 0.0, 0

    def _scan_width(self) -> int:
        """The compaction width: the most in-slice entries of any row of
        the WHOLE dataset, ceiled to `nnz_multiple` (at most nnz), so
        every chunk's compacted arrays share one shape."""
        best = 1
        if self.cache is not None:
            idx_f = self.cache._flat("idx")
            val_f = self.cache._flat("val")
            nnz = idx_f.shape[-1]
            per_tile = int(np.prod(idx_f.shape[1:]))
            step = max(1, (1 << 22) // max(per_tile, 1))
            for s in range(0, idx_f.shape[0], step):
                idx = np.asarray(idx_f[s:s + step]).reshape(-1, nnz)
                val = np.asarray(val_f[s:s + step]).reshape(-1, nnz)
                best = max(best, self._max_count(idx, val))
        else:
            best = self._max_count(self.host.idx, self.host.val)
        mult = self.nnz_multiple
        return min(-(-best // mult) * mult, max(self.nnz, 1))

    def _max_count(self, idx: np.ndarray, val: np.ndarray) -> int:
        # the keep-mask of compact_slice_rows(positions=True): real
        # entries and explicit (idx != 0, val == 0) zeros; (0, 0)
        # padding is rebuilt by the reassembly's zero base
        keep = (val != 0) | (idx != 0)
        lane = idx // self.d_loc
        best = 0
        for m in range(self.model_lanes):
            c = ((lane == m) & keep).sum(axis=-1)
            best = max(best, int(c.max(initial=0)))
        return best

    def _fill_sliced(self, bids: np.ndarray, bufs) -> None:
        from repro_torch.data.cache import compact_slice_rows
        rows, y = self._src.gather_buckets(bids)
        dl = self.d_loc
        kw = dict(nnz_multiple=self.nnz_multiple, positions=True,
                  width=self.width)

        def lane(h):
            m = self.lanes[h]
            if self.cache is not None:
                # the per-lane compaction IS slice_gather (gathered=
                # skips re-reading the tiles for every lane)
                (gi, gv, gp), _ = self.cache.slice_gather(
                    bids, m * dl, (m + 1) * dl, gathered=(rows, y), **kw)
            else:
                gi, gv, gp = compact_slice_rows(*rows, m * dl, (m + 1) * dl,
                                                **kw)
            bufs["idx"][h], bufs["val"][h], bufs["pos"][h] = gi, gv, gp

        # one thread a lane: numpy's sorts and gathers release the GIL,
        # and each lane writes only its own rows of the buffers
        with ThreadPoolExecutor(max_workers=len(self.lanes)) as ex:
            list(ex.map(lane, range(len(self.lanes))))
        bufs["y"][...] = y

    def fetch(self, bids: np.ndarray):
        t0 = time.perf_counter()
        bids = np.asarray(bids)
        lead, nb = bids.shape[:-1], bids.shape[-1]
        if self.verify and self.cache is not None:
            self.cache.verify_tiles(bids)
        if self.sliced:
            rows = lead + (nb * self.bucket,)
            lanes = (len(self.lanes),) + rows + (self.width,)
            specs = {"idx": (lanes, np.int32), "val": (lanes, np.float32),
                     "pos": (lanes, np.int32), "y": (rows, np.float32)}
            t = self.staging.put(specs,
                                 lambda bufs: self._fill_sliced(bids, bufs))
            data = (t["idx"], t["val"], t["pos"])
        else:
            kw = {} if self.rows is None else {"rows": self.rows}
            t = self.staging.put(
                self._src.chunk_specs(lead, nb, **kw),
                lambda bufs: self._src.gather_buckets(bids, out=bufs, **kw))
            data = (t["idx"], t["val"]) if self.sparse else t["X"]
        self.bytes_h2d += sum(x.numel() * x.element_size()
                              for x in t.values())
        self.fetch_s += time.perf_counter() - t0
        self.fetches += 1
        return data, t["y"]

    def host_fetch(self, bids: np.ndarray):
        """The raw host rows ``(data, y)`` of the given buckets: never
        compacted, never copied to the device.  The streamed gap pass
        reads these, since a sliced `fetch` gives per-lane compactions
        that the margins cannot take."""
        return self._src.gather_buckets(np.asarray(bids).reshape(-1))


def reassemble_rows(idx_c: Tensor, val_c: Tensor, pos: Tensor, nnz: int
                    ) -> tuple[Tensor, Tensor]:
    """Slice-compacted (M, *lead, rows, w) idx/val/pos -> the exact
    (*lead, rows, nnz) padded-CSR rows they came from.

    Kept entries scatter to their original (row, position); every
    entry the compaction dropped is (idx=0, val=0) padding, which the
    zero base reproduces, so the rows are bitwise the originals
    (explicit zero values included).  Pad slots carry pos = nnz: they
    land in one spare column, cropped afterwards (the reference's
    scatter drops them; they hold zeros, so the spare column's value
    does not depend on the order of those writes)."""
    lead = tuple(idx_c.shape[1:-1])

    def lanes_last(t):                     # -> (*lead, rows, M * w)
        return torch.movedim(t, 0, -2).flatten(-2)

    p = lanes_last(pos).long()
    idx = torch.zeros(lead + (nnz + 1,), dtype=torch.int32,
                      device=idx_c.device).scatter_(-1, p, lanes_last(idx_c))
    val = torch.zeros(lead + (nnz + 1,), dtype=torch.float32,
                      device=val_c.device).scatter_(-1, p, lanes_last(val_c))
    return idx[..., :nnz].contiguous(), val[..., :nnz].contiguous()


def make_mesh_streamed_step(coll, solver: LocalSolver, algo: AlgoConfig, *,
                            nnz: Optional[int] = None,
                            dv_scale: float = 1.0, gather_lanes=None):
    """The mesh twin of `make_streamed_step`: the same (data, yc, cols,
    alpha, v) -> (alpha, v) step on a mesh's collectives, alpha the
    global (n,) vector.  With ``nnz`` the chunk is slice-compacted
    (`MeshChunkFeed` with model lanes), and its rows are reassembled
    (`reassemble_rows`) before the solver sees them, so it gets the
    bytes the resident mesh hands it.  ``gather_lanes`` (a process
    mesh's `MeshCollectives.gather_model`) first collects every model
    lane's compaction of the chunk from the ranks that hold them: idx,
    val (as its bits) and pos in one int32 tensor, one all-gather a
    chunk."""
    step = make_streamed_step(coll, solver, algo, dv_scale=dv_scale)
    if nnz is None:
        return step

    def sliced_step(data, yc, cols, a, v_c):
        if gather_lanes is not None:
            idx_c, val_c, pos = data                 # (1, *lead, rows, w)
            packed = torch.stack([idx_c[0], val_c[0].view(torch.int32),
                                  pos[0]])
            g = gather_lanes(packed)                 # (M, 3, *lead, rows, w)
            data = (g[:, 0], g[:, 1].view(torch.float32), g[:, 2])
        return step(reassemble_rows(*data, nnz), yc, cols, a, v_c)

    return sliced_step


class MeshStreamDriver:
    """What `run_epoch_streamed` asks of the collectives, for a mesh:
    `pod_replicate` and `pod_reduce` (the stacked or the process mesh's
    own), and `share_alpha` at the epoch's end.

    On a process mesh each rank's step writes alpha only at its own
    columns; `share_alpha` all-gathers every rank's columns (where the
    schedule's `layout(epoch)` put them) so alpha is whole on every
    rank, as the stacked mesh's.  When the model axis carries slices a
    worker's M ranks hold the same columns, with the same bits: the
    columns are taken from each worker's model lane 0.  On a stacked
    mesh it returns alpha as it is.
    """

    def __init__(self, coll, schedule: MeshSchedule, bucket: int):
        self.coll, self.schedule, self.bucket = coll, schedule, int(bucket)

    def pod_replicate(self, v: Tensor) -> Tensor:
        return self.coll.pod_replicate(v)

    def pod_reduce(self, v_pods: Tensor, v_in: Tensor) -> Tensor:
        return self.coll.pod_reduce(v_pods, v_in)

    def share_alpha(self, alpha: Tensor, epoch: int) -> Tensor:
        if not isinstance(self.coll, MeshCollectives):
            return alpha
        lay = self.schedule.layout(int(epoch)).astype(np.int64)
        B = self.bucket
        lanes = lay.shape[1]
        # (workers, n_local) columns, a worker's row pod * lanes + lane
        cols = (lay[..., None] * B + np.arange(B)).reshape(lay.shape[0]
                                                           * lanes, -1)
        cols = torch.from_numpy(cols).to(alpha.device)
        mesh = self.coll.mesh
        own = mesh.coords[0] * lanes + self.coll.lane
        parts = self.coll.gather(alpha[cols[own]], None)
        D, M = mesh.data, mesh.model
        workers, keep = [], []
        for r in range(mesh.size):
            p, d, m = r // (D * M), r // M % D, r % M
            if self.coll.model_role == "examples":
                workers.append(p * lanes + d * M + m)
                keep.append(parts[r])
            elif m == 0:
                workers.append(p * lanes + d)
                keep.append(parts[r])
        alpha[cols[workers].reshape(-1)] = torch.cat(keep)
        return alpha
