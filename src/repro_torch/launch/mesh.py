"""The (pod, data, model) mesh: stacked on one device, or one process a
worker over `torch.distributed`.

The reference lays its epoch program over a device mesh whose axes map
the paper's hierarchy:

    pod   — static example partition (the slowest link)
    data  — dynamic example partition within a pod
    model — feature sharding (or more example lanes)

Two meshes carry it here:

  * `StackedMesh` (`make_host_mesh`): every shard stacked on ONE
    device, as the reference's tests force host devices; the
    collectives are ordered tensor operations
    (`core.engine.StackedMeshCollectives`), and `launch.glm` runs the
    dense and sparse epoch programs on it in every role of the model
    axis.
  * `DistMesh` (`make_dist_mesh`): every worker a process of a
    `torch.distributed` process group, ranks laid out row-major over
    (pod, data, model) as `jax.make_mesh` lays out devices; the
    collectives are `core.engine.MeshCollectives` over the mesh's
    per-axis groups, in every role of the model axis: more example
    lanes, or one model lane a rank of a feature-sharded worker (dense
    tensor parallelism, sparse slices), the lanes trading each
    bucket's partials or working sets over 'model'.

`H2D_BW` and `HBM_BW` are the card's host-link and memory rates, defined
once in `core.planner` (its streamed-plan score) and re-exported here
beside its peak arithmetic rates and its link rate (`PEAK_FLOPS`,
`PEAK_FLOPS_F32`, `LINK_BW`), which the dry run's roofline divides by.
`abstract_mesh` is a mesh's shape alone, with no device and no process
behind it: the dry run's spec transforms and input specs partition
over it.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.planner import H2D_BW, HBM_BW  # noqa: F401
from repro_torch.device import resolve_device

AXES = ("pod", "data", "model")

#: Dense bf16 tensor-core peak of the H100 SXM (NVIDIA's data sheet, at
#: its 700 W limit; the rate PERF.md's kernel bounds use), FLOP/s.
PEAK_FLOPS = 989e12
#: f32 peak of the same card (CUDA cores, no tensor cores), FLOP/s:
#: every GLM kernel computes in f32, so a GLM record is bounded by it.
PEAK_FLOPS_F32 = 67e12
#: NVLink 4 of the H100 SXM, one direction, bytes/s (the data sheet's
#: 900 GB/s is both directions summed).
LINK_BW = 450e9


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axes and sizes, and nothing else: no device, no process
    group.  `shape` maps each axis name to its size, in `axis_names`'
    order."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def abstract_mesh(shape, axis_names) -> AbstractMesh:
    """An `AbstractMesh` of these sizes over these axis names (the
    reference's constructor's argument order)."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"{len(shape)} sizes for {len(axis_names)} axes")
    for name, size in zip(axis_names, shape):
        if size < 1:
            raise ValueError(f"mesh axis {name}={size} must be >= 1")
    return AbstractMesh(axis_names, shape)


@dataclasses.dataclass(frozen=True)
class StackedMesh:
    """A (pod, data, model) mesh whose shards all live on `device`."""
    pod: int = 1
    data: int = 1
    model: int = 1
    device: torch.device = torch.device("cuda")

    axis_names = AXES

    @property
    def shape(self) -> dict[str, int]:
        return {"pod": self.pod, "data": self.data, "model": self.model}


def make_host_mesh(*, pod: int = 1, data: int = 1, model: int = 1,
                   device="cuda") -> StackedMesh:
    """A (pod, data, model) mesh stacked on one device (the card unless
    the caller asks for the CPU; a missing GPU raises)."""
    _check_sizes(pod, data, model)
    return StackedMesh(int(pod), int(data), int(model),
                       resolve_device(device))


def _check_sizes(pod, data, model) -> None:
    for name, size in (("pod", pod), ("data", data), ("model", model)):
        if int(size) < 1:
            raise ValueError(f"mesh axis {name}={size} must be >= 1")


def rank_coords(rank: int, shape: dict[str, int]) -> tuple[int, int, int]:
    """(pod, data, model) of a rank, laid out row-major (model fastest),
    the order `jax.make_mesh` gives devices."""
    D, M = shape["data"], shape["model"]
    return rank // (D * M), rank // M % D, rank % M


@dataclasses.dataclass(frozen=True, eq=False)
class DistMesh:
    """A (pod, data, model) mesh whose workers are the processes of a
    `torch.distributed` process group, one worker each.

    ``rank`` is this process's rank in the world group; its coordinates
    are `rank_coords` (row-major).  ``groups`` maps each axis of size > 1
    to this rank's group along it (the ranks that share its other two
    coordinates, in axis order), and, when all three axes are larger
    than 1, each pair of axes to the group of the ranks that share the
    third coordinate.  ``backend`` is the process group's;
    under "gloo" on a CUDA device the collectives stage through host
    memory (``stages``).
    """
    pod: int
    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    groups: dict

    axis_names = AXES

    @property
    def shape(self) -> dict[str, int]:
        return {"pod": self.pod, "data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.pod * self.data * self.model

    @property
    def coords(self) -> tuple[int, int, int]:
        return rank_coords(self.rank, self.shape)

    @property
    def stages(self) -> bool:
        """Whether collectives copy through host memory (gloo on CUDA)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def live_axes(self, axes) -> tuple:
        """`axes` (None: every axis; a name or a tuple of names) as the
        tuple of those of size > 1, in mesh order."""
        if axes is None:
            axes = AXES
        elif isinstance(axes, str):
            axes = (axes,)
        unknown = set(axes) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}")
        return tuple(a for a in AXES if a in axes and self.shape[a] > 1)

    def group(self, axis):
        """This rank's group along `axis`: an axis name, a tuple of
        names (their joint group, its ranks in mesh order, so the first
        name is the major) or None (the world).  Axes of size 1 add
        nothing; a group of one rank is an error."""
        if axis is None:
            return None
        if isinstance(axis, str):
            return self.groups[axis]
        live = self.live_axes(axis)
        if not live:
            raise ValueError(f"axes {axis!r} hold one rank: no group")
        if len(live) == 1:
            return self.groups[live[0]]
        return None if live == self.live_axes(None) else self.groups[live]

    def group_size(self, axis) -> int:
        if axis is None:
            return self.size
        return math.prod(self.shape[a] for a in self.live_axes(axis))

    def group_index(self, axis) -> int:
        """This rank's index in its group along `axis` (mesh order: the
        last axis fastest)."""
        c = dict(zip(AXES, self.coords))
        idx = 0
        for a in self.live_axes(axis):
            idx = idx * self.shape[a] + c[a]
        return idx


def _env_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ValueError(f"pass {name.lower()}= or set ${name}")
    return int(os.environ[name])


def make_dist_mesh(*, pod: int = 1, data: int = 1, model: int = 1,
                   backend: Optional[str] = None, device="cuda",
                   init_method: Optional[str] = None,
                   rank: Optional[int] = None,
                   world_size: Optional[int] = None,
                   timeout: Optional[float] = None) -> DistMesh:
    """This process's worker of a (pod, data, model) process mesh.

    ``rank``/``world_size`` default to ``$RANK``/``$WORLD_SIZE``; the
    world must hold pod * data * model ranks.  ``device="cuda"`` is
    ``cuda:{$LOCAL_RANK % device_count}`` (``$LOCAL_RANK`` defaults to
    the rank) and raises without a GPU; only ``device="cpu"`` runs on
    the CPU.  TF32 is turned off on the rank's device.  ``backend`` is
    "nccl" by default on CUDA and "gloo" on the CPU; gloo on CUDA runs
    only when the caller names it (several ranks on one card, which
    NCCL refuses).  The default process group is initialized here
    (``init_method``, default ``env://``; ``timeout`` seconds bound it
    and every collective) unless it already is, with this backend and
    world size.  Every rank creates every axis group, in one order, as
    `dist.new_group` requires.
    """
    _check_sizes(pod, data, model)
    pod, data, model = int(pod), int(data), int(model)
    rank = _env_int("RANK", rank)
    world_size = _env_int("WORLD_SIZE", world_size)
    if pod * data * model != world_size:
        raise ValueError(f"a ({pod}, {data}, {model}) mesh needs "
                         f"{pod * data * model} ranks; the world has "
                         f"{world_size}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if not dist.is_initialized():
        kw = {}
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size, **kw)
    elif (dist.get_backend() != backend or dist.get_world_size() != world_size
          or dist.get_rank() != rank):
        raise ValueError(
            f"the process group is already {dist.get_backend()} rank "
            f"{dist.get_rank()} of {dist.get_world_size()}; this mesh asks "
            f"for {backend} rank {rank} of {world_size}")
    shape = {"pod": pod, "data": data, "model": model}
    groups = {}
    for axis in AXES:
        if shape[axis] <= 1:
            continue
        for r in range(world_size):        # every group, in rank order
            if rank_coords(r, shape)[AXES.index(axis)] != 0:
                continue
            step = math.prod(shape[a] for a in AXES[AXES.index(axis) + 1:])
            members = [r + i * step for i in range(shape[axis])]
            g = dist.new_group(members)
            if rank in members:
                groups[axis] = g
    if all(shape[a] > 1 for a in AXES):
        # the pairs' joint groups (with one axis of size 1 a pair is the
        # world): the ranks that share the third coordinate
        for pair in ((a, b) for i, a in enumerate(AXES) for b in AXES[i + 1:]):
            third = AXES.index(next(a for a in AXES if a not in pair))
            for c in range(shape[AXES[third]]):
                members = [r for r in range(world_size)
                           if rank_coords(r, shape)[third] == c]
                g = dist.new_group(members)
                if rank in members:
                    groups[pair] = g
    return DistMesh(pod, data, model, rank, dev, backend, groups)


def make_production_mesh(*, multi_pod: bool = False, **kw) -> DistMesh:
    """The reference's production mesh as a process mesh: (16, 16) over
    (data, model), or (2, 16, 16) with a pod axis; the world must hold
    256 or 512 ranks (``kw`` goes to `make_dist_mesh`)."""
    pod, data, model = (2, 16, 16) if multi_pod else (1, 16, 16)
    n = pod * data * model
    world = (dist.get_world_size() if dist.is_initialized()
             else kw.get("world_size", os.environ.get("WORLD_SIZE")))
    if world is None or int(world) < n:
        raise RuntimeError(
            f"need {n} ranks for {(pod, data, model)}, have "
            f"{world if world is not None else 'no process group'}")
    return make_dist_mesh(pod=pod, data=data, model=model, **kw)


def mesh_chips(mesh) -> int:
    """Shards of a mesh: a process mesh's ranks, a stacked mesh's
    stacked shards."""
    return math.prod(mesh.shape.values())
