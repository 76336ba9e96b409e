"""Differentiable collectives over a `launch.mesh.DistMesh`'s axes: the
LM's train and serve steps on a process mesh.

Each op runs over `axes`, an axis name or a tuple of names (their joint
group, the first name the major).  On a gloo mesh (its ranks on one
machine: several may share one card) the payload is staged through
host memory explicitly: each rank copies its part into a buffer that
the group's ranks map together (`HostStage`, a file in the temporary
directory, unlinked as soon as every member has mapped it), a gloo
barrier, then each rank copies what it needs back to its device.
gloo itself carries only the barriers: with 4 ranks at work on the
H100's host its loopback takes 0.67 s for a pair's all-gather of 256
MiB, where copies into and out of the shared buffer take 0.043 and
0.052 s (`tools/stage_probe.py`, `PERF.md`).  On an NCCL mesh the ops
are `core.engine.MeshCollectives`' `all_gather` and
`all_to_all_single` on the device.  No op uses `all_reduce`: every sum
is an all-gather (or, for a reduce-scatter, the members' chunks) added
in group-rank order, a bf16 tensor's in f32 and rounded once, so two
runs of a mesh are `torch.equal` and the ranks of a group hold the same
bits.

The autograd Functions follow the tensor-parallel convention: an
activation replicated over 'model' carries its full gradient on every
model rank.

  * `gather_weight`   all-gather forward, ordered reduce-scatter
                      backward: a weight sharded over FSDP / ZeRO-3 axes
                      (or a kv projection split inside a head over
                      'model'), whose gradient on each rank is a partial
  * `gather_act`      all-gather forward, this rank's chunk backward: an
                      activation split over 'model' made whole again
  * `slice_act`       this rank's chunk forward, all-gather backward
  * `sum_out`         ordered sum forward, identity backward: a
                      row-parallel output
  * `copy_in`         identity forward, ordered sum backward: a
                      column-parallel input
  * `all_to_all`      an all-to-all of equal chunks forward, the reverse
                      all-to-all backward: the MoE's dispatch of tokens
                      to their experts' owners and its combine

`STATS` counts each kind's calls, bytes sent (this rank's payload),
seconds on the host's clock (the staged copies synchronize the device)
and the distinct payload shapes; `reset_stats` zeroes it.
"""
from __future__ import annotations

import mmap
import os
import secrets
import tempfile
import time

import torch

#: kind -> {"calls", "bytes", "seconds", "shapes"}, this process's
#: collectives (the distinct shapes of its payloads, as lists)
STATS: dict = {}

_COLL: dict = {}
_STAGES: dict = {}


def reset_stats() -> None:
    STATS.clear()


class HostStage:
    """The host buffer one group of a gloo mesh stages its payloads in.

    Member 0 creates a file of the buffer's size in the temporary
    directory (`tempfile.gettempdir()`);
    after a barrier every member maps it, and after another member 0
    unlinks it (the mapping outlives the name, so a crash leaves no
    file behind).  The mapping is not page-locked: the H100's driver
    refuses `cudaHostRegister` on a file in the machine's temporary
    directory, and a refused call fails the next kernel launch; pageable
    copies into and out of it run at 6.2 and 5.1 GB/s there with 4
    ranks at work (`tools/stage_probe.py`).  The buffer
    grows (to twice its size at least) when a payload does not fit;
    every member sees the same payloads, so they grow it together (the
    MoE's all-to-all to the group's size times a rank's dispatch
    payload)."""

    def __init__(self, mesh, axes):
        self.mesh, self.axes = mesh, axes
        self.L, self.i = mesh.group_size(axes), mesh.group_index(axes)
        self.cap = self.gen = 0
        self.buf = self._mm = None
        tok = torch.tensor([secrets.randbits(62) if self.i == 0 else 0])
        self.token = int(self._gather(tok)[0])

    def _gather(self, t):
        return _coll(self.mesh).gather(t, self.axes)

    def barrier(self) -> None:
        self._gather(torch.zeros(1))

    def close(self) -> None:
        self.buf = None
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        self.cap = 0

    def ensure(self, nbytes: int) -> None:
        if nbytes <= self.cap:
            return
        cap = -(-max(nbytes, 2 * self.cap) // (1 << 20)) << 20
        self.close()
        path = os.path.join(tempfile.gettempdir(),
                            f"repro-stage-{self.token:x}-{self.gen}")
        self.gen += 1
        if self.i == 0:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            os.ftruncate(fd, cap)
            os.close(fd)
        self.barrier()
        fd = os.open(path, os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, cap)
        finally:
            os.close(fd)
        # a buffer first grown under serving's inference mode is written
        # outside it afterwards: it must not be an inference tensor
        with torch.inference_mode(False):
            self.buf = torch.frombuffer(self._mm, dtype=torch.uint8)
        self.barrier()
        if self.i == 0:
            os.unlink(path)
        self.cap = cap

    def _put(self, x: torch.Tensor) -> int:
        """x's bytes into this member's slot, every member's in place
        after it; -> the bytes of a slot."""
        nb = x.numel() * x.element_size()
        self.ensure(max(self.L * nb, 1))
        self.barrier()                  # the last use's reads are done
        self.buf[self.i * nb:(self.i + 1) * nb].copy_(
            x.contiguous().reshape(-1).view(torch.uint8))
        self.barrier()                  # every member's slot is written
        return nb

    def gather(self, x: torch.Tensor) -> list:
        """Every member's x, in group-rank order, on x's device."""
        nb = self._put(x)
        whole = self.buf[:self.L * nb]
        whole = whole.to(x.device) if x.is_cuda else whole.clone()
        return [whole[j * nb:(j + 1) * nb].view(x.dtype).view(x.shape)
                for j in range(self.L)]

    def chunks(self, x: torch.Tensor) -> torch.Tensor:
        """x (L * c, ...): every member's chunk i (this member's index),
        stacked in group-rank order, (L, c, ...), on x's device."""
        nb = self._put(x)
        cb = nb // self.L
        out = torch.empty((self.L, cb), dtype=torch.uint8, device=x.device)
        for j in range(self.L):
            lo = j * nb + self.i * cb
            out[j].copy_(self.buf[lo:lo + cb])
        return out.view(x.dtype).view(
            (self.L, x.shape[0] // self.L) + tuple(x.shape[1:]))


def _stage(mesh, axes) -> HostStage:
    live = mesh.live_axes(axes)
    key = (id(mesh), live)
    if key not in _STAGES or _STAGES[key].mesh is not mesh:
        _STAGES[key] = HostStage(mesh, live)
    return _STAGES[key]


def _note(kind: str, x: torch.Tensor, t0: float) -> None:
    rec = STATS.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0,
                                  "shapes": []})
    rec["calls"] += 1
    rec["bytes"] += x.numel() * x.element_size()
    rec["seconds"] += time.perf_counter() - t0
    if list(x.shape) not in rec["shapes"]:
        rec["shapes"].append(list(x.shape))


def _coll(mesh):
    """The mesh's `MeshCollectives` (one per mesh)."""
    key = id(mesh)
    if key not in _COLL or _COLL[key][0] is not mesh:
        from repro_torch.core.engine import MeshCollectives
        _COLL[key] = (mesh, MeshCollectives(mesh=mesh, deterministic=True))
    return _COLL[key][1]


def _acc(t: torch.Tensor) -> torch.dtype:
    """The dtype a sum of `t`s accumulates in: f32 for 16-bit floats."""
    return torch.float32 if t.dtype in (torch.bfloat16, torch.float16) \
        else t.dtype


def _ordered(parts) -> torch.Tensor:
    dt = _acc(parts[0])
    out = parts[0].to(dt)
    for p in parts[1:]:
        out = out + p.to(dt)
    return out.to(parts[0].dtype)


def _gather(x: torch.Tensor, mesh, axes) -> list:
    if mesh.backend == "gloo":
        return _stage(mesh, axes).gather(x)
    return _coll(mesh).gather(x, axes)


def all_gather(x: torch.Tensor, mesh, axes, dim: int,
               kind: str = "gather") -> torch.Tensor:
    """The group's `x`s concatenated along `dim` in group-rank order."""
    if mesh.group_size(axes) == 1:
        return x
    t0 = time.perf_counter()
    out = torch.cat(_gather(x, mesh, axes), dim=dim)
    _note(kind, x, t0)
    return out


def gather_list(x: torch.Tensor, mesh, axes, kind: str) -> list:
    """The group's `x`s in group-rank order."""
    if mesh.group_size(axes) == 1:
        return [x]
    t0 = time.perf_counter()
    out = _gather(x, mesh, axes)
    _note(kind, x, t0)
    return out


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int,
                   kind: str = "reduce_scatter") -> torch.Tensor:
    """This rank's chunk along `dim` of the group's `x`s summed in
    group-rank order (an all-to-all of the chunks, then the adds)."""
    L = mesh.group_size(axes)
    if L == 1:
        return x
    if x.shape[dim] % L:
        raise ValueError(f"reduce-scatter of {tuple(x.shape)} along {dim} "
                         f"over {L} ranks")
    t0 = time.perf_counter()
    xm = x.movedim(dim, 0).contiguous()
    if mesh.backend == "gloo":
        got = _stage(mesh, axes).chunks(xm)
    else:
        got = _coll(mesh)._all_to_all(xm, axes)
    out = _ordered(got.reshape((L, -1) + tuple(xm.shape[1:])).unbind(0))
    _note(kind, x, t0)
    return out.movedim(0, dim)


def ordered_sum(x: torch.Tensor, mesh, axes, kind: str = "sum"
                ) -> torch.Tensor:
    """The group's `x`s summed in group-rank order."""
    if mesh.group_size(axes) == 1:
        return x
    return _ordered(gather_list(x, mesh, axes, kind))


def ordered_max(x: torch.Tensor, mesh, axes, kind: str = "max"
                ) -> torch.Tensor:
    """The group's `x`s' elementwise max (order-free)."""
    if mesh.group_size(axes) == 1:
        return x
    return torch.stack(gather_list(x, mesh, axes, kind)).amax(dim=0)


def chunk(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's chunk of `x` along `dim` over `axes` (a contiguous
    copy)."""
    L = mesh.group_size(axes)
    if L == 1:
        return x
    if x.shape[dim] % L:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {axes} ({L} ranks)")
    n = x.shape[dim] // L
    return x.narrow(dim, mesh.group_index(axes) * n, n).contiguous()


def _exchange(x: torch.Tensor, mesh, axes, kind: str) -> torch.Tensor:
    """x (L * c, ...) -> (L * c, ...): chunk j of the result is member
    j's chunk i (i this rank's index in the group)."""
    L = mesh.group_size(axes)
    if L == 1:
        return x
    if x.shape[0] % L:
        raise ValueError(f"all-to-all of {tuple(x.shape)} over {L} ranks")
    t0 = time.perf_counter()
    x = x.contiguous()
    if mesh.backend == "gloo":
        out = _stage(mesh, axes).chunks(x).reshape(x.shape)
    else:
        out = _coll(mesh)._all_to_all(x, axes)
    _note(kind, x, t0)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, kind):
        ctx.mesh, ctx.axes, ctx.kind = mesh, axes, kind
        return _exchange(x, mesh, axes, kind)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g, ctx.mesh, ctx.axes, f"{ctx.kind}_bwd"),
                None, None, None)


class _GatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, kind):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim),
                None, None, None, None)


class _GatherSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, kind):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return chunk(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None, None


class _SliceGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, kind):
        ctx.mesh, ctx.axes, ctx.dim, ctx.kind = mesh, axes, dim, kind
        return chunk(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim,
                           ctx.kind), None, None, None, None)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, kind):
        return ordered_sum(x, mesh, axes, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _CopySum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, kind):
        ctx.mesh, ctx.axes, ctx.kind = mesh, axes, kind
        return x

    @staticmethod
    def backward(ctx, g):
        return ordered_sum(g, ctx.mesh, ctx.axes, ctx.kind), None, None, None


def gather_weight(w, mesh, axes, dim: int, kind: str = "gather"):
    """All-gather forward, ordered reduce-scatter backward."""
    if mesh.group_size(axes) == 1:
        return w
    return _GatherRS.apply(w, mesh, axes, dim, kind)


def gather_act(x, mesh, axes, dim: int, kind: str = "act_gather"):
    """All-gather forward, this rank's chunk backward."""
    if mesh.group_size(axes) == 1:
        return x
    return _GatherSlice.apply(x, mesh, axes, dim, kind)


def slice_act(x, mesh, axes, dim: int, kind: str = "act_gather"):
    """This rank's chunk forward, all-gather backward."""
    if mesh.group_size(axes) == 1:
        return x
    return _SliceGather.apply(x, mesh, axes, dim, kind)


def sum_out(x, mesh, axes, kind: str = "sum"):
    """Ordered sum forward, identity backward."""
    if mesh.group_size(axes) == 1:
        return x
    return _Sum.apply(x, mesh, axes, kind)


def copy_in(x, mesh, axes, kind: str = "sum"):
    """Identity forward, ordered sum backward."""
    if mesh.group_size(axes) == 1:
        return x
    return _CopySum.apply(x, mesh, axes, kind)


def all_to_all(x, mesh, axes, kind: str):
    """x (L * c, ...), L the group's size: chunk j of the result is
    member j's chunk i, i this rank's group index (a transpose of the
    chunks over the group).  Its backward is the same exchange of the
    gradient, the reverse all-to-all (kind + "_bwd").  No arithmetic:
    the bytes arrive as they were sent."""
    if mesh.group_size(axes) == 1:
        return x
    return _AllToAll.apply(x, mesh, axes, kind)
