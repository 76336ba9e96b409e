"""Sharding context: the mesh registry, partition cleaning and the
activation constraint.

The reference's `sharding` package: `set_mesh` / `get_mesh` register
the mesh a program runs on, and `clean_pspec` drops from a partition
the axis names that mesh lacks, so one spec serves a ("data", "model")
mesh and a ("pod", "data", "model") one.  A partition is a tuple, one
entry a dimension: None, an axis name or a tuple of names (the port's
`ParamSpec.pspec`, `launch.glm.InputSpec.partition`).

`constrain(x, *spec)` is the reference's activation constraint.  With
no mesh registered it returns `x` as it is (one card).  With a
`launch.mesh.DistMesh` registered, `x` is this rank's local tensor, and
constrain lays it out as the cleaned spec says, with the explicit
collectives of `sharding.collectives`: a dimension held whole that the
spec splits is cut to this rank's chunk, a dimension held split that
the spec leaves whole is all-gathered, and one already laid out is
left.  On a process mesh the LM's steps register their
`sharding.layout.LMLayout` too (`use_layout`), which `models.lm` reads.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

_MESH = None
_LAYOUT = None


def set_mesh(mesh) -> None:
    """Register `mesh` (anything with `axis_names`; None clears it)."""
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def get_layout():
    """The registered LM layout on a process mesh, else None."""
    return _LAYOUT


@contextlib.contextmanager
def use_layout(layout):
    """Register `layout` (a `sharding.layout.LMLayout`) and its mesh for
    the body; the previous registration comes back after it."""
    global _MESH, _LAYOUT
    before = _MESH, _LAYOUT
    _MESH, _LAYOUT = layout.mesh, layout
    try:
        yield layout
    finally:
        _MESH, _LAYOUT = before


def keep_axes(spec, names) -> tuple:
    """`spec` with every axis name outside `names` dropped (a tuple
    entry left empty becomes None)."""
    names = set(names)

    def keep(e):
        if e is None:
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a in names)
            return kept if kept else None
        return e if e in names else None

    return tuple(keep(e) for e in spec)


def clean_pspec(spec: tuple, mesh: Optional[object] = None) -> tuple:
    """Drop axis names absent from `mesh` (default: the registered one;
    with none registered `spec` comes back as it is)."""
    mesh = _MESH if mesh is None else mesh
    if mesh is None:
        return tuple(spec)
    return keep_axes(spec, mesh.axis_names)


def _axes(e) -> tuple:
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def constrain(x, *spec, held=None, shape=None):
    """`x` laid out as `spec` says on the registered mesh (the
    reference's `with_sharding_constraint`; axis names the mesh lacks
    are dropped).  No mesh: `x` itself.

    On a `DistMesh`, `x` is this rank's local tensor, laid out as `held`
    says (default: dimension 0 split as the spec's entry 0 says, the
    batch, and every other dimension whole).  Per dimension: held whole
    and split by the spec, this rank's chunk is kept (backward: an
    all-gather); held split and whole in the spec, it is all-gathered
    (backward: this rank's chunk); held as the spec says, it is left.
    Any other change, a dimension that does not divide, or (given the
    global `shape`) a local shape that is not `held`'s shard shape
    raises.  Any other mesh raises: a layout is a collective's work."""
    if _MESH is None:
        return x
    from repro_torch.launch.mesh import DistMesh
    from . import collectives as coll
    if not isinstance(_MESH, DistMesh):
        raise TypeError(f"constrain lays tensors out on a DistMesh, not a "
                        f"{type(_MESH).__name__}")
    mesh = _MESH
    spec = clean_pspec(tuple(spec) + (None,) * (x.dim() - len(spec)), mesh)
    if held is None:
        held = (spec[0],) + (None,) * (x.dim() - 1)
    held = clean_pspec(tuple(held) + (None,) * (x.dim() - len(held)), mesh)
    if len(spec) != x.dim() or len(held) != x.dim():
        raise ValueError(f"partition {spec} for a tensor of rank {x.dim()}")
    if shape is not None:
        want = tuple(n // math.prod(mesh.shape[a] for a in _axes(e))
                     for n, e in zip(shape, held))
        if tuple(x.shape) != want:
            raise ValueError(f"local shape {tuple(x.shape)} is not the "
                             f"shard {want} of {tuple(shape)} under {held}")
    for dim, (h, s) in enumerate(zip(held, spec)):
        hl, sl = mesh.live_axes(_axes(h)), mesh.live_axes(_axes(s))
        if hl == sl:
            continue
        if not hl:
            x = coll.slice_act(x, mesh, sl, dim)
        elif not sl:
            x = coll.gather_act(x, mesh, hl, dim)
        else:
            raise ValueError(f"constrain: dimension {dim} held over {hl} "
                             f"cannot move to {sl}")
    return x
