"""Sharding context: the mesh registry and partition cleaning.

The reference's `sharding` package: `set_mesh` / `get_mesh` register
the mesh a program runs on, and `clean_pspec` drops from a partition
the axis names that mesh lacks, so one spec serves a ("data", "model")
mesh and a ("pod", "data", "model") one.  A partition is a tuple, one
entry a dimension: None, an axis name or a tuple of names (the port's
`ParamSpec.pspec`, `launch.glm.InputSpec.partition`).

The reference's `constrain` (an activation sharding constraint inside
the model, a no-op without a mesh) has no counterpart yet: it waits for
the runtime half of A16 step 4b, the LM's train and serve steps on a
mesh of cards (ROADMAP).  On one card there is no mesh to constrain to.
"""
from __future__ import annotations

from typing import Optional

_MESH = None


def set_mesh(mesh) -> None:
    """Register `mesh` (anything with `axis_names`; None clears it)."""
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


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
