"""The (pod, data, model) mesh, stacked on one device.

The reference lays its epoch program over a device mesh whose axes map
the paper's hierarchy:

    pod   — static example partition (the slowest link)
    data  — dynamic example partition within a pod
    model — feature sharding

`make_host_mesh` here describes such a mesh with every shard stacked on
ONE device, as the reference's tests do when they force host devices:
the collectives become ordered tensor operations
(`core.engine.StackedMeshCollectives`), and `launch.glm` runs the dense
and sparse epoch programs on it in every role of the model axis.
Meshes over several GPUs (NCCL, ROADMAP A11) are not ported yet.
`H2D_BW` and `HBM_BW` are the card's host-link and memory rates, defined
once in `core.planner` (its streamed-plan score) and re-exported here.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.planner import H2D_BW, HBM_BW  # noqa: F401
from repro_torch.device import resolve_device

AXES = ("pod", "data", "model")


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
    for name, size in (("pod", pod), ("data", data), ("model", model)):
        if int(size) < 1:
            raise ValueError(f"mesh axis {name}={size} must be >= 1")
    return StackedMesh(int(pod), int(data), int(model),
                       resolve_device(device))
