"""Carry the reference package's state into the port.

Takes plain numpy arrays and dicts only — reading the reference's
objects (`Session.state_dict()`, `dataclasses.asdict(EngineConfig)`)
is the caller's job — so the port never imports the reference.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from repro_torch.core.config import EngineConfig

__all__ = ["session_state", "engine_config", "SOLVER_NAMES"]

#: reference local-solver names -> the port's
SOLVER_NAMES = {"xla": "torch", "pallas": "kernel", "auto": "auto"}


def session_state(st: Mapping[str, Any]) -> dict[str, Any]:
    """A reference `Session.state_dict()` (alpha, v, epoch as numpy) as
    the port's `Session.load_state_dict` input."""
    return {"alpha": np.asarray(st["alpha"], np.float32),
            "v": np.asarray(st["v"], np.float32),
            "epoch": int(st["epoch"])}


def engine_config(fields: Mapping[str, Any]) -> EngineConfig:
    """An `EngineConfig` from the reference's fields, nested
    (``{"algo": {...}, "deployment": {...}}``, as `dataclasses.asdict`
    gives them) or flat; solver names are mapped by `SOLVER_NAMES`."""
    if "algo" in fields or "deployment" in fields:
        flat = {**fields.get("algo", {}), **fields.get("deployment", {})}
    else:
        flat = dict(fields)
    if "local_solver" in flat:
        flat["local_solver"] = SOLVER_NAMES[flat["local_solver"]]
    return EngineConfig.make(**flat)

