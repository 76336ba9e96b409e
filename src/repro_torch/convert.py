"""Carry the reference package's state into the port.

Takes plain numpy arrays and dicts only — reading the reference's
objects (`Session.state_dict()`, `dataclasses.asdict(EngineConfig)`,
an LM's parameter tree through `jax.tree.map(np.asarray, params)`) is
the caller's job — so the port never imports the reference.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.config import EngineConfig

__all__ = ["session_state", "engine_config", "lm_params_from_reference",
           "SOLVER_NAMES", "REFERENCE_SOLVER_NAMES"]

#: reference local-solver names -> the port's
SOLVER_NAMES = {"xla": "torch", "pallas": "kernel", "auto": "auto"}
#: the port's local-solver names -> the reference's (what a checkpoint
#: the port writes holds, so the reference can read it)
REFERENCE_SOLVER_NAMES = {v: k for k, v in SOLVER_NAMES.items()}


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


def _tensor(a, device) -> torch.Tensor:
    """numpy -> tensor of the same dtype; bfloat16 (ml_dtypes) arrays go
    through their 16-bit pattern, which numpy alone cannot name."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def lm_params_from_reference(params_np: Mapping[str, Any], cfg,
                             device="cpu") -> dict:
    """The reference's LM parameter tree (numpy leaves) as the port's.

    The reference stacks the repeated superblocks: every leaf of
    `params_np["blocks"]` has a leading n_rep axis.  The port keeps one
    dict per superblock, so those leaves are unstacked.  The other
    leaves (an encoder's `enc_blocks`, a list in both packages, and
    `enc_norm`, `enc_pos`, `pos_embed`, a LayerNorm's `b`, the xLSTM
    cores' f32 gate weights) are carried as they are.  Dtypes are kept
    as given; every leaf's shape is checked against the port's
    `lm.param_specs(cfg)`."""
    from repro_torch.models import lm
    from repro_torch.models.layers import tree_map

    dev = torch.device(device)
    specs = lm.param_specs(cfg)
    n_rep = len(specs["blocks"])
    tree = dict(params_np)
    stacked = tree.pop("blocks", {})
    tree["blocks"] = [tree_map(lambda a, r=r: np.asarray(a)[r], stacked)
                      for r in range(n_rep)]
    if set(tree) != set(specs):
        raise ValueError(f"parameter tree keys {sorted(tree)} != the "
                         f"port's {sorted(specs)} for {cfg.name}")

    def conv(spec, a):
        t = _tensor(a, dev)
        if tuple(t.shape) != spec.shape:
            raise ValueError(f"{cfg.name}: leaf of shape {tuple(t.shape)} "
                             f"where the port expects {spec.shape}")
        return t

    return tree_map(conv, specs, tree)      # in the port's key order
