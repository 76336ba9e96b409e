"""Training results.  The legacy trainer shims of the reference package
are not ported; `repro_torch.api.Session` is the front door."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FitResult:
    epochs: int
    converged: bool
    diverged: bool
    v: np.ndarray
    alpha: np.ndarray
    history: list[dict[str, float]]
    wall_time: float

    @property
    def final_gap(self) -> float:
        return self.history[-1]["gap"] if self.history else float("nan")
