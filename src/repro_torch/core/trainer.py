"""Training results, and the legacy GLM training drivers as deprecation
shims over `repro_torch.api.Session`.

The drivers (`GLMTrainer` for resident arrays, `StreamedGLMTrainer` for
out-of-core caches, `fit_dataset` for registry names) are thin facades
over ONE owner of solver state, the port's `Session`.  Each keeps the
reference's constructor/`fit` signature and attributes (`alpha`, `v`,
`epoch`, `plan`, `bplan`, `gap()`, `primal()`, `state_dict()`), takes
the run's ``device`` like every entry point of the port, and emits a
`ReproDeprecationWarning` pointing at the replacement:

    Session((X, y), ...)          instead of  GLMTrainer(X, y, ...)
    Session(cache, streamed=True) instead of  StreamedGLMTrainer(cache)
    Session("higgs").fit(...)     instead of  fit_dataset("higgs")
    api.LogisticRegression(...)   for the sklearn-shaped front door
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from .cocoa import SolverConfig
from .config import EngineConfig
from .objectives import Objective


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


class _TrainerBase:
    """Shared shim plumbing: every attribute the legacy trainers exposed
    resolves against the wrapped `Session`."""

    _session: Any

    # legacy state fields, proxied so reads AND writes hit the session
    @property
    def alpha(self):
        return self._session.alpha

    @alpha.setter
    def alpha(self, value):
        self._session.alpha = value

    @property
    def v(self):
        return self._session.v

    @v.setter
    def v(self, value):
        self._session.v = value

    @property
    def epoch(self) -> int:
        return self._session.epochs_done

    @epoch.setter
    def epoch(self, value: int):
        self._session.epochs_done = int(value)

    def __getattr__(self, name):
        # anything else (obj, lam, plan, bplan, spec, X, y, idx, val, n,
        # d, sparse, ...) lives on the session; __getattr__ only fires
        # when normal lookup misses
        if name == "_session":
            raise AttributeError(name)
        return getattr(self._session, name)

    def fit(self, max_epochs: int = 100, tol: float = 1e-3,
            gap_every: int = 0, verbose: bool = False,
            diverge_above: float = 1e8) -> FitResult:
        return self._session.fit(
            max_epochs=max_epochs, tol=tol, gap_every=gap_every,
            verbose=verbose, diverge_above=diverge_above)

    def gap(self) -> float:
        return self._session.gap()

    def primal(self) -> float:
        return self._session.primal()

    def state_dict(self) -> dict[str, Any]:
        return self._session.state_dict()

    def load_state_dict(self, st: dict[str, Any]) -> None:
        self._session.load_state_dict(st)


class GLMTrainer(_TrainerBase):
    """Deprecated: use `repro_torch.api.Session((X, y), ...)` (or an
    estimator).  dense: X (d, n); sparse: (idx, val) padded CSR plus d."""

    def __init__(self, X, y, *, objective: str | Objective = "logistic",
                 lam: float = 1e-3,
                 cfg: SolverConfig | EngineConfig = SolverConfig(),
                 sparse: bool = False, d: Optional[int] = None,
                 bucket_force: Optional[int] = None, device="cuda"):
        from repro_torch.api import Session, warn_deprecated
        warn_deprecated("repro_torch.core.GLMTrainer",
                        "repro_torch.api.Session (or a repro_torch.api "
                        "estimator)")
        data = tuple(X) if sparse else X
        self._session = Session(data, y, objective=objective, lam=lam,
                                cfg=cfg, d=d, bucket=bucket_force,
                                pad=False, device=device)


class StreamedGLMTrainer(_TrainerBase):
    """Deprecated: use `repro_torch.api.Session(cache, streamed=True)`.
    Trains out of core over a `TileCache`; ``journal_dir`` and ``health``
    go to the `Session` (crash-safe epochs, the health guard)."""

    def __init__(self, cache, *, objective: str | Objective | None = None,
                 lam: float = 1e-3,
                 cfg: SolverConfig | EngineConfig = SolverConfig(),
                 jit_step: bool = True, journal_dir=None, health=None,
                 device="cuda"):
        from repro_torch.api import Session, warn_deprecated
        warn_deprecated("repro_torch.core.StreamedGLMTrainer",
                        "repro_torch.api.Session(cache, streamed=True)")
        # jit_step has no meaning in the port (nothing is traced)
        self._session = Session(cache, objective=objective, lam=lam,
                                cfg=cfg, streamed=True,
                                journal_dir=journal_dir, health=health,
                                device=device)


def fit_dataset(name: str, *,
                cfg: SolverConfig | EngineConfig | None = None,
                objective: Optional[str] = None,
                lam: Optional[float] = None,
                n: Optional[int] = None, d: Optional[int] = None,
                streamed: bool = False, cache_dir=None, data_dir=None,
                bucket: Optional[int] = None,
                nnz_multiple: Optional[int] = None,
                max_epochs: int = 100, tol: float = 1e-3,
                gap_every: int = 0, verbose: bool = False,
                return_trainer: bool = False, device="cuda"):
    """Deprecated: use `repro_torch.api.Session(name, ...).fit(...)`.

    Train on a registry dataset end to end: name -> (tile cache) -> fit.
    ``nnz_multiple`` shapes the tile cache of a streamed or cached run
    and, as in the reference, the resident path ignores it.  With
    ``return_trainer=True`` the second element is the underlying
    `Session`.
    """
    from repro_torch.api import Session, warn_deprecated
    warn_deprecated("repro_torch.core.fit_dataset",
                    "repro_torch.api.Session(name, ...).fit(...)")
    session = Session(name, objective=objective, lam=lam, cfg=cfg,
                      n=n, d=d, streamed=streamed, cache_dir=cache_dir,
                      data_dir=data_dir, bucket=bucket,
                      nnz_multiple=nnz_multiple, device=device)
    res = session.fit(max_epochs=max_epochs, tol=tol,
                      gap_every=gap_every, verbose=verbose)
    return (res, session) if return_trainer else res
