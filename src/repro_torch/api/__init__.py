"""The public training API: estimators + Session.

One front door for every data source the port takes:

    from repro_torch import api
    clf = api.LogisticRegression(lanes=8, bucket=8).fit(X, y)   # on the card
    clf = api.LogisticRegression(device="cpu").fit(X, y)        # plain versions
    s = api.Session("higgs", streamed=True); s.fit(until=20)   # out of core

Everything older (`core.GLMTrainer`, `core.StreamedGLMTrainer`,
`core.fit_dataset`, `core.cocoa.epoch_sim*`) is a deprecation shim over
these (`ReproDeprecationWarning`).  `HealthMonitor` and `HealthPolicy`
(the numerical-health guard of `repro_torch.resilience`) are exported
here, as the reference exports them.
"""
from repro_torch.resilience import HealthMonitor, HealthPolicy

from .callbacks import (BenchmarkRecorder, Callback, CheckpointHook,
                        EarlyStopping, GapLogger)
from .deprecation import ReproDeprecationWarning, warn_deprecated
from .estimators import (GLMEstimator, LinearSVC, LogisticRegression,
                         NotFittedError, Ridge, load)
from .session import Session, margins

__all__ = [
    "BenchmarkRecorder", "Callback", "CheckpointHook", "EarlyStopping",
    "GapLogger", "HealthMonitor", "HealthPolicy",
    "ReproDeprecationWarning", "warn_deprecated",
    "GLMEstimator", "LinearSVC", "LogisticRegression", "NotFittedError",
    "Ridge", "load",
    "Session", "margins",
]
