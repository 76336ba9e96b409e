"""Numerical-health guard: detect bad state, roll back, remediate.

The solver's failure modes at scale are numerical, not only mechanical:
a poisoned chunk puts NaN into alpha/v, an over-aggressive aggregation
diverges, a kernel fails to build or launch.  `HealthMonitor` is a
`Session.fit` callback (plus an ``on_epoch_error`` hook for exceptions
raised by the epoch itself) that keeps a host copy of the last HEALTHY
(alpha, v, epoch) and, when an epoch ends unhealthy:

  1. rolls the session back to that snapshot (and re-commits it over
     any journal state downstream of the poison),
  2. re-runs the epoch: a plain retry first (``retries``), which is
     bitwise exact for transient faults because schedules are pure
     functions of (seed, epoch),
  3. then applies the policy remedy: ``"fallback"`` reroutes the local
     solver to the plain PyTorch version through
     `Session._switch_local_solver("torch")` (action
     ``"fallback:torch"``, the reference's ``"fallback:xla"``) on a CPU
     session only; on any other device the plain version would hide a
     failing kernel, so the action is ``"fallback-refused"`` and the
     trip raises as under ``"raise"``.  ``"damp"`` multiplies the
     update's aggressiveness (the CoCoA ``dv_scale`` knob) by
     ``damp_factor``, ``"raise"`` re-raises,
  4. gives up after ``max_trips`` (the fit reports ``diverged``).

Unhealthy means: non-finite alpha or v, ``max|v|`` above
``diverge_above``, the epoch raising, or the monitored series (gap when
present, else rel_change) rising ``divergence_streak`` epochs in a row.

The monitor exists only when a `HealthPolicy` is supplied: `Session.fit`
without one runs its loop with no extra host read.  With one, each
epoch reads max|alpha| and max|v| to the host and copies alpha and v
there at every snapshot.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import faultinject

__all__ = ["HealthPolicy", "HealthMonitor"]


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Knobs for detection and remediation (see module docstring)."""
    diverge_above: float = 1e8     # trip when max|v| exceeds this
    divergence_streak: int = 3     # trip after N straight increases
    retries: int = 1               # plain re-runs before the remedy
    remedy: str = "fallback"       # fallback | damp | raise
    damp_factor: float = 0.5       # dv_scale multiplier per damp trip
    max_trips: int = 5             # then give up (fit -> diverged)
    snapshot_every: int = 1        # healthy-state snapshot cadence

    def __post_init__(self):
        if self.remedy not in ("fallback", "damp", "raise"):
            raise ValueError(f"unknown remedy {self.remedy!r}")


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy no later in-place write to `t` reaches (on the CPU
    ``t.cpu()`` is `t` itself)."""
    return t.detach().to("cpu", copy=True)


class HealthMonitor:
    """`Session.fit` callback implementing a `HealthPolicy`.

    Duck-typed against `repro_torch.api.callbacks.Callback` (bind /
    on_epoch_end) plus the fit-loop-only ``on_epoch_error``.  One
    monitor carries trip state across the whole fit; pass the same
    instance to successive fits to keep counting.  Every trip is in
    `events`, in the event log (``health.trip``) and in an epoch's
    record under ``"health"``: the record of the epoch that tripped, or,
    for a trip raised by the epoch itself (which has no record), the
    record of the next epoch that ends.
    """

    needs_gap = False

    def __init__(self, policy: Optional[HealthPolicy] = None):
        self.policy = policy or HealthPolicy()
        self.trips = 0
        self.gave_up = False
        self.events: list[dict] = []
        self._snap = None               # (epochs_done, alpha, v) on host
        self._streak = 0
        self._prev = None               # last monitored value
        self._unreported = None         # an error trip's event

    def bind(self, session) -> None:
        self.session = session
        if self._snap is None:
            self._snapshot()            # pre-training state is healthy

    def _snapshot(self) -> None:
        s = self.session
        self._snap = (s.epochs_done, _host_copy(s.alpha), _host_copy(s.v))

    # -- detection -------------------------------------------------------
    def _check(self) -> Optional[str]:
        s = self.session
        amax, vmax = torch.stack([torch.max(torch.abs(s.alpha)),
                                  torch.max(torch.abs(s.v))]).tolist()
        if not (np.isfinite(amax) and np.isfinite(vmax)):
            return "non-finite alpha/v"
        if vmax > self.policy.diverge_above:
            return f"max|v|={vmax:.3e} above {self.policy.diverge_above:g}"
        return None

    def on_epoch_end(self, metrics: dict) -> bool:
        if self._unreported is not None:
            metrics["health"] = self._unreported
            self._unreported = None
        reason = self._check()
        if reason is None:
            val = metrics.get("gap", metrics.get("rel_change"))
            if (val is not None and self._prev is not None
                    and np.isfinite(val) and val > self._prev):
                self._streak += 1
                if self._streak >= self.policy.divergence_streak:
                    reason = (f"monitored value rose {self._streak} "
                              f"epochs in a row")
            else:
                self._streak = 0
            self._prev = val
        if reason is not None:
            return self._trip(reason, metrics)
        if (self.session.epochs_done - self._snap[0]
                >= self.policy.snapshot_every):
            self._snapshot()
        return False

    def on_epoch_error(self, err: Exception) -> None:
        """An exception escaped the epoch (kernel failure, feed error
        past its retries).  Same rollback/remedy path; the exception
        re-raises when the policy is exhausted."""
        stop = self._trip(f"{type(err).__name__}: {err}", None, err=err)
        if stop:
            raise err

    # -- remediation -----------------------------------------------------
    def _trip(self, reason: str, metrics: Optional[dict],
              err: Optional[Exception] = None) -> bool:
        self.trips += 1
        s = self.session
        event = {"trip": self.trips, "epoch": int(s.epochs_done),
                 "reason": reason}

        # roll back to the last healthy snapshot, as copies (the session
        # writes its state in place), and make the journal agree: an
        # inflight record downstream of the poison must not survive
        ep, alpha, v = self._snap
        s.alpha = torch.as_tensor(alpha).to(s.device, copy=True)
        s.v = torch.as_tensor(v).to(s.device, copy=True)
        s.epochs_done = ep
        journal = getattr(s, "_journal", None)
        if journal is not None:
            journal.commit_epoch(s.alpha, s.v, ep)
        self._streak = 0
        self._prev = None

        if self.trips > self.policy.max_trips:
            event["action"] = "give-up"
            self.gave_up = True
        elif self.trips <= self.policy.retries:
            event["action"] = "retry"
        elif self.policy.remedy == "fallback":
            if s.device.type == "cpu":
                event["action"] = "fallback:torch"
                s._switch_local_solver("torch")
            else:                       # never run around a kernel
                event["action"] = "fallback-refused"
                self.gave_up = True
        elif self.policy.remedy == "damp":
            s._damp *= self.policy.damp_factor
            event["action"] = f"damp:{s._damp:g}"
            s._rebuild_epoch_fn()
        else:                           # "raise"
            event["action"] = "raise"
            self.gave_up = True
        self.events.append(event)
        if metrics is not None:
            metrics["health"] = event
        else:
            self._unreported = event
        faultinject.log_event("health.trip", **event)
        if err is None and event["action"] in ("raise", "fallback-refused"):
            raise RuntimeError(f"health trip: {reason}")
        return self.gave_up
