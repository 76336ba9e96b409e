"""Epoch callbacks for `Session.fit`.

The contract is one method:

    on_epoch_end(metrics: dict) -> bool | None

`metrics` is the epoch record (`epoch`, `rel_change`, cumulative `t`,
and `gap` when computed); a truthy return stops training after the
current epoch.  A bare callable works too.  Two optional extensions:

  * ``needs_gap = True``  — ask `fit` to compute the duality gap every
    epoch (it is a full data pass, so only callbacks that consume it
    should request it);
  * ``bind(session)``     — called once before the loop for callbacks
    that need solver state (checkpoint hooks).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

__all__ = ["Callback", "EarlyStopping", "GapLogger", "CheckpointHook",
           "BenchmarkRecorder"]


class Callback:
    """Base class (optional — any `on_epoch_end(metrics)` works)."""

    needs_gap: bool = False

    def bind(self, session) -> None:
        """Attach the owning `Session` before the first epoch."""
        self.session = session

    def on_epoch_end(self, metrics: dict) -> Optional[bool]:
        """Called after every epoch; return True to stop training."""
        return None


class EarlyStopping(Callback):
    """Stop on a target value or on stalled improvement.

    * ``threshold``: stop as soon as `monitor` drops below it (e.g.
      gap < 1e-4, the certificate the engine's dual gives).
    * ``patience``: stop after this many consecutive epochs without
      `min_delta` improvement of the monitored value.
    """

    def __init__(self, monitor: str = "gap",
                 threshold: Optional[float] = None,
                 patience: Optional[int] = None,
                 min_delta: float = 0.0):
        self.monitor = monitor
        self.threshold = threshold
        self.patience = patience
        self.min_delta = min_delta
        self.needs_gap = monitor == "gap"
        self.best = float("inf")
        self.stale = 0

    def on_epoch_end(self, metrics: dict) -> bool:
        """Stop when the monitored metric hits its target or stalls."""
        val = metrics.get(self.monitor)
        if val is None:
            return False
        if self.threshold is not None and val < self.threshold:
            return True
        if self.patience is None:
            return False
        if val < self.best - self.min_delta:
            self.best = val
            self.stale = 0
        else:
            self.stale += 1
        return self.stale >= self.patience


class GapLogger(Callback):
    """Print (or collect) the duality-gap trajectory every `every`
    epochs — the paper's convergence trace, as a callback.

    Does NOT set `needs_gap` (which would force the full-data gap pass
    on every epoch): on logging epochs it uses the gap already in
    `metrics` if some other consumer requested it, else computes it
    through the bound session — so only 1 in `every` epochs pays."""

    def __init__(self, every: int = 1,
                 printer: Optional[Callable[[str], None]] = print):
        self.every = every
        self.printer = printer
        self.trace: list[tuple[int, float]] = []

    def on_epoch_end(self, metrics: dict) -> None:
        """Record and (every `every` epochs) print the duality gap."""
        ep = int(metrics["epoch"])
        if ep % self.every:
            return
        gap = metrics.get("gap")
        if gap is None:
            gap = self.session.gap()
            metrics["gap"] = gap       # share with later callbacks
        self.trace.append((ep, gap))
        if self.printer is not None:
            self.printer(f"[gap] epoch {ep:4d}  gap={gap:.3e}  "
                         f"rel={metrics['rel_change']:.3e}")


class CheckpointHook(Callback):
    """Save session state every `every` epochs via `CheckpointManager`
    (atomic commits, keep-N GC) so long fits restart mid-run."""

    def __init__(self, root, *, every: int = 1, keep_n: int = 3,
                 meta: Optional[dict] = None):
        from repro_torch.checkpoint import CheckpointManager
        self.mgr = CheckpointManager(root, keep_n=keep_n)
        self.every = every
        self.meta = meta or {}

    def on_epoch_end(self, metrics: dict) -> None:
        """Save a checkpoint every `every` epochs."""
        ep = int(metrics["epoch"])
        if ep % self.every:
            return
        self.mgr.save(ep, self.session.state_dict(),
                      meta=dict(self.meta, epoch=ep))


class BenchmarkRecorder(Callback):
    """Collect per-epoch records (+ wall-clock) for benchmark emitters."""

    def __init__(self):
        self.records: list[dict] = []
        self._t0 = time.perf_counter()

    def bind(self, session) -> None:
        """Attach the session and restart the wall clock."""
        super().bind(session)
        self._t0 = time.perf_counter()

    def on_epoch_end(self, metrics: dict) -> None:
        """Append this epoch's metrics stamped with elapsed wall time."""
        self.records.append(
            dict(metrics, wall=time.perf_counter() - self._t0))

    @property
    def wall_time(self) -> float:
        """Wall-clock seconds from bind to the latest recorded epoch."""
        return self.records[-1]["wall"] if self.records else 0.0
