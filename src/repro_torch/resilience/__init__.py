"""Fault-tolerant training runtime, the reference's `repro.resilience`.

Four pillars, each opt-in and free when unused:

  * `EpochJournal`        crash-safe streamed epochs: chunk cursor +
                          state journal; a killed run resumes at the
                          last committed chunk boundary, bitwise.
  * `ResilientChunkFeed`  feed-layer retry/timeout/backoff; transient
                          I/O is retried, `TileCorruptionError` is
                          quarantined and rebuilt from source.
  * `HealthPolicy` /
    `HealthMonitor`       numerical-health guard: non-finite or
                          diverging state rolls back to the last
                          healthy snapshot, then retry / damp /
                          kernel -> torch fallback (a CPU session's
                          only: on the card it is refused and raises).
  * `faultinject`         seeded deterministic fault schedules
                          (``$REPRO_FAULTS``, ``$REPRO_SEED``) proving
                          every recovery path, with a JSON event log
                          (``$REPRO_FAULT_LOG``).

On a process mesh `MeshJournal` keeps each rank's journal and agrees
the world's resume cursor.  On a mesh, `ResilientChunkFeed` rebinds a rebuilt cache into its
`engine.MeshChunkFeed`, so the mesh layout and the compaction width
survive a quarantine.
"""
from .faultinject import (FaultInjectedIOError, FaultInjector, FaultyFeed,
                          KernelBuildError, SimulatedCrash, log_event,
                          parse_schedule)
from .feed import ResilientChunkFeed
from .health import HealthMonitor, HealthPolicy
from .journal import EpochJournal, MeshJournal

__all__ = [
    "EpochJournal", "MeshJournal", "ResilientChunkFeed", "HealthMonitor", "HealthPolicy",
    "FaultInjector", "FaultyFeed", "SimulatedCrash",
    "FaultInjectedIOError", "KernelBuildError", "parse_schedule",
    "log_event",
]
