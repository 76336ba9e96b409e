"""Seeded, deterministic fault injection for the training runtime.

Every recovery path in `repro_torch.resilience` is proven, not trusted:
this module turns a schedule string (``$REPRO_FAULTS`` or an explicit
`FaultInjector`) into exact, reproducible failures at exact points in
the training program, so tests can assert that the recovered model is
bitwise an uninterrupted ``deterministic=True`` run.  The grammar, the
environment variables and the event log are the reference package's
(`repro.resilience.faultinject`), so one schedule arms either package
and both write the same log.

Schedule grammar (semicolon-separated specs)::

    kind@tokens[:arg]

    tokens:  e<N> epoch    c<N> chunk    n<N> Nth fetch (1-based)
             t<N> tile id  x<N> fire count (default 1)

    kinds:   fetch-error   raise a transient OSError on the Nth fetch
             nan-chunk     poison the Nth fetched chunk's labels w/ NaN
             kill          raise SimulatedCrash at an epoch/chunk
                           boundary (chunk-level needs a journal; on a
                           process mesh arg presave / postsave puts it
                           before / after the rank's chunk record,
                           `journal.MeshJournal`)
             kernel-fail   raise KernelBuildError when the epoch runs
                           on a solver other than "torch"
             nan-epoch     poison alpha/v after the epoch completes
             flip-tile     XOR one seeded byte of tile t on disk
                           (arg = array name, default first data array)

    example: "fetch-error@n2x2;kill@e1c3;kernel-fail@e2;flip-tile@t7:val"

Faults are pure functions of (schedule, seed, call sequence), with no
randomness at fire time beyond the seeded byte position, so a failed
chaos run replays exactly.  Events (injections AND recoveries) are
appended as sorted-key JSON lines to ``$REPRO_FAULT_LOG`` when set; the
log carries no timestamps, so two identical runs write identical logs.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
from typing import Optional

import numpy as np
import torch

__all__ = [
    "SimulatedCrash", "FaultInjectedIOError", "KernelBuildError",
    "FaultSpec", "FaultInjector", "FaultyFeed", "parse_schedule",
    "log_event",
]

FAULT_KINDS = ("fetch-error", "nan-chunk", "kill", "kernel-fail",
               "nan-epoch", "flip-tile")


class SimulatedCrash(BaseException):
    """An injected process kill.

    Deliberately a BaseException (like KeyboardInterrupt): recovery
    machinery catches `Exception`, and a kill must never be absorbed by
    a retry loop; it has to unwind the whole process so that the
    kill-and-resume tests exercise the real restart path.
    """


class FaultInjectedIOError(OSError):
    """An injected TRANSIENT I/O failure (retryable by design)."""


class KernelBuildError(RuntimeError):
    """An injected kernel build or launch failure (any solver but
    "torch")."""


_TOKEN = re.compile(r"([ecnxt])(\d+)")
_TOKEN_FIELD = {"e": "epoch", "c": "chunk", "n": "nth",
                "x": "times", "t": "tile"}


@dataclasses.dataclass
class FaultSpec:
    """One parsed fault: a kind plus its firing coordinates."""
    kind: str
    epoch: Optional[int] = None
    chunk: Optional[int] = None
    nth: Optional[int] = None
    tile: Optional[int] = None
    times: int = 1
    arg: str = ""
    fired: int = 0

    def live(self) -> bool:
        return self.fired < self.times


def parse_schedule(schedule: str) -> list[FaultSpec]:
    specs = []
    for part in schedule.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition("@")
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in {part!r}; "
                f"known: {FAULT_KINDS}")
        tokens, _, arg = rest.partition(":")
        fields: dict = {"kind": kind, "arg": arg}
        pos = 0
        for m in _TOKEN.finditer(tokens):
            if m.start() != pos:
                raise ValueError(f"bad fault tokens {tokens!r} in {part!r}")
            pos = m.end()
            fields[_TOKEN_FIELD[m.group(1)]] = int(m.group(2))
        if pos != len(tokens):
            raise ValueError(f"bad fault tokens {tokens!r} in {part!r}")
        specs.append(FaultSpec(**fields))
    return specs


def log_event(event: str, *, log_path=None, **fields) -> None:
    """Append one sorted-key JSON line to the fault/recovery event log.

    No-op unless ``log_path`` or ``$REPRO_FAULT_LOG`` names a file, so
    the fault-free hot loop pays nothing.  Used by injection sites AND
    by the recovery machinery (retry, rollback, quarantine).  The file
    destination is keyword ``log_path`` (not ``path``) so that event
    payloads can carry a ``path=`` field.
    """
    log_path = log_path or os.environ.get("REPRO_FAULT_LOG")
    if not log_path:
        return
    rec = {"event": event, **fields}
    with open(log_path, "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")


class FaultInjector:
    """Deterministic fault scheduler; one per training run.

    Each probe is called from one point in the training program; it
    raises (or returns a poison directive) exactly when a live
    `FaultSpec` matches its coordinates, then consumes one firing.
    Probes are called only from the training loop and its one prefetch
    thread, and each spec fires a bounded number of times, so a plain
    counter suffices.
    """

    def __init__(self, schedule: str = "", *, seed: int = 0,
                 log_path=None):
        self.specs = (parse_schedule(schedule)
                      if isinstance(schedule, str) else list(schedule))
        self.seed = seed
        self.fetches = 0
        self.log_path = log_path

    @classmethod
    def from_env(cls) -> Optional["FaultInjector"]:
        """Build from ``$REPRO_FAULTS`` and ``$REPRO_SEED`` (None when
        the schedule is unset or empty)."""
        schedule = os.environ.get("REPRO_FAULTS", "")
        if not schedule:
            return None
        return cls(schedule, seed=int(os.environ.get("REPRO_SEED", "0")))

    def log(self, event: str, **fields) -> None:
        log_event(event, log_path=self.log_path, **fields)

    def _take(self, kind: str, *, epoch=None, chunk=None, nth=None,
              at: str = "") -> Optional[FaultSpec]:
        for s in self.specs:
            if s.kind != kind or not s.live():
                continue
            if kind == "kill" and s.arg != at:
                continue
            if s.nth is not None and not (
                    nth is not None and s.nth <= nth < s.nth + s.times):
                continue
            if s.epoch is not None and s.epoch != epoch:
                continue
            # chunk-level kills fire only at chunk boundaries and
            # epoch-level ones only at epoch boundaries: a kill@e1 must
            # not also fire inside epoch 1's chunk loop
            if kind == "kill" and (s.chunk is None) != (chunk is None):
                continue
            if s.chunk is not None and s.chunk != chunk:
                continue
            s.fired += 1
            return s
        return None

    # -- probes, one per program point -----------------------------------
    def on_fetch(self) -> Optional[str]:
        """Called by `FaultyFeed` before each fetch; may raise, or
        return ``"nan"`` to poison the fetched labels."""
        self.fetches += 1
        n = self.fetches
        if self._take("fetch-error", nth=n) is not None:
            self.log("inject.fetch-error", nth=n)
            raise FaultInjectedIOError(
                f"injected transient I/O fault on fetch {n}")
        if self._take("nan-chunk", nth=n) is not None:
            self.log("inject.nan-chunk", nth=n)
            return "nan"
        return None

    def maybe_kill(self, epoch: int, chunk: Optional[int] = None, *,
                   at: str = "") -> None:
        """Raise `SimulatedCrash` when a live kill matches (epoch, chunk)
        and is placed ``at`` this point (its arg; "" the boundary)."""
        if self._take("kill", epoch=int(epoch), chunk=chunk,
                      at=at) is not None:
            self.log("inject.kill", epoch=int(epoch), chunk=chunk,
                     **({"at": at} if at else {}))
            raise SimulatedCrash(
                f"injected kill at epoch {epoch}, chunk {chunk}")

    def maybe_kernel_fail(self, epoch: int) -> None:
        for s in self.specs:
            if s.kind == "kernel-fail" and s.live() and (
                    s.epoch is None or s.epoch == int(epoch)):
                s.fired += 1
                self.log("inject.kernel-fail", epoch=int(epoch))
                raise KernelBuildError(
                    f"injected kernel failure at epoch {epoch}")

    def nan_epoch(self, epoch: int) -> bool:
        """True when this epoch's result should be poisoned with NaN
        (the resident-path twin of nan-chunk)."""
        if self._take("nan-epoch", epoch=int(epoch)) is not None:
            self.log("inject.nan-epoch", epoch=int(epoch))
            return True
        return False

    # -- disk faults (applied once, before training) ---------------------
    def apply_disk_faults(self, cache_path) -> int:
        """Apply all live flip-tile specs to a cache directory; returns
        the number of bytes flipped.  The byte position inside the tile
        is seeded by (seed, tile), the flip is XOR 0xFF: always a real
        change, always the same change for the same schedule."""
        from repro_torch.data import cache as tile_cache
        path = pathlib.Path(cache_path)
        doc = json.loads((path / "meta.json").read_text())
        meta = tile_cache.CacheMeta(
            **{f.name: doc[f.name]
               for f in dataclasses.fields(tile_cache.CacheMeta)})
        specs_by_array = meta.array_specs()
        flipped = 0
        for s in self.specs:
            if s.kind != "flip-tile" or not s.live():
                continue
            s.fired += 1
            aname = s.arg or next(a for a in specs_by_array if a != "y")
            shape, dtype = specs_by_array[aname]
            tile_nbytes = (int(np.prod(shape[2:]))
                           * np.dtype(dtype).itemsize)
            tile = s.tile or 0
            rng = np.random.default_rng([self.seed, tile])
            off = tile * tile_nbytes + int(rng.integers(tile_nbytes))
            with open(path / f"{aname}.bin", "r+b") as f:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0xFF]))
            flipped += 1
            self.log("inject.flip-tile", array=aname, tile=tile,
                     offset=off)
        return flipped


class FaultyFeed:
    """`ChunkFeed` wrapper that injects scheduled faults on fetch.

    Sits UNDER `ResilientChunkFeed` in tests (the resilient wrapper sees
    the injected failures exactly as it would see real ones) and is
    harmless in production: with an empty schedule every fetch passes
    straight through.
    """

    def __init__(self, feed, injector: FaultInjector):
        self.feed = feed
        self.injector = injector
        self.n, self.d = feed.n, feed.d
        self.bucket, self.sparse = feed.bucket, feed.sparse
        self.device = feed.device
        self.cache = getattr(feed, "cache", None)

    def fetch(self, bids: np.ndarray):
        action = self.injector.on_fetch()
        data, y = self.feed.fetch(bids)
        if action == "nan":
            # made here, on the fetching thread's current stream: on the
            # card that is the streamed loop's side stream, before the
            # event the compute stream waits on
            y = torch.full_like(y, float("nan"))
        return data, y
