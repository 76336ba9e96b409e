"""Failure-classifying retry wrapper over the `ChunkFeed` protocol.

`ResilientChunkFeed` is the feed-layer pillar of the fault-tolerant
runtime.  It tells two failure classes apart on fetch:

  * TRANSIENT (OSError/TimeoutError by default): retried in place with
    capped exponential backoff (NFS hiccups, throttled object stores,
    injected `FaultInjectedIOError`).  The retried fetch returns the
    bytes a clean fetch would, so training stays bitwise exact.
  * CORRUPTION (`TileCorruptionError` from the per-tile crc check):
    never retried, since the bytes will not get better.  The backing
    cache directory is quarantined aside and rebuilt from source through
    the ``rebuild`` callback; cache builds are byte-stable, so the
    rebuilt tiles are identical (the CSR invariant of sparse rows
    included) and training continues bitwise exact.

The fault-free path pays one try/except around the underlying fetch:
no checksum, no thread, no device synchronize (a per-fetch timeout opts
in through ``timeout=``, which runs the fetch on one worker thread).
"""
from __future__ import annotations

import contextlib
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.data.cache import TileCorruptionError

from . import faultinject

__all__ = ["ResilientChunkFeed"]


class ResilientChunkFeed:
    """`ChunkFeed` wrapper: retry transients, quarantine corruption.

    Parameters
    ----------
    feed : ChunkFeed
        The wrapped feed (`TileFeed`, `ArrayFeed`, `FaultyFeed`, ...).
    retries : int
        Max transient retries per fetch before re-raising.
    backoff, backoff_cap : float
        Initial / maximum sleep between transient retries (seconds,
        doubled each attempt).
    timeout : float | None
        Per-fetch timeout in seconds; a timed-out fetch counts as
        transient.  None (default) calls the feed directly.
    transient : tuple[type, ...]
        Exception classes treated as retryable.
    rebuild : callable | None
        Zero-argument callback returning a fresh `TileCache` (or feed)
        after corruption, typically ``lambda: registry.materialize(...)``.
        Without it, corruption re-raises to the caller.
    sleep : callable
        Injection point for tests (default `time.sleep`).
    """

    def __init__(self, feed, *, retries: int = 3, backoff: float = 0.05,
                 backoff_cap: float = 2.0,
                 timeout: Optional[float] = None,
                 transient: tuple = (OSError, TimeoutError),
                 rebuild: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.feed = feed
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.timeout = timeout
        self.transient = transient
        self.rebuild = rebuild
        self.sleep = sleep
        self._pool: Optional[ThreadPoolExecutor] = None

    # `self.feed` can be swapped by a corruption rebuild, so the
    # protocol attributes forward dynamically instead of being copied
    @property
    def n(self) -> int:
        return self.feed.n

    @property
    def d(self) -> int:
        return self.feed.d

    @property
    def bucket(self) -> int:
        return self.feed.bucket

    @property
    def sparse(self) -> bool:
        return self.feed.sparse

    @property
    def device(self) -> torch.device:
        return self.feed.device

    @property
    def cache(self):
        return getattr(self.feed, "cache", None)

    def _fetch_once(self, bids: np.ndarray):
        if self.timeout is None:
            return self.feed.fetch(bids)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1)
        # the current stream is per thread: the worker issues the feed's
        # copies on the caller's stream (the streamed loop's side
        # stream), which the loop's event then covers
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        return self._pool.submit(self._fetch_on, stream, bids).result(
            timeout=self.timeout)

    def _fetch_on(self, stream, bids: np.ndarray):
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            return self.feed.fetch(bids)

    def _recover_corruption(self, err: TileCorruptionError) -> None:
        """Quarantine the corrupt cache directory and swap in a rebuilt
        one."""
        if self.rebuild is None:
            raise err
        cache = self.cache
        if cache is not None:
            p = cache.path
            q = p.parent / f".quarantine.{p.name}"
            shutil.rmtree(q, ignore_errors=True)
            os.rename(p, q)
            faultinject.log_event(
                "recover.quarantine", path=str(p), array=err.array,
                tile=err.tile, offset=err.offset)
        new = self.rebuild()
        if hasattr(self.feed, "rebind") and not hasattr(new, "fetch"):
            # a mesh feed (engine.MeshChunkFeed) survives the rebuild:
            # only its backing cache is swapped, so the mesh layout and
            # the compaction width stay (a plain TileFeed would not fit
            # the mesh step)
            self.feed.rebind(new)
        else:
            if hasattr(new, "feed"):      # TileCache -> its ChunkFeed
                new = new.feed(verify=getattr(self.feed, "verify", False),
                               device=self.device)
            self.feed = new
        faultinject.log_event("recover.rebuilt", array=err.array,
                              tile=err.tile)

    def fetch(self, bids: np.ndarray):
        attempt = 0
        rebuilt = False
        delay = self.backoff
        while True:
            try:
                return self._fetch_once(bids)
            except TileCorruptionError as err:
                if rebuilt:               # rebuilt bytes are bad too
                    raise
                self._recover_corruption(err)
                rebuilt = True
            except self.transient as err:
                attempt += 1
                if attempt > self.retries:
                    raise
                faultinject.log_event(
                    "recover.retry", attempt=attempt,
                    error=f"{type(err).__name__}: {err}")
                self.sleep(delay)
                delay = min(delay * 2.0, self.backoff_cap)
