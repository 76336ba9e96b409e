"""Crash-safe epoch journal for the streamed training loop.

Two commit levels, both written through `checkpoint.manager.save_tree`
(atomic stage-swap protocol, so a kill at ANY instant leaves a
complete, loadable record):

  * ``<root>/epoch``    state after the last COMPLETED epoch (alpha, v;
    meta ``epochs_done``).  Committed by `Session.epoch`.
  * ``<root>/inflight`` mid-epoch snapshot at a chunk boundary (alpha,
    the pod-replicated v and v_in; meta ``epoch`` and the chunk cursor
    ``chunk``), written every ``every`` chunks by `run_epoch_streamed`.
    The partition schedule is a pure function of (seed, epoch), so
    resuming from chunk cursor ``c`` replays exactly the chunks the
    killed run had not yet applied, and the finished epoch is bitwise
    one that was never interrupted.

The layout, the keys and the meta are the reference package's
(`repro.resilience.journal`), so a journal written by either package
resumes in the other.  Records are read back as tensors on the device
the caller names.

The journal is opt-in (``journal_dir=`` on `Session` /
`StreamedGLMTrainer`): with none the streamed loop runs two ``is not
None`` tests per chunk and nothing else.  A journal write reads alpha,
v and v_in back to the host, which synchronizes the device.

The optional `FaultInjector` hook is how kill-and-resume tests place a
`SimulatedCrash` exactly at a chunk boundary.
"""
from __future__ import annotations

import pathlib
import shutil
from typing import Optional

from repro_torch.checkpoint.manager import restore_tree, save_tree

from . import faultinject

__all__ = ["EpochJournal"]


class EpochJournal:
    """Chunk-cursor + state journal under one directory."""

    def __init__(self, root, *, every: int = 1,
                 injector: Optional["faultinject.FaultInjector"] = None):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.every = max(1, int(every))
        self.injector = injector

    @property
    def _inflight(self) -> pathlib.Path:
        return self.root / "inflight"

    @property
    def _epoch(self) -> pathlib.Path:
        return self.root / "epoch"

    @staticmethod
    def _complete(path: pathlib.Path) -> bool:
        return ((path / "keys.json").exists()
                or (path.with_name(f".old.{path.name}")
                    / "keys.json").exists())

    # -- mid-epoch (called from run_epoch_streamed) ----------------------
    def pre_chunk(self, epoch: int, c: int) -> None:
        if self.injector is not None:
            self.injector.maybe_kill(int(epoch), c)

    def post_chunk(self, epoch: int, c: int, alpha, v, v_in,
                   total: int) -> None:
        done = c + 1
        if done >= total or done % self.every:
            return          # the final chunk is covered by commit_epoch
        save_tree(self._inflight,
                  {"alpha": alpha, "v": v, "v_in": v_in},
                  meta={"epoch": int(epoch), "chunk": done})
        faultinject.log_event("journal.chunk", epoch=int(epoch),
                              chunk=done)

    def load_inflight(self, epoch: int, alpha, v, v_in, *, device=None):
        """-> (start_chunk, alpha, v, v_in) when a mid-epoch snapshot of
        this epoch exists, else None.  The passed tensors are only
        shape and dtype templates; the snapshot comes back as fresh
        tensors on ``device`` (numpy arrays when None)."""
        if not self._complete(self._inflight):
            return None
        tree, meta = restore_tree(
            self._inflight, {"alpha": alpha, "v": v, "v_in": v_in},
            device=device)
        if meta.get("epoch") != int(epoch):
            return None     # stale snapshot from an earlier epoch
        faultinject.log_event("journal.resume", epoch=int(epoch),
                              chunk=int(meta["chunk"]))
        return (int(meta["chunk"]), tree["alpha"], tree["v"],
                tree["v_in"])

    def clear_inflight(self) -> None:
        """Drop the mid-epoch snapshot (and its swap siblings): on epoch
        commit, and on health rollback, where an inflight record
        downstream of a poisoned chunk must never be resumed."""
        for name in ("inflight", ".old.inflight", ".tmp.inflight"):
            shutil.rmtree(self.root / name, ignore_errors=True)

    # -- epoch level (called from Session) -------------------------------
    def commit_epoch(self, alpha, v, epochs_done: int) -> None:
        save_tree(self._epoch, {"alpha": alpha, "v": v},
                  meta={"epochs_done": int(epochs_done)})
        self.clear_inflight()

    def load_epoch(self, alpha, v, *, device=None):
        """-> (alpha, v, epochs_done) from the last committed epoch, or
        None when the journal holds no completed epoch yet.  alpha and v
        come back as fresh tensors on ``device`` (numpy arrays when
        None); the passed ones are templates."""
        if not self._complete(self._epoch):
            return None
        tree, meta = restore_tree(self._epoch, {"alpha": alpha, "v": v},
                                  device=device)
        faultinject.log_event("journal.restore",
                              epochs_done=int(meta["epochs_done"]))
        return tree["alpha"], tree["v"], int(meta["epochs_done"])
