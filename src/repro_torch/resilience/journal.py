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

On a process mesh each rank keeps a `MeshJournal` under
``root/rank{r}``: records named by their cursor, the previous one kept
until every rank has written the next (a barrier), and a resume at the
least cursor every rank holds.
"""
from __future__ import annotations

import pathlib
import shutil
from typing import Optional

from repro_torch.checkpoint.manager import restore_tree, save_tree

from . import faultinject

__all__ = ["EpochJournal", "MeshJournal"]


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


class MeshJournal(EpochJournal):
    """One rank's journal on a process mesh (`launch.mesh.DistMesh`).

    Each rank journals its own state under ``root/rank{r}``: alpha (a
    rank writes only its own columns within an epoch, and
    `engine.MeshStreamDriver.share_alpha` makes it whole at the epoch's
    end), the rank's v and v_in.  Records are named by their cursor,
    ``inflight.e{E}.c{C}`` mid-epoch and ``epoch.{K}`` at an epoch's
    end.  A rank writes a new record, the world meets at a barrier, and
    only then does the rank delete its older records: until every rank
    has written the new one, each still holds the one before.  On a
    resume the world takes the least of the ranks' newest complete
    cursors (an all-reduce), which every rank holds, and each rank
    loads its own record at it: a rank that saved one chunk more than
    the others resumes a chunk back with them, and the replayed chunk
    gives the same bits.

    Besides the chunk-boundary kill (`pre_chunk`, as `EpochJournal`),
    a kill whose argument is ``presave`` fires after a chunk's step and
    before its record is written, and ``postsave`` after the write and
    before the barrier (``kill@e1c3:presave`` on some ranks and
    ``kill@e1c3:postsave`` on one leaves that rank a save ahead).
    """

    def __init__(self, root, mesh, *, every: int = 1,
                 injector: Optional["faultinject.FaultInjector"] = None):
        super().__init__(pathlib.Path(root) / f"rank{mesh.rank}",
                         every=every, injector=injector)
        self.mesh = mesh

    @classmethod
    def on_mesh(cls, journal: EpochJournal, mesh) -> "MeshJournal":
        """`journal` as this rank's journal of `mesh` (a MeshJournal of
        the same rank passes through; an EpochJournal at ``root`` puts
        this rank's records under ``root/rank{r}``)."""
        if isinstance(journal, cls):
            if journal.mesh.rank != mesh.rank:
                raise ValueError(f"a journal of rank {journal.mesh.rank} "
                                 f"on rank {mesh.rank}")
            return journal
        return cls(journal.root, mesh, every=journal.every,
                   injector=journal.injector)

    # -- the world's agreement --------------------------------------------
    def _world_min(self, value: int) -> int:
        import torch
        import torch.distributed as dist
        dev = "cpu" if self.mesh.backend == "gloo" else self.mesh.device
        t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
        # audit: collective-ok integer MIN of cursors: agreement, no sum
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return int(t.item())

    def _barrier(self) -> None:
        import torch.distributed as dist
        # audit: collective-ok no rank drops old records before all saved
        dist.barrier()

    def _records(self, prefix: str) -> dict[int, pathlib.Path]:
        """cursor -> path of this rank's complete records named
        ``{prefix}{cursor}``."""
        out = {}
        for p in self.root.glob(f"{prefix}*"):
            tail = p.name[len(prefix):]
            if tail.isdigit() and self._complete(p):
                out[int(tail)] = p
        return out

    def _drop(self, prefix: str, keep: Optional[pathlib.Path]) -> None:
        for p in list(self.root.glob(f"{prefix}*")) + list(
                self.root.glob(f".*.{prefix}*")):
            if p != keep:
                shutil.rmtree(p, ignore_errors=True)

    def _kill(self, epoch: int, chunk: int, at: str) -> None:
        if self.injector is not None:
            self.injector.maybe_kill(int(epoch), chunk, at=at)

    # -- mid-epoch -----------------------------------------------------------
    def post_chunk(self, epoch: int, c: int, alpha, v, v_in,
                   total: int) -> None:
        done = c + 1
        if done >= total or done % self.every:
            return
        prefix = f"inflight.e{int(epoch)}.c"
        self._kill(epoch, done, "presave")
        path = self.root / f"{prefix}{done}"
        save_tree(path, {"alpha": alpha, "v": v, "v_in": v_in},
                  meta={"epoch": int(epoch), "chunk": done})
        self._kill(epoch, done, "postsave")
        self._barrier()
        self._drop("inflight.", path)
        faultinject.log_event("journal.chunk", epoch=int(epoch),
                              chunk=done, rank=self.mesh.rank)

    def load_inflight(self, epoch: int, alpha, v, v_in, *, device=None):
        """-> (start_chunk, alpha, v, v_in) at the least cursor of this
        epoch that every rank holds, else None (a collective: every rank
        calls it at the epoch's start)."""
        recs = self._records(f"inflight.e{int(epoch)}.c")
        cursor = self._world_min(max(recs, default=0))
        if cursor <= 0:
            return None
        tree, meta = restore_tree(
            recs[cursor], {"alpha": alpha, "v": v, "v_in": v_in},
            device=device)
        faultinject.log_event("journal.resume", epoch=int(epoch),
                              chunk=cursor, rank=self.mesh.rank)
        return cursor, tree["alpha"], tree["v"], tree["v_in"]

    def clear_inflight(self) -> None:
        self._drop("inflight", None)

    # -- epoch level ---------------------------------------------------------
    def commit_epoch(self, alpha, v, epochs_done: int) -> None:
        path = self.root / f"epoch.{int(epochs_done)}"
        save_tree(path, {"alpha": alpha, "v": v},
                  meta={"epochs_done": int(epochs_done)})
        self._barrier()
        self._drop("epoch.", path)
        self.clear_inflight()

    def load_epoch(self, alpha, v, *, device=None):
        """-> (alpha, v, epochs_done) at the least completed epoch every
        rank holds, or None (a collective)."""
        recs = self._records("epoch.")
        done = self._world_min(max(recs, default=0))
        if done <= 0:
            return None
        tree, _ = restore_tree(recs[done], {"alpha": alpha, "v": v},
                               device=device)
        faultinject.log_event("journal.restore", epochs_done=done,
                              rank=self.mesh.rank)
        return tree["alpha"], tree["v"], done
