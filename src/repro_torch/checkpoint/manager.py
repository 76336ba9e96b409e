"""Atomic, keep-N, async-write checkpoints of the port's trees.

A tree is nested dicts, lists, tuples and named tuples (the optimizer's
`AdamWState` and `QMoment`) whose leaves are tensors, numpy arrays,
numpy scalars or Python numbers (`None` is an empty subtree).
The on-disk layout is the reference package's (`repro.checkpoint`), so
a checkpoint written by either package restores in the other:

  * ``arrays.npz`` holds leaf i's raw bytes as the uint8 array ``a{i}``;
  * ``keys.json`` is the manifest ``[{"key", "dtype", "shape"}, ...]``,
    in the reference's flatten order (dict keys sorted, sequences and
    named tuples in order), each key the path's parts joined by ``/``, a
    named tuple's field as ``.<name>`` (how JAX prints its path entry);
  * ``meta.json`` holds the caller's metadata.

The device is a property of the run, not of the data: leaves are saved
as plain host bytes and `restore_tree` places them where it is told.

  * ATOMIC: a save stages into ``.tmp.<name>``, moves the live
    directory to ``.old.<name>``, renames the stage into place, then
    drops ``.old``; at every instant one of the two holds a complete
    checkpoint, and `restore_tree` falls back to ``.old`` when
    ``<name>`` is torn.
  * KEEP-N: `CheckpointManager` drops old steps after each commit.
  * ASYNC: the manager snapshots the tree on the caller's thread (a
    copy, so a later in-place update of a tensor never reaches the
    file) and writes it on a background thread.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.layers import tree_items, tree_map_path

__all__ = ["CheckpointManager", "restore_tree", "save_tree"]

#: the one dtype of the port's trees that numpy cannot name (without
#: ml_dtypes); it is stored and read as its 16-bit pattern
_BF16 = "bfloat16"


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (host array holding its bytes, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _snapshot(_path, leaf):
    """A copy of `leaf` that no later update of the caller's reaches."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def save_tree(path: pathlib.Path, tree, *, meta: Optional[dict] = None
              ) -> None:
    """Atomic save of a tree (+ meta.json), overwriting `path`.

    Stages into ``.tmp.<name>`` (a stale stage from a killed save is
    removed first), swaps the live directory to ``.old.<name>``, renames
    the stage into place and drops ``.old``."""
    path = pathlib.Path(path)
    tmp = path.with_name(f".tmp.{path.name}")
    old = path.with_name(f".old.{path.name}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True, exist_ok=True)
    flat = [(_key(p), *_host(leaf)) for p, leaf in tree_items(tree)]
    manifest = [{"key": k, "dtype": name, "shape": list(arr.shape)}
                for k, arr, name in flat]
    np.savez(tmp / "arrays.npz",
             **{f"a{i}": np.frombuffer(arr.tobytes(), np.uint8)
                for i, (_, arr, _) in enumerate(flat)})
    (tmp / "keys.json").write_text(json.dumps(manifest))
    (tmp / "meta.json").write_text(json.dumps(meta or {}))
    if path.exists():
        shutil.rmtree(old, ignore_errors=True)
        path.rename(old)
    tmp.rename(path)
    shutil.rmtree(old, ignore_errors=True)


def _decode(raw: bytes, name: str, shape) -> torch.Tensor:
    """A stored leaf as a CPU tensor of its own dtype."""
    if name == _BF16:
        arr = np.frombuffer(raw, np.int16).copy()
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(raw, np.dtype(name)).copy()
                            ).reshape(shape)


def _torch_dtype(like) -> torch.dtype:
    if isinstance(like, torch.Tensor):
        return like.dtype
    dt = np.asarray(like).dtype if not hasattr(like, "dtype") \
        else np.dtype(like.dtype)
    if dt.name == _BF16:
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dt)).dtype


def _shape(like) -> tuple:
    return tuple(like.shape) if hasattr(like, "shape") else np.shape(like)


def _place(t: torch.Tensor, like, device):
    """`t` (already of the target's dtype) as the caller asked for it:
    a tensor on `device`, else a numpy array; bfloat16 stays a CPU
    tensor then, unless the target is a numpy array that names it."""
    if device is not None:
        return t.to(device)
    if t.dtype != torch.bfloat16:
        return t.numpy()
    if isinstance(like, np.ndarray):
        return t.view(torch.int16).numpy().view(like.dtype)
    return t


def restore_tree(path: pathlib.Path, target, *, device=None
                 ) -> tuple[Any, dict]:
    """Restore into the structure of `target` (a tree of tensors or
    arrays, or anything with ``shape`` and ``dtype``); returns (tree,
    meta).  Each leaf is cast to its target's dtype and comes back as a
    tensor on `device`, or, when `device` is None, as a numpy array
    (a bfloat16 leaf as a CPU tensor, since numpy cannot name it).

    Falls back to the ``.old.<name>`` sibling when ``<name>`` is
    missing or torn (no keys.json).  The reference's ``shardings`` has
    no counterpart: the port restores onto one device."""
    path = pathlib.Path(path)
    if not (path / "keys.json").exists():
        old = path.with_name(f".old.{path.name}")
        if (old / "keys.json").exists():
            path = old
    manifest = json.loads((path / "keys.json").read_text())
    with np.load(path / "arrays.npz") as z:
        flat = {m["key"]: _decode(z[f"a{i}"].tobytes(), m["dtype"],
                                  m["shape"])
                for i, m in enumerate(manifest)}
    meta = json.loads((path / "meta.json").read_text())

    def leaf(p, like):
        key = _key(p)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = flat[key]
        if tuple(t.shape) != tuple(_shape(like)):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{tuple(t.shape)} vs target {_shape(like)}")
        return _place(t.to(_torch_dtype(like)), like, device)

    return tree_map_path(leaf, target), meta


class CheckpointManager:
    """Step-numbered checkpoints under a root dir; keep_n GC; async."""

    def __init__(self, root: str | pathlib.Path, *, keep_n: int = 3,
                 async_write: bool = True):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self.async_write = async_write
        self._pending: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> pathlib.Path:
        return self.root / f"step_{step:012d}"

    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.root.glob("step_*"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def save(self, step: int, tree, *, meta: Optional[dict] = None
             ) -> None:
        self.wait()
        meta = dict(meta or {}, step=step)
        snap = tree_map_path(_snapshot, tree)     # on the caller's thread

        def _write():
            save_tree(self._step_dir(step), snap, meta=meta)
            self._gc()

        if self.async_write:
            self._pending = threading.Thread(target=_write, daemon=True)
            self._pending.start()
        else:
            _write()

    def restore(self, target, *, step: Optional[int] = None,
                device=None) -> tuple[Any, dict]:
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return restore_tree(self._step_dir(step), target, device=device)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
