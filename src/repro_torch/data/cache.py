"""Example padding for resident arrays.

The tile cache (`repro.data.cache` in the reference) is not ported yet
(ROADMAP queue A7); this module holds the one piece the resident
Session path needs: padding n up to the multiple every partition mode
divides, with inert examples.
"""
from __future__ import annotations

import numpy as np

__all__ = ["pad_examples"]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_examples(y: np.ndarray, multiple: int, *,
                 X: np.ndarray | None = None,
                 idx: np.ndarray | None = None,
                 val: np.ndarray | None = None):
    """Pad n up to `multiple` with inert examples (x=0, y=+1)."""
    n = y.shape[0]
    n_pad = _ceil_to(max(n, 1), multiple)
    if n_pad == n:
        return y, X, idx, val
    extra = n_pad - n
    y = np.concatenate([y, np.ones(extra, dtype=y.dtype)])
    if X is not None:
        X = np.concatenate(
            [X, np.zeros((X.shape[0], extra), dtype=X.dtype)], axis=1)
    if idx is not None:
        idx = np.concatenate(
            [idx, np.zeros((extra, idx.shape[1]), dtype=idx.dtype)])
        val = np.concatenate(
            [val, np.zeros((extra, val.shape[1]), dtype=val.dtype)])
    return y, X, idx, val
