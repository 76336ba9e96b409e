"""Padded-CSR row invariant: helpers shared by samplers and kernels.

The sparse solver paths hold rows to one invariant: no feature id
repeats within a row with a NONZERO value (padding with idx=0/val=0 is
fine).  Real svmlight/CSR data satisfies it by construction;
`zero_duplicates` enforces it for samplers that draw ids with
replacement.  A numpy copy of the reference's `repro.data.formats`
helpers of the same names.
"""
from __future__ import annotations

import numpy as np

__all__ = ["zero_duplicates", "nonzero_duplicate_rows",
           "raise_on_duplicate_nonzeros"]


def nonzero_duplicate_rows(idx: np.ndarray, val: np.ndarray) -> np.ndarray:
    """Per-row mask: True where a row repeats a feature id with NONZERO
    values.  Zero-valued entries are masked to a sentinel id BEFORE the
    adjacency compare, so an A,0,A pattern is still caught."""
    ids = np.where(val != 0, idx, -1)   # keeps idx's dtype: no copy blowup
    s = np.sort(ids, axis=1)
    dup = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    return dup.any(axis=1)


def raise_on_duplicate_nonzeros(idx: np.ndarray, val: np.ndarray,
                                context: str) -> None:
    """Raise the CSR-invariant error if `nonzero_duplicate_rows` flags
    any row; `context` names the caller's data provenance."""
    bad = nonzero_duplicate_rows(idx, val)
    if not bad.any():
        return
    row = int(np.argmax(bad))
    s = np.sort(np.where(val[row] != 0, idx[row], -1))
    feat = int(s[1:][(s[1:] == s[:-1]) & (s[1:] >= 0)][0])
    raise ValueError(
        f"{context} violate the CSR no-duplicate-nonzero invariant "
        f"(row {row} repeats feature id {feat} with nonzero values).  "
        f"Sanitize with data.formats.zero_duplicates(idx, val) first, or "
        f"use local_solver='torch'.")


def zero_duplicates(idx: np.ndarray, val: np.ndarray) -> np.ndarray:
    """Enforce the padded-CSR invariant: at most one NONZERO value per
    feature id per row.  Repeated entries' values are zeroed (first
    occurrence wins).  Returns the cleaned val; idx is left untouched."""
    order = np.argsort(idx, axis=1, kind="stable")
    sorted_idx = np.take_along_axis(idx, order, axis=1)
    dup_sorted = np.zeros_like(sorted_idx, dtype=bool)
    dup_sorted[:, 1:] = sorted_idx[:, 1:] == sorted_idx[:, :-1]
    dup = np.zeros_like(dup_sorted)
    np.put_along_axis(dup, order, dup_sorted, axis=1)
    return np.where(dup, np.zeros((), val.dtype), val)
