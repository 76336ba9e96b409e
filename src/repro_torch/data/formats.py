"""Real-dataset ingestion: svmlight/libsvm and dense CSV parsers, and
the padded-CSR row invariant.

The paper's evaluation datasets (criteo-kaggle, higgs, epsilon,
webspam) all ship in one of two text formats:

  * svmlight/libsvm — ``label [qid:q] idx:val idx:val ...`` per line,
    the distribution format of every LIBSVM-hosted dataset;
  * dense CSV — ``label,f1,f2,...`` per line (higgs/epsilon are dense).

Parsers produce the engine's two layouts directly: padded-CSR
``(idx (n, nnz) int32, val (n, nnz) float32)`` for sparse data and
column-major ``X (d, n) float32`` for dense data.  Everything is
deterministic: row order is preserved, padding is idx=0/val=0, and the
writers (`dump_svmlight`/`dump_csv`) emit shortest-exact float32 reprs
so parse -> dump -> parse is the identity.  A numpy copy of the
reference's `repro.data.formats`: the same text gives the same arrays,
and the same arrays the same text, character for character.

One-based svmlight feature ids (the LIBSVM convention) are shifted to
zero-based with ``zero_based=False`` (the default).

The sparse solver paths hold rows to one invariant: no feature id
repeats within a row with a NONZERO value (padding with idx=0/val=0 is
fine).  Real svmlight data satisfies it by construction;
`zero_duplicates` enforces it for samplers that draw ids with
replacement.
"""
from __future__ import annotations

import array
import os
from typing import IO, Iterable, Union

import numpy as np

__all__ = [
    "parse_svmlight", "parse_csv", "dump_svmlight", "dump_csv",
    "to_dense", "nonzero_duplicate_rows", "raise_on_duplicate_nonzeros",
    "zero_duplicates",
]

Source = Union[str, os.PathLike, IO[str], Iterable[str]]


def _as_lines(source: Source) -> Iterable[str]:
    """Accept a path, an open file, raw text, or an iterable of lines.

    Files are streamed line by line (never read whole — real datasets
    run to tens of GB); raw text is split in memory.
    """
    if hasattr(source, "read"):
        return source
    if isinstance(source, os.PathLike):
        return _stream_file(source)
    if isinstance(source, str):
        if "\n" not in source and not os.path.exists(source):
            # a single line with no record separators (space/comma/
            # colon) cannot be svmlight or CSV data — it is a mistyped
            # path; raise instead of silently parsing zero examples
            if (not any(c in source for c in " ,:")
                    or "/" in source or os.sep in source):
                raise FileNotFoundError(
                    f"{source!r} looks like a path but does not exist")
        if "\n" in source or not os.path.exists(source):
            return source.splitlines()
        return _stream_file(source)
    return source


def _stream_file(path) -> Iterable[str]:
    with open(path, "r") as f:
        yield from f


def _f32_repr(x: float) -> str:
    """Shortest decimal that parses back to the exact same float32.

    float32 -> float64 is exact and repr(float64) round-trips, so the
    f64 repr of the f32 value re-parses to the identical f32.
    """
    return repr(float(np.float32(x)))


# ---------------------------------------------------------------------------
# svmlight / libsvm
# ---------------------------------------------------------------------------


def parse_svmlight(source: Source, *, nnz: int | None = None,
                   d: int | None = None, zero_based: bool = False):
    """Parse svmlight text into padded CSR.

    Returns ``((idx, val), y, d)`` with idx/val of shape (n, nnz): nnz
    defaults to the max row length; rows are padded with idx=0/val=0
    (a zero value never contributes to a margin, so padding is inert).
    Rows longer than an explicit ``nnz`` raise.  ``d`` defaults to
    1 + max feature id seen.

    Memory: the file is streamed and features accumulate in compact
    typed buffers (4 B/entry), so peak footprint is the same order as
    the padded output arrays — real multi-GB datasets ingest without
    holding text or per-feature Python objects.
    """
    labels = array.array("f")
    flat_idx = array.array("i")        # feature ids, rows concatenated
    flat_val = array.array("f")
    row_len = array.array("i")
    shift = 0 if zero_based else 1
    max_id = -1
    for lineno, line in enumerate(_as_lines(source), start=1):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        toks = line.split()
        try:
            labels.append(float(toks[0]))
        except ValueError:
            raise ValueError(
                f"svmlight line {lineno}: bad label {toks[0]!r}")
        k = 0
        for tok in toks[1:]:
            key, _, sval = tok.partition(":")
            if key == "qid":          # ranking group id — not a feature
                continue
            j = int(key) - shift
            if j < 0:
                raise ValueError(
                    f"svmlight line {lineno}: feature id {key} < "
                    f"{shift} (set zero_based={not zero_based}?)")
            flat_idx.append(j)
            flat_val.append(float(sval))   # C float == float32 rounding
            k += 1
            if j > max_id:
                max_id = j
        row_len.append(k)

    n = len(row_len)
    lens = np.frombuffer(row_len, dtype=np.int32) if n else \
        np.zeros(0, np.int32)
    width = int(lens.max()) if n else 0
    if nnz is None:
        nnz = max(width, 1)
    elif width > nnz:
        raise ValueError(f"row with {width} features exceeds nnz={nnz}")
    if d is None:
        d = max_id + 1
    elif max_id >= d:
        raise ValueError(f"feature id {max_id} out of range for d={d}")

    idx = np.zeros((n, nnz), dtype=np.int32)
    val = np.zeros((n, nnz), dtype=np.float32)
    mask = np.arange(nnz) < lens[:, None]      # row-major == flat order
    idx[mask] = np.frombuffer(flat_idx, dtype=np.int32)
    val[mask] = np.frombuffer(flat_val, dtype=np.float32)
    return (idx, val), np.frombuffer(labels, dtype=np.float32).copy(), d


def dump_svmlight(idx: np.ndarray, val: np.ndarray, y: np.ndarray, *,
                  zero_based: bool = False) -> str:
    """Padded CSR -> svmlight text (zero-valued/padded entries omitted)."""
    shift = 0 if zero_based else 1
    out = []
    for i in range(val.shape[0]):
        parts = [_f32_repr(y[i])]
        for j, x in zip(idx[i], val[i]):
            if x != 0.0:
                parts.append(f"{int(j) + shift}:{_f32_repr(x)}")
        out.append(" ".join(parts))
    return "\n".join(out) + ("\n" if out else "")


def to_dense(idx: np.ndarray, val: np.ndarray, d: int) -> np.ndarray:
    """Padded CSR -> dense X (d, n); duplicate ids accumulate."""
    n, nnz = val.shape
    X = np.zeros((d, n), dtype=np.float32)
    cols = np.repeat(np.arange(n), nnz)
    np.add.at(X, (idx.reshape(-1), cols), val.reshape(-1))
    return X


def nonzero_duplicate_rows(idx: np.ndarray, val: np.ndarray) -> np.ndarray:
    """Per-row mask: True where a row repeats a feature id with NONZERO
    values — the invariant violation `zero_duplicates` sanitizes away
    and the sparse CUDA kernel's bitwise contract forbids (the kernel
    wrapper's host-side check shares this helper).

    Zero-valued duplicates (padding, already-sanitized rows) don't
    count, so zero-valued entries are masked to a sentinel id BEFORE
    the adjacency compare: a plain duplicate check on sorted ids would
    miss an A,0,A pattern where a zero-valued duplicate sorts between
    two nonzero ones.
    """
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
    feature id per row.

    Real svmlight/CSR data satisfies this by construction; synthetic
    samplers that draw ids with replacement do not.  The repeated
    entries' values are zeroed (first occurrence wins), which keeps
    margins/updates well-defined AND is what makes the sparse CUDA
    kernel's per-bucket scatter bitwise-identical to the per-coordinate
    plain scan (zero-valued duplicates contribute exact zeros on both
    paths).  Returns the cleaned val; idx is left untouched.
    """
    order = np.argsort(idx, axis=1, kind="stable")
    sorted_idx = np.take_along_axis(idx, order, axis=1)
    dup_sorted = np.zeros_like(sorted_idx, dtype=bool)
    dup_sorted[:, 1:] = sorted_idx[:, 1:] == sorted_idx[:, :-1]
    dup = np.zeros_like(dup_sorted)
    np.put_along_axis(dup, order, dup_sorted, axis=1)
    return np.where(dup, np.zeros((), val.dtype), val)


# ---------------------------------------------------------------------------
# dense CSV
# ---------------------------------------------------------------------------


def parse_csv(source: Source, *, label_col: int = 0):
    """Parse ``label,f1,f2,...`` rows into (X (d, n) f32, y (n,) f32).

    A non-numeric first row is treated as a header and skipped.  The
    file is streamed; features accumulate in a compact typed buffer
    (4 B/value), not per-row Python objects.
    """
    flat = array.array("f")
    labels = array.array("f")
    width = None
    for lineno, line in enumerate(_as_lines(source), start=1):
        line = line.strip()
        if not line:
            continue
        toks = line.split(",")
        if width is None:
            try:
                float(toks[label_col])
            except ValueError:
                continue                       # header row
            width = len(toks)
        if len(toks) != width:
            raise ValueError(
                f"csv line {lineno}: {len(toks)} fields, expected {width}")
        labels.append(float(toks[label_col]))
        for i, tok in enumerate(toks):
            if i != label_col:
                flat.append(float(tok))
    n = len(labels)
    if not n:
        return np.zeros((0, 0), np.float32), np.zeros((0,), np.float32)
    X = np.frombuffer(flat, dtype=np.float32).reshape(n, width - 1).T
    return np.ascontiguousarray(X), np.frombuffer(
        labels, dtype=np.float32).copy()


def dump_csv(X: np.ndarray, y: np.ndarray) -> str:
    """(X (d, n), y) -> ``label,f1,...`` text with exact-f32 reprs."""
    out = []
    for i in range(X.shape[1]):
        out.append(",".join([_f32_repr(y[i])]
                            + [_f32_repr(x) for x in X[:, i]]))
    return "\n".join(out) + ("\n" if out else "")
