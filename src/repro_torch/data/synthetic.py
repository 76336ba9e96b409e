"""Seeded synthetic datasets shaped like the paper's benchmarks.

A numpy copy of the reference package's generators (`repro.data.
synthetic`): for the same arguments and seed they return byte-identical
arrays, so both packages train on the same data.

  make_dense_classification  — dense, X (d, n), y in {-1, +1}
  make_sparse_classification — padded-CSR (idx, val), optional Zipf-ish
                               feature-popularity skew (criteo-like)
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_dense_classification", "make_sparse_classification"]


def _labels_from_logits(rng, logits):
    p = 1.0 / (1.0 + np.exp(-logits))
    return (rng.uniform(size=logits.shape) < p).astype(np.float32) * 2 - 1


def make_dense_classification(n: int = 100_000, d: int = 100, *,
                              seed: int = 0, scale: float = 1.0,
                              normalize: bool = True):
    """Paper's dense synthetic dataset (Fig 1a).  X: (d, n), y in {-1,+1}."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((d, n)).astype(np.float32) * scale
    if normalize:
        X /= np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-12)
    w = rng.standard_normal(d).astype(np.float32)
    y = _labels_from_logits(rng, 4.0 * (w @ X) / np.linalg.norm(w))
    return X, y.astype(np.float32)


def make_sparse_classification(n: int = 100_000, d: int = 1_000, *,
                               nnz: int = 10, seed: int = 0,
                               skew: float = 0.0):
    """Paper's sparse synthetic dataset (Fig 1b): 1% uniform sparsity.

    Returns padded-CSR (idx (n,nnz) int32, val (n,nnz) f32), y, d.
    skew>0 draws feature ids from a Zipf-ish distribution (criteo-like
    popularity skew) instead of uniform.
    """
    rng = np.random.default_rng(seed)
    if skew > 0:
        p = (1.0 / np.arange(1, d + 1) ** skew)
        p /= p.sum()
        idx = rng.choice(d, size=(n, nnz), p=p).astype(np.int32)
    else:
        idx = rng.integers(0, d, size=(n, nnz)).astype(np.int32)
    val = (rng.standard_normal((n, nnz)) / np.sqrt(nnz)).astype(np.float32)
    # real CSR rows never repeat a feature id; sampling with replacement
    # does, so zero the repeats (keeps the padded-CSR invariant every
    # solver path — including the sparse CUDA kernel — relies on)
    from .formats import zero_duplicates
    val = zero_duplicates(idx, val)
    w = rng.standard_normal(d).astype(np.float32)
    logits = (val * w[idx]).sum(axis=1) * 4.0
    y = _labels_from_logits(rng, logits)
    return (idx, val), y.astype(np.float32), d
