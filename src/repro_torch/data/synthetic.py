"""Seeded synthetic datasets shaped like the paper's benchmarks.

A numpy copy of the reference package's generators (`repro.data.
synthetic`): for the same arguments and seed they return byte-identical
arrays, so both packages train on the same data.

  make_dense_classification  — dense, X (d, n), y in {-1, +1}
  make_dense_regression      — dense, X (d, n), real-valued y (ridge)
  make_sparse_classification — padded-CSR (idx, val), optional Zipf-ish
                               feature-popularity skew (criteo-like)

and the stand-ins for the paper's three evaluation datasets, whose
character matches the originals at a documented scale factor:

  criteo_like   — sparse binary classification (criteo-kaggle: 45M x 1M,
                  ~39 nnz/example, skewed feature popularity)
  higgs_like    — dense, narrow (HIGGS: 11M x 28)
  epsilon_like  — dense, wide (epsilon: 400k x 2000, normalized)
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "make_dense_classification", "make_dense_regression",
    "make_sparse_classification", "criteo_like", "higgs_like",
    "epsilon_like",
]


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


def make_dense_regression(n: int = 50_000, d: int = 100, *, seed: int = 0,
                          noise: float = 0.1):
    """Dense ridge data: X (d, n) with unit columns, y = w @ X + noise."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((d, n)).astype(np.float32)
    X /= np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-12)
    w = rng.standard_normal(d).astype(np.float32)
    y = w @ X + noise * rng.standard_normal(n)
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


# -- stand-ins for the paper's three evaluation datasets -------------------

def criteo_like(n: int = 131_072, d: int = 65_536, *, seed: int = 1):
    """criteo-kaggle stand-in: sparse, skewed, ~39 nnz.  Scale ~1/350."""
    return make_sparse_classification(n=n, d=d, nnz=39, seed=seed, skew=1.1)


def higgs_like(n: int = 262_144, *, seed: int = 2):
    """HIGGS stand-in: dense, 28 features.  Scale ~1/42 in n."""
    return make_dense_classification(n=n, d=28, seed=seed)


def epsilon_like(n: int = 65_536, *, seed: int = 3):
    """epsilon stand-in: dense, 2000 normalized features.  Scale ~1/6."""
    return make_dense_classification(n=n, d=2_000, seed=seed)
