"""Dataset registry: the paper's evaluation datasets as named specs.

Each entry declares the REAL dataset's shape and objective plus a
reduced "sub" shape and a deterministic synthetic fallback, so every
run works offline.  This slice of the port resolves names to the
seeded synthetic stand-ins only; ingesting raw svmlight/CSV files and
materializing tile caches is ROADMAP queue A7, so a raw file found
under ``data_dir`` / ``$REPRO_DATA_DIR`` raises instead of being
silently ignored (the reference package would train on it).
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Optional

import numpy as np

from . import synthetic

__all__ = ["DatasetSpec", "Dataset", "REGISTRY", "get_spec", "get_dataset"]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """One named workload: real shape + offline fallback shape."""
    name: str
    kind: str                  # dense | sparse
    objective: str             # default training objective
    full_n: int                # real dataset example count
    full_d: int
    sub_n: int                 # offline fallback default shape
    sub_d: int
    nnz: int = 0               # real (padded) row width, sparse only
    sub_nnz: int = 0           # fallback row width
    skew: float = 0.0          # Zipf-ish feature popularity (sparse)
    lam: float = 1e-3
    seed: int = 0
    source: str = ""           # provenance / download pointer


REGISTRY = {
    # criteo-kaggle: the paper's headline workload (45M x 1M, ~39 nnz —
    # the REAL row width; the synthetic fallback draws 40-wide rows)
    "criteo-kaggle-sub": DatasetSpec(
        "criteo-kaggle-sub", "sparse", "logistic",
        full_n=45_840_617, full_d=1_000_000, nnz=39,
        sub_n=8_192, sub_d=4_096, sub_nnz=40, skew=1.1, seed=1,
        source="https://labs.criteo.com/2014/02/"
               "kaggle-display-advertising-challenge-dataset/"),
    # HIGGS: dense, narrow — every worker is example-parallel
    "higgs": DatasetSpec(
        "higgs", "dense", "logistic",
        full_n=11_000_000, full_d=28, sub_n=16_384, sub_d=28, seed=2,
        source="https://archive.ics.uci.edu/dataset/280/higgs"),
    # epsilon: dense, wide, pre-normalized
    "epsilon": DatasetSpec(
        "epsilon", "dense", "logistic",
        full_n=400_000, full_d=2_000, sub_n=4_096, sub_d=2_000, seed=3,
        source="https://www.csie.ntu.edu.tw/~cjlin/libsvmtools/"
               "datasets/binary.html#epsilon"),
    # webspam (trigram): extreme-d sparse (the paper's 4th dataset)
    "webspam": DatasetSpec(
        "webspam", "sparse", "logistic",
        full_n=350_000, full_d=16_609_143, nnz=3_727,
        sub_n=4_096, sub_d=16_384, sub_nnz=64, skew=1.0, seed=4,
        source="https://www.csie.ntu.edu.tw/~cjlin/libsvmtools/"
               "datasets/binary.html#webspam"),
    # small fully-synthetic entries (paper Fig 1 shapes) for tests/CI
    "synthetic-dense": DatasetSpec(
        "synthetic-dense", "dense", "logistic",
        full_n=100_000, full_d=100, sub_n=2_048, sub_d=64, seed=0,
        source="data/synthetic.py (paper Fig 1a)"),
    "synthetic-sparse": DatasetSpec(
        "synthetic-sparse", "sparse", "logistic",
        full_n=100_000, full_d=1_000, nnz=10,
        sub_n=2_048, sub_d=256, sub_nnz=8, seed=0,
        source="data/synthetic.py (paper Fig 1b)"),
}


@dataclasses.dataclass
class Dataset:
    """A materialized (in-memory) dataset + where it came from."""
    spec: DatasetSpec
    y: np.ndarray
    d: int
    sparse: bool
    X: Optional[np.ndarray] = None             # dense (d, n)
    idx: Optional[np.ndarray] = None           # sparse (n, nnz)
    val: Optional[np.ndarray] = None
    provenance: str = "synthetic"

    @property
    def n(self) -> int:
        return self.y.shape[0]

    @property
    def scale(self) -> float:
        """Fraction of the real dataset's n this materialization holds."""
        return self.n / self.spec.full_n


def get_spec(name: str) -> DatasetSpec:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; registered: {sorted(REGISTRY)}")


def _find_raw_file(name: str, data_dir) -> Optional[pathlib.Path]:
    data_dir = data_dir or os.environ.get("REPRO_DATA_DIR")
    if not data_dir:
        return None
    base = pathlib.Path(data_dir)
    for ext in (".svm", ".svmlight", ".libsvm", ".txt", ".csv"):
        p = base / f"{name}{ext}"
        if p.exists():
            return p
    return None


def get_dataset(name: str, *, n: Optional[int] = None,
                d: Optional[int] = None, data_dir=None) -> Dataset:
    """Resolve a registry name to the seeded synthetic stand-in at
    (n or sub_n, d or sub_d) — the same arrays the reference package
    draws for the same name and shape."""
    spec = get_spec(name)
    raw = _find_raw_file(name, data_dir)
    if raw is not None:
        raise NotImplementedError(
            f"{raw}: raw-file ingest is not ported yet (ROADMAP queue A7); "
            f"unset $REPRO_DATA_DIR to train on the synthetic stand-in")
    n = n or spec.sub_n
    d = d or spec.sub_d
    if spec.kind == "dense":
        X, y = synthetic.make_dense_classification(n=n, d=d,
                                                   seed=spec.seed)
        return Dataset(spec, y, d, False, X=X)
    # the fallback draws rows whose width is ceiled to a multiple of 8,
    # as the reference does (its TPU kernels need nnz % 8 == 0)
    nnz = -(-(spec.sub_nnz or spec.nnz) // 8) * 8
    (idx, val), y, d = synthetic.make_sparse_classification(
        n=n, d=d, nnz=nnz, seed=spec.seed, skew=spec.skew)
    return Dataset(spec, y, d, True, idx=idx, val=val)
