"""Dataset registry: the paper's evaluation datasets as named specs.

Each entry declares the REAL dataset's shape and objective plus a
reduced "sub" shape and a deterministic synthetic fallback, so every
run works offline: `get_dataset` ingests a real svmlight/CSV file when
one is present under ``data_dir`` (or ``$REPRO_DATA_DIR``) and
otherwise falls back to a seeded stand-in of the same character
(sparsity, skew, feature width) — the same arrays the reference package
draws for the same name and shape.  Only files the user already has
are read; nothing is fetched.

`materialize` is the bridge to the tile cache: it resolves a spec,
builds the packed bucket-tile cache under a shape-keyed directory if
missing (cold-start ingest paid once), and returns the opened
`TileCache` ready for in-memory loading or out-of-core streaming.  The
directory key is the reference's, so either package finds a cache the
other built.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
import shutil
import tempfile
from typing import Optional

import numpy as np

from . import cache as tile_cache
from . import formats, synthetic

__all__ = ["DatasetSpec", "Dataset", "REGISTRY", "get_spec",
           "get_dataset", "materialize", "cache_root"]


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
    provenance: str = "synthetic"              # synthetic | file:<path>

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
    """Resolve a registry name to in-memory arrays.

    Real file wins when present (svmlight/CSV under data_dir or
    $REPRO_DATA_DIR, optionally truncated to ``n``); otherwise the
    seeded synthetic fallback at (n or sub_n, d or sub_d).
    """
    spec = get_spec(name)
    raw = _find_raw_file(name, data_dir)
    if raw is not None:
        if raw.suffix == ".csv":
            X, y = formats.parse_csv(raw)
            if n is not None:
                X, y = X[:, :n], y[:n]
            if spec.kind == "sparse":
                raise ValueError(f"{raw}: CSV ingest is dense-only")
            return Dataset(spec, y, X.shape[0], False, X=X,
                           provenance=f"file:{raw}")
        (idx, val), y, d_seen = formats.parse_svmlight(raw, d=d)
        if n is not None:
            idx, val, y = idx[:n], val[:n], y[:n]
        if spec.kind == "dense":
            X = formats.to_dense(idx, val, d_seen)
            return Dataset(spec, y, d_seen, False, X=X,
                           provenance=f"file:{raw}")
        return Dataset(spec, y, d_seen, True, idx=idx, val=val,
                       provenance=f"file:{raw}")

    n = n or spec.sub_n
    d = d or spec.sub_d
    if spec.kind == "dense":
        X, y = synthetic.make_dense_classification(n=n, d=d,
                                                   seed=spec.seed)
        return Dataset(spec, y, d, False, X=X)
    # the fallback draws rows whose width is ceiled to a multiple of 8,
    # as the reference does (its TPU kernels need nnz % 8 == 0), so the
    # same name and shape give the same arrays in both packages
    nnz = -(-(spec.sub_nnz or spec.nnz) // 8) * 8
    (idx, val), y, d = synthetic.make_sparse_classification(
        n=n, d=d, nnz=nnz, seed=spec.seed, skew=spec.skew)
    return Dataset(spec, y, d, True, idx=idx, val=val)


def cache_root(cache_dir=None) -> pathlib.Path:
    """Resolve the cache directory: arg > $REPRO_CACHE_DIR > ~/.cache.

    Holds the versioned bucket-tile caches (`data.cache`, one
    subdirectory per materialized workload) and the solver planner's
    cached plans (`core.planner`, under ``plans_torch/``), the same
    root the reference package uses.
    """
    if cache_dir is not None:
        return pathlib.Path(cache_dir)
    env = os.environ.get("REPRO_CACHE_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "repro-glm"


def materialize(name: str, cache_dir=None, *, bucket: int = 16,
                pods: int = 1, n: Optional[int] = None,
                d: Optional[int] = None, pad_multiple: Optional[int] = None,
                nnz_multiple: Optional[int] = None,
                data_dir=None) -> tile_cache.TileCache:
    """Dataset name -> opened `TileCache`, building it if missing.

    The cache directory is keyed by everything that changes the bytes
    (shape, bucket, pod sharding, nnz padding, cache version), so
    different training topologies coexist and a version bump
    invalidates cleanly.  ``nnz_multiple`` pads sparse row widths with
    inert columns (part of the key, as in the reference, whose TPU
    kernels need nnz % 8 == 0).  A directory that does not open (torn
    build, stale version, truncated tiles) is moved aside under a
    dot-prefixed quarantine name and rebuilt.
    """
    spec = get_spec(name)
    root = cache_root(cache_dir)
    mult = pad_multiple or (pods * bucket)
    raw = _find_raw_file(name, data_dir)
    # n=None means "full file" for raw ingests (keyed 'nall' so it can
    # never collide with an explicit-n build) and sub_n for synthetics.
    # Raw files also key on (size, mtime) so replacing the file on disk
    # invalidates the cache instead of silently serving stale tiles.
    n_key = n if n is not None else ("all" if raw is not None
                                     else spec.sub_n)
    raw_key = ""
    if raw is not None:
        st = raw.stat()
        fp = hashlib.sha1(
            f"{st.st_size}-{st.st_mtime_ns}".encode()).hexdigest()[:10]
        raw_key = f"-raw{fp}"
    nnz_key = f"-z{nnz_multiple}" if nnz_multiple else ""
    key = (f"{name}-n{n_key}-d{d or spec.sub_d}"
           f"-b{bucket}-p{pods}-m{mult}{nnz_key}{raw_key}"
           f"-v{tile_cache.CACHE_VERSION}")
    path = root / key

    def _quarantine():
        # Move the bad directory aside (kept for forensics under a
        # dot-prefixed name that cache-key lookups can never match)
        # and rebuild below.
        quarantine = path.parent / f".quarantine.{path.name}"
        shutil.rmtree(quarantine, ignore_errors=True)
        os.rename(path, quarantine)

    if (path / "meta.json").exists():
        try:
            return tile_cache.open_cache(path)
        except (ValueError, KeyError, OSError):
            # torn build or corrupt/stale tiles: quarantined and
            # rebuilt from source; the rebuild re-raises real failures
            _quarantine()
    elif path.exists():
        # meta.json is build_cache's final write, so a cache directory
        # without it is a build that died mid-way: never open it.
        _quarantine()
    ds = get_dataset(name, n=n, d=d, data_dir=data_dir)
    # build into a private temp dir and rename into place: concurrent
    # materialize calls (pytest workers, threads, parallel benchmarks)
    # and mid-build crashes can never corrupt the shared cache dir.
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(
        dir=path.parent, prefix=f".{path.name}.tmp-"))
    if ds.sparse:
        tile_cache.build_cache(
            tmp, name, y=ds.y, idx=ds.idx, val=ds.val, d=ds.d,
            kind="sparse", bucket=bucket, pods=pods, pad_multiple=mult,
            nnz_multiple=nnz_multiple, objective=spec.objective)
    else:
        tile_cache.build_cache(
            tmp, name, y=ds.y, X=ds.X, kind="dense", bucket=bucket,
            pods=pods, pad_multiple=mult, objective=spec.objective)
    try:
        os.rename(tmp, path)
    except OSError:
        # another process won the race; its (byte-identical) build wins
        shutil.rmtree(tmp, ignore_errors=True)
    return tile_cache.open_cache(path)
