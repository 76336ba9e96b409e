"""sklearn-compatible estimators over the port's `Session`.

The drop-in surface for the paper's comparison with scikit-learn:

    from repro_torch.api import LogisticRegression
    clf = LogisticRegression(lam=1e-3, lanes=8).fit(X, y)   # X (n, d)
    clf.predict(X), clf.predict_proba(X), clf.score(X, y)

Estimators follow the sklearn protocol (`fit/predict/score/get_params/
set_params`, `coef_`/`classes_`/`n_iter_` post-fit attributes, keyword-
only constructor params so `sklearn.clone` works) and speak sklearn's
ROW-major layout `X (n_samples, n_features)`; the underlying `Session`
speaks the engine's `(d, n)`.  `fit` takes everything a Session does —
dense arrays, scipy sparse matrices, padded-CSR `(idx, val)` pairs,
registry dataset names, `TileCache`s and `ChunkFeed`s — so the same
estimator trains in memory or out of core (``streamed=True``,
``cache_dir=``).

The device is a property of the run, not of the model: ``device=``
(default ``"cuda"``, which raises without a GPU) goes to the `Session`
and to prediction, but not into a checkpoint.  `save(path)` writes the
reference package's layout with the reference's solver names, and
`load(path, device=...)` reads a checkpoint of either package, so an
estimator trained by one predicts and resumes in the other; a resumed
`fit` runs the REMAINING epochs, bitwise under ``deterministic=True``.
"""
from __future__ import annotations

import inspect
import json
import os
import pathlib
import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.convert import REFERENCE_SOLVER_NAMES, SOLVER_NAMES
from repro_torch.core.config import EngineConfig
from repro_torch.device import resolve_device

from .session import Session, margins

__all__ = ["GLMEstimator", "LogisticRegression", "LinearSVC", "Ridge",
           "NotFittedError", "load"]

#: rows that prediction moves to the device at a time; a call's rows are
#: cut into blocks of this size from its first row, so `predict(X)` and
#: `launch.serve.glm_predict_batch(est, X)` (whose default batch is this
#: size) run the same products on the same blocks
PREDICT_ROWS = 8192


class NotFittedError(ValueError, AttributeError):
    """Estimator used before `fit` (mirrors sklearn's exception MRO)."""


def _csr_to_padded(sp) -> tuple[np.ndarray, np.ndarray]:
    """scipy CSR/CSC/COO -> engine padded-CSR (idx, val), (n, nnz_max).

    Pad slots use idx=0/val=0 — a zero value contributes nothing to any
    margin or update, so padding is inert by construction.
    """
    sp = sp.tocsr()
    n = sp.shape[0]
    row_nnz = np.diff(sp.indptr)
    nnz = max(int(row_nnz.max(initial=0)), 1)
    idx = np.zeros((n, nnz), np.int32)
    val = np.zeros((n, nnz), np.float32)
    rows = np.repeat(np.arange(n), row_nnz)
    cols = np.arange(len(sp.indices)) - np.repeat(sp.indptr[:-1], row_nnz)
    idx[rows, cols] = sp.indices
    val[rows, cols] = sp.data
    return idx, val


def _is_scipy_sparse(X) -> bool:
    return hasattr(X, "tocsr") and not isinstance(X, (tuple, list))


class GLMEstimator:
    """Shared estimator machinery; subclasses pin the objective.

    Hyperparameters mirror `EngineConfig` (algorithm x deployment
    layers) plus the fit budget and the run's ``device``; everything is
    keyword-only and stored under its own name, which is exactly what
    `get_params`/`set_params` (and therefore `sklearn.base.clone`)
    require.  ``local_solver`` takes the port's names
    (``"auto"``/``"torch"``/``"kernel"``).  ``health`` (a `HealthPolicy`,
    `HealthMonitor` or True) and ``journal_dir`` go to the `Session`:
    the numerical-health guard, and crash-safe epochs that a new fit on
    the same journal resumes.
    """

    _objective = "logistic"
    _classifier = True

    def __init__(self, *, lam: float = 1e-3, max_epochs: int = 100,
                 tol: float = 1e-3, bucket: int = 8, pods: int = 1,
                 lanes: int = 1, chunks: int = 1,
                 partition: str = "hierarchical",
                 aggregation: str = "adding", local_solver: str = "auto",
                 redeal_frac: float = 1.0, compress_sync: bool = False,
                 compress_pod: bool = False, deterministic: bool = False,
                 seed: int = 0, gap_every: int = 0, verbose: bool = False,
                 streamed: bool = False, cache_dir=None, data_dir=None,
                 n_features: Optional[int] = None,
                 callbacks: Optional[Sequence] = None,
                 health=None, journal_dir=None, device="cuda"):
        self.lam = lam
        self.max_epochs = max_epochs
        self.tol = tol
        self.bucket = bucket
        self.pods = pods
        self.lanes = lanes
        self.chunks = chunks
        self.partition = partition
        self.aggregation = aggregation
        self.local_solver = local_solver
        self.redeal_frac = redeal_frac
        self.compress_sync = compress_sync
        self.compress_pod = compress_pod
        self.deterministic = deterministic
        self.seed = seed
        self.gap_every = gap_every
        self.verbose = verbose
        self.streamed = streamed
        self.cache_dir = cache_dir
        self.data_dir = data_dir
        self.n_features = n_features
        self.callbacks = callbacks
        self.health = health
        self.journal_dir = journal_dir
        self.device = device
        self._resume_state: Optional[dict[str, Any]] = None
        self._coef_dev: Optional[tuple] = None

    # -- sklearn parameter protocol ---------------------------------------

    @classmethod
    def _param_names(cls) -> list[str]:
        sig = inspect.signature(cls.__init__)
        return [p for p in sig.parameters if p != "self"]

    def get_params(self, deep: bool = True) -> dict[str, Any]:
        """Constructor parameters as a dict (sklearn protocol)."""
        return {name: getattr(self, name) for name in self._param_names()}

    def set_params(self, **params) -> "GLMEstimator":
        """Set constructor parameters in place; returns self (sklearn
        protocol)."""
        valid = set(self._param_names())
        for name, value in params.items():
            if name not in valid:
                raise ValueError(
                    f"invalid parameter {name!r} for {type(self).__name__};"
                    f" valid: {sorted(valid)}")
            setattr(self, name, value)
        return self

    def engine_config(self) -> EngineConfig:
        """The `EngineConfig` this estimator's parameters resolve to."""
        return EngineConfig.make(
            pods=self.pods, lanes=self.lanes, bucket=self.bucket,
            chunks=self.chunks, partition=self.partition,
            aggregation=self.aggregation, local_solver=self.local_solver,
            redeal_frac=self.redeal_frac, compress_sync=self.compress_sync,
            compress_pod=self.compress_pod,
            deterministic=self.deterministic, seed=self.seed)

    # -- fitting -----------------------------------------------------------

    def _label_transform(self, y) -> np.ndarray:
        """Map arbitrary binary labels onto the engine's {-1, +1}."""
        y = np.asarray(y)
        classes = np.unique(y)
        if classes.shape[0] != 2:
            raise ValueError(
                f"{type(self).__name__} is a binary classifier; got "
                f"{classes.shape[0]} classes")
        if self._resume_state is not None and hasattr(self, "classes_") \
                and not np.array_equal(classes, self.classes_):
            raise ValueError("resumed fit saw different classes than the "
                             f"checkpoint: {classes} vs {self.classes_}")
        self.classes_ = classes
        return np.where(y == classes[1], 1.0, -1.0).astype(np.float32)

    def _make_session(self, X, y) -> Session:
        kw = dict(objective=self._objective, lam=self.lam,
                  cfg=self.engine_config(), streamed=self.streamed,
                  cache_dir=self.cache_dir, data_dir=self.data_dir,
                  bucket=self.bucket, health=self.health,
                  journal_dir=self.journal_dir, device=self.device)
        if isinstance(X, str) or hasattr(X, "gather_buckets") \
                or hasattr(X, "fetch"):
            if y is not None:
                raise ValueError("labels come from the dataset/feed "
                                 "itself; pass y=None")
            if self._classifier and not hasattr(self, "classes_"):
                # dataset labels are already in the engine's {-1, +1}
                self.classes_ = np.array([-1.0, 1.0], np.float32)
            return Session(X, **kw)
        if y is None:
            raise ValueError("array input requires y")
        if self._classifier:
            y = self._label_transform(y)
        else:
            y = np.asarray(y, np.float32)
        if _is_scipy_sparse(X):
            idx, val = _csr_to_padded(X)
            return Session((idx, val), y, d=int(X.shape[1]), **kw)
        if isinstance(X, (tuple, list)):          # engine (idx, val) pair
            idx, val = X
            d = self.n_features or int(np.asarray(idx).max()) + 1
            return Session((idx, val), y, d=d, **kw)
        X = np.asarray(X, np.float32)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D (n_samples, n_features); "
                             f"got shape {X.shape}")
        return Session(X.T, y, **kw)              # sklearn -> engine layout

    def fit(self, X, y=None) -> "GLMEstimator":
        """Train to `max_epochs` TOTAL epochs (or `tol` convergence).

        On an estimator restored by `load`, training resumes from the
        checkpointed epoch and runs the REMAINING epochs — so
        `fit(3); save; load; fit()` equals one uninterrupted fit
        (bitwise under `deterministic=True`).
        """
        self.session_ = self._make_session(X, y)
        if self._resume_state is not None:
            st = self._resume_state
            if st["v"].shape[0] != self.session_.d:
                raise ValueError(
                    f"checkpoint d={st['v'].shape[0]} != data "
                    f"d={self.session_.d}")
            if st["alpha"].shape[0] != self.session_.n:
                raise ValueError(
                    f"checkpoint n={st['alpha'].shape[0]} != data "
                    f"n={self.session_.n} (after padding); resume needs "
                    "the same examples the checkpoint was trained on")
            self.session_.load_state_dict(st)
            self._resume_state = None
        res = self.session_.fit(
            until=self.max_epochs, tol=self.tol, gap_every=self.gap_every,
            callbacks=self.callbacks or (), verbose=self.verbose)
        self.fit_result_ = res
        self.coef_ = np.asarray(res.v)
        self.intercept_ = 0.0
        self.n_iter_ = res.epochs
        return self

    # -- inference ---------------------------------------------------------

    def _check_fitted(self) -> None:
        if not hasattr(self, "coef_"):
            raise NotFittedError(
                f"this {type(self).__name__} instance is not fitted yet; "
                "call fit(X, y) first")

    def _coef(self) -> torch.Tensor:
        """`coef_` on the prediction device (the fit's session's, else
        this estimator's), copied there once per model."""
        dev = (self.session_.device if hasattr(self, "session_")
               else resolve_device(self.device))
        cached = self._coef_dev
        if cached is None or cached[0] is not self.coef_ or cached[1] != dev:
            v = torch.as_tensor(np.asarray(self.coef_, np.float32)).to(dev)
            self._coef_dev = cached = (self.coef_, dev, v)
        return cached[2]

    def _margins(self, X) -> np.ndarray:
        """x_i^T coef_ on the device, `PREDICT_ROWS` rows at a time."""
        self._check_fitted()
        v = self._coef()
        if _is_scipy_sparse(X):
            X = _csr_to_padded(X)
        pair = isinstance(X, (tuple, list))
        if pair:
            X = tuple(X)
        else:
            X = np.asarray(X, np.float32)
        n = X[0].shape[0] if pair else X.shape[0]
        out = np.empty(n, np.float32)
        for s in range(0, n, PREDICT_ROWS):
            e = min(s + PREDICT_ROWS, n)
            if pair:
                blk = tuple(torch.from_numpy(np.ascontiguousarray(
                    a[s:e], dt)).to(v.device)
                    for a, dt in zip(X, (np.int32, np.float32)))
            else:                      # margins() takes the (d, n) layout
                blk = torch.from_numpy(np.ascontiguousarray(
                    X[s:e])).to(v.device).T
            out[s:e] = margins(v, blk).cpu().numpy()
        return out

    def decision_function(self, X) -> np.ndarray:
        """Signed margins x_i^T w, shape (n_samples,)."""
        return self._margins(X)

    def predict(self, X) -> np.ndarray:
        """Class labels for classifiers, real-valued predictions
        otherwise."""
        m = self._margins(X)
        if not self._classifier:
            return m
        return np.asarray(self.classes_)[(m > 0).astype(int)]

    def score(self, X, y) -> float:
        """Accuracy (classifiers) / R^2 (regressors) — sklearn's
        default."""
        y = np.asarray(y)
        if self._classifier:
            return float(np.mean(self.predict(X) == y))
        resid = y - self.predict(X)
        denom = np.sum((y - y.mean()) ** 2)
        return float(1.0 - np.sum(resid ** 2) / max(denom, 1e-30))

    # -- whole-estimator checkpointing ------------------------------------

    def save(self, path) -> None:
        """Atomic snapshot: hyperparameters + solver state + classes, in
        the reference package's layout.

        ``device`` is not saved (it belongs to the run), and
        ``local_solver`` is written under the reference's name.  Path-
        like params are stored as strings; params that cannot be
        serialized (e.g. callback objects) are dropped with a warning —
        re-attach them after `load`."""
        self._check_fitted()
        from repro_torch.checkpoint import save_tree
        params = {k: (os.fspath(v) if isinstance(v, os.PathLike) else v)
                  for k, v in self.get_params().items() if k != "device"}
        params["local_solver"] = REFERENCE_SOLVER_NAMES[
            params["local_solver"]]
        dropped = sorted(k for k, v in params.items()
                         if not _jsonable(v))
        if dropped:
            warnings.warn(
                f"estimator params not serializable, dropped from the "
                f"checkpoint (re-set them after load): {dropped}",
                UserWarning, stacklevel=2)
        meta = {"estimator": type(self).__name__,
                "params": {k: v for k, v in params.items()
                           if _jsonable(v)},
                "n": int(self.session_.n), "d": int(self.session_.d)}
        if self._classifier and hasattr(self, "classes_"):
            meta["classes"] = np.asarray(self.classes_).tolist()
        save_tree(path, self.session_.state_dict(), meta=meta)

    @classmethod
    def load(cls, path, device="cuda") -> "GLMEstimator":
        """Restore an estimator saved by `save` of either package, to
        predict and resume on `device` (module-level `load` dispatches
        on the stored class name)."""
        from repro_torch.checkpoint import restore_tree
        device = resolve_device(device)
        target = _state_target(path)
        st, meta = restore_tree(path, target)
        klass = _ESTIMATORS.get(meta.get("estimator"), cls)
        if cls is not GLMEstimator and klass is not cls:
            raise ValueError(f"{path} holds a {meta.get('estimator')}, "
                             f"not a {cls.__name__}")
        params = dict(meta.get("params", {}))
        if "local_solver" in params:
            params["local_solver"] = SOLVER_NAMES[params["local_solver"]]
        est = klass(**params, device=device)
        if "classes" in meta:
            est.classes_ = np.asarray(meta["classes"])
        est._resume_state = st
        est.coef_ = np.asarray(st["v"])
        est.intercept_ = 0.0
        est.n_iter_ = int(st["epoch"])
        return est


def _jsonable(v) -> bool:
    return isinstance(v, (int, float, str, bool, type(None)))


def _state_target(path) -> dict[str, np.ndarray]:
    """Shape the restore target from the checkpoint's own manifest."""
    manifest = json.loads(
        (pathlib.Path(path) / "keys.json").read_text())
    return {m["key"]: np.zeros(m["shape"], dtype=m["dtype"])
            for m in manifest}


class LogisticRegression(GLMEstimator):
    """Binary logistic regression — the paper's headline objective.

    Regularization: minimizes ``(1/n) sum log-loss + (lam/2)||w||^2``
    (no intercept).  sklearn equivalence: ``C = 1 / (lam * n)`` with
    ``fit_intercept=False``.
    """

    _objective = "logistic"
    _classifier = True

    def predict_proba(self, X) -> np.ndarray:
        """(n, 2) probabilities, columns ordered like `classes_`."""
        m = self._margins(X)
        p1 = 1.0 / (1.0 + np.exp(-m))
        return np.stack([1.0 - p1, p1], axis=1)

    def predict_log_proba(self, X) -> np.ndarray:
        """Log of `predict_proba`, clipped away from -inf."""
        return np.log(np.maximum(self.predict_proba(X), 1e-30))


class LinearSVC(GLMEstimator):
    """Linear SVM (hinge loss, box-constrained dual)."""

    _objective = "hinge"
    _classifier = True


class Ridge(GLMEstimator):
    """Ridge regression (squared loss); `score` is R^2."""

    _objective = "ridge"
    _classifier = False


_ESTIMATORS = {c.__name__: c
               for c in (LogisticRegression, LinearSVC, Ridge)}


def load(path, device="cuda") -> GLMEstimator:
    """Restore whichever estimator class `path` holds, onto `device`."""
    return GLMEstimator.load(path, device=device)
