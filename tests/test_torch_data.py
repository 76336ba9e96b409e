"""The port's data layer against `repro.data`: synthetic generators are
byte-identical for the same seed (both are numpy), and the CSR
helpers, padding and registry agree exactly."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import cache as jcache                        # noqa: E402
from repro.data import formats as jformats                    # noqa: E402
from repro.data import registry as jreg                       # noqa: E402
from repro.data import synthetic as jsynth                    # noqa: E402
from repro_torch.data import cache as tcache                  # noqa: E402
from repro_torch.data import formats as tformats              # noqa: E402
from repro_torch.data import registry as treg                 # noqa: E402
from repro_torch.data import synthetic as tsynth              # noqa: E402


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 2])
def test_dense_generator_byte_identical(seed):
    for j, t in zip(jsynth.make_dense_classification(n=300, d=28, seed=seed),
                    tsynth.make_dense_classification(n=300, d=28, seed=seed)):
        _same(j, t)


@pytest.mark.parametrize("skew", [0.0, 1.1])
def test_sparse_generator_byte_identical(skew):
    (ji, jv), jy, jd = jsynth.make_sparse_classification(
        n=300, d=500, nnz=40, seed=1, skew=skew)
    (ti, tv), ty, td = tsynth.make_sparse_classification(
        n=300, d=500, nnz=40, seed=1, skew=skew)
    assert jd == td
    for j, t in ((ji, ti), (jv, tv), (jy, ty)):
        _same(j, t)


def test_csr_helpers_match():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 6, size=(200, 5)).astype(np.int32)
    val = rng.normal(size=(200, 5)).astype(np.float32)
    _same(jformats.zero_duplicates(idx, val), tformats.zero_duplicates(idx, val))
    _same(jformats.nonzero_duplicate_rows(idx, val),
          tformats.nonzero_duplicate_rows(idx, val))
    with pytest.raises(ValueError, match="no-duplicate-nonzero"):
        tformats.raise_on_duplicate_nonzeros(idx, val, "rows")
    tformats.raise_on_duplicate_nonzeros(
        idx, tformats.zero_duplicates(idx, val), "rows")


def test_pad_examples_matches():
    rng = np.random.default_rng(1)
    y = rng.normal(size=10).astype(np.float32)
    X = rng.normal(size=(3, 10)).astype(np.float32)
    idx = rng.integers(0, 9, size=(10, 4)).astype(np.int32)
    val = rng.normal(size=(10, 4)).astype(np.float32)
    for j, t in zip(jcache.pad_examples(y, 8, X=X, idx=idx, val=val),
                    tcache.pad_examples(y, 8, X=X, idx=idx, val=val)):
        _same(j, t)


@pytest.mark.parametrize("name", sorted(jreg.REGISTRY))
def test_registry_matches(name, monkeypatch):
    monkeypatch.delenv("REPRO_DATA_DIR", raising=False)
    assert jreg.REGISTRY[name] .__dict__ == treg.REGISTRY[name].__dict__
    j = jreg.get_dataset(name, n=64)
    t = treg.get_dataset(name, n=64)
    assert (j.d, j.sparse) == (t.d, t.sparse)
    for attr in ("y", "X", "idx", "val"):
        if getattr(j, attr) is not None:
            _same(getattr(j, attr), getattr(t, attr))
