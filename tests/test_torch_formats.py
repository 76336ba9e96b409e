"""The port's svmlight/CSV ingestion against `repro.data.formats`.

Both are numpy, so the same text must give byte-identical arrays (same
dtypes, shapes and bits) and the same arrays character-identical text;
error cases raise the same exception with the same message.  The
round-trip properties run under hypothesis with `derandomize=True`, so
they draw the same examples on every run.  Tolerance: none anywhere —
every comparison is exact.
"""
import io
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st   # noqa: E402

from repro.data import formats as jformats                 # noqa: E402
from repro_torch.data import formats as tformats           # noqa: E402

REF_TEXT = ("# comment line\n"
            "+1 qid:3 1:0.5 4:-2 7:1e-3\n"
            "-1 2:1.25\n"
            "0.5   # empty row with float label\n")


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


def _both(fn, *args, **kw):
    return (getattr(jformats, fn)(*args, **kw),
            getattr(tformats, fn)(*args, **kw))


@pytest.mark.parametrize("kw", [{}, {"zero_based": True}, {"nnz": 6},
                                {"d": 12}])
def test_svmlight_parses_reference_text(kw):
    j, t = _both("parse_svmlight", REF_TEXT, **kw)
    _same(j, t)
    (idx, val), y, d = t
    np.testing.assert_array_equal(y, [1.0, -1.0, 0.5])
    assert d == kw.get("d", 8 if kw.get("zero_based") else 7)


def test_svmlight_sources_path_file_and_lines(tmp_path):
    f = tmp_path / "a.svm"
    f.write_text(REF_TEXT)
    want = jformats.parse_svmlight(REF_TEXT)
    for src in (f, str(f), io.StringIO(REF_TEXT), REF_TEXT.splitlines()):
        _same(want, tformats.parse_svmlight(src))


@pytest.mark.parametrize("text,kw,exc", [
    ("notanumber 1:2\n", {}, ValueError),            # bad label
    ("1 0:2\n", {}, ValueError),                     # 0 is invalid 1-based
    ("1 1:1 2:2\n", {"nnz": 1}, ValueError),         # exceeds nnz
    ("1 5:1\n", {"d": 3}, ValueError),               # id out of range for d
    ("1 2:x\n", {}, ValueError),                     # bad value
    ("no/such/dir/data.svm", {}, FileNotFoundError),  # a mistyped path
])
def test_svmlight_errors_match(text, kw, exc):
    with pytest.raises(exc) as je:
        jformats.parse_svmlight(text, **kw)
    with pytest.raises(exc) as te:
        tformats.parse_svmlight(text, **kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("text", [
    "label,f1,f2\n1,0.5,-1\n-1,2,3\n",               # header skipped
    "1,0.5,-1\n\n-1,2,3e-7\n",                       # blank line
    "label,f1\n",                                    # no rows
])
def test_csv_parses_like_reference(text):
    j, t = _both("parse_csv", text)
    _same(j, t)


def test_empty_text_is_a_missing_path_in_both():
    for fn in ("parse_csv", "parse_svmlight"):
        with pytest.raises(FileNotFoundError) as je:
            getattr(jformats, fn)("")
        with pytest.raises(FileNotFoundError) as te:
            getattr(tformats, fn)("")
        assert str(te.value) == str(je.value)


def test_csv_label_col_and_field_count_error():
    _same(*_both("parse_csv", "0.5,1,-1\n2,-1,3\n", label_col=1))
    with pytest.raises(ValueError) as je:
        jformats.parse_csv("1,2,3\n1,2\n")
    with pytest.raises(ValueError) as te:
        tformats.parse_csv("1,2,3\n1,2\n")
    assert str(te.value) == str(je.value)


def _compacted(idx, val):
    """What svmlight text keeps of padded-CSR rows: each row's nonzero
    entries, left-aligned in order, zero-padded."""
    idx2, val2 = np.zeros_like(idx), np.zeros_like(val)
    for i in range(val.shape[0]):
        keep = val[i] != 0
        idx2[i, :keep.sum()] = idx[i][keep]
        val2[i, :keep.sum()] = val[i][keep]
    return idx2, val2


def _seeded(n=64, nnz=5, d=100, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, nnz)).astype(np.int32)
    val = rng.standard_normal((n, nnz)).astype(np.float32)
    val[::7, 0] = 0.0                                # omitted on dump
    val[1, 1] = np.float32(1e-40)                    # subnormal
    val[2, 2] = np.float32(3.4e38)
    y = rng.standard_normal(n).astype(np.float32)
    return idx, val, y


@pytest.mark.parametrize("zero_based", [False, True])
def test_dump_svmlight_identical_text(zero_based):
    idx, val, y = _seeded()
    j, t = _both("dump_svmlight", idx, val, y, zero_based=zero_based)
    assert t == j
    got, y2, _ = tformats.parse_svmlight(t, d=100, nnz=5,
                                         zero_based=zero_based)
    _same(got, _compacted(idx, val))
    _same(y2, y)


def test_dump_csv_identical_text():
    _, val, y = _seeded()
    X = np.ascontiguousarray(val.T)
    X[0, 0] = -0.0
    j, t = _both("dump_csv", X, y)
    assert t == j
    _same(tformats.parse_csv(t), (X, y))
    assert tformats.dump_csv(np.zeros((3, 0), np.float32),
                             np.zeros(0, np.float32)) == ""


def test_to_dense_accumulates_duplicates():
    idx = np.asarray([[0, 0], [1, 2]], np.int32)
    val = np.asarray([[1.0, 2.0], [3.0, 4.0]], np.float32)
    j, t = _both("to_dense", idx, val, 3)
    _same(j, t)
    np.testing.assert_array_equal(t[:, 0], [3.0, 0.0, 0.0])


F32 = st.floats(width=32, allow_nan=False, allow_infinity=False)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.lists(st.lists(st.tuples(st.integers(0, 999), F32),
                         max_size=8, unique_by=lambda t: t[0]),
                min_size=1, max_size=16),
       st.lists(F32, min_size=16, max_size=16))
def test_svmlight_roundtrip_property(rows, labels):
    n = len(rows)
    nnz = max(max(len(r) for r in rows), 1)
    idx = np.zeros((n, nnz), np.int32)
    val = np.zeros((n, nnz), np.float32)
    for i, r in enumerate(rows):
        for k, (j, x) in enumerate(r):
            idx[i, k], val[i, k] = j, x
    y = np.asarray(labels[:n], np.float32)
    text = tformats.dump_svmlight(idx, val, y)
    assert text == jformats.dump_svmlight(idx, val, y)
    # an entry of value 0 (or -0) is not written, so the row reads back
    # compacted; every nonzero keeps its id, value bits and order
    got, y2, _ = tformats.parse_svmlight(text, d=1000, nnz=nnz)
    _same(y2, y)
    _same(got, _compacted(idx, val))
    _same(got, jformats.parse_svmlight(text, d=1000, nnz=nnz)[0])


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.integers(1, 6), st.integers(1, 12), st.data())
def test_csv_roundtrip_property(d, n, data):
    X = np.asarray(data.draw(st.lists(F32, min_size=d * n,
                                      max_size=d * n)),
                   np.float32).reshape(d, n)
    y = np.asarray(data.draw(st.lists(F32, min_size=n, max_size=n)),
                   np.float32)
    text = tformats.dump_csv(X, y)
    assert text == jformats.dump_csv(X, y)
    _same(tformats.parse_csv(text), (X, y))


def test_module_has_every_reference_export():
    assert set(jformats.__all__) <= set(dir(tformats))
    assert pathlib.Path(tformats.__file__).parent.name == "data"
