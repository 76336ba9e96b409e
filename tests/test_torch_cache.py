"""The port's bucket-tile cache and registry against `repro.data`.

Both packages' `build_cache` on the same arrays must give byte-identical
directories (every file, `filecmp.cmp(shallow=False)`), each package
must open the other's caches with equal `load_arrays` and
`gather_buckets`, and `materialize` must find a cache the reference
built under the same key without rebuilding it.  No tolerance: every
comparison is exact.  Every cache goes under `tmp_path`, and
$REPRO_CACHE_DIR / $REPRO_DATA_DIR are set per test, so nothing is
written to the home directory.
"""
import filecmp
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import cache as jcache                     # noqa: E402
from repro.data import formats as jformats                 # noqa: E402
from repro.data import registry as jreg                    # noqa: E402
from repro_torch.data import cache as tcache               # noqa: E402
from repro_torch.data import registry as treg              # noqa: E402


@pytest.fixture(autouse=True)
def _dirs(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache-root"))
    monkeypatch.delenv("REPRO_DATA_DIR", raising=False)


def _arrays(case):
    """(build_cache kwargs) for each case; n is never a multiple of the
    padding, so every case pads."""
    rng = np.random.default_rng(7)
    if case == "dense":
        X = rng.standard_normal((5, 100)).astype(np.float32)
        y = np.sign(rng.standard_normal(100)).astype(np.float32)
        return dict(X=X, y=y, bucket=8)
    n, nnz, d = 90, 5, 40
    idx = rng.integers(0, d, (n, nnz)).astype(np.int32)
    val = rng.standard_normal((n, nnz)).astype(np.float32)
    y = np.sign(rng.standard_normal(n)).astype(np.float32)
    kw = dict(idx=idx, val=val, y=y, d=d, bucket=8)
    if case == "sparse-nnz8":
        kw["nnz_multiple"] = 8
    if case == "sparse-pods2":
        kw.update(pods=2, pad_multiple=48)
    return kw


CASES = ["dense", "sparse", "sparse-nnz8", "sparse-pods2"]


def _same_dirs(a, b):
    fa = sorted(p.name for p in a.iterdir())
    assert fa == sorted(p.name for p in b.iterdir())
    assert {"meta.json", "tilecrc.bin", "y.bin"} <= set(fa)
    for name in fa:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


def _same(a, b):
    if isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", CASES)
def test_build_cache_byte_identical(case, tmp_path):
    kw = _arrays(case)
    jc = jcache.build_cache(tmp_path / "j", "t", **kw)
    tc = tcache.build_cache(tmp_path / "t", "t", **kw)
    _same_dirs(jc.path, tc.path)
    assert tc.meta == tcache.CacheMeta(**{
        k: getattr(jc.meta, k) for k in jc.meta.__dataclass_fields__})
    if case == "sparse-nnz8":
        assert tc.meta.nnz == 8
    if case == "sparse-pods2":
        assert tc.meta.pods == 2 and tc.meta.n == 96


@pytest.mark.parametrize("case", CASES)
def test_caches_cross_packages(case, tmp_path):
    kw = _arrays(case)
    jc = jcache.build_cache(tmp_path / "j", "t", **kw)
    tc = tcache.build_cache(tmp_path / "t", "t", **kw)
    nb = tc.meta.n_buckets
    bids = np.random.default_rng(1).permutation(nb)[:6].reshape(2, 3)
    for built in (jc.path, tc.path):
        j = jcache.open_cache(built, verify=True)
        t = tcache.open_cache(built, verify=True)
        _same(j.load_arrays(), t.load_arrays())
        _same(j.gather_buckets(bids), t.gather_buckets(bids))
        # gathering into preallocated (staging) buffers gives the same
        specs = t.chunk_specs(bids.shape[:-1], bids.shape[-1])
        bufs = {k: np.full(s, 7, dt) for k, (s, dt) in specs.items()}
        _same(t.gather_buckets(bids, out=bufs), j.gather_buckets(bids))


def test_cache_version_and_magic_guard(tmp_path):
    kw = _arrays("dense")
    tcache.build_cache(tmp_path / "c", "t", **kw)
    doc = json.loads((tmp_path / "c" / "meta.json").read_text())
    doc["version"] = 999
    (tmp_path / "c" / "meta.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="version 999 != supported 3"):
        tcache.open_cache(tmp_path / "c")
    doc["magic"] = "nope"
    (tmp_path / "c" / "meta.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="not a repro-tile-cache"):
        tcache.open_cache(tmp_path / "c")
    assert (tcache.CACHE_MAGIC, tcache.CACHE_VERSION) == \
        (jcache.CACHE_MAGIC, jcache.CACHE_VERSION)


def test_truncated_array_refused(tmp_path):
    tc = tcache.build_cache(tmp_path / "c", "t", **_arrays("sparse"))
    with open(tc.path / "val.bin", "r+b") as f:
        f.truncate(12)
    with pytest.raises(ValueError, match="truncated or corrupt"):
        tcache.open_cache(tc.path)


@pytest.mark.parametrize("case,array", [("dense", "X"), ("sparse", "val"),
                                        ("sparse", "y")])
def test_verify_tiles_names_array_and_tile(case, array, tmp_path):
    tc = tcache.build_cache(tmp_path / "c", "t", **_arrays(case))
    spec_shape, dtype = tc.meta.array_specs()[array]
    tile_bytes = int(np.prod(spec_shape[2:])) * np.dtype(dtype).itemsize
    bad = 5                                  # the global bucket to corrupt
    data = bytearray((tc.path / f"{array}.bin").read_bytes())
    data[bad * tile_bytes + 3] ^= 0xFF
    (tc.path / f"{array}.bin").write_bytes(bytes(data))
    t = tcache.open_cache(tc.path)
    t.verify_tiles(np.arange(bad))           # the tiles before it are fine
    with pytest.raises(tcache.TileCorruptionError) as te:
        t.verify_tiles()
    assert (te.value.array, te.value.tile, te.value.offset) == \
        (array, bad, bad * tile_bytes)
    with pytest.raises(jcache.TileCorruptionError) as je:
        jcache.open_cache(tc.path).verify_tiles()
    assert str(te.value) == str(je.value)
    with pytest.raises(tcache.TileCorruptionError):
        tcache.open_cache(tc.path, verify=True)
    feed = t.feed(verify=True, device="cpu")
    feed.fetch(np.array([0, 1]))
    with pytest.raises(tcache.TileCorruptionError):
        feed.fetch(np.array([0, bad]))


@pytest.mark.parametrize("case", ["dense", "sparse"])
def test_feeds_give_the_gathered_tiles(case, tmp_path):
    tc = tcache.build_cache(tmp_path / "c", "t", **_arrays(case))
    bids = np.array([[3, 0], [5, 1]])
    data, y = tc.gather_buckets(bids)
    arrays, yall = tc.load_arrays()
    if case == "dense":
        af = tcache.ArrayFeed(yall, X=arrays, bucket=8, device="cpu")
    else:
        af = tcache.ArrayFeed(yall, idx=arrays[0], val=arrays[1],
                              d=tc.meta.d, bucket=8, device="cpu")
    for feed in (tc.feed(device="cpu"), af):
        fdata, fy = feed.fetch(bids)
        assert feed.device == torch.device("cpu")
        assert (feed.n, feed.d, feed.bucket, feed.sparse) == \
            (tc.meta.n, tc.meta.d, 8, case == "sparse")
        _same(tuple(t.numpy() for t in fdata) if case == "sparse"
              else fdata.numpy(), data)
        _same(fy.numpy(), y)


def test_feed_concurrent_fetches(tmp_path):
    """The streamed loop fetches from a worker thread: eight threads
    fetching different chunks at once each get their own chunk."""
    tc = tcache.build_cache(tmp_path / "c", "t", **_arrays("sparse"))
    feed = tc.feed(device="cpu")
    nb = tc.meta.n_buckets
    got, errs = {}, []

    def run(k):
        try:
            for r in range(20):
                bids = np.array([(k + r) % nb, (3 * k + r) % nb])
                (idx, val), y = feed.fetch(bids)
                want = tc.gather_buckets(bids)
                _same((idx.numpy(), val.numpy()), want[0])
                got[k] = True
        except Exception as e:                   # reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errs and len(got) == 8


def test_feeds_need_a_gpu_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    tc = tcache.build_cache(tmp_path / "c", "t", **_arrays("dense"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tc.feed(), lambda: tcache.TileFeed(tc),
                 lambda: tcache.ArrayFeed(np.ones(16, np.float32),
                                          X=np.ones((2, 16), np.float32)),
                 lambda: tcache.PinnedStaging()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def _materialize_both(**kw):
    j = jreg.materialize(**kw)
    t = treg.materialize(**kw)
    return j, t


def test_materialize_finds_the_reference_cache(tmp_path):
    kw = dict(name="synthetic-sparse", bucket=8, pods=2, n=256, d=64,
              pad_multiple=64)
    j = jreg.materialize(**kw)
    stamp = (j.path / "meta.json").stat().st_mtime_ns
    t = treg.materialize(**kw)
    assert t.path == j.path
    assert (t.path / "meta.json").stat().st_mtime_ns == stamp
    assert treg.cache_root() == jreg.cache_root() == tmp_path / "cache-root"
    # and a fresh root: the port builds the same bytes under the same key
    t2 = treg.materialize(cache_dir=tmp_path / "other", **kw)
    assert t2.path.name == j.path.name
    _same_dirs(t2.path, j.path)


def test_cache_root_default_is_the_references(monkeypatch):
    monkeypatch.delenv("REPRO_CACHE_DIR")
    assert treg.cache_root() == jreg.cache_root()
    assert treg.cache_root().parts[-2:] == (".cache", "repro-glm")
    assert treg.cache_root("x") == jreg.cache_root("x")


@pytest.mark.parametrize("tear", ["no-meta", "stale-version", "truncated"])
def test_torn_cache_is_quarantined_and_rebuilt(tear, tmp_path):
    kw = dict(name="synthetic-dense", bucket=8, n=128, d=16)
    good = treg.materialize(**kw)
    want = {p.name: p.read_bytes() for p in good.path.iterdir()}
    if tear == "no-meta":
        (good.path / "meta.json").unlink()
    elif tear == "stale-version":
        doc = json.loads((good.path / "meta.json").read_text())
        doc["version"] = 2
        (good.path / "meta.json").write_text(json.dumps(doc))
    else:
        with open(good.path / "X.bin", "r+b") as f:
            f.truncate(100)
    again = treg.materialize(**kw)
    assert again.path == good.path
    assert {p.name: p.read_bytes() for p in again.path.iterdir()} == want
    quarantine = good.path.parent / f".quarantine.{good.path.name}"
    assert quarantine.is_dir()
    assert not list(good.path.parent.glob(f".{good.path.name}.tmp-*"))


def _raw_files(tmp_path):
    tmp_path.mkdir()
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 64, (40, 5)).astype(np.int32)
    val = rng.standard_normal((40, 5)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], 40).astype(np.float32)
    X = rng.standard_normal((6, 40)).astype(np.float32)
    (tmp_path / "criteo-kaggle-sub.svm").write_text(
        jformats.dump_svmlight(idx, val, y))
    (tmp_path / "higgs.csv").write_text(jformats.dump_csv(X, y))
    (tmp_path / "epsilon.libsvm").write_text(
        jformats.dump_svmlight(idx, val, y))
    return tmp_path


@pytest.mark.parametrize("name,n", [("criteo-kaggle-sub", None),
                                    ("higgs", None), ("higgs", 33),
                                    ("epsilon", 20)])
def test_raw_ingest_matches_reference(name, n, tmp_path, monkeypatch):
    raw = _raw_files(tmp_path / "raw")
    j = jreg.get_dataset(name, n=n, data_dir=raw)
    t = treg.get_dataset(name, n=n, data_dir=raw)
    assert t.provenance == j.provenance and t.provenance.startswith("file:")
    assert (t.d, t.sparse, t.n) == (j.d, j.sparse, j.n)
    for attr in ("y", "X", "idx", "val"):
        if getattr(j, attr) is not None:
            _same(getattr(j, attr), getattr(t, attr))
    # the same through $REPRO_DATA_DIR, and into identical caches
    monkeypatch.setenv("REPRO_DATA_DIR", str(raw))
    jc, tc = _materialize_both(name=name, n=n, bucket=8,
                               cache_dir=tmp_path / "c",
                               nnz_multiple=8 if j.sparse else None)
    assert "-raw" in tc.path.name and tc.path == jc.path
    jc2 = jreg.materialize(name, tmp_path / "c2", n=n, bucket=8,
                           nnz_multiple=8 if j.sparse else None)
    _same_dirs(jc2.path, tc.path)


def test_raw_csv_for_a_sparse_spec_refused(tmp_path):
    (tmp_path / "webspam.csv").write_text("1,0.5\n")
    with pytest.raises(ValueError, match="CSV ingest is dense-only"):
        treg.get_dataset("webspam", data_dir=tmp_path)
