"""Out-of-core training and serving: the port's streamed path against its
resident path and against the reference's streamed path.

Contracts and their tolerances:
  * port streamed == port resident, BITWISE in alpha and v after every
    epoch (`torch.equal`), dense and sparse, pods x lanes 2 x 2, chunks
    1, 2 and 4, from arrays, a registry name with ``cache_dir`` and a
    `TileCache` — each chunk's solver call gets the resident loop's
    bytes; `TileFeed` and `ArrayFeed` over the same rows likewise;
  * port streamed vs the reference's streamed epochs (its XLA route on
    the CPU, planner off) over 3 epochs, at 2 and 4 chunks, and at 1 and
    4 chunks on 2 x 4 workers where 4 chunks stall the gap: rtol 1e-4,
    atol 1e-5, the gaps within rel 1e-3 after each epoch, the
    tolerances tests/test_torch_session.py holds `Session` to;
  * the streamed gap (summed per group of 256 buckets) within rel 1e-3
    (abs 1e-6) of the resident gap, as the reference holds its own;
  * `glm_predict_streamed` equal to `glm_predict_batch` elementwise,
    and to the reference's labels wherever |margin| > 1e-4.
Every cache goes under `tmp_path` ($REPRO_CACHE_DIR is set per test).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import LogisticRegression as JLogReg          # noqa: E402
from repro.api import Session as JSession                    # noqa: E402
from repro.core.config import EngineConfig as JConfig        # noqa: E402
from repro.data import registry as jreg                      # noqa: E402
from repro.launch.serve import glm_predict_streamed as jpredict  # noqa: E402
from repro_torch.api import (LinearSVC, LogisticRegression,   # noqa: E402
                             Session, load)
from repro_torch.api.deprecation import (                    # noqa: E402
    ReproDeprecationWarning, reset_deprecation_registry)
from repro_torch.api.session import _pad_multiple            # noqa: E402
from repro_torch.core import engine                          # noqa: E402
from repro_torch.core.config import EngineConfig             # noqa: E402
from repro_torch.core.objectives import get_objective        # noqa: E402
from repro_torch.data import cache as tcache                 # noqa: E402
from repro_torch.data import registry as treg                # noqa: E402
from repro_torch.launch import serve                         # noqa: E402

CPU = dict(device="cpu")
TOPO = dict(pods=2, lanes=2, bucket=8, partition="hierarchical",
            deterministic=True)
NAMES = {"dense": "synthetic-dense", "sparse": "synthetic-sparse"}
SHAPE = dict(n=500, d=64)        # pads to 512 at every chunk count below


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache-root"))
    monkeypatch.delenv("REPRO_DATA_DIR", raising=False)
    monkeypatch.setenv("REPRO_PLAN", "off")
    monkeypatch.delenv("REPRO_LOCAL_SOLVER", raising=False)


def _cfg(chunks=2, **kw):
    return EngineConfig.make(chunks=chunks, **TOPO, **kw)


def _arrays(kind):
    ds = treg.get_dataset(NAMES[kind], **SHAPE)
    if kind == "dense":
        return (ds.X, ds.y), {}
    return ((ds.idx, ds.val), ds.y), {"d": ds.d}


def _cache(kind, tmp_path, chunks=2, **kw):
    return treg.materialize(
        NAMES[kind], tmp_path / "c", bucket=8, pods=2, **SHAPE,
        pad_multiple=_pad_multiple(_cfg(chunks), 8), **kw)


def _pair(kind, source, chunks, tmp_path):
    """(resident, streamed) sessions over the same data and config."""
    kw = dict(cfg=_cfg(chunks), objective="ridge", **CPU)
    if source == "arrays":
        data, dkw = _arrays(kind)
        return (Session(data, **dkw, **kw),
                Session(data, streamed=True, **dkw, **kw))
    if source == "registry":
        kw.update(SHAPE, cache_dir=tmp_path / "reg")
        return (Session(NAMES[kind], **kw),
                Session(NAMES[kind], streamed=True, **kw))
    cache = _cache(kind, tmp_path, chunks)
    return Session(cache, **kw), Session(cache, streamed=True, **kw)


def _equal(a, b):
    assert torch.equal(a.alpha, b.alpha) and torch.equal(a.v, b.v)


@pytest.mark.parametrize("source", ["arrays", "registry", "cache"])
@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_streamed_equals_resident_bitwise(kind, chunks, source, tmp_path):
    mem, st = _pair(kind, source, chunks, tmp_path)
    assert st.streamed and st.feed is not None and not hasattr(st, "X")
    assert (st.n, st.d, st.lam, st.n_examples) == \
        (mem.n, mem.d, mem.lam, mem.n_examples)
    for _ in range(3):
        mem.epoch()
        st.epoch()
        _equal(mem, st)
    assert float(torch.abs(st.v).max()) > 0


def test_registry_streamed_equals_plain_resident(tmp_path):
    """A cached, streamed run equals the resident run that never saw a
    cache (same padding, same lam rescale)."""
    kw = dict(cfg=_cfg(2), **SHAPE, **CPU)
    plain = Session("synthetic-dense", **kw)
    st = Session("synthetic-dense", streamed=True, cache_dir=tmp_path, **kw)
    for _ in range(2):
        plain.epoch()
        st.epoch()
    _equal(plain, st)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_tile_feed_equals_array_feed(kind, tmp_path):
    cache = _cache(kind, tmp_path)
    arrays, y = cache.load_arrays()
    if kind == "dense":
        af = tcache.ArrayFeed(y, X=arrays, bucket=8, **CPU)
    else:
        af = tcache.ArrayFeed(y, idx=arrays[0], val=arrays[1],
                              d=cache.meta.d, bucket=8, **CPU)
    plan = Session(cache, cfg=_cfg(), streamed=True, **CPU).plan
    outs = []
    for feed in (cache.feed(**CPU), af):
        ep = engine.make_streamed_epoch(get_objective("logistic"), _cfg(),
                                        plan, feed, lam=1e-2, **CPU)
        a = torch.zeros(cache.meta.n)
        v = torch.zeros(cache.meta.d)
        for e in range(2):
            a, v = ep(a, v, e)
        outs.append((a, v))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def _streamed_both(name, topo, chunks, tmp_path, objective, **shape):
    """3 streamed epochs of both packages on the SAME cache directory
    (the reference builds it; the port finds it under the same key),
    the port held to the reference after each; -> (ref gaps, port gaps)
    after each epoch, each pair within rel 1e-3."""
    kw = dict(objective=objective, streamed=True, cache_dir=tmp_path, **shape)
    js = JSession(name, cfg=JConfig.make(chunks=chunks, **topo), **kw)
    ts = Session(name, cfg=EngineConfig.make(chunks=chunks, **topo),
                 **kw, **CPU)
    assert ts.cache.path == js.cache.path
    gaps = ([], [])
    for _ in range(3):
        js.epoch()
        ts.epoch()
        np.testing.assert_allclose(ts.alpha.numpy(), np.asarray(js.alpha),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v),
                                   rtol=1e-4, atol=1e-5)
        jg, tg = js.gap(), ts.gap()
        assert abs(tg - jg) <= 1e-3 * abs(jg), (tg, jg)
        gaps[0].append(jg)
        gaps[1].append(tg)
    return gaps


@pytest.mark.parametrize("chunks", [2, 4])
@pytest.mark.parametrize("objective", ["ridge", "hinge", "logistic"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_streamed_matches_reference(kind, objective, chunks, tmp_path):
    _streamed_both(NAMES[kind], TOPO, chunks, tmp_path, objective, **SHAPE)


#: 2 x 4 workers, bucket 16, on the HIGGS stand-in at n 8,192 (512
#: buckets): a size at which 4 chunks hold the hierarchical logistic
#: gap up, as 2 x 16 workers do at full HIGGS size on the card
STALL_TOPO = dict(pods=2, lanes=4, bucket=16, partition="hierarchical",
                  deterministic=True)


def _chunked_stall(topo, chunks, tmp_path):
    """After 3 epochs both packages' gaps at `chunks` stay above 10x
    their gaps at 1 chunk, and the port stays within the reference's
    tolerances after every epoch of both runs."""
    one, many = (_streamed_both("higgs", topo, c, tmp_path, "logistic",
                                n=8192) for c in (1, chunks))
    print(f"gaps after epochs 1-3, reference / port: 1 chunk {one[0]} / "
          f"{one[1]}; {chunks} chunks {many[0]} / {many[1]}")
    for k in (0, 1):                      # the reference, then the port
        assert many[k][-1] > 10 * one[k][-1], (one[k], many[k])
    return many


def test_four_chunks_stall_the_gap_in_both_packages(tmp_path):
    """The port follows the reference where 4 chunks stall the gap."""
    _chunked_stall(STALL_TOPO, 4, tmp_path)


def test_eight_chunks_at_bucket_8_stall_the_gap_in_both_packages(tmp_path):
    """The geometry the planner's search picks for HIGGS on 2 pods (B 8,
    8 chunks) stalls the gap in the reference as in the port, the gap
    rising after the first epoch as it does on the card."""
    many = _chunked_stall(dict(STALL_TOPO, bucket=8), 8, tmp_path)
    for gaps in many:
        assert gaps[1] > gaps[0], many


def test_bucket_mismatch_guard(tmp_path):
    cache = _cache("dense", tmp_path)
    bad = EngineConfig.make(bucket=16)
    with pytest.raises(ValueError, match="cache bucket=8"):
        Session(cache, cfg=bad, streamed=True, **CPU)
    with pytest.raises(ValueError, match="feed bucket=8"):
        Session(cache.feed(**CPU), cfg=bad, **CPU)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_streamed_gap_close_to_resident(kind, tmp_path):
    mem, st = _pair(kind, "cache", 2, tmp_path)
    arrays, y = st.cache.load_arrays()
    feed_only = Session(tcache.ArrayFeed(
        y, bucket=8, **CPU,
        **({"X": arrays} if kind == "dense"
           else {"idx": arrays[0], "val": arrays[1], "d": st.d})),
        cfg=_cfg(2), objective="ridge", lam=st.lam, **CPU)
    for s in (mem, st, feed_only):
        s.fit(max_epochs=3, tol=0.0)
    _equal(mem, feed_only)
    for s in (st, feed_only):
        assert s.gap() == pytest.approx(mem.gap(), rel=1e-3, abs=1e-6)
        assert s.primal() == pytest.approx(mem.primal(), rel=1e-3)


# -- the front door -------------------------------------------------------------

EST = dict(bucket=8, pods=2, lanes=2, chunks=2, partition="hierarchical",
           deterministic=True, tol=0.0, **CPU)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_estimator_streamed_equals_resident(kind):
    (data, y), dkw = _arrays(kind)
    X = data.T if kind == "dense" else data
    kw = dict(EST, max_epochs=3, n_features=dkw.get("d"))
    mem = LogisticRegression(**kw).fit(X, y)
    st = LogisticRegression(streamed=True, **kw).fit(X, y)
    assert st.session_.streamed and not mem.session_.streamed
    assert np.array_equal(st.coef_, mem.coef_)
    assert torch.equal(st.session_.alpha, mem.session_.alpha)
    assert np.array_equal(st.predict(X), mem.predict(X))


def test_estimator_sources_agree(tmp_path):
    """A registry name with cache_dir (resident and streamed), a
    TileCache, and a ChunkFeed over it: one model, bit for bit (the
    registry's default shape, which a name alone resolves to)."""
    name = NAMES["dense"]
    cache = treg.materialize(name, tmp_path, bucket=8, pods=2,
                             pad_multiple=_pad_multiple(_cfg(2), 8))
    fits = []
    for X, extra in ((name, {"cache_dir": tmp_path}),
                     (name, {"cache_dir": tmp_path, "streamed": True}),
                     (cache, {}), (cache, {"streamed": True}),
                     (cache.feed(**CPU), {})):
        est = LinearSVC(max_epochs=1, **EST, **extra)
        fits.append(est.fit(X))
        assert est.session_.n_examples == cache.meta.n_examples
    for est in fits[1:]:
        assert np.array_equal(est.coef_, fits[0].coef_)
        assert est.classes_.tolist() == [-1.0, 1.0]
    assert fits[1].session_.streamed and fits[4].session_.streamed
    with pytest.raises(ValueError, match="pass y=None"):
        LinearSVC(**EST).fit(cache, np.ones(3))


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_streamed_estimator_resume_is_bitwise(kind, tmp_path):
    cache = _cache(kind, tmp_path)
    kw = dict(EST, streamed=True)
    straight = LogisticRegression(max_epochs=6, **kw).fit(cache)
    half = LogisticRegression(max_epochs=3, **kw).fit(cache)
    half.save(tmp_path / "ckpt")
    resumed = load(tmp_path / "ckpt", **CPU)
    assert resumed.streamed and resumed.n_iter_ == 3
    resumed.set_params(max_epochs=6).fit(cache)
    assert resumed.n_iter_ == 6
    assert np.array_equal(resumed.coef_, straight.coef_)
    assert torch.equal(resumed.session_.alpha, straight.session_.alpha)


def test_streamed_trainer_and_fit_dataset(tmp_path):
    from repro_torch.core import StreamedGLMTrainer, fit_dataset
    reset_deprecation_registry()
    kw = dict(cfg=_cfg(2), cache_dir=tmp_path, **SHAPE, max_epochs=3,
              tol=0.0, return_trainer=True, **CPU)
    with pytest.warns(ReproDeprecationWarning, match="fit_dataset"):
        mem, mem_tr = fit_dataset(NAMES["sparse"], streamed=False, **kw)
    st, st_tr = fit_dataset(NAMES["sparse"], streamed=True, **kw)
    assert st_tr.streamed and not mem_tr.streamed
    assert np.array_equal(mem.alpha, st.alpha)
    assert np.array_equal(mem.v, st.v)
    assert st.final_gap == pytest.approx(mem.final_gap, rel=1e-3, abs=1e-6)
    # nnz_multiple shapes the cache a streamed run trains on
    _, z_tr = fit_dataset(NAMES["sparse"], streamed=True, nnz_multiple=16,
                          **kw)
    assert z_tr.cache.meta.nnz == 16 and "-z16" in z_tr.cache.path.name
    with pytest.warns(ReproDeprecationWarning, match="StreamedGLMTrainer"):
        tr = StreamedGLMTrainer(z_tr.cache, cfg=_cfg(2), **CPU)
    res = tr.fit(max_epochs=2, tol=0.0)
    assert res.epochs == 2 and tr.streamed and tr.epoch == 2


# -- serving ----------------------------------------------------------------

def _fitted(kind, tmp_path):
    cache = _cache(kind, tmp_path)
    est = LogisticRegression(max_epochs=3, streamed=True, **EST).fit(cache)
    return est, cache


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_glm_predict_streamed(kind, tmp_path):
    est, cache = _fitted(kind, tmp_path)
    arrays, _ = cache.load_arrays()
    # writable copies: the sparse arrays are views of the read-only mmap
    rows = arrays.T if kind == "dense" else tuple(np.array(a)
                                                  for a in arrays)
    n = cache.meta.n_examples
    batch = serve.glm_predict_batch(est, rows, batch=64)[:n]
    # 8 buckets of 8 rows = the batch's 64 rows: the same products
    got = serve.glm_predict_streamed(est, cache, gbuckets=8)
    assert got.shape == (n,) and np.array_equal(got, batch)
    mg = serve.glm_predict_streamed(est, cache, gbuckets=8,
                                    return_margins=True, verify_tiles=True)
    assert np.array_equal(mg, est.decision_function(rows)[:n])
    # the reference's streamed labels from the same coefficients
    jest = JLogReg(bucket=8)
    jest.coef_, jest.classes_ = est.coef_, est.classes_
    jcache = jreg.materialize(NAMES[kind], tmp_path / "c", bucket=8,
                              pods=2, **SHAPE,
                              pad_multiple=_pad_multiple(_cfg(2), 8))
    want = np.asarray(jpredict(jest, jcache, gbuckets=8))
    sure = np.abs(mg) > 1e-4
    assert sure.mean() > 0.9
    assert np.array_equal(got[sure], want[sure])


def test_glm_predict_streamed_refuses_corrupt_tiles(tmp_path):
    est, cache = _fitted("dense", tmp_path)
    data = bytearray((cache.path / "X.bin").read_bytes())
    data[-5] ^= 0xFF
    (cache.path / "X.bin").write_bytes(bytes(data))
    bad = tcache.open_cache(cache.path)
    serve.glm_predict_streamed(est, bad, gbuckets=8)   # unchecked: serves
    with pytest.raises(tcache.TileCorruptionError, match="'X'"):
        serve.glm_predict_streamed(est, bad, gbuckets=8, verify_tiles=True)


def test_serve_glm_fit_and_checkpoint(tmp_path, capsys):
    preds, acc = serve.serve_glm("synthetic-dense", epochs=1, batch=64,
                                 cache_dir=tmp_path, **CPU)
    n = treg.get_spec("synthetic-dense").sub_n
    assert preds.shape == (n,) and acc > 0.6
    assert "glm-serve synthetic-dense" in capsys.readouterr().out
    est = LogisticRegression(max_epochs=1, bucket=8, lanes=4,
                             partition="dynamic", **CPU)
    est.fit("synthetic-dense")
    est.save(tmp_path / "ckpt")
    p2, acc2 = serve.serve_glm("synthetic-dense", ckpt=tmp_path / "ckpt",
                               cache_dir=tmp_path, verbose=False, **CPU)
    assert p2.shape == (n,) and acc2 == pytest.approx(acc, abs=0.05)


def test_serve_cli_glm(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--glm", "synthetic-sparse", "--glm-epochs", "1",
        "--glm-batch", "256", "--glm-cache-dir", str(tmp_path),
        "--device", "cpu"])
    serve.main()
    assert "glm-serve synthetic-sparse: 2048 rows" in capsys.readouterr().out


# -- failures reach the caller ---------------------------------------------------

class _Failing:
    """An ArrayFeed whose second fetch fails."""

    def __init__(self, inner, fail_at=1, wrong=None):
        self.inner, self.fail_at, self.calls, self.wrong = inner, fail_at, 0, wrong
        for k in ("n", "d", "bucket", "sparse", "device"):
            setattr(self, k, getattr(inner, k))

    def fetch(self, bids):
        self.calls += 1
        if self.calls > self.fail_at:
            raise OSError("tile read failed")
        data, y = self.inner.fetch(bids)
        if self.wrong == "numpy":
            return data.numpy(), y
        return data, y


def _dense_feed():
    (X, y), _ = _arrays("dense")
    return tcache.ArrayFeed(np.concatenate([y, y[:12]]),
                            X=np.concatenate([X, X[:, :12]], axis=1),
                            bucket=8, **CPU)


def test_fetch_error_reaches_the_caller_and_state_survives():
    s = Session(_Failing(_dense_feed()), cfg=_cfg(4), **CPU)
    a0, v0 = s.alpha.clone(), s.v.clone()
    with pytest.raises(OSError, match="tile read failed"):
        s.epoch()
    assert torch.equal(s.alpha, a0) and torch.equal(s.v, v0)
    assert s.epochs_done == 0


def test_feed_must_hand_tensors_on_the_step_device():
    s = Session(_Failing(_dense_feed(), fail_at=99, wrong="numpy"),
                cfg=_cfg(2), **CPU)
    with pytest.raises(ValueError, match="handed chunk 0"):
        s.epoch()
    feed = _dense_feed()
    feed.device = torch.device("cuda")
    with pytest.raises(ValueError, match="lands on|land on"):
        Session(feed, cfg=_cfg(2), **CPU)
    with pytest.raises(ValueError, match="land on"):
        engine.make_streamed_epoch(get_objective("ridge"), _cfg(2),
                                   Session(_dense_feed(), cfg=_cfg(2),
                                           **CPU).plan, feed, lam=1e-3,
                                   **CPU)


def test_journal_threads_into_the_streamed_loop(tmp_path):
    """`make_streamed_epoch(journal=)` gives the journal-free epoch's
    bits and leaves an inflight record at chunk 1 of 2; a later call of
    the same epoch resumes there and runs one chunk."""
    from repro_torch.resilience import EpochJournal
    s = Session(_dense_feed(), cfg=_cfg(2), **CPU)
    args = (get_objective("ridge"), _cfg(2), s.plan, s.feed)
    plain = engine.make_streamed_epoch(*args, lam=1e-3, **CPU)
    journaled = engine.make_streamed_epoch(
        *args, lam=1e-3, journal=EpochJournal(tmp_path), **CPU)
    want = plain(s.alpha, s.v, 0)
    for chunks in (2, 1):
        stats = {}
        got = journaled(s.alpha, s.v, 0, stats=stats)
        assert stats["chunks"] == chunks
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        meta = (tmp_path / "inflight" / "meta.json").read_text()
        assert json.loads(meta) == {"epoch": 0, "chunk": 1}


def test_streamed_entry_points_need_a_gpu(tmp_path, monkeypatch):
    cache = _cache("dense", tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: Session(cache, streamed=True),
            lambda: Session("synthetic-dense", streamed=True,
                            cache_dir=tmp_path),
            lambda: engine.make_streamed_epoch(
                get_objective("ridge"), _cfg(2), None, None, lam=1e-3),
            lambda: LogisticRegression(streamed=True).fit(cache),
            lambda: serve.serve_glm("synthetic-dense", cache_dir=tmp_path)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
