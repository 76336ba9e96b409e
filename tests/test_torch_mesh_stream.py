"""The mesh-streamed path of the port, on a stacked mesh on the CPU.

Streamed-from-host training on a (pod, data, model) mesh is bitwise the
resident mesh training (`launch.glm.make_dense_epoch` /
`make_sparse_epoch`), and the sim's streamed loop driven by the same
`MeshSchedule`, for dense example-parallel, dense tensor-parallel with
pods, sparse replicated and sparse feature-sharded (slice-compacted)
data, and through `Session(..., streamed=True, mesh=)`.  The integer and
byte parts are held to the reference directly: `MeshSchedule` integer
for integer, `compact_slice_rows` and `TileCache.slice_gather` byte for
byte.  The cases mirror the reference's `tests/test_mesh_stream.py` by
name (there they run on 8 forced host devices; here the mesh is stacked
on the CPU, so no subprocess is needed).  About 16 s on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as jengine                      # noqa: E402
from repro.data import cache as jcache                        # noqa: E402
from repro_torch.api import Session                           # noqa: E402
from repro_torch.core import engine                           # noqa: E402
from repro_torch.core.config import EngineConfig              # noqa: E402
from repro_torch.core.objectives import LOGISTIC, RIDGE       # noqa: E402
from repro_torch.data import registry                         # noqa: E402
from repro_torch.data.cache import ArrayFeed, compact_slice_rows  # noqa: E402
from repro_torch.data.synthetic import (make_dense_classification,  # noqa: E402
                                        make_sparse_classification)
from repro_torch.launch import glm                            # noqa: E402
from repro_torch.launch.glm import (GLMScale, make_dense_epoch,  # noqa: E402
                                    make_sparse_epoch,
                                    make_streamed_epoch_mesh)
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,  # noqa: E402
                                     mesh_chips)

EPOCHS = 2


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_PLAN", "off")
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("REPRO_LOCAL_SOLVER", raising=False)


def _cols(lay: np.ndarray, B: int) -> torch.Tensor:
    """Global example ids of a (pods, lanes, per_lane) bucket layout."""
    return torch.from_numpy((lay.astype(np.int64)[..., None] * B
                             + np.arange(B)).reshape(-1))


def _dense(n=1024, d=64, seed=4):
    X, y = make_dense_classification(n=n, d=d, seed=seed)
    return X, y


def _sparse(n=1024, d=64, nnz=8, seed=2):
    (idx, val), y, _ = make_sparse_classification(n=n, d=d, nnz=nnz,
                                                  seed=seed)
    return idx, val, y


def _resident(scale, mesh, arrays, epochs=EPOCHS, obj=LOGISTIC):
    """The resident mesh's (alpha, v) after each epoch, alpha in its
    re-dealt layout."""
    make = make_sparse_epoch if scale.kind == "sparse" else make_dense_epoch
    ep = make(scale, mesh, obj)
    st = (*arrays, np.zeros(scale.n, np.float32),
          np.zeros(scale.d, np.float32))
    out = []
    for e in range(epochs):
        st = ep(*st, e)
        out.append((st[-2], st[-1]))
    return out


def _assert_streamed_equals_resident(epoch_m, resident, B, epochs=EPOCHS):
    n, d = resident[0][0].shape[0], resident[0][1].shape[0]
    a, v = torch.zeros(n), torch.zeros(d)
    for e in range(epochs):
        a, v = epoch_m(a, v, e)
        ar, vr = resident[e]
        assert torch.equal(v, vr), f"v after epoch {e}"
        assert torch.equal(a[_cols(epoch_m.schedule.layout(e), B)], ar), \
            f"alpha after epoch {e}"
    assert float(v.abs().max()) > 0                    # actually trained
    return a, v


# -- held to the reference ----------------------------------------------------

SCHEDULES = [
    dict(pods=1, data=8, model=1),
    dict(pods=2, data=2, model=2),
    dict(pods=2, data=2, model=2, model_in_lanes=False),
    dict(pods=2, data=4, model=2, redeal_frac=0.25),
    dict(pods=1, data=2, model=4, model_in_lanes=False, redeal_frac=0.5),
    dict(pods=2, data=2, model=1, redeal=False),
    dict(pods=1, data=1, model=1),
    dict(pods=2, data=3, model=2, seed=7),
]


@pytest.mark.parametrize("kw", SCHEDULES,
                         ids=lambda kw: "-".join(f"{k}{v}"
                                                 for k, v in kw.items()))
def test_mesh_schedule_matches_reference(kw):
    """`MeshSchedule.layout` and `.schedule` equal the reference's integer
    for integer over 4 epochs, for every layout of the axes, both roles
    of the model axis, the re-deal on and off, and partial re-deals."""
    lanes = kw["data"] * (kw["model"] if kw.get("model_in_lanes", True)
                          else 1)
    nb = kw["pods"] * lanes * 8
    ours = engine.MeshSchedule(nb, **kw)
    ref = jengine.MeshSchedule(nb, **kw)
    for e in range(4):
        assert np.array_equal(ours.layout(e), np.asarray(ref.layout(e)))
        assert np.array_equal(ours.schedule(e), np.asarray(ref.schedule(e)))
    assert ours.schedule(0).dtype == np.int32


def _rows_with_zeros(rng, n=64, d=96, nnz=12):
    idx = np.stack([rng.choice(d, size=nnz, replace=False)
                    for _ in range(n)]).astype(np.int32)
    val = rng.normal(size=(n, nnz)).astype(np.float32)
    val[rng.random((n, nnz)) < 0.2] = 0.0     # explicit zeros
    idx[:, -2:] = 0                           # padding tail
    val[:, -2:] = 0.0
    idx[3, 0], val[3, 0] = 0, 1.5             # feature 0, a real entry
    return idx, val


@pytest.mark.parametrize("positions", [False, True])
@pytest.mark.parametrize("width", [None, 16])
def test_compact_slice_rows_matches_reference(positions, width):
    """`compact_slice_rows` gives the reference's arrays byte for byte
    (dtype and shape too), in both modes, at a scanned and a fixed
    width, on rows with explicit zeros, padding and feature 0."""
    rng = np.random.default_rng(11)
    idx, val = _rows_with_zeros(rng)
    for lo, hi in ((0, 32), (32, 64), (64, 96)):
        ours = compact_slice_rows(idx, val, lo, hi, positions=positions,
                                  width=width)
        ref = jcache.compact_slice_rows(idx, val, lo, hi,
                                        positions=positions, width=width)
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_slice_gather_matches_reference(tmp_path):
    """`TileCache.slice_gather` on a cache the port built gives the
    reference's bytes (the reference opens the same files), with and
    without ``positions``, ``width`` and ``gathered``."""
    cache = registry.materialize("synthetic-sparse", tmp_path, bucket=8,
                                 pods=1, n=512, d=64, pad_multiple=256)
    jc = jcache.open_cache(cache.path)
    bids = np.array([[3, 0, 7], [12, 5, 9]])
    for kw in (dict(), dict(positions=True),
               dict(positions=True, width=8),
               dict(positions=True, gathered=cache.gather_buckets(bids))):
        (ours, y), (ref, jy) = (cache.slice_gather(bids, 16, 48, **kw),
                                jc.slice_gather(bids, 16, 48, **kw))
        assert y.tobytes() == np.asarray(jy).tobytes()
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError):
        dense = registry.materialize("synthetic-dense", tmp_path, bucket=8,
                                     pods=1, n=256, d=16)
        dense.slice_gather(bids, 0, 8)


# -- bitwise pins: streamed mesh == resident mesh == sim streamed -------------

def test_mesh_streamed_trio_bitwise_dense():
    """Dense example-parallel on (data=8): the mesh-streamed epochs, the
    resident mesh epochs and the sim's streamed loop driven by the same
    `MeshSchedule` give the same bits; the feed's byte count and the
    loop's stats are the streamed loop's."""
    n, d, B, K = 1024, 64, 8, 8
    X, y = _dense(n, d)
    scale = GLMScale("t", "dense", n=n, d=d, bucket=B, chunks=2,
                     deterministic=True, compress_pod=False, lam=1e-3)
    mesh = make_host_mesh(pod=1, data=K, model=1, device="cpu")
    resident = _resident(scale, mesh, (X, y))
    epoch_m = make_streamed_epoch_mesh(
        scale, mesh, ArrayFeed(y, X=X, bucket=B, device="cpu"))
    am, vm = _assert_streamed_equals_resident(epoch_m, resident, B)

    sched = engine.MeshSchedule(n // B, pods=1, data=K, model=1,
                                seed=scale.seed)
    epoch_s = engine.make_streamed_epoch(
        LOGISTIC, scale.engine_config(mesh), sched,
        ArrayFeed(y, X=X, bucket=B, device="cpu"), lam=scale.lam,
        device="cpu")
    a_s, v_s = torch.zeros(n), torch.zeros(d)
    for e in range(EPOCHS):
        stats = {}
        a_s, v_s = epoch_s(a_s, v_s, e, stats=stats)
    assert torch.equal(vm, v_s) and torch.equal(am, a_s)
    assert epoch_m.feed.bytes_h2d == EPOCHS * (n * d * 4 + n * 4)
    assert epoch_m.feed.fetches == EPOCHS * scale.chunks
    stats = {}
    epoch_m(am, vm, EPOCHS, stats=stats)
    assert stats["chunks"] == 2
    assert 0.0 <= stats["transfer_hidden_frac"] <= 1.0


def test_mesh_streamed_bitwise_sparse_replicated():
    """Sparse rows replicated on every worker (the model axis carrying
    examples) stream bitwise against the resident sparse mesh, with the
    int8 two-phase sync and a partial re-deal."""
    n, d, nnz, B = 1024, 64, 8, 8
    idx, val, y = _sparse(n, d, nnz)
    scale = GLMScale("t", "sparse", n=n, d=d, nnz=nnz, bucket=B, chunks=2,
                     deterministic=True, compress_pod=True,
                     compress_sync=True, redeal_frac=0.25, lam=1e-3, seed=2)
    mesh = make_host_mesh(pod=2, data=2, model=2, device="cpu")
    resident = _resident(scale, mesh, (idx, val, y))
    epoch_m = make_streamed_epoch_mesh(
        scale, mesh, ArrayFeed(y, idx=idx, val=val, d=d, bucket=B,
                               device="cpu"))
    assert not epoch_m.feed.sliced
    _assert_streamed_equals_resident(epoch_m, resident, B)


def test_mesh_streamed_bitwise_sparse_sharded_slice_compacted(tmp_path):
    """Feature-sharded sparse on (data=4, model=2): the feed compacts
    every row to each model lane's slice through
    `TileCache.slice_gather`, the step reassembles exact rows, and the
    result is bitwise the resident sharded run.  Each lane's bytes are
    rows * w * 12 (idx, val, pos) beside the shared labels."""
    cache = registry.materialize("synthetic-sparse", tmp_path, bucket=8,
                                 pods=1, n=512, d=64, pad_multiple=256)
    m = cache.meta
    (idx, val), y = cache.load_arrays()
    idx, val, y = (np.array(a) for a in (idx, val, y))   # writable copies
    scale = GLMScale("t", "sparse", n=m.n, d=m.d, nnz=m.nnz,
                     bucket=m.bucket, chunks=4, feature_shard=True,
                     deterministic=True, compress_pod=False, lam=1e-3,
                     seed=3)
    mesh = make_host_mesh(pod=1, data=4, model=2, device="cpu")
    resident = _resident(scale, mesh, (idx, val, y))
    epoch_m = make_streamed_epoch_mesh(scale, mesh, cache)
    feed = epoch_m.feed
    assert feed.sliced and feed.cache is cache
    _assert_streamed_equals_resident(epoch_m, resident, m.bucket)
    M, w = 2, feed.width
    assert feed.bytes_h2d == EPOCHS * (M * m.n * w * 12 + m.n * 4)


@pytest.mark.parametrize("name", ["tp", "pods"])
def test_mesh_streamed_bitwise_dense_tp_and_pods(name):
    """Dense tensor parallelism with pods (model=2, the int8 sync and the
    per-slice int8 pod reduce) and a 2-pod example-parallel mesh with the
    int8 pod reduce both stream bitwise against resident."""
    n, d, B = 1024, 64, 8
    X, y = _dense(n, d)
    kw, mk = {
        "tp": (dict(feature_shard=True, compress_pod=True,
                    compress_sync=True, seed=4),
               dict(pod=2, data=2, model=2)),
        "pods": (dict(compress_pod=True, seed=6),
                 dict(pod=2, data=4, model=1)),
    }[name]
    scale = GLMScale(name, "dense", n=n, d=d, bucket=B, chunks=2,
                     deterministic=True, lam=1e-3, **kw)
    mesh = make_host_mesh(device="cpu", **mk)
    resident = _resident(scale, mesh, (X, y))
    epoch_m = make_streamed_epoch_mesh(
        scale, mesh, ArrayFeed(y, X=X, bucket=B, device="cpu"))
    _assert_streamed_equals_resident(epoch_m, resident, B)


SESSION_CASES = {
    # name: (kind, mesh, EngineConfig knobs)
    "dense": ("dense", dict(pod=2, data=2, model=2), dict(pods=2, lanes=4)),
    "dense-tp": ("dense", dict(pod=2, data=2, model=2),
                 dict(pods=2, lanes=2, feature_shard=True)),
    "sparse": ("sparse", dict(pod=1, data=2, model=2),
               dict(pods=1, lanes=4, compress_sync=True)),
    "sparse-sharded": ("sparse", dict(pod=1, data=2, model=2),
                       dict(pods=1, lanes=2, feature_shard=True)),
}


@pytest.mark.parametrize("case", list(SESSION_CASES))
def test_session_mesh_streamed(case):
    """`Session(..., streamed=True, mesh=)` trains through the mesh
    pipeline: over 3 epochs bitwise the resident mesh program of the
    same scale, reproducible across constructions, the feed's counters
    filled, the gap finite; ``mesh=`` without a streamed source raises
    the reference's ValueError.  Ridge: its delta is closed-form, and
    the other objectives run the same path (the trio test runs
    logistic)."""
    kind, mk, knobs = SESSION_CASES[case]
    mesh = make_host_mesh(device="cpu", **mk)
    cfg = EngineConfig.make(bucket=8, chunks=2, partition="alltoall",
                            deterministic=True, compress_pod=False, **knobs)
    if kind == "dense":
        arrays = _dense(512, 32, seed=7)
        data, kw = arrays, {}
    else:
        arrays = _sparse(512, 64, 8, seed=7)
        data, kw = ((arrays[0], arrays[1]), arrays[2]), {"d": 64}
    runs = []
    for _ in range(2):
        s = Session(data, objective="ridge", lam=1e-3, cfg=cfg,
                    streamed=True, mesh=mesh, device="cpu", **kw)
        for _e in range(3):
            s.epoch()
        runs.append(s)
    a, b = runs
    assert torch.equal(a.v, b.v) and torch.equal(a.alpha, b.alpha)
    assert a.mesh_feed.bytes_h2d > 0
    assert a.mesh_feed.sliced == (case == "sparse-sharded")
    assert np.isfinite(a.gap())
    extra = {"nnz": 8} if kind == "sparse" else {}
    scale = glm.scale_for_estimator(a, feature_shard=knobs.get(
        "feature_shard", False), **extra)
    resident = _resident(scale, mesh, arrays, epochs=3, obj=RIDGE)
    assert torch.equal(a.v, resident[-1][1])
    lay = a._epoch_fn.schedule.layout(2)
    assert torch.equal(a.alpha[_cols(lay, 8)], resident[-1][0])
    with pytest.raises(ValueError, match="streamed source"):
        Session(data, cfg=cfg, mesh=mesh, device="cpu", **kw)


# -- slice compaction and the schedule (no mesh needed) -----------------------

def test_slice_compaction_positions_roundtrip():
    """`compact_slice_rows(positions=True)` pieces, stacked per lane,
    reassemble on the device (`engine.reassemble_rows`) to the exact
    rows: global ids, explicit zero values kept, padding rebuilt by the
    zero base."""
    rng = np.random.default_rng(11)
    idx, val = _rows_with_zeros(rng)
    n, nnz, M = idx.shape[0], idx.shape[1], 3
    dl = 96 // M
    pieces = [compact_slice_rows(idx, val, m * dl, (m + 1) * dl,
                                 positions=True, width=nnz)
              for m in range(M)]
    stacks = [torch.from_numpy(np.stack([p[k] for p in pieces]))
              for k in range(3)]
    fi, fv = engine.reassemble_rows(*stacks, nnz)
    assert torch.equal(fi, torch.from_numpy(idx))
    assert fv.numpy().tobytes() == val.tobytes()
    # a leading worker shape rides along
    lead = [s.reshape(M, 2, n // 2, nnz) for s in stacks]
    fi2, _ = engine.reassemble_rows(*lead, nnz)
    assert torch.equal(fi2.reshape(n, nnz), fi)


def test_slice_compaction_per_lane_bytes_and_width():
    """The per-lane compaction is the transfer saving on uniform ids:
    each lane's (idx, val, pos) is rows * w * 12 bytes with w ~ nnz/M,
    against rows * nnz * 8 for replicated rows; an undersized forced
    width raises instead of dropping entries."""
    rng = np.random.default_rng(13)
    n, d, nnz, M = 128, 4096, 256, 8
    idx = np.stack([rng.choice(d, size=nnz, replace=False)
                    for _ in range(n)]).astype(np.int32)
    val = rng.normal(size=(n, nnz)).astype(np.float32)
    dl = d // M
    per_lane = []
    for m in range(M):
        ic, vc, pos = compact_slice_rows(idx, val, m * dl, (m + 1) * dl,
                                         positions=True)
        per_lane.append(ic.nbytes + vc.nbytes + pos.nbytes)
    assert max(per_lane) < n * nnz * 8 / 2
    with pytest.raises(ValueError):
        compact_slice_rows(idx, val, 0, dl, positions=True, width=1)


def test_mesh_schedule_pure_and_composed():
    """`MeshSchedule` is a pure function of (seed, epoch): instances
    agree, layouts compose re-deals epoch over epoch, and every epoch's
    schedule is a permutation of all buckets; a worker's view is its row
    of the schedule."""
    a = engine.MeshSchedule(64, pods=2, data=2, model=2, seed=9)
    b = engine.MeshSchedule(64, pods=2, data=2, model=2, seed=9)
    s3 = a.schedule(3)                  # builds layouts 0..3 in order
    assert np.array_equal(s3, b.schedule(3))
    assert np.array_equal(a.layout(2), b.layout(2))
    for e in range(4):
        assert np.array_equal(np.sort(a.schedule(e), axis=None),
                              np.arange(64))
    w = a.worker(1, 3)
    assert w.per_lane == a.per_lane
    assert np.array_equal(w.schedule(2), a.schedule(2)[1, 3][None, None])
    st = engine.MeshSchedule(64, pods=2, data=2, model=2, seed=9,
                             redeal=False)
    assert np.array_equal(st.layout(3), st.layout(0))
    assert not np.array_equal(st.schedule(1), st.schedule(2))
    with pytest.raises(ValueError):
        engine.MeshSchedule(60, pods=2, data=4, model=2)


def test_mesh_feed_host_fetch_rebind_and_refusals(tmp_path):
    """A mesh feed hands raw host rows to the gap pass (`host_fetch`),
    swaps a rebuilt cache in (`rebind`, cache-backed only), and a source
    it cannot stream raises."""
    cache = registry.materialize("synthetic-sparse", tmp_path, bucket=8,
                                 pods=1, n=256, d=64, pad_multiple=128)
    feed = engine.MeshChunkFeed(cache, model_lanes=2, d_loc=32,
                                device="cpu")
    (hi, hv), hy = feed.host_fetch(np.array([[2, 5]]))
    (ci, cv), cy = cache.gather_buckets(np.array([2, 5]))
    assert np.array_equal(hi, ci) and np.array_equal(hy, cy)
    other = registry.materialize("synthetic-sparse", tmp_path / "b",
                                 bucket=8, pods=1, n=256, d=64,
                                 pad_multiple=128)
    w = feed.width
    feed.rebind(other)
    assert feed.cache is other and feed.width == w
    arr = engine.MeshChunkFeed(
        ArrayFeed(cy, idx=ci, val=cv, d=64, bucket=8, device="cpu"),
        device="cpu")
    with pytest.raises(ValueError, match="cache-backed"):
        arr.rebind(other)
    with pytest.raises(ValueError, match="d_loc"):
        engine.MeshChunkFeed(cache, model_lanes=2, device="cpu")
    scale = GLMScale("t", "sparse", n=256, d=64, nnz=8, bucket=8, chunks=2)
    with pytest.raises(TypeError, match="cannot stream"):
        make_streamed_epoch_mesh(scale, make_host_mesh(device="cpu"),
                                 object())


def test_input_specs_shards_and_production_mesh(monkeypatch):
    """`glm_input_specs` partitions as the reference's (examples over the
    example axes, X's rows over 'model' under TP); `local_shard` and
    `assemble_shards` round-trip through every rank's shard;
    `make_production_mesh` refuses a world that is not 256 or 512
    ranks, and `mesh_chips` counts shards."""
    from repro_torch.launch.mesh import DistMesh
    tp = GLMScale("t", "dense", n=64, d=8, feature_shard=True)
    sp = GLMScale("s", "sparse", n=64, d=8, nnz=4)
    mesh = make_host_mesh(pod=2, data=2, model=2, device="cpu")
    X = glm.glm_input_specs(tp, mesh)[0]
    assert X.shape == (8, 64) and X.partition == (("model",),
                                                 ("pod", "data"))
    idx = glm.glm_input_specs(sp, mesh)[0]
    assert idx.dtype == torch.int32 and idx.partition == (
        ("pod", "data", "model"), None)
    shape = mesh.shape
    g = torch.arange(8 * 64, dtype=torch.float32).reshape(8, 64)
    for spec in (X, glm.glm_input_specs(sp, mesh)[2]):
        full = g if len(spec.shape) == 2 else g[0]
        shards = [glm.local_shard(full, spec, DistMesh(
            2, 2, 2, r, torch.device("cpu"), "gloo", {})) for r in range(8)]
        assert torch.equal(glm.assemble_shards(shards, spec, shape), full)
    assert mesh_chips(mesh) == 8
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="256"):
        make_production_mesh()
    monkeypatch.setenv("WORLD_SIZE", "256")
    with pytest.raises(RuntimeError, match="512"):
        make_production_mesh(multi_pod=True)
