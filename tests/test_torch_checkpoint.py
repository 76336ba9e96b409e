"""The port's checkpoint store against the reference's.

Mirrors tests/test_checkpoint.py for `repro_torch.checkpoint`: roundtrip,
shape mismatch, keep-N and latest step, the async snapshot, the stale
stage, the torn swap, the atomic overwrite.  Then the layout itself: a
tree that either package writes restores in the other BITWISE (an int64
scalar and a bf16 leaf included), and both write the same manifest and
meta bytes for the same tree.  `Session.save`/`load` ride on it.  Every
comparison here is exact: a checkpoint stores raw bytes.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro import checkpoint as jckpt                          # noqa: E402
from repro.api import Session as JSession                     # noqa: E402
from repro.core.config import EngineConfig as JConfig         # noqa: E402
from repro.data import synthetic as jsynth                    # noqa: E402
from repro_torch.api import Session                           # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,        # noqa: E402
                                    restore_tree, save_tree)
from repro_torch.core.config import EngineConfig              # noqa: E402

CFG = dict(pods=1, lanes=2, bucket=8, chunks=2, deterministic=True)


@pytest.fixture(autouse=True)
def _plan_off(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN", "off")


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as a flat uint8 array (bf16 included)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return np.frombuffer(t.numpy().tobytes(), np.uint8)
    return np.frombuffer(np.asarray(x).tobytes(), np.uint8)


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _leaves(t)]
    return [tree]


def _torch_tree():
    return {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": [torch.linspace(-2, 3, 4).to(torch.bfloat16),
                  np.float32(3.5)],
            "c": {"d": torch.zeros((), dtype=torch.int32),
                  "e": np.int64(-7)},
            "f": torch.randn(3, 5, generator=torch.Generator().manual_seed(0))}


@pytest.mark.parametrize("device", [None, "cpu"])
def test_save_restore_roundtrip(tmp_path, device):
    tree = _torch_tree()
    save_tree(tmp_path / "ck", tree, meta={"step": 7})
    out, meta = restore_tree(tmp_path / "ck", tree, device=device)
    assert meta["step"] == 7
    assert list(out) == list(tree) and len(out["b"]) == 2
    for l1, l2 in zip(_leaves(tree), _leaves(out)):
        np.testing.assert_array_equal(_bits(l1), _bits(l2))
        if device is not None:
            assert isinstance(l2, torch.Tensor) and l2.device.type == "cpu"
        elif getattr(l1, "dtype", None) != torch.bfloat16:
            assert isinstance(l2, np.ndarray)
    assert out["b"][0].dtype == torch.bfloat16        # numpy cannot name it
    assert out["a"].dtype == (np.int32 if device is None else torch.int32)


def test_restore_casts_to_the_target_dtype(tmp_path):
    save_tree(tmp_path / "ck", {"a": np.arange(4, dtype=np.int64)})
    out, _ = restore_tree(tmp_path / "ck",
                          {"a": torch.zeros(4, dtype=torch.float32)})
    assert out["a"].dtype == np.float32
    np.testing.assert_array_equal(out["a"], [0, 1, 2, 3])


def test_restore_rejects_shape_mismatch(tmp_path):
    save_tree(tmp_path / "ck", {"a": torch.ones(2, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_tree(tmp_path / "ck", {"a": torch.ones(3, 2)})
    with pytest.raises(KeyError, match="missing leaf"):
        restore_tree(tmp_path / "ck", {"b": torch.ones(2, 3)})


def test_manager_keep_n_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_n=2, async_write=False)
    assert mgr.latest_step() is None
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((2,), float(s))})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    out, meta = mgr.restore({"x": torch.zeros(2)})
    assert meta["step"] == 4
    np.testing.assert_array_equal(out["x"], [4.0, 4.0])
    out, meta = mgr.restore({"x": torch.zeros(2)}, step=3)
    assert meta["step"] == 3
    np.testing.assert_array_equal(out["x"], [3.0, 3.0])


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_async_write_snapshot_is_consistent(tmp_path, kind):
    """The snapshot holds the values at save() time even when the
    caller updates the same memory in place right after (on the CPU a
    tensor's numpy view shares its storage)."""
    mgr = CheckpointManager(tmp_path, async_write=True)
    x = torch.arange(4.0) if kind == "tensor" else np.arange(4.0)
    mgr.save(1, {"x": x})
    x *= 0                                    # in place, immediately
    mgr.wait()
    out, _ = mgr.restore({"x": np.zeros(4)})
    np.testing.assert_array_equal(out["x"], [0, 1, 2, 3])


def test_save_tree_cleans_stale_tmp_from_killed_save(tmp_path):
    stale = tmp_path / ".tmp.ck"
    stale.mkdir()
    (stale / "junk.bin").write_bytes(b"half a tensor")
    save_tree(tmp_path / "ck", {"a": torch.arange(3.0)}, meta={"step": 1})
    out, meta = restore_tree(tmp_path / "ck", {"a": torch.zeros(3)})
    assert meta["step"] == 1
    np.testing.assert_array_equal(out["a"], [0.0, 1.0, 2.0])
    assert not stale.exists()


def test_restore_tree_falls_back_to_old_after_torn_swap(tmp_path):
    ck = tmp_path / "ck"
    save_tree(ck, {"a": torch.arange(3.0)}, meta={"step": 1})
    ck.rename(tmp_path / ".old.ck")
    ck.mkdir()                                 # half-written replacement,
    (ck / "partial.bin").write_bytes(b"")      # no keys.json manifest
    out, meta = restore_tree(ck, {"a": torch.zeros(3)})
    assert meta["step"] == 1
    np.testing.assert_array_equal(out["a"], [0.0, 1.0, 2.0])


def test_save_tree_overwrite_is_atomic_swap(tmp_path):
    ck = tmp_path / "ck"
    save_tree(ck, {"a": torch.zeros(4)}, meta={"step": 1})
    save_tree(ck, {"a": torch.full((4,), 7.0)}, meta={"step": 2})
    out, meta = restore_tree(ck, {"a": torch.zeros(4)})
    assert meta["step"] == 2
    np.testing.assert_array_equal(out["a"], np.full(4, 7.0))
    assert [p.name for p in tmp_path.iterdir()] == ["ck"]


# -- across the two packages ------------------------------------------------

def _ref_tree():
    rng = np.random.default_rng(3)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "h": jnp.asarray(rng.standard_normal(5), jnp.bfloat16),
            "step": np.int64(123456789012),
            "blocks": [{"k": np.arange(6, dtype=np.int32).reshape(2, 3)},
                       {"k": -np.arange(6, dtype=np.int32).reshape(2, 3)}]}


def _port_tree(ref):
    h = np.asarray(ref["h"]).view(np.int16).copy()
    return {"w": torch.from_numpy(ref["w"].copy()),
            "h": torch.from_numpy(h).view(torch.bfloat16),
            "step": np.int64(ref["step"]),
            "blocks": [{"k": torch.from_numpy(b["k"].copy())}
                       for b in ref["blocks"]]}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_packages_bitwise(tmp_path, writer):
    ref = _ref_tree()
    port = _port_tree(ref)
    meta = {"epoch": 3, "note": "cross"}
    if writer == "reference":
        jckpt.save_tree(tmp_path / "ck", ref, meta=meta)
        out, got = restore_tree(tmp_path / "ck", port)
        src = ref
    else:
        save_tree(tmp_path / "ck", port, meta=meta)
        out, got = jckpt.restore_tree(tmp_path / "ck", ref)
        src = port
    assert got == meta
    for a, b in zip(_leaves(src), _leaves(out)):
        if not isinstance(b, torch.Tensor):
            b = np.asarray(b)
        np.testing.assert_array_equal(_bits(a), _bits(b))
        assert tuple(np.shape(a)) == tuple(np.shape(b))


def test_both_packages_write_the_same_manifest_and_meta(tmp_path):
    ref = _ref_tree()
    jckpt.save_tree(tmp_path / "j", ref, meta={"epoch": 3})
    save_tree(tmp_path / "t", _port_tree(ref), meta={"epoch": 3})
    for name in ("keys.json", "meta.json"):
        assert ((tmp_path / "j" / name).read_bytes()
                == (tmp_path / "t" / name).read_bytes())
    keys = [m["key"] for m in json.loads((tmp_path / "t" /
                                          "keys.json").read_text())]
    assert keys == ["blocks/0/k", "blocks/1/k", "h", "step", "w"]
    with np.load(tmp_path / "j" / "arrays.npz") as zj, \
            np.load(tmp_path / "t" / "arrays.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for f in zj.files:
            np.testing.assert_array_equal(zj[f], zt[f])


# -- Session.save / Session.load ---------------------------------------------

def _data():
    X, y = jsynth.make_dense_classification(n=256, d=16, seed=0)
    return np.asarray(X), np.asarray(y)


def test_session_save_load_roundtrip_and_resume(tmp_path):
    X, y = _data()
    cfg = EngineConfig.make(**CFG)
    straight = Session((X, y), lam=1e-2, cfg=cfg, device="cpu")
    straight.fit(until=4, tol=0.0)
    half = Session((X, y), lam=1e-2, cfg=cfg, device="cpu")
    half.fit(until=2, tol=0.0)
    half.save(tmp_path / "s", meta={"note": 1})
    again = Session((X, y), lam=1e-2, cfg=cfg, device="cpu")
    meta = again.load(tmp_path / "s")
    assert meta == {"note": 1, "epochs_done": 2} and again.epochs_done == 2
    assert torch.equal(again.v, half.v) and torch.equal(again.alpha,
                                                        half.alpha)
    again.fit(until=4, tol=0.0)
    assert torch.equal(again.v, straight.v)
    assert torch.equal(again.alpha, straight.alpha)


def test_session_loads_a_reference_session_save(tmp_path):
    X, y = _data()
    js = JSession((X, y), lam=1e-2, cfg=JConfig.make(**CFG))
    js.fit(until=2, tol=0.0)
    js.save(tmp_path / "s")
    ts = Session((X, y), lam=1e-2, cfg=EngineConfig.make(**CFG),
                 device="cpu")
    meta = ts.load(tmp_path / "s")
    assert meta["epochs_done"] == 2 and ts.epochs_done == 2
    np.testing.assert_array_equal(ts.v.numpy(), np.asarray(js.v))
    np.testing.assert_array_equal(ts.alpha.numpy(), np.asarray(js.alpha))
