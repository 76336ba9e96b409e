"""The port's threefry PRNG and every schedule it draws, against jax.random.

All comparisons are EXACT: schedules, re-deal layouts and visit orders
are integers, and the port must reproduce the reference's bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                              # noqa: E402
import jax.numpy as jnp                                 # noqa: E402

from repro.core import engine as jengine                # noqa: E402
from repro.core.partition import PartitionPlan as JPlan  # noqa: E402
from repro_torch.core import engine as tengine          # noqa: E402
from repro_torch.core import prng                       # noqa: E402
from repro_torch.core.partition import PartitionPlan as TPlan  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 + 5, -3, 123456789])
def test_prngkey_exact(seed):
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)),
                          prng.PRNGKey(seed))


@pytest.mark.parametrize("data", [0, 1, 5, 31, 123456, 2**31 - 1])
def test_fold_in_exact(data):
    for seed in (0, 3):
        k = jax.random.PRNGKey(seed)
        got = prng.fold_in(prng.PRNGKey(seed), data)
        assert np.array_equal(
            np.asarray(jax.random.fold_in(k, jnp.int32(data))), got)


@pytest.mark.parametrize("num", [1, 2, 7, 32])
def test_split_exact(num):
    k = jax.random.PRNGKey(11)
    assert np.array_equal(np.asarray(jax.random.split(k, num)),
                          prng.split(prng.PRNGKey(11), num))


# 1 sort round up to n = 1625, 2 above (131,072 = criteo-shaped bucket
# count)
@pytest.mark.parametrize("n", [0, 1, 5, 1625, 1626, 131_072])
def test_permutation_exact(n):
    k = jax.random.fold_in(jax.random.PRNGKey(4), jnp.int32(2))
    pk = prng.fold_in(prng.PRNGKey(4), 2)
    assert np.array_equal(np.asarray(jax.random.permutation(k, n)),
                          prng.permutation(pk, n))


_MODES = ["static", "dynamic", "hierarchical", "rotation", "alltoall"]


@pytest.mark.parametrize("mode,pods,lanes,nb",
                         [(m, 1, 4, 64) for m in _MODES]
                         + [(m, 2, 2, 64) for m in _MODES]
                         # 2048+ buckets per shuffle: 2 sort rounds
                         + [("dynamic", 2, 4, 4096),
                            ("hierarchical", 2, 4, 4096)])
def test_partition_schedules_exact(mode, pods, lanes, nb):
    for frac in ((1.0, 0.5) if mode == "alltoall" else (1.0,)):
        kw = dict(n_buckets=nb, pods=pods, lanes=lanes, mode=mode, seed=5,
                  redeal_frac=frac)
        jp, tp = JPlan(**kw), TPlan(**kw)
        for epoch in (0, 2):
            got = tp.schedule(epoch)
            assert got.dtype == np.int32
            assert np.array_equal(np.asarray(jp.schedule(epoch)), got), \
                (mode, frac, epoch)


def test_partition_schedule_criteo_shape_exact():
    """The criteo-shaped main path: 131,072 buckets on 2 pods x 16
    lanes, hierarchical — 65,536 buckets per pod take 2 sort rounds."""
    kw = dict(n_buckets=131_072, pods=2, lanes=16, mode="hierarchical")
    assert np.array_equal(np.asarray(JPlan(**kw).schedule(2)),
                          TPlan(**kw).schedule(2))


@pytest.mark.parametrize("pods,lanes", [(1, 1), (2, 3), (3, 4)])
def test_worker_keys_and_streams_exact(pods, lanes):
    jc = jengine.SimCollectives(pods=pods, lanes=lanes)
    tc = tengine.SimCollectives(pods=pods, lanes=lanes)
    for seed, epoch in ((0, 0), (9, 4)):
        jk = np.asarray(jc.worker_keys(seed, epoch))
        tk = tc.worker_keys(seed, epoch)
        assert np.array_equal(jk, tk)
        # the visit-order stream fold(k, 1)
        assert np.array_equal(
            np.asarray(jc.visit_perms(jnp.asarray(jk), 12)),
            tc.visit_perms(tk, 12, "cpu").numpy().astype(np.int32))


@pytest.mark.parametrize("frac", [1.0, 0.5, 0.0])
def test_redeal_layout_exact(frac):
    """The re-deal stream fold(k, 0) and the stacked all-to-all layout,
    on integer payloads along both block axes the engine uses."""
    P, K, nb, B, nnz = 2, 4, 8, 2, 3
    jc = jengine.SimCollectives(pods=P, lanes=K)
    tc = tengine.SimCollectives(pods=P, lanes=K)
    keys = tc.worker_keys(3, 2)
    n_local = nb * B
    ids = np.arange(P * K * n_local, dtype=np.int32).reshape(P, K, n_local)
    rows = np.arange(P * K * n_local * nnz,
                     dtype=np.int32).reshape(P, K, n_local, nnz)
    dense = np.arange(P * K * 5 * n_local,
                      dtype=np.int32).reshape(P, K, 5, n_local)
    jout = jc.redeal(((jnp.asarray(ids), -1), (jnp.asarray(rows), -2),
                      (jnp.asarray(dense), -1)), nb, jnp.asarray(keys), frac)
    tout = tc.redeal(((torch.as_tensor(ids), -1), (torch.as_tensor(rows), -2),
                      (torch.as_tensor(dense), -1)), nb, keys, frac)
    for j, t in zip(jout, tout):
        assert np.array_equal(np.asarray(j), t.numpy())
