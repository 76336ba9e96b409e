"""The port's plain SDCA sub-epochs and kernel wrappers against the JAX
reference: `repro.core.sdca` and the Pallas kernels run in interpret
mode through `repro.kernels.ops` (small n, as the reference's own CPU
tests run them).

On the CPU the port's kernel wrappers run their plain versions, so the
wrapper tests here exercise the padding, tiling and unscaling around
the CUDA kernels; the kernels themselves are held against the plain
versions on the card by chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                  # noqa: E402

from repro.core import objectives as jobj                # noqa: E402
from repro.core import sdca as jsdca                     # noqa: E402
from repro.kernels import ops as jops                    # noqa: E402
from repro_torch.core import objectives as tobj          # noqa: E402
from repro_torch.core import sdca as tsdca               # noqa: E402
from repro_torch.kernels import ops as tops              # noqa: E402
from repro_torch.kernels import sdca_bucket, sdca_sparse_bucket  # noqa: E402
from repro_torch.data.synthetic import make_sparse_classification  # noqa: E402

OBJS = ["ridge", "hinge", "logistic"]
LAM_N, SIG = 0.64, 2.0


def _labels(rng, name, shape):
    if name == "ridge":
        return (rng.normal(size=shape).astype(np.float32),
                (0.1 * rng.normal(size=shape)).astype(np.float32))
    y = rng.choice([-1.0, 1.0], size=shape).astype(np.float32)
    return y, (y * rng.uniform(0.05, 0.5, size=shape)).astype(np.float32)


def _dense_case(name, W=2, d=5, n=32, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(W, d, n)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y, a = _labels(rng, name, (W, n))
    v0 = (0.1 * rng.normal(size=(W, d))).astype(np.float32)
    return X, y, a, v0


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _scal():
    return (torch.tensor(LAM_N, dtype=torch.float32),
            torch.tensor(SIG, dtype=torch.float32))


def _close_dense(got, ref):
    # margin and Gram products are summed in another order than XLA's
    # matmuls: rtol 1e-5, atol 1e-6 on alpha and dv
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", OBJS)
@pytest.mark.parametrize("bucket", [1, 4, 8])
def test_dense_subepoch_vs_reference(name, bucket):
    X, y, a, v0 = _dense_case(name)
    lam, sig = _scal()
    ta, tdv = tsdca.dense_local_subepoch(tobj.get_objective(name), *_t(X, y, a, v0),
                                         lam, sig, bucket)
    jo = jobj.get_objective(name)
    for w in range(X.shape[0]):
        ja, jdv = jsdca.dense_local_subepoch(
            jo, jnp.asarray(X[w]), jnp.asarray(y[w]), jnp.asarray(a[w]),
            jnp.asarray(v0[w]), jnp.float32(LAM_N), jnp.float32(SIG), bucket)
        _close_dense(ta[w].numpy(), np.asarray(ja))
        _close_dense(tdv[w].numpy(), np.asarray(jdv))


@pytest.mark.parametrize("name", OBJS)
@pytest.mark.parametrize("bucket", [4, 8])
def test_dense_wrapper_vs_interpreted_kernel(name, bucket):
    """ops.sdca_bucket_subepoch (d 5 -> 8 and B 4 -> 8 zero padding,
    dv unscaling) against the reference's interpreted Pallas kernel."""
    X, y, a, v0 = _dense_case(name, seed=1)
    sdca_bucket.launches = 0
    ta, tdv = tops.sdca_bucket_subepoch(tobj.get_objective(name),
                                        *_t(X, y, a, v0), LAM_N, SIG,
                                        bucket=bucket)
    assert sdca_bucket.launches == 0          # CPU tensors: plain version
    jo = jobj.get_objective(name)
    for w in range(X.shape[0]):
        ja, jdv = jops.sdca_bucket_subepoch(
            jo, jnp.asarray(X[w]), jnp.asarray(y[w]), jnp.asarray(a[w]),
            jnp.asarray(v0[w]), LAM_N, SIG, bucket=bucket, interpret=True)
        _close_dense(ta[w].numpy(), np.asarray(ja))
        _close_dense(tdv[w].numpy(), np.asarray(jdv))


def test_dense_plain_tile_pass_matches_subepoch():
    """The kernel's plain version on tiles == the solver on columns."""
    X, y, a, v0 = _dense_case("logistic", d=8, n=16, seed=2)
    obj = tobj.LOGISTIC
    lam, sig = _scal()
    ta, tdv = tsdca.dense_local_subepoch(obj, *_t(X, y, a, v0), lam, sig, 8)
    xb = torch.as_tensor(X).reshape(2, 8, 2, 8).permute(0, 2, 1, 3)
    ka, kv = sdca_bucket.sdca_bucket_kernel(
        obj, xb, *_t(y.reshape(2, 2, 8), a.reshape(2, 2, 8), v0), LAM_N, SIG)
    assert torch.equal(ka.reshape(2, 16), ta)
    assert torch.equal((kv - torch.as_tensor(v0)) / sig, tdv)


def _sparse_case(name, W=2, n=32, d=40, nnz=8, seed=0):
    rng = np.random.default_rng(seed)
    (idx, val), _, _ = make_sparse_classification(n=W * n, d=d, nnz=nnz,
                                                  seed=seed, skew=1.0)
    y, a = _labels(rng, name, (W, n))
    v0 = (0.1 * rng.normal(size=(W, d))).astype(np.float32)
    return idx.reshape(W, n, nnz), val.reshape(W, n, nnz), y, a, v0


def _close_sparse(got, ref):
    # the scan's margins and q are summed left to right here and by XLA's
    # reductions in the reference: rtol 1e-6.  The hinge update divides
    # by q, which amplifies a one-ulp margin difference in the entries
    # that cancel towards zero: atol 1e-6, as for the dense path
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", OBJS)
def test_sparse_subepoch_vs_reference(name):
    idx, val, y, a, v0 = _sparse_case(name)
    lam, sig = _scal()
    ta, tdv = tsdca.sparse_local_subepoch(
        tobj.get_objective(name), *_t(idx, val, y, a, v0), lam, sig)
    jo = jobj.get_objective(name)
    for w in range(idx.shape[0]):
        args = [jnp.asarray(x[w]) for x in (idx, val, y, a, v0)]
        ja, jdv = jsdca.sparse_local_subepoch(jo, *args, jnp.float32(LAM_N),
                                              jnp.float32(SIG))
        _close_sparse(ta[w].numpy(), np.asarray(ja))
        _close_sparse(tdv[w].numpy(), np.asarray(jdv))
        # the reference's interpreted Pallas kernel (B, nnz multiples of 8)
        ka, kdv = jops.sdca_sparse_bucket_subepoch(
            jo, *args, LAM_N, SIG, bucket=8, interpret=True)
        _close_sparse(ta[w].numpy(), np.asarray(ka))
        _close_sparse(tdv[w].numpy(), np.asarray(kdv))


@pytest.mark.parametrize("name", OBJS)
def test_sparse_wrapper_equals_plain(name):
    """ops.sdca_sparse_bucket_subepoch (tiling, q precompute, d padding,
    unscaling) is bitwise equal to the plain solver on the same device."""
    idx, val, y, a, v0 = _sparse_case(name, d=37, seed=3)
    lam, sig = _scal()
    obj = tobj.get_objective(name)
    sdca_sparse_bucket.launches = 0
    ka, kdv = tops.sdca_sparse_bucket_subepoch(obj, *_t(idx, val, y, a, v0),
                                               LAM_N, SIG, bucket=8)
    assert sdca_sparse_bucket.launches == 0
    pa, pdv = tsdca.sparse_local_subepoch(obj, *_t(idx, val, y, a, v0),
                                          lam, sig)
    assert torch.equal(ka, pa) and torch.equal(kdv, pdv)


def test_row_sq_norms_left_to_right():
    val = torch.tensor([[1e8, 1.0, -1e8, 1.0]], dtype=torch.float32)
    # ((1e16 + 1) + 1e16) + 1 in f32, in that order
    acc = torch.zeros(1)
    for k in range(4):
        acc = acc + val[:, k] * val[:, k]
    assert torch.equal(tsdca.row_sq_norms(val), acc)


def test_sequential_epoch_vs_reference():
    X, y, a, v0 = _dense_case("hinge", W=1, d=6, n=24, seed=4)
    perm = np.random.default_rng(0).permutation(24)
    ta, tv = tsdca.sequential_epoch(tobj.HINGE, *_t(X[0], y[0], a[0], v0[0]),
                                    0.05, torch.as_tensor(perm), bucket=4)
    ja, jv = jsdca.sequential_epoch(
        jobj.HINGE, *(jnp.asarray(x) for x in (X[0], y[0], a[0], v0[0])),
        0.05, jnp.asarray(perm), bucket=4)
    _close_dense(ta.numpy(), np.asarray(ja))
    _close_dense(tv.numpy(), np.asarray(jv))


def test_misfits():
    assert tops.dense_kernel_misfit(28, 64, 16) is None
    assert tops.dense_kernel_misfit(28, 60, 16).code == \
        tops.MisfitCode.BUCKET_INDIVISIBLE
    assert tops.dense_kernel_misfit(28, 1024, 1024).code == \
        tops.MisfitCode.BUCKET_CAP
    # d never misfits: replicas live in global memory
    assert tops.sparse_solver_plan(64, 40, 10**8, 16) == ("kernel", None)
    # nor the bucket's size: stages too large for shared memory stay in
    # global memory
    assert tops.sparse_solver_plan(1024, 4096, 100, 512) == ("kernel", None)
    assert tops.sparse_kernel_misfit(60, 8, 100, 16).code == \
        tops.MisfitCode.BUCKET_INDIVISIBLE


def test_dense_smem_layout():
    # deltas + 2 stages of (a, y, q); v + 2 stage tiles (+16 B to align
    # them); 2 stage Gram matrices
    assert sdca_bucket.STAGES == 2
    assert sdca_bucket.smem_layout(16, 32) == (
        True, True, (16 + 2 * 3 * 16) * 4 + (32 + 2 * 32 * 16) * 4 + 16
        + 2 * 16 * 16 * 4)
    x_in, g_in, _ = sdca_bucket.smem_layout(512, 32)        # G is 1 MB
    assert x_in and not g_in
    x_in, g_in, _ = sdca_bucket.smem_layout(16, 100_000)    # tile 6.4 MB
    assert not x_in and g_in


def test_csr_invariant_checked_for_untrusted_rows():
    idx = torch.tensor([[3, 3]], dtype=torch.int32)
    val = torch.tensor([[1.0, 2.0]])
    with pytest.raises(ValueError, match="no-duplicate-nonzero"):
        tops._check_csr_invariant(idx, val, "ad-hoc arrays")
    tops._check_csr_invariant(idx, val, "resident arrays")
