"""The port's dense mesh program and int8 wire reductions against the
JAX reference.

Covers, at small sizes on the CPU (about 50 s, 15 s of it the
reference's subprocess):
  * `launch.glm.make_dense_epoch` on stacked (pod, data, model) meshes,
    example-parallel and tensor-parallel (TP), with the int8 pod reduce
    and the int8 two-phase chunk sync, against the reference's
    shard_map program on 4 forced host devices;
  * `engine.StackedMeshCollectives.lane_sum(compress=True)` (`q_psum`)
    and `optim.compression.ef_allreduce` against the reference's
    collectives under shard_map, bitwise;
  * `make_sparse_epoch` with `compress_sync` and a partial re-deal;
  * the stacked dense mesh bitwise against the port's own
    `engine.sim_sharded_dense_epoch`, and that against the reference's;
  * TP convergence, the TP kernel route (the dense kernel's wrapper,
    which runs its plain version on the CPU), the refusals;
  * `kernels.ref.sdca_subepoch_ref`, the naive oracle, and
    `launch.glm.estimator_epoch`.

Every reference mesh run happens in ONE module-scoped subprocess, so
jax's compile cost is paid once (the main process keeps one device).
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.core import engine as jengine                      # noqa: E402
from repro.core import objectives as jobj                     # noqa: E402
from repro.core import sdca as jsdca                          # noqa: E402
from repro.kernels import ref as jref                         # noqa: E402
from repro_torch.api import LogisticRegression                # noqa: E402
from repro_torch.core import engine, sdca                     # noqa: E402
from repro_torch.core.config import EngineConfig              # noqa: E402
from repro_torch.core.objectives import (LOGISTIC, duality_gap,  # noqa: E402
                                         get_objective)
from repro_torch.data.synthetic import (make_dense_classification,  # noqa: E402
                                        make_sparse_classification)
from repro_torch.kernels.ref import sdca_subepoch_ref         # noqa: E402
from repro_torch.launch import glm                            # noqa: E402
from repro_torch.launch.glm import (GLMScale, estimator_epoch,  # noqa: E402
                                    make_dense_epoch, make_sparse_epoch)
from repro_torch.launch.mesh import make_host_mesh            # noqa: E402
from repro_torch.optim.compression import compress, ef_allreduce  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
OBJS = ["ridge", "hinge", "logistic"]
N, D = 512, 64
SN, SD, NNZ = 512, 96, 8
LANE_D = 61          # not a multiple of the lane count: q_psum pads

#: the reference's dense mesh runs: tag -> ((pod, data, model), knobs)
DENSE_CASES = {
    "ex": ((1, 2, 2), dict(feature_shard=False)),
    "tp": ((1, 2, 2), dict(feature_shard=True, compress_sync=True)),
    "pods": ((2, 2, 1), dict(feature_shard=False, compress_pod=True)),
    "tppod": ((2, 1, 2), dict(feature_shard=True, compress_pod=True)),
}


def _dense_scale(**kw):
    kw = {"compress_pod": False, **kw}
    return GLMScale("t", "dense", n=N, d=D, bucket=8, chunks=2, lam=1e-2,
                    deterministic=True, **kw)


def _sparse_scale(**kw):
    return GLMScale("s", "sparse", n=SN, d=SD, nnz=NNZ, bucket=8, chunks=2,
                    lam=1e-2, deterministic=True, compress_sync=True,
                    redeal_frac=0.25, **kw)


def _dense_inputs():
    X, y = make_dense_classification(n=N, d=D, seed=0)
    return dict(X=X, y=y, a=np.zeros(N, np.float32),
                v=np.zeros(D, np.float32))


def _sparse_inputs():
    (idx, val), y, _ = make_sparse_classification(n=SN, d=SD, nnz=NNZ,
                                                  seed=2)
    return dict(idx=idx, val=val, y=y, a=np.zeros(SN, np.float32),
                v=np.zeros(SD, np.float32))


def _lane_inputs():
    """Seeded deltas for the lane sums (one row per lane) and the
    error-feedback all-reduce (arrays and residuals of 4 lanes)."""
    rng = np.random.default_rng(7)
    dv = (rng.standard_normal((4, LANE_D))
          * rng.uniform(1e-3, 1.0, size=(4, 1))).astype(np.float32)
    dv_tp = rng.standard_normal((2, 2 * 31)).astype(np.float32)
    x = rng.standard_normal((4, 3, 17)).astype(np.float32)
    err = (1e-3 * rng.standard_normal((4, 3, 17))).astype(np.float32)
    return dict(dv=dv, dv_tp=dv_tp, x=x, err=err)


_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import engine
from repro.launch.glm import GLMScale, make_dense_epoch, make_sparse_epoch
from repro.launch.mesh import make_host_mesh
from repro.optim.compression import compress, ef_allreduce

z = np.load(sys.argv[1])
out = {}
for tag, ((pod, data, model), kw) in %(cases)r.items():
    kw = {"compress_pod": False, **kw}
    sc = GLMScale("t", "dense", n=%(n)d, d=%(d)d, bucket=8, chunks=2,
                  lam=1e-2, deterministic=True, local_solver="xla", **kw)
    mesh = make_host_mesh(pod=pod, data=data, model=model)
    with mesh:
        ep = jax.jit(make_dense_epoch(sc, mesh))
        st = tuple(jnp.asarray(z[k]) for k in ("X", "y", "a", "v"))
        for e in range(2):
            st = ep(*st, jnp.int32(e))
            for k, t in zip(("X", "y", "a", "v"), st):
                out[f"{tag}{e}_{k}"] = np.asarray(t)

sc = GLMScale("s", "sparse", n=%(sn)d, d=%(sd)d, nnz=%(nnz)d, bucket=8,
              chunks=2, lam=1e-2, deterministic=True, compress_sync=True,
              redeal_frac=0.25, compress_pod=False, local_solver="xla")
mesh = make_host_mesh(pod=1, data=2, model=2)
with mesh:
    ep = jax.jit(make_sparse_epoch(sc, mesh))
    st = tuple(jnp.asarray(z[k]) for k in ("idx", "val", "sy", "sa", "sv"))
    for e in range(2):
        st = ep(*st, jnp.int32(e))
        for k, t in zip(("idx", "val", "y", "a", "v"), st):
            out[f"sparse{e}_{k}"] = np.asarray(t)

# the compressed lane sums, every lane's result
mesh = make_host_mesh(pod=1, data=2, model=2)
sizes = {"pod": 1, "data": 2, "model": 2}
for tag, sync, spec, key in (
        ("lanes", ("data", "model"), P(("data", "model")), "dv"),
        ("tp", ("data",), P("data", "model"), "dv_tp")):
    coll = engine.MeshCollectives(lane_axes=("data", "model"),
                                  sync_axes=sync, axis_sizes=sizes,
                                  deterministic=True)
    f = engine.shard_map(lambda x: coll.lane_sum(x[0], compress=True)[None],
                         mesh, in_specs=(spec,), out_specs=spec)
    with mesh:
        out[f"lane_sum_{tag}"] = np.asarray(jax.jit(f)(jnp.asarray(z[key])))
scale_of = jax.jit(lambda x: compress(x))
for i, row in enumerate(z["dv"]):
    qz, _ = scale_of(jnp.asarray(row))
    out[f"q{i}"], out[f"s{i}"] = np.asarray(qz.q), np.asarray(qz.scale)

lmesh = jax.make_mesh((4,), ("l",), devices=jax.devices()[:4])
g = engine.shard_map(
    lambda x, e: tuple(t[None] for t in ef_allreduce(x[0], e[0], "l")),
    lmesh, in_specs=(P("l"), P("l")), out_specs=(P("l"), P("l")))
red, err = jax.jit(g)(jnp.asarray(z["x"]), jnp.asarray(z["err"]))
out["ef_sum"], out["ef_err"] = np.asarray(red), np.asarray(err)
np.savez(sys.argv[2], **out)
""" % dict(cases=DENSE_CASES, n=N, d=D, sn=SN, sd=SD, nnz=NNZ)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every reference mesh run, in one subprocess on 4 forced host
    devices; outputs converted with `np.asarray` only (its post-epoch
    host math trips jax's explicit-axis sharding checks)."""
    sp = _sparse_inputs()
    inputs = {**_dense_inputs(), **_lane_inputs(), "idx": sp["idx"],
              "val": sp["val"], "sy": sp["y"], "sa": sp["a"],
              "sv": sp["v"]}
    tmp = tmp_path_factory.mktemp("dense_mesh")
    np.savez(tmp / "in.npz", **inputs)
    script = tmp / "reference.py"
    script.write_text(textwrap.dedent(_REFERENCE))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, str(script), str(tmp / "in.npz"),
                        str(tmp / "out.npz")], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(tmp / "out.npz"))


def _cpu_mesh(pod, data, model):
    return make_host_mesh(pod=pod, data=data, model=model, device="cpu")


def _run(epoch_fn, st, epochs=2):
    out = []
    for e in range(epochs):
        st = epoch_fn(*st, e)
        out.append(st)
    return out


# ---------------------------------------------------------------------------
# the mesh programs against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", list(DENSE_CASES))
def test_make_dense_epoch_vs_reference_mesh(reference, tag):
    """Two epochs on the stacked mesh against the reference's shard_map
    program: the re-dealt X and y are exact; alpha and v within rtol
    1e-4, atol 1e-5 (XLA and PyTorch sum the margins and Gram entries
    in other orders, and the logistic bisection's libm calls round
    differently; the differences compound over 2 epochs)."""
    shape, kw = DENSE_CASES[tag]
    st = tuple(_dense_inputs()[k] for k in ("X", "y", "a", "v"))
    got = _run(make_dense_epoch(_dense_scale(local_solver="torch", **kw),
                                _cpu_mesh(*shape)), st)
    for e, out in enumerate(got):
        for k, t in zip(("X", "y"), out[:2]):
            np.testing.assert_array_equal(t.numpy(), reference[f"{tag}{e}_{k}"])
        for k, t in zip(("a", "v"), out[2:]):
            np.testing.assert_allclose(t.numpy(), reference[f"{tag}{e}_{k}"],
                                       rtol=1e-4, atol=1e-5)
    assert float(got[-1][3].abs().max()) > 0


def test_make_sparse_epoch_compress_sync_vs_reference_mesh(reference):
    """`glm-criteo-opt`'s knobs (int8 two-phase sync over data and
    model, a quarter of the buckets re-dealt) on (1, 2, 2): the re-dealt
    rows exact, alpha and v within rtol 1e-4, atol 1e-5."""
    sp = _sparse_inputs()
    st = tuple(sp[k] for k in ("idx", "val", "y", "a", "v"))
    got = _run(make_sparse_epoch(
        _sparse_scale(compress_pod=False, local_solver="torch"),
        _cpu_mesh(1, 2, 2)), st)
    for e, out in enumerate(got):
        for k, t in zip(("idx", "val", "y"), out[:3]):
            np.testing.assert_array_equal(t.numpy(),
                                          reference[f"sparse{e}_{k}"])
        for k, t in zip(("a", "v"), out[3:]):
            np.testing.assert_allclose(t.numpy(), reference[f"sparse{e}_{k}"],
                                       rtol=1e-4, atol=1e-5)
    assert float(got[-1][4].abs().max()) > 0


# ---------------------------------------------------------------------------
# int8 wire reductions, bitwise
# ---------------------------------------------------------------------------


def test_compiled_compress_payload_exact(reference):
    """The int8 payload and scale of each lane's vector equal the
    reference's compiled `compress` (a multiply by f32(1/127))."""
    for i, row in enumerate(_lane_inputs()["dv"]):
        qz, _ = compress(torch.as_tensor(row))
        np.testing.assert_array_equal(qz.q.numpy(), reference[f"q{i}"])
        np.testing.assert_array_equal(qz.scale.numpy(), reference[f"s{i}"])


@pytest.mark.parametrize("layout", ["lanes", "tp"])
def test_lane_sum_compress_vs_reference(reference, layout):
    """`lane_sum(compress=True)` against the reference's
    `MeshCollectives.lane_sum(compress=True)` under shard_map on (data
    2, model 2), every lane's result.  "lanes": the model axis carries
    examples, q_psum over data then model, d 61 (padded to 62, then 62
    over 2).  "tp": each model lane reduces its own 31-entry slice over
    data (padded to 32), one scale per slice.

    Within rtol 1e-6, not bitwise: XLA on the CPU contracts phase 1's
    products and sum into fused multiply-adds (acc = fma(q_i, s_i, acc)
    in lane order; a numpy model of that matches the reference bit for
    bit), while the port multiplies and adds in separate roundings, as
    it does on the card, where its result must equal the CPU's.  The
    int8 payloads are exact (`test_compiled_compress_payload_exact`)."""
    li = _lane_inputs()
    if layout == "lanes":
        coll = engine.StackedMeshCollectives(pods=1, lanes=4, model=2)
        dv = torch.as_tensor(li["dv"])[None]
    else:
        coll = engine.StackedMeshCollectives(pods=1, lanes=2, model=2,
                                             model_role="tp")
        dv = torch.as_tensor(li["dv_tp"])[None]
    got = coll.lane_sum(dv, compress=True)[0].numpy()
    want = reference[f"lane_sum_{layout}"]
    for row in want:
        np.testing.assert_allclose(got, row, rtol=1e-6, atol=0)
    # it differs from the f32 sum only by the int8 rounding
    exact = coll.lane_sum(dv)[0].numpy()
    assert 0 < np.abs(got - exact).max() < 0.05 * np.abs(exact).max()


def test_q_psum_one_lane_passes_through():
    x = torch.randn(3, 1, 10, generator=torch.Generator().manual_seed(0))
    assert torch.equal(engine.q_psum(x), x[:, 0])


def test_ef_allreduce_vs_reference(reference):
    """The error-feedback int8 all-reduce over 4 lanes against the
    reference's `ef_allreduce` under shard_map: the sum, which every
    lane holds, and each lane's new residual, exact."""
    li = _lane_inputs()
    red, err = ef_allreduce(torch.as_tensor(li["x"]), torch.as_tensor(li["err"]))
    for row in reference["ef_sum"]:
        np.testing.assert_array_equal(red.numpy(), row)
    np.testing.assert_array_equal(err.numpy(), reference["ef_err"])


# ---------------------------------------------------------------------------
# sim equals mesh
# ---------------------------------------------------------------------------


def _stacked(X, P, K):
    d, n = X.shape
    return np.ascontiguousarray(
        X.reshape(d, P, K, n // K // P).transpose(1, 2, 0, 3))


@pytest.mark.parametrize("pod,data,compress_pod", [(1, 4, False),
                                                   (2, 2, True)])
def test_dense_sim_equals_mesh_bitwise(pod, data, compress_pod):
    """The stacked mesh (model 1, deterministic) equals the port's
    `sim_sharded_dense_epoch` on the same stacked layout, bitwise, after
    each of 2 epochs (X, y, alpha and v)."""
    scale = _dense_scale(compress_pod=compress_pod, local_solver="torch")
    mesh = _cpu_mesh(pod, data, 1)
    inp = _dense_inputs()
    mst = tuple(inp[k] for k in ("X", "y", "a", "v"))
    sst = (_stacked(inp["X"], pod, data), inp["y"].reshape(pod, data, -1),
           inp["a"].reshape(pod, data, -1), inp["v"])
    spec = scale.engine_config(mesh)
    ep = make_dense_epoch(scale, mesh)
    for e in range(2):
        mst = ep(*mst, e)
        sst = engine.sim_sharded_dense_epoch(
            LOGISTIC, spec, *sst, e, lam=scale.lam, n_total=N, device="cpu")
        Xs = sst[0].permute(2, 0, 1, 3).reshape(D, N)
        for m, s in zip(mst, (Xs, sst[1].reshape(N), sst[2].reshape(N),
                              sst[3])):
            assert torch.equal(m, s)
    assert float(mst[3].abs().max()) > 0


def test_sim_sharded_dense_epoch_vs_reference():
    """The port's `sim_sharded_dense_epoch` against the reference's,
    called in-process with no mesh, 2 pods x 2 lanes, int8 pod reduce,
    2 epochs: X and y exact, alpha and v within rtol 1e-4, atol 1e-5."""
    from repro.core.config import EngineConfig as JConfig
    kw = dict(pods=2, lanes=2, bucket=8, chunks=2, partition="alltoall",
              compress_pod=True, deterministic=True)
    inp = _dense_inputs()
    st = (_stacked(inp["X"], 2, 2), inp["y"].reshape(2, 2, -1),
          inp["a"].reshape(2, 2, -1), inp["v"])
    jst = tuple(jnp.asarray(t) for t in st)
    jspec = JConfig.make(**kw, local_solver="xla")
    jep = jax.jit(lambda X, y, a, v, e: jengine.sim_sharded_dense_epoch(
        jobj.LOGISTIC, jspec, X, y, a, v, e, lam=1e-2, n_total=N))
    spec = EngineConfig.make(**kw, local_solver="torch")
    for e in range(2):
        jst = jep(*jst, jnp.int32(e))
        st = engine.sim_sharded_dense_epoch(LOGISTIC, spec, *st, e, lam=1e-2,
                                            n_total=N, device="cpu")
        for t, j in zip(st[:2], jst[:2]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        for t, j in zip(st[2:], jst[2:]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


def test_tp_epochs_converge():
    """15 TP epochs on (2, 2, 2), n 1,024, d 64: gap < 1e-3, as the
    reference's tests/test_distributed.py asserts of its mesh."""
    n, d = 1024, 64
    X, y = make_dense_classification(n=n, d=d, seed=0)
    sc = GLMScale("t", "dense", n=n, d=d, bucket=8, chunks=2, lam=1e-2,
                  feature_shard=True, compress_pod=False)
    ep = make_dense_epoch(sc, _cpu_mesh(2, 2, 2))
    st = (X, y, np.zeros(n, np.float32), np.zeros(d, np.float32))
    for e in range(15):
        st = ep(*st, e)
    Xn, yn, a, v = st
    assert abs(float(duality_gap(LOGISTIC, a, v, Xn, yn, 1e-2))) < 1e-3


@pytest.mark.parametrize("name", OBJS)
def test_tp_pass_vs_reference_model_axis(name):
    """`dense_local_subepoch(model_lanes=2)` against the reference's
    single-lane `dense_local_subepoch` on the whole d: the two lanes'
    packed partials, summed, are the whole-d margins and Gram entries
    up to the order of the sums (rtol 1e-5, atol 1e-6).  (The
    reference's own TP route runs in its mesh program, held above.)"""
    rng = np.random.default_rng(3)
    d, n, B = 16, 64, 8
    X = rng.standard_normal((d, n)).astype(np.float32) / 4
    y = (rng.standard_normal(n) if name == "ridge"
         else rng.choice([-1.0, 1.0], n)).astype(np.float32)
    a = np.zeros(n, np.float32)
    v0 = (0.1 * rng.standard_normal(d)).astype(np.float32)
    obj = get_objective(name)
    lam, sig = torch.tensor(6.4), torch.tensor(2.0)
    ta, tdv = sdca.dense_local_subepoch(
        obj, *(torch.as_tensor(t) for t in (X, y, a, v0)), lam, sig, B,
        model_lanes=2)
    ja, jdv = jsdca.dense_local_subepoch(
        jobj.get_objective(name), *(jnp.asarray(t) for t in (X, y, a, v0)),
        jnp.float32(6.4), jnp.float32(2.0), B)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tdv.numpy(), np.asarray(jdv), rtol=1e-5,
                               atol=1e-6)


def _tp_kernel_route_epoch(mesh, scale, st, epoch):
    """One epoch of `make_dense_epoch`'s TP program with the dense
    KERNEL solver, whose wrapper runs its plain version on the CPU
    (`make_local_solver` reserves "kernel" for the card)."""
    W = glm._worker_count(mesh, scale)
    spec = scale.engine_config(mesh)
    coll = glm._collectives(mesh, scale)
    X, y, a, v = (torch.as_tensor(t) for t in st)
    d, n = X.shape
    P, K = coll.pods, coll.lanes
    solver = engine.dense_kernel_solver(
        LOGISTIC, scale.lam * scale.n, spec.sigma_prime(W), scale.bucket)
    blk, y, a, v = engine.run_epoch(
        coll, solver, spec.algo,
        engine.DenseBlock(X.reshape(d, P, K, -1).permute(1, 2, 0, 3)),
        y.reshape(P, K, -1), a.reshape(P, K, -1), v, epoch)
    return (blk.X.permute(2, 0, 1, 3).reshape(d, n), y.reshape(n),
            a.reshape(n), v)


def test_tp_kernel_route_bitwise_vs_example_parallel():
    """The TP program on (2, 2, 2) through the dense kernel's wrapper
    equals, bitwise, the example-parallel "torch" program on the same
    P x D = 4 workers, (2, 2, 1): same keys, re-deal, sigma' and sums;
    and it holds to the TP "torch" route within rtol 1e-4, atol 1e-5
    (that route sums the lanes' partials in lane order)."""
    inp = _dense_inputs()
    st = tuple(inp[k] for k in ("X", "y", "a", "v"))
    tp = _dense_scale(feature_shard=True, local_solver="torch")
    ex = make_dense_epoch(_dense_scale(feature_shard=False,
                                       local_solver="torch"),
                          _cpu_mesh(2, 2, 1))
    tp_torch = make_dense_epoch(tp, _cpu_mesh(2, 2, 2))
    kst, tst = st, st
    for e in range(2):
        want = ex(*kst, e)
        kst = _tp_kernel_route_epoch(_cpu_mesh(2, 2, 2), tp, kst, e)
        for k, w in zip(kst, want):
            assert torch.equal(k, w)
        tst = tp_torch(*tst, e)
        for k, t in zip(kst, tst):
            np.testing.assert_allclose(k.numpy(), t.numpy(), rtol=1e-4,
                                       atol=1e-5)
    assert float(kst[3].abs().max()) > 0


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_refusals():
    with pytest.raises(ValueError, match="needs CUDA"):
        engine.make_local_solver("kernel", LOGISTIC, 1.0, 2.0, bucket=8,
                                 model_lanes=2, device="cpu")
    bad = GLMScale("t", "dense", n=N, d=63, bucket=8, chunks=2,
                   feature_shard=True)
    with pytest.raises(ValueError, match="multiple"):
        make_dense_epoch(bad, _cpu_mesh(1, 2, 2))
    solve = engine.make_local_solver("torch", LOGISTIC, 1.0, 2.0, bucket=8,
                                     model_lanes=2, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        solve(torch.zeros(1, 63, 16), torch.ones(1, 16), torch.zeros(1, 16),
              torch.zeros(1, 63))
    with pytest.raises(ValueError, match="fitted estimator"):
        estimator_epoch(LogisticRegression(device="cpu"), _cpu_mesh(1, 2, 1))


# ---------------------------------------------------------------------------
# the naive oracle
# ---------------------------------------------------------------------------


def _oracle_inputs(name, d=12, n=32, seed=5):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((d, n)) / np.sqrt(d)).astype(np.float32)
    if name == "ridge":
        y = rng.standard_normal(n).astype(np.float32)
        a = (0.1 * rng.standard_normal(n)).astype(np.float32)
    else:
        y = rng.choice([-1.0, 1.0], n).astype(np.float32)
        a = (y * rng.uniform(0.05, 0.5, n)).astype(np.float32)
    v0 = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return X, y, a, v0


@pytest.mark.parametrize("name", OBJS)
def test_sdca_subepoch_ref_vs_reference(name):
    args = _oracle_inputs(name)
    ta, tv = sdca_subepoch_ref(get_objective(name),
                               *(torch.as_tensor(t) for t in args), 3.2, 2.0)
    ja, jv = jref.sdca_subepoch_ref(jobj.get_objective(name),
                                    *(jnp.asarray(t) for t in args), 3.2, 2.0)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", OBJS)
@pytest.mark.parametrize("B", [1, 8])
def test_bucket_pass_vs_naive_oracle(name, B):
    """The Gram reformulation equals the per-coordinate algorithm at
    any bucket (rtol 1e-5, atol 1e-6), with two leading worker axes."""
    X, y, a, v0 = (torch.as_tensor(np.stack([t, t[..., ::-1].copy()]))
                   for t in _oracle_inputs(name))
    obj = get_objective(name)
    ra, rv = sdca_subepoch_ref(obj, X, y, a, v0, 3.2, 2.0)
    ba, bdv = sdca.dense_local_subepoch(obj, X, y, a, v0, torch.tensor(3.2),
                                        torch.tensor(2.0), B)
    np.testing.assert_allclose(ba.numpy(), ra.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bdv.numpy(), ((rv - v0) / 2.0).numpy(),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# estimator_epoch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("partition", ["static", "alltoall"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_estimator_epoch_bitwise_vs_sim(kind, partition):
    """A fitted `LogisticRegression`'s program on (pod 2, data 2, model
    1) equals `sim_sharded_*_epoch` from the fit's state, bitwise."""
    kw = dict(lam=1e-2, bucket=8, pods=2, lanes=2, chunks=2,
              partition=partition, deterministic=True, max_epochs=2,
              tol=0.0, device="cpu")
    if kind == "dense":
        X, y = make_dense_classification(n=256, d=16, seed=1)
        est = LogisticRegression(**kw).fit(X.T, y)
    else:
        (idx, val), y, d = make_sparse_classification(n=256, d=48, nnz=8,
                                                      seed=1)
        est = LogisticRegression(**kw, n_features=d).fit((idx, val), y)
    mesh = _cpu_mesh(2, 2, 1)
    ep, scale = estimator_epoch(est, mesh)
    ses = est.session_
    assert (scale.kind, scale.n, scale.d, scale.partition) == (
        kind, ses.n, ses.d, partition)
    spec = scale.engine_config(mesh)
    n = ses.n
    lead = lambda t: t.reshape((2, 2, -1) + tuple(t.shape[1:]))
    if kind == "dense":
        got = ep(ses.X, ses.y, ses.alpha, ses.v, 2)
        Xs = ses.X.reshape(ses.d, 2, 2, -1).permute(1, 2, 0, 3)
        sim = engine.sim_sharded_dense_epoch(
            LOGISTIC, spec, Xs, lead(ses.y), lead(ses.alpha), ses.v, 2,
            lam=scale.lam, n_total=n, device="cpu")
        sim = (sim[0].permute(2, 0, 1, 3).reshape(ses.d, n),
               sim[1].reshape(n), sim[2].reshape(n), sim[3])
    else:
        got = ep(ses.idx, ses.val, ses.y, ses.alpha, ses.v, 2)
        sim = engine.sim_sharded_sparse_epoch(
            LOGISTIC, spec, lead(ses.idx), lead(ses.val), lead(ses.y),
            lead(ses.alpha), ses.v, 2, lam=scale.lam, n_total=n,
            device="cpu")
        sim = (sim[0].reshape(n, -1), sim[1].reshape(n, -1),
               sim[2].reshape(n), sim[3].reshape(n), sim[4])
    for g, s in zip(got, sim):
        assert torch.equal(g, s)
    assert not torch.equal(got[-1], ses.v)
