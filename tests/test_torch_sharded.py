"""The port's feature-sharded sparse path against the JAX reference.

Covers, at small sizes on the CPU:
  * `kernels.ops.sparse_slice_width` and the sharded routes of
    `sparse_solver_plan`;
  * the plain versions of the two sharded kernels against the
    reference's Pallas kernels in interpret mode, bucket by bucket
    (the harness of tests/test_kernels.py's emulated exchange; the
    gather's own forms are in tests/test_torch_gather.py);
  * `ops.sharded_tiles`' links, walked by a numpy copy of the CUDA
    kernel's loops (the kernel itself runs only on the card, where
    chip_smoke.py holds it against its plain version);
  * `ops.sdca_sparse_sharded_subepoch` bitwise against the port's own
    replicated scan;
  * `launch.glm.make_sparse_epoch` on a stacked (pod, data, model) mesh
    against the reference's shard_map epoch on 4 forced host devices,
    run in a subprocess as tests/test_engine.py runs its mesh tests.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.kernels import ops as jops                         # noqa: E402
from repro.kernels import sdca_sparse_bucket as jsb           # noqa: E402
from repro.core import objectives as jobj                     # noqa: E402
from repro_torch.core import engine, sdca                     # noqa: E402
from repro_torch.core.objectives import get_objective         # noqa: E402
from repro_torch.data.synthetic import make_sparse_classification  # noqa: E402
from repro_torch.kernels import ops                           # noqa: E402
from repro_torch.kernels import sdca_sparse_bucket as ks      # noqa: E402
from repro_torch.launch.glm import GLMScale, make_sparse_epoch  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh            # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
OBJS = ["ridge", "hinge", "logistic"]
LAM_N, SIG = 3.2, 2.0


def _worker_data(name, W, n_local, d, nnz, seed):
    """(W, n_local, nnz) skewed padded-CSR rows (repeated ids, zeroed as
    the CSR invariant asks) with labels, duals and a v per worker."""
    (idx, val), y, _ = make_sparse_classification(
        n=W * n_local, d=d, nnz=nnz, seed=seed, skew=1.0)
    rng = np.random.default_rng(seed)
    if name == "ridge":
        y = rng.normal(size=y.shape).astype(np.float32)
        a = (0.1 * rng.normal(size=y.shape)).astype(np.float32)
    else:
        a = (y * rng.uniform(0.05, 0.5, size=y.shape)).astype(np.float32)
    v0 = (0.1 * rng.normal(size=(W, d))).astype(np.float32)
    return (idx.reshape(W, n_local, nnz), val.reshape(W, n_local, nnz),
            y.reshape(W, n_local), a.reshape(W, n_local), v0)


# ---------------------------------------------------------------------------
# slice width and routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 7, 50, 250, 1_000_003, 16_609_280])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 8])
def test_slice_width_matches_reference(d, M):
    got = ops.sparse_slice_width(d, M)
    assert got == jops.sparse_slice_width(d, M)
    assert got % 8 == 0 and got * M >= d


#: (n_local, nnz, d, B, M) -> the port's route (Hopper budgets) and the
#: reference's (TPU VMEM budgets).  They agree on divisibility and on
#: narrow rows; at webspam width the reference's (B, nnz, nnz) match
#: tensor blows its VMEM budget, while the port's sharded pair keeps its
#: working set in global memory and takes it, and so does the replicated
#: kernel on one lane.  A bucket of 64 criteo rows (2,560 entries) is
#: too large for the replicated kernel's shared-memory stages: one lane
#: keeps them in global memory, more lanes take the sharded pair.
ROUTES = [
    (64, 8, 4_096, 8, 1, "kernel", "pallas-replicated"),
    (64, 8, 4_096, 8, 4, "kernel", "pallas-replicated"),
    (12, 8, 4_096, 8, 4, "torch", "xla"),
    (64, 8, 8_388_608, 8, 8, "kernel", "pallas-sharded"),
    (2_048, 3_728, 16_609_280, 16, 4, "kernel-sharded", "xla"),
    (2_048, 3_728, 16_609_280, 16, 1, "kernel", "xla"),
    (256, 40, 1_000_000, 64, 1, "kernel", "pallas-replicated"),
    (256, 40, 1_000_000, 64, 2, "kernel-sharded", "pallas-replicated"),
]


@pytest.mark.parametrize("n_local,nnz,d,B,M,route,ref_route", ROUTES)
def test_sharded_routes_against_reference(n_local, nnz, d, B, M, route,
                                          ref_route):
    got, why = ops.sparse_solver_plan(n_local, nnz, d, B, model_lanes=M)
    assert got == route
    assert jops.sparse_solver_plan(n_local, nnz, d, B,
                                   model_lanes=M)[0] == ref_route
    if route == "torch":
        assert why.code == ops.MisfitCode.BUCKET_INDIVISIBLE
        assert ops.sparse_kernel_misfit(n_local, nnz, d, B,
                                        model_lanes=M) == why
    else:
        assert why is None
        assert ops.sparse_kernel_misfit(n_local, nnz, d, B,
                                        model_lanes=M) is None


# ---------------------------------------------------------------------------
# the two kernels' plain versions against the reference's Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", OBJS)
@pytest.mark.parametrize("d", [50, 250])          # uneven slices + padding
@pytest.mark.parametrize("M", [2, 4])
def test_sharded_pair_plain_vs_reference(name, d, M):
    """Bucket by bucket, every lane: the gather is BITWISE the
    reference's per-lane gathers after its all-gather and owner-select;
    the sharded bucket is within rtol 1e-6, atol 1e-6 of it, because
    the reference sums each margin with XLA's reduction and the port
    left to right (hinge divides by q, which turns a one-ulp margin
    difference into an absolute one near zero).  Both sides get the
    reference's state at every bucket."""
    n, nnz, B = 32, 8, 16
    idx, val, y, a, v0 = _worker_data(name, 1, n, d, nnz, seed=3 + M + d)
    obj, jo = get_objective(name), jobj.get_objective(name)
    d_loc = ops.sparse_slice_width(d, M)
    idxb, valb, yb, ab, qb, links, v_loc = ops.sharded_tiles(
        *map(torch.as_tensor, (idx, val, y, a, v0)), bucket=B,
        model_lanes=M)
    jv = [jnp.asarray(v_loc[0, k].numpy())[:, None] for k in range(M)]
    scal = jnp.stack([jnp.float32(LAM_N), jnp.float32(SIG)])
    for b in range(n // B):
        idx_t = jnp.asarray(idxb[0, b].numpy())
        parts = jnp.stack([jsb.sdca_sparse_gather_bucket(
            idx_t, jv[k], jnp.int32(k * d_loc), True) for k in range(M)])
        owner = (idx_t // jnp.int32(d_loc)).astype(jnp.int32)
        jW = np.asarray(jnp.take_along_axis(parts, owner[None], axis=0)[0])
        W = ks.sdca_sparse_gather_bucket(idxb, b, v_loc)
        np.testing.assert_array_equal(W[0].numpy().view(np.int32),
                                      jW.view(np.int32))
        a_t = ks.sdca_sparse_sharded_bucket(obj, idxb, valb, yb, ab, qb,
                                            links, b, W, v_loc, LAM_N, SIG)
        for k in range(M):
            ja, jv[k] = jsb.sdca_sparse_sharded_bucket(
                jo, idx_t, jnp.asarray(valb[0, b].numpy()),
                jnp.asarray(yb[0, b].numpy()), jnp.asarray(ab[0, b].numpy()),
                jnp.asarray(qb[0, b].numpy()), jnp.asarray(jW),
                jv[k], scal, jnp.int32(k * d_loc), True)
            np.testing.assert_allclose(a_t[0, k].numpy(), np.asarray(ja),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(v_loc[0, k].numpy(),
                                       np.asarray(jv[k])[:, 0],
                                       rtol=1e-6, atol=1e-6)
            v_loc[0, k] = torch.tensor(np.asarray(jv[k])[:, 0])


# ---------------------------------------------------------------------------
# the CUDA kernel's walk over ops.sharded_tiles' links, in numpy
# ---------------------------------------------------------------------------


def _emulate_sharded_kernel(obj, idxb, valb, yb, ab, qb, links, b, W,
                            v_loc, lam_n, sig):
    """The loops of csrc/sdca_sparse_sharded_bucket.cu (and the walk of
    csrc/sparse_recursion.cuh), one block at a time, in float32 (the
    delta is the plain version's, on one row)."""
    f = np.float32
    Wk, nb, B, nnz = idxb.shape
    M, d_loc = v_loc.shape[1:]
    E = B * nnz
    a_out = np.empty((Wk, M, B), np.float32)
    v = v_loc.numpy().copy()
    for g in range(Wk * M):
        w, lane = divmod(g, M)
        idx = idxb[w, b].reshape(-1).numpy()
        val = valb[w, b].reshape(-1).numpy()
        pos, slot, run_len, group_len, rpos = links[w, b].numpy()
        S = np.full(E, np.nan, np.float32)
        Wg = W[w].reshape(-1).numpy()         # the worker's, every lane
        for t in range(E):
            if group_len[t] > 0:
                S[pos[t]] = Wg[t]
        for i in range(B):
            r = range(i * nnz, (i + 1) * nnz)
            m = f(0)
            for t in r:                       # lane 0, chunk by chunk
                m = f(m + f(S[slot[t]] * val[t]))
            q = f(f(f(sig) * qb[w, b, i].numpy()) / f(lam_n))
            d = float(obj.delta(torch.tensor(m), ab[w, b, i], yb[w, b, i],
                                torch.tensor(q)))
            a_out[w, lane, i] = f(ab[w, b, i].numpy() + f(d))
            c = f(f(f(sig) * f(d)) / f(lam_n))
            u_row = np.full(nnz, np.nan, np.float32)
            for t in r:
                u_row[rpos[t]] = f(c * val[t])
            for t in r:
                if run_len[t] > 0:
                    acc = S[slot[t]]
                    for j in range(run_len[t]):
                        acc = f(acc + u_row[rpos[t] + j])
                    S[slot[t]] = acc
        for t in range(E):                    # the owned scatter
            q = idx[t] - lane * d_loc
            if group_len[t] > 0 and 0 <= q < d_loc:
                v[w, lane, q] = S[pos[t]]
    return torch.as_tensor(a_out), torch.as_tensor(v)


@pytest.mark.parametrize("name", OBJS)
@pytest.mark.parametrize("d,M", [(50, 2), (250, 4)])
def test_kernel_walk_over_links_is_the_plain_bucket(name, d, M):
    """The kernel's algorithm (slots in (id, position) order, row runs,
    feature groups) on `sharded_tiles`' links gives the plain version's
    bits, on rows that repeat ids (zero-valued duplicates)."""
    Wk, n, nnz, B = 2, 32, 8, 16
    idx, val, y, a, v0 = _worker_data(name, Wk, n, d, nnz, seed=7 + d)
    assert any(len(set(r)) < nnz for r in idx.reshape(-1, nnz))
    obj = get_objective(name)
    idxb, valb, yb, ab, qb, links, v_loc = ops.sharded_tiles(
        *map(torch.as_tensor, (idx, val, y, a, v0)), bucket=B,
        model_lanes=M)
    for b in range(n // B):
        W = ks.sdca_sparse_gather_bucket(idxb, b, v_loc)
        a_e, v_e = _emulate_sharded_kernel(obj, idxb, valb, yb, ab, qb,
                                           links, b, W, v_loc, LAM_N, SIG)
        a_p = ks.sdca_sparse_sharded_bucket(obj, idxb, valb, yb, ab, qb,
                                            links, b, W, v_loc, LAM_N, SIG)
        assert torch.equal(a_e, a_p) and torch.equal(v_e, v_loc)


@pytest.mark.parametrize("name", OBJS)
def test_kernel_walk_on_the_exchanged_w_keeps_signed_zeros(name):
    """The kernel's scatter writes each owned feature's final cell, which
    started at the feature's W value: that is the slice's new value
    because the gather hands every lane the owner's own bits.  Shown
    with -0.0 in the slice at an id of every bucket's first row (a sum
    of the lanes' partial working sets would turn it into +0.0): W
    holds the slice's bits at every owned entry, and the emulated walk
    gives the plain version's bits."""
    Wk, n, nnz, B, d, M = 2, 32, 8, 16, 50, 2
    idx, val, y, a, v0 = _worker_data(name, Wk, n, d, nnz, seed=5)
    for w in range(Wk):
        v0[w, idx[w, ::B, 0]] = -0.0
    obj = get_objective(name)
    idxb, valb, yb, ab, qb, links, v_loc = ops.sharded_tiles(
        *map(torch.as_tensor, (idx, val, y, a, v0)), bucket=B,
        model_lanes=M)
    d_loc = v_loc.shape[-1]
    negz = 0
    for b in range(n // B):
        W = ks.sdca_sparse_gather_bucket(idxb, b, v_loc)
        for w in range(Wk):
            ids = idxb[w, b].reshape(-1).long()
            owner, q = ids // d_loc, ids % d_loc
            for lane in range(M):
                mine = owner == lane
                got = W[w].reshape(-1)[mine]
                want = v_loc[w, lane, q[mine]]
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))
                negz += int((want.view(torch.int32)
                             == torch.tensor(-0.0).view(torch.int32)).sum())
        a_e, v_e = _emulate_sharded_kernel(obj, idxb, valb, yb, ab, qb,
                                           links, b, W, v_loc, LAM_N, SIG)
        a_p = ks.sdca_sparse_sharded_bucket(obj, idxb, valb, yb, ab, qb,
                                            links, b, W, v_loc, LAM_N, SIG)
        assert torch.equal(a_e, a_p) and torch.equal(v_e, v_loc)
    assert negz > 0


def test_links_layout():
    """pos is a permutation, slots point at each feature's first entry,
    the run and group lengths count every entry once, and rpos puts
    each row's run of a feature together, from its first entry."""
    idx = torch.tensor([[[5, 0, 5, 0], [0, 9, 5, 5]]], dtype=torch.int32)
    links = ops._bucket_links(idx[:, None])[0, 0]
    pos, slot, run_len, group_len, rpos = links.tolist()
    # sorted (id, t): 0@1 0@3 0@4 | 5@0 5@2 5@6 5@7 | 9@5
    assert pos == [3, 0, 4, 1, 2, 7, 5, 6]
    assert slot == [3, 0, 3, 0, 0, 7, 3, 3]
    assert run_len == [2, 2, 0, 0, 1, 1, 2, 0]
    assert group_len == [4, 3, 0, 0, 0, 1, 0, 0]
    # rows sorted (id, k): 0@1 0@3 5@0 5@2 | 0@0 5@2 5@3 9@1
    assert rpos == [2, 0, 3, 1, 0, 3, 1, 2]


# ---------------------------------------------------------------------------
# the sharded sub-epoch against the port's own replicated scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", OBJS)
@pytest.mark.parametrize("d", [50, 250])
@pytest.mark.parametrize("M", [2, 4])
def test_sharded_subepoch_bitwise_vs_replicated(name, d, M):
    """Every lane's duals and the lanes' dv slices, summed in lane
    order, are bitwise the replicated scan's; each lane's dv is zero
    outside its slice."""
    W, n, nnz = 3, 48, 8
    args = [torch.as_tensor(t) for t in
            _worker_data(name, W, n, d, nnz, seed=11 + d + M)]
    obj = get_objective(name)
    a_r, dv_r = sdca.sparse_local_subepoch(
        obj, *args, torch.tensor(LAM_N), torch.tensor(SIG))
    a_s, dv_s = ops.sdca_sparse_sharded_subepoch(
        obj, *args, LAM_N, SIG, bucket=16, model_lanes=M)
    assert a_s.shape == (W, M, n) and dv_s.shape == (W, M, d)
    for m in range(M):
        assert torch.equal(a_s[:, m], a_r)
    d_loc = ops.sparse_slice_width(d, M)
    lane = torch.arange(d) // d_loc
    total = dv_s[:, 0]
    for m in range(1, M):
        total = total + dv_s[:, m]
    assert torch.equal(total, dv_r)
    for m in range(M):
        assert not bool(dv_s[:, m, lane != m].any())
    assert float(dv_r.abs().max()) > 0


# ---------------------------------------------------------------------------
# the mesh epoch
# ---------------------------------------------------------------------------

N, D, NNZ = 256, 250, 8
SCALE = dict(n=N, d=D, nnz=NNZ, bucket=8, chunks=2, lam=1e-2,
             deterministic=True)

_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.glm import GLMScale, make_sparse_epoch
from repro.launch.mesh import make_host_mesh

z = np.load(sys.argv[1])
out = {}
for tag, shard, solver in (("sharded", True, "pallas"),
                           ("examples", False, "xla")):
    sc = GLMScale("s", "sparse", n=%(n)d, d=%(d)d, nnz=%(nnz)d, bucket=8,
                  chunks=2, lam=1e-2, compress_pod=False, deterministic=True,
                  local_solver=solver, feature_shard=shard)
    mesh = make_host_mesh(pod=1, data=2, model=2)
    with mesh:
        ep = jax.jit(make_sparse_epoch(sc, mesh, interpret=True))
        st = tuple(jnp.asarray(z[k]) for k in ("idx", "val", "y", "a", "v"))
        for e in range(2):
            st = ep(*st, jnp.int32(e))
            for k, t in zip(("idx", "val", "y", "a", "v"), st):
                out[f"{tag}{e}_{k}"] = np.asarray(t)
np.savez(sys.argv[2], **out)
""" % dict(n=N, d=D, nnz=NNZ)


@pytest.fixture(scope="module")
def mesh_case(tmp_path_factory):
    """The reference's 2-epoch mesh runs on (pod=1, data=2, model=2),
    feature-sharded (Pallas kernels, interpret mode) and with the model
    axis as example lanes (XLA scan)."""
    (idx, val), y, _ = make_sparse_classification(n=N, d=D, nnz=NNZ, seed=2)
    inputs = dict(idx=idx, val=val, y=y, a=np.zeros(N, np.float32),
                  v=np.zeros(D, np.float32))
    tmp = tmp_path_factory.mktemp("mesh")
    np.savez(tmp / "in.npz", **inputs)
    script = tmp / "reference.py"
    script.write_text(textwrap.dedent(_REFERENCE))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, str(script), str(tmp / "in.npz"),
                        str(tmp / "out.npz")], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return inputs, dict(np.load(tmp / "out.npz"))


def _port_epochs(mesh, epochs=2, **kw):
    (idx, val), y, _ = make_sparse_classification(n=N, d=D, nnz=NNZ, seed=2)
    ep = make_sparse_epoch(GLMScale("s", "sparse", **{**SCALE, **kw}), mesh)
    st = (idx, val, y, np.zeros(N, np.float32), np.zeros(D, np.float32))
    out = []
    for e in range(epochs):
        st = ep(*st, e)
        out.append([t.numpy() for t in st])
    return out


@pytest.mark.parametrize("tag,shard", [("sharded", True),
                                       ("examples", False)])
def test_make_sparse_epoch_vs_reference_mesh(mesh_case, tag, shard):
    """Two epochs on the stacked (1, 2, 2) mesh against the reference's
    shard_map program: the re-dealt idx/val/y are exact; alpha and v
    within rtol 1e-4, atol 1e-5 (XLA and PyTorch round the margins'
    reductions and the logistic bisection's libm calls differently, and
    the difference compounds over 2 epochs of 4 workers)."""
    _, ref = mesh_case
    got = _port_epochs(make_host_mesh(pod=1, data=2, model=2, device="cpu"),
                       compress_pod=False, local_solver="torch",
                       feature_shard=shard)
    for e, st in enumerate(got):
        for k, t in zip(("idx", "val", "y"), st[:3]):
            np.testing.assert_array_equal(t, ref[f"{tag}{e}_{k}"])
        for k, t in zip(("a", "v"), st[3:]):
            np.testing.assert_allclose(t, ref[f"{tag}{e}_{k}"], rtol=1e-4,
                                       atol=1e-5)
    assert np.abs(got[-1][4]).max() > 0


def _kernel_route_epoch(mesh, scale, st, epoch):
    """One epoch of `make_sparse_epoch`'s program with the sharded
    KERNEL solver, whose wrappers run their plain versions on the CPU
    (`make_local_solver` reserves "kernel" for the card)."""
    from repro_torch.launch import glm
    W = glm._worker_count(mesh, scale)
    spec = scale.engine_config(mesh)
    coll = glm._collectives(mesh, scale)
    idx, val, y, a, v = (torch.as_tensor(t) for t in st)
    P, K = coll.pods, coll.lanes
    solver = engine.sparse_sharded_kernel_solver(
        get_objective("logistic"), scale.lam * scale.n,
        spec.sigma_prime(W), scale.bucket, mesh.shape["model"])
    blk, y, a, v = engine.run_epoch(
        coll, solver, spec.algo,
        engine.SparseBlock(idx.reshape(P, K, -1, NNZ),
                           val.reshape(P, K, -1, NNZ)),
        y.reshape(P, K, -1), a.reshape(P, K, -1), v, epoch)
    return [blk.idx.reshape(N, NNZ), blk.val.reshape(N, NNZ),
            y.reshape(N), a.reshape(N), v]


@pytest.mark.parametrize("pod,compress", [(1, False), (2, True)])
def test_sharded_kernel_route_epoch_bitwise(pod, compress):
    """The mesh epoch through the sharded kernel pair is bitwise the
    masked-scan route's, and, with pod = 2 and the int8 pod reduce,
    bitwise the port's replicated stacked-sim epoch
    (`engine.sim_sharded_sparse_epoch`, SimCollectives)."""
    mesh = make_host_mesh(pod=pod, data=2, model=2, device="cpu")
    kw = dict(compress_pod=compress, feature_shard=True)
    scale = GLMScale("s", "sparse", **SCALE, **kw)
    torch_route = _port_epochs(mesh, local_solver="torch", **kw)
    (idx, val), y, _ = make_sparse_classification(n=N, d=D, nnz=NNZ, seed=2)
    st = (idx, val, y, np.zeros(N, np.float32), np.zeros(D, np.float32))
    spec = scale.engine_config(mesh)
    assert (spec.deployment.pods, spec.deployment.lanes) == (pod, 2)
    for e in range(2):
        kern = _kernel_route_epoch(mesh, scale, st, e)
        sim = engine.sim_sharded_sparse_epoch(
            get_objective("logistic"), spec,
            *(torch.as_tensor(t).reshape((pod, 2, -1) + t.shape[1:])
              for t in st[:4]), st[4], e, lam=scale.lam, n_total=N,
            device="cpu")
        sim = [t.reshape((N,) + t.shape[3:]) if t.ndim > 1 else t
               for t in sim]
        for k, p, s in zip(kern, torch_route[e], sim):
            assert np.array_equal(k.numpy(), p)
            assert np.array_equal(s.numpy(), p)
        st = [t.numpy() for t in kern]
    assert np.abs(st[4]).max() > 0


def test_stacked_mesh_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh(pod=1, data=2, model=2)
