"""Feature sharding across processes: a `launch.mesh.DistMesh` whose model
axis carries slices, one model lane a process, held bitwise to the
stacked mesh and within tolerance to the JAX reference.

One module-scoped spawn runs 4 CPU processes on the gloo backend on
(pod, data, model) = (1, 2, 2) (a file store under ``tmp_path``, a
timeout on the rendezvous, every collective and the join).  Each rank
runs, on its shards (`glm_input_specs`, `local_shard`):

  * dense tensor parallelism (`feature_shard` on a dense scale): the
    rank holds d/M rows of X and of v, and per bucket the lanes' packed
    [m0 | G] partials are summed over 'model' by an ordered all-gather
    (`sdca.dense_tp_bucket_pass`'s ``reduce`` hook);
  * sparse feature sharding: the rows replicated over 'model', v's
    slice owned by the rank's lane ("torch": the masked scan);
  * both with the int8 two-phase sync and a partial re-deal;
  * both through the kernels' route (`sdca_bucket_tp_subepoch`: the
    split pair; `sdca_sparse_sharded_subepoch` in its process form: B3
    on the lane's slice, the all-gather of the partial working sets,
    the owner-select, B4 with the lane's offset), whose wrappers run
    their plain versions on the CPU;
  * resident (`make_dense_epoch`/`make_sparse_epoch`), streamed
    (`make_streamed_epoch_mesh`, per-lane rows or slice-compacted
    feeds) and `Session(mesh=DistMesh, streamed=True)`, 3 epochs;
  * a journaled `Session` killed at a chunk and resumed by a new one:
    once with every rank at the same cursor, once with one rank a save
    ahead (`resilience.MeshJournal`, kills placed before and after a
    record's write);

and writes what it holds.  Here every state is `torch.equal` to the same
scale on the `StackedMesh` after each epoch (the resumed runs to an
uninterrupted stacked `Session`), and the two configurations that the
reference's mesh tests run (`tests/test_torch_dense_mesh.py`'s "tp",
`tests/test_torch_sharded.py`'s "sharded") are held to the reference's
shard_map programs, run once in a subprocess on 4 forced host devices,
within those files' rtol 1e-4 / atol 1e-5.  About 40 s on the CPU.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Session                           # noqa: E402
from repro_torch.core import engine, sdca                     # noqa: E402
from repro_torch.core.config import EngineConfig              # noqa: E402
from repro_torch.core.objectives import get_objective         # noqa: E402
from repro_torch.data.cache import ArrayFeed                  # noqa: E402
from repro_torch.data.synthetic import (make_dense_classification,  # noqa: E402
                                        make_sparse_classification)
from repro_torch.kernels import ops                           # noqa: E402
from repro_torch.kernels import sdca_sparse_bucket as ks      # noqa: E402
from repro_torch.launch import glm                            # noqa: E402
from repro_torch.launch.mesh import make_host_mesh            # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
MESH = (1, 2, 2)
EPOCHS = 3
SPAWN_TIMEOUT = 240          # seconds for the whole world to finish
B = 8

#: tag -> case: data (kind, n, d, nnz, seed), objective, lam, epochs,
#: GLMScale knobs, the local solver and the runs
CASES = {
    "tp": dict(data=("dense", 512, 64, 0, 5), obj="ridge", lam=1e-3,
               epochs=EPOCHS, knobs=dict(deterministic=True),
               solver="torch", runs=["resident", "streamed", "session"]),
    "tpcmp": dict(data=("dense", 512, 64, 0, 5), obj="ridge", lam=1e-3,
                  epochs=EPOCHS,
                  knobs=dict(deterministic=True, compress_sync=True,
                             redeal_frac=0.25),
                  solver="torch", runs=["resident", "streamed"]),
    "tpk": dict(data=("dense", 512, 64, 0, 5), obj="logistic", lam=1e-3,
                epochs=2, knobs=dict(deterministic=True), solver="kernel",
                runs=["resident", "streamed"]),
    "sl": dict(data=("sparse", 512, 250, 8, 6), obj="ridge", lam=1e-3,
               epochs=EPOCHS, knobs=dict(deterministic=True),
               solver="torch", runs=["resident", "streamed", "session"]),
    "slcmp": dict(data=("sparse", 512, 250, 8, 6), obj="ridge", lam=1e-3,
                  epochs=EPOCHS,
                  knobs=dict(deterministic=True, compress_sync=True,
                             redeal_frac=0.25),
                  solver="torch", runs=["resident", "streamed"]),
    "slk": dict(data=("sparse", 512, 250, 8, 6), obj="logistic", lam=1e-3,
                epochs=2, knobs=dict(deterministic=True), solver="kernel",
                runs=["resident", "streamed"]),
    # the reference's own mesh configurations (see REFERENCE below)
    "tpref": dict(data=("dense", 512, 64, 0, 0), obj="logistic", lam=1e-2,
                  epochs=2, knobs=dict(deterministic=True,
                                       compress_sync=True),
                  solver="torch", runs=["resident"]),
    "slref": dict(data=("sparse", 256, 250, 8, 2), obj="logistic",
                  lam=1e-2, epochs=2, knobs=dict(deterministic=True),
                  solver="torch", runs=["resident"]),
}

#: the journaled Sessions: tag -> (case whose data and knobs they train,
#: chunks, each rank's kill schedule)
JOURNAL = {
    "jtp": ("tp", 4, ["kill@e1c2"] * WORLD),
    "jsl": ("sl", 4, ["kill@e1c3:presave", "kill@e1c3:presave",
                      "kill@e1c3:postsave", "kill@e1c3:presave"]),
}

_RANK = r'''
import json, os, sys
import numpy as np
import torch

rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
from repro_torch.api import Session
from repro_torch.core import engine
from repro_torch.core.config import EngineConfig
from repro_torch.core.objectives import get_objective
from repro_torch.data.cache import ArrayFeed
from repro_torch.data.synthetic import (make_dense_classification,
                                        make_sparse_classification)
from repro_torch.launch import glm
from repro_torch.launch.mesh import make_dist_mesh
from repro_torch.resilience import FaultInjector, SimulatedCrash

spec = json.load(open(f"{root}/cases.json"))
B, MESH = spec["B"], tuple(spec["MESH"])
exec(spec["helpers"])
mesh = make_dist_mesh(pod=MESH[0], data=MESH[1], model=MESH[2],
                      backend="gloo", device="cpu",
                      init_method=f"file://{root}/store", rank=rank,
                      world_size=world, timeout=60)
out = {}
for tag, case in spec["cases"].items():
    scale, arrays, obj = case_scale(tag, case)
    sparse = scale.kind == "sparse"
    with kernel_route(case["solver"] == "kernel"):
        if "resident" in case["runs"]:
            specs = glm.glm_input_specs(scale, mesh)
            st = tuple(glm.local_shard(t, s, mesh) for t, s in zip(
                (*arrays, np.zeros(scale.n, np.float32),
                 np.zeros(scale.d, np.float32)), specs))
            ep = (glm.make_sparse_epoch if sparse else glm.make_dense_epoch)(
                scale, mesh, obj)
            for e in range(case["epochs"]):
                st = ep(*st, e)
                for i, t in enumerate(st):
                    out[f"{tag}/resident/{e}/{i}"] = t.numpy()
        if "streamed" in case["runs"]:
            em = glm.make_streamed_epoch_mesh(scale, mesh, feed_of(scale, arrays),
                                              obj)
            a, v = torch.zeros(scale.n), torch.zeros(scale.d)
            for e in range(case["epochs"]):
                a, v = em(a, v, e)
                out[f"{tag}/streamed/{e}/a"] = a.numpy().copy()
                out[f"{tag}/streamed/{e}/v"] = v.numpy().copy()
            out[f"{tag}/streamed/bytes"] = np.array(em.feed.bytes_h2d)
        if "session" in case["runs"]:
            s = Session(session_data(scale, arrays), objective=case["obj"],
                        lam=scale.lam, cfg=session_cfg(scale, 2),
                        streamed=True, mesh=mesh, device="cpu",
                        **({"d": scale.d} if sparse else {}))
            for e in range(case["epochs"]):
                s.epoch()
            out[f"{tag}/session/a"] = s.alpha.numpy()
            out[f"{tag}/session/v"] = s.v.numpy()

for tag, (base, chunks, kills) in spec["journal"].items():
    case = spec["cases"][base]
    scale, arrays, obj = case_scale(base, case)
    sparse = scale.kind == "sparse"
    kw = dict(objective=case["obj"], lam=scale.lam,
              cfg=session_cfg(scale, chunks), streamed=True, mesh=mesh,
              device="cpu", journal_dir=f"{root}/{tag}",
              **({"d": scale.d} if sparse else {}))
    s = Session(session_data(scale, arrays),
                faults=FaultInjector(kills[rank]), **kw)
    try:
        for e in range(case["epochs"]):
            s.epoch()
        out[f"{tag}/crashed"] = np.array(False)
    except SimulatedCrash:
        out[f"{tag}/crashed"] = np.array(True)
    mine = sorted(p.name for p in
                  __import__("pathlib").Path(f"{root}/{tag}/rank{rank}").iterdir()
                  if p.name.startswith("inflight."))
    out[f"{tag}/records"] = np.array(mine, dtype=str)
    s = Session(session_data(scale, arrays), **kw)
    out[f"{tag}/resumed_at"] = np.array(s.epochs_done)
    while s.epochs_done < case["epochs"]:
        s.epoch()
    out[f"{tag}/a"] = s.alpha.numpy()
    out[f"{tag}/v"] = s.v.numpy()

out["coords"] = np.array(mesh.coords)
out["foreign"] = np.array(sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")),
    dtype=str)
np.savez(f"{root}/rank{rank}.npz", **out)
'''

#: shared by the ranks and this module: a case's scale and data, its
#: feed and Session config, and the kernels' route on the CPU
_HELPERS = r'''
import contextlib


def case_scale(tag, case):
    kind, n, d, nnz, seed = case["data"]
    if kind == "dense":
        arrays = make_dense_classification(n=n, d=d, seed=seed)
    else:
        (idx, val), ys, _ = make_sparse_classification(n=n, d=d, nnz=nnz,
                                                       seed=seed)
        arrays = (idx, val, ys)
    scale = glm.GLMScale(tag, kind, n=n, d=d, nnz=nnz, bucket=B, chunks=2,
                         lam=case["lam"], feature_shard=True,
                         compress_pod=False, local_solver=case["solver"],
                         **case["knobs"])
    return scale, arrays, get_objective(case["obj"])


def feed_of(scale, arrays):
    if scale.kind == "sparse":
        idx, val, ys = arrays
        return ArrayFeed(ys, idx=idx, val=val, d=scale.d, bucket=B,
                         device="cpu")
    X, y = arrays
    return ArrayFeed(y, X=X, bucket=B, device="cpu")


def session_data(scale, arrays):
    return (((arrays[0], arrays[1]), arrays[2]) if scale.kind == "sparse"
            else arrays)


def session_cfg(scale, chunks):
    return EngineConfig.make(
        pods=MESH[0], lanes=MESH[1], bucket=B, chunks=chunks,
        partition="alltoall", feature_shard=True, compress_pod=False,
        deterministic=scale.deterministic,
        compress_sync=scale.compress_sync, redeal_frac=scale.redeal_frac)


@contextlib.contextmanager
def kernel_route(on):
    """"kernel" on the CPU: the kernels' wrappers (plain versions here)
    in place of `make_local_solver`'s refusal; the stacked mesh runs the
    split pair too (split_tp), the process mesh's twin."""
    orig = engine.make_local_solver
    if on:
        def make(kind, obj, lam_n, sig, *, bucket=1, sparse=False,
                 model_lanes=None, lane=None, exchange=None,
                 split_tp=False, device="cuda"):
            if sparse:
                return engine.sparse_sharded_kernel_solver(
                    obj, lam_n, sig, bucket, model_lanes, lane, exchange)
            return engine.dense_tp_kernel_solver(obj, lam_n, sig, bucket,
                                                 model_lanes, exchange)
        engine.make_local_solver = make
    try:
        yield
    finally:
        engine.make_local_solver = orig
'''

exec(_HELPERS)

#: the reference's shard_map programs for "tpref" and "slref", as
#: tests/test_torch_dense_mesh.py and tests/test_torch_sharded.py run them
_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.glm import GLMScale, make_dense_epoch, make_sparse_epoch
from repro.launch.mesh import make_host_mesh

z = np.load(sys.argv[1])
out = {}
mesh = make_host_mesh(pod=1, data=2, model=2)
sc = GLMScale("t", "dense", n=512, d=64, bucket=8, chunks=2, lam=1e-2,
              deterministic=True, local_solver="xla", feature_shard=True,
              compress_sync=True, compress_pod=False)
with mesh:
    ep = jax.jit(make_dense_epoch(sc, mesh))
    st = tuple(jnp.asarray(z[k]) for k in ("X", "y", "a", "v"))
    for e in range(2):
        st = ep(*st, jnp.int32(e))
        for i, t in enumerate(st):
            out[f"tpref/{e}/{i}"] = np.asarray(t)
sc = GLMScale("s", "sparse", n=256, d=250, nnz=8, bucket=8, chunks=2,
              lam=1e-2, compress_pod=False, deterministic=True,
              local_solver="pallas", feature_shard=True)
with mesh:
    ep = jax.jit(make_sparse_epoch(sc, mesh, interpret=True))
    st = tuple(jnp.asarray(z[k]) for k in ("idx", "val", "sy", "sa", "sv"))
    for e in range(2):
        st = ep(*st, jnp.int32(e))
        for i, t in enumerate(st):
            out[f"slref/{e}/{i}"] = np.asarray(t)
np.savez(sys.argv[2], **out)
"""


def _spawn(root: pathlib.Path, script: pathlib.Path, env: dict) -> list:
    procs = []
    for r in range(WORLD):
        log = open(root / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(script), str(r), str(WORLD), str(root)],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    return procs


def _join(root: pathlib.Path, procs: list) -> None:
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
        pytest.fail(f"the gloo ranks did not finish in {SPAWN_TIMEOUT} s")
    finally:
        for p, log in procs:
            p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, (root / f"rank{r}.log").read_text()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the 4 gloo ranks and, beside them, the reference's
    subprocess; -> (each rank's outputs in rank order, the reference's)."""
    root = tmp_path_factory.mktemp("slices")
    (root / "cases.json").write_text(json.dumps(dict(
        cases=CASES, journal=JOURNAL, B=B, MESH=MESH, helpers=_HELPERS)))
    script = root / "rank.py"
    script.write_text(textwrap.dedent(_RANK))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    env.pop("REPRO_FAULTS", None)
    procs = _spawn(root, script, env)

    X, y = make_dense_classification(n=512, d=64, seed=0)
    (idx, val), ys, _ = make_sparse_classification(n=256, d=250, nnz=8,
                                                   seed=2)
    np.savez(root / "in.npz", X=X, y=y, a=np.zeros(512, np.float32),
             v=np.zeros(64, np.float32), idx=idx, val=val, sy=ys,
             sa=np.zeros(256, np.float32), sv=np.zeros(250, np.float32))
    ref_script = root / "reference.py"
    ref_script.write_text(textwrap.dedent(_REFERENCE))
    ref_env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(REPO / "src"),
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, str(ref_script),
                            str(root / "in.npz"), str(root / "ref.npz")],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           env=ref_env, text=True)
    _join(root, procs)
    log, _ = ref.communicate(timeout=SPAWN_TIMEOUT)
    assert ref.returncode == 0, log
    return ([dict(np.load(root / f"rank{r}.npz")) for r in range(WORLD)],
            dict(np.load(root / "ref.npz")))


def _stacked(tag):
    """The same case on the stacked mesh: the global state after each
    epoch, and the mesh."""
    case = CASES[tag]
    scale, arrays, obj = case_scale(tag, case)
    mesh = make_host_mesh(pod=MESH[0], data=MESH[1], model=MESH[2],
                          device="cpu")
    with kernel_route(case["solver"] == "kernel"):
        make = (glm.make_sparse_epoch if scale.kind == "sparse"
                else glm.make_dense_epoch)
        ep = make(scale, mesh, obj, **({} if scale.kind == "sparse"
                                       else {"split_tp": True}))
        st = (*arrays, np.zeros(scale.n, np.float32),
              np.zeros(scale.d, np.float32))
        out = []
        for e in range(case["epochs"]):
            st = ep(*st, e)
            out.append(st)
    return out, mesh, scale


def _cols(sched, e):
    lay = sched.layout(e).astype(np.int64)
    return torch.from_numpy((lay[..., None] * B + np.arange(B)).reshape(-1))


def _schedule(scale):
    return engine.MeshSchedule(scale.n // B, pods=MESH[0], data=MESH[1],
                               model=MESH[2], model_in_lanes=False,
                               seed=scale.seed,
                               redeal_frac=scale.redeal_frac)


RESIDENT = [t for t, c in CASES.items() if "resident" in c["runs"]]


@pytest.mark.parametrize("tag", RESIDENT)
def test_dist_slices_resident_equals_stacked(world, tag):
    """Every rank's shards after each epoch, put together
    (`assemble_shards`: X's rows cut by 'model' under TP, sparse rows
    and v replicated over it), are `torch.equal` to the stacked mesh's
    global arrays: the re-dealt data, labels, alpha and v."""
    ranks, _ = world
    stacked, mesh, scale = _stacked(tag)
    specs = glm.glm_input_specs(scale, mesh)
    for e, want_st in enumerate(stacked):
        for i, want in enumerate(want_st):
            got = glm.assemble_shards(
                [r[f"{tag}/resident/{e}/{i}"] for r in ranks], specs[i],
                mesh.shape)
            assert torch.equal(got, want), (tag, e, i)
    assert float(stacked[-1][-1].abs().max()) > 0
    if scale.kind == "sparse":         # every model lane holds all of v
        for r in ranks:
            assert np.array_equal(r[f"{tag}/resident/{e}/4"],
                                  ranks[0][f"{tag}/resident/{e}/4"])


STREAMED = [t for t, c in CASES.items() if "streamed" in c["runs"]]


@pytest.mark.parametrize("tag", STREAMED)
def test_dist_slices_streamed_equals_stacked(world, tag):
    """`make_streamed_epoch_mesh` on the process mesh (each rank its
    buckets, under TP its feature rows only, sparse its own lane's
    compaction, the lanes' gathered over 'model'): after every epoch
    every rank holds the stacked resident mesh's whole alpha and v."""
    ranks, _ = world
    stacked, _, scale = _stacked(tag)
    sched = _schedule(scale)
    for e, want in enumerate(stacked):
        cols = _cols(sched, e)
        for r in ranks:
            v = torch.from_numpy(r[f"{tag}/streamed/{e}/v"])
            a = torch.from_numpy(r[f"{tag}/streamed/{e}/a"])
            assert torch.equal(v, want[-1]), (tag, e)
            assert torch.equal(a[cols], want[-2]), (tag, e)
    if scale.kind == "dense":     # a rank copies its d/M rows, not all d
        n_local = scale.n // (MESH[0] * MESH[1])
        per_epoch = n_local * (scale.d // MESH[2] + 1) * 4
        assert int(ranks[0][f"{tag}/streamed/bytes"]) == \
            CASES[tag]["epochs"] * per_epoch


SESSIONS = [t for t, c in CASES.items() if "session" in c["runs"]]


def _stacked_session(tag, chunks=2):
    case = CASES[tag]
    scale, arrays, _ = case_scale(tag, case)
    return Session(session_data(scale, arrays), objective=case["obj"],
                   lam=scale.lam, cfg=session_cfg(scale, chunks),
                   streamed=True, device="cpu",
                   mesh=make_host_mesh(pod=MESH[0], data=MESH[1],
                                       model=MESH[2], device="cpu"),
                   **({"d": scale.d} if scale.kind == "sparse" else {}))


@pytest.mark.parametrize("tag", SESSIONS)
def test_dist_slices_session_equals_stacked(world, tag):
    """`Session(..., streamed=True, mesh=DistMesh)` with a feature-sharded
    config: `alpha` and `v` on every rank equal the same Session's on the
    stacked mesh."""
    ranks, _ = world
    s = _stacked_session(tag)
    for _ in range(CASES[tag]["epochs"]):
        s.epoch()
    for r in ranks:
        assert torch.equal(torch.from_numpy(r[f"{tag}/session/a"]), s.alpha)
        assert torch.equal(torch.from_numpy(r[f"{tag}/session/v"]), s.v)


@pytest.mark.parametrize("tag", list(JOURNAL))
def test_dist_slices_journal_resume_bitwise(world, tag):
    """A journaled Session on the process mesh killed at epoch 1 and
    resumed by a new Session on the same journal ends bitwise an
    uninterrupted stacked Session.  "jtp": every rank killed at chunk
    2's boundary, each holding one record; "jsl": three ranks killed
    after chunk 2's step, before their record of cursor 3, and rank 2
    after writing it, before the barrier: rank 2 a save ahead, the
    world resumes at cursor 2, which every rank still holds."""
    ranks, _ = world
    base, chunks, _ = JOURNAL[tag]
    want = _stacked_session(base, chunks)
    for _ in range(CASES[base]["epochs"]):
        want.epoch()
    for r, out in enumerate(ranks):
        assert bool(out[f"{tag}/crashed"]), r
        assert int(out[f"{tag}/resumed_at"]) == 1
        recs = list(out[f"{tag}/records"])
        ahead = tag == "jsl" and r == 2
        assert recs == (["inflight.e1.c2", "inflight.e1.c3"] if ahead
                        else ["inflight.e1.c2"]), (r, recs)
        assert torch.equal(torch.from_numpy(out[f"{tag}/a"]), want.alpha)
        assert torch.equal(torch.from_numpy(out[f"{tag}/v"]), want.v)


@pytest.mark.parametrize("tag", ["tpref", "slref"])
def test_dist_slices_vs_reference_mesh(world, tag):
    """The reference's own feature-sharded mesh runs on (1, 2, 2) (dense
    TP with the int8 two-phase sync, `tests/test_torch_dense_mesh.py`'s
    "tp"; sparse slices through its Pallas kernels in interpret mode,
    `tests/test_torch_sharded.py`'s "sharded"), 2 epochs: the ranks'
    re-dealt data exact, alpha and v within rtol 1e-4, atol 1e-5."""
    ranks, ref = world
    case = CASES[tag]
    scale, _, _ = case_scale(tag, case)
    mesh = make_host_mesh(pod=MESH[0], data=MESH[1], model=MESH[2],
                          device="cpu")
    specs = glm.glm_input_specs(scale, mesh)
    n_out = len(specs) - 1
    for e in range(case["epochs"]):
        for i in range(n_out):
            got = glm.assemble_shards(
                [r[f"{tag}/resident/{e}/{i}"] for r in ranks], specs[i],
                mesh.shape).numpy()
            if i < n_out - 2:
                np.testing.assert_array_equal(got, ref[f"{tag}/{e}/{i}"])
            else:
                np.testing.assert_allclose(got, ref[f"{tag}/{e}/{i}"],
                                           rtol=1e-4, atol=1e-5)


def test_dist_slices_ranks_import_no_reference(world):
    """Rank r sits at the row-major coordinates of r on (1, 2, 2), and no
    rank imported JAX or the reference package."""
    ranks, _ = world
    for r, out in enumerate(ranks):
        assert tuple(out["coords"]) == (0, r // 2, r % 2)
        assert out["foreign"].size == 0, out["foreign"]


# -- the pieces, in one process ----------------------------------------------

@pytest.mark.parametrize("name", ["ridge", "logistic"])
def test_sharded_bucket_lane_offset_plain(name):
    """B4's plain version with a lane offset: one lane's slice alone
    (M = 1, m0 = m), given the exchanged working set, gives that lane's
    duals and slice bitwise as the stacked call on every lane does."""
    rng = np.random.default_rng(3)
    Wk, M, nb, Bk, nnz, d = 2, 3, 2, 4, 6, 70
    idx = np.sort(rng.integers(0, d, (Wk, nb * Bk, nnz)), -1)
    val = rng.standard_normal((Wk, nb * Bk, nnz)).astype(np.float32)
    val[..., 1:][idx[..., 1:] == idx[..., :-1]] = 0.0
    y = np.where(rng.random((Wk, nb * Bk)) < 0.5, -1.0, 1.0)
    v0 = (0.1 * rng.standard_normal((Wk, d))).astype(np.float32)
    v0[:, ::5] = -0.0
    t = [torch.as_tensor(x) for x in (idx, val, y.astype(np.float32),
                                      np.zeros((Wk, nb * Bk), np.float32),
                                      v0)]
    idxb, valb, yb, ab, qb, links, v_loc = ops.sharded_tiles(
        *t, bucket=Bk, model_lanes=M)
    obj = get_objective(name)
    for b in range(nb):
        W = ks.sdca_sparse_gather_bucket(idxb, b, v_loc)
        lanes = [v_loc[:, m:m + 1].clone() for m in range(M)]
        want = ks.sdca_sparse_sharded_bucket(obj, idxb, valb, yb, ab, qb,
                                             links, b, W, v_loc, 3.0, 2.0)
        for m in range(M):
            got = ks.sdca_sparse_sharded_bucket(
                obj, idxb, valb, yb, ab, qb, links, b, W, lanes[m], 3.0,
                2.0, m0=m)
            assert torch.equal(got[:, 0], want[:, m])
            assert torch.equal(lanes[m][:, 0], v_loc[:, m])


def test_owner_select_keeps_signed_zeros():
    """`ops.owner_select` of the lanes' partial working sets (B3's
    one-lane form on each lane's slice) is bitwise B3's stacked gather
    over every slice, -0.0 entries of v included; a sum of the partials
    would give +0.0 there."""
    rng = np.random.default_rng(6)
    Wk, M, nb, Bk, nnz, d = 2, 3, 2, 4, 6, 70
    idxb = torch.as_tensor(rng.integers(0, d, (Wk, nb, Bk, nnz)),
                           dtype=torch.int32)
    v = torch.as_tensor(rng.standard_normal((Wk, d)), dtype=torch.float32)
    v[:, ::3] = -0.0
    d_loc = ops.sparse_slice_width(d, M)
    v_loc = torch.nn.functional.pad(v, (0, M * d_loc - d)).reshape(
        Wk, M, d_loc)
    for b in range(nb):
        want = ks.sdca_sparse_gather_bucket(idxb, b, v_loc)
        parts = torch.stack([ks.sdca_sparse_gather_bucket(
            idxb, b, v_loc[:, m:m + 1].contiguous(), m) for m in range(M)])
        got = ops.owner_select(parts, idxb[:, b], d_loc)
        assert torch.equal(got, want)
        assert torch.equal(torch.signbit(got), torch.signbit(want))
        assert bool(torch.signbit(want).any())
        assert not torch.equal(torch.signbit(parts.sum(0)),
                               torch.signbit(want))


def test_sharded_subepoch_process_form_equals_stacked():
    """`ops.sdca_sparse_sharded_subepoch` in its process form, one lane a
    thread (``lane``, and an ``exchange`` that stacks the M lanes'
    partial working sets in lane order, as the all-gather over 'model'
    does), gives each lane's duals and dv bitwise as the stacked form."""
    import threading
    (idx, val), y, _ = make_sparse_classification(n=64, d=90, nnz=6, seed=4)
    rng = np.random.default_rng(1)
    v0 = (0.1 * rng.standard_normal(90)).astype(np.float32)
    v0[::4] = -0.0
    t = [torch.as_tensor(x)[None] for x in (idx, val, y,
                                            np.zeros(64, np.float32), v0)]
    obj, M = get_objective("logistic"), 3
    a_s, dv_s = ops.sdca_sparse_sharded_subepoch(obj, *t, 5.0, 2.0,
                                                 bucket=8, model_lanes=M)
    slots, res, errs = [None] * M, [None] * M, []
    bar = threading.Barrier(M, timeout=60)

    def lane(m):
        def exchange(partial):
            slots[m] = partial
            bar.wait()
            out = torch.stack(slots)
            bar.wait()
            return out
        try:
            res[m] = ops.sdca_sparse_sharded_subepoch(
                obj, *t, 5.0, 2.0, bucket=8, model_lanes=M, lane=m,
                exchange=exchange)
        except BaseException as e:          # reported below
            errs.append(e)
            bar.abort()

    threads = [threading.Thread(target=lane, args=(m,)) for m in range(M)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs, errs
    for m in range(M):
        a_p, dv_p = res[m]
        assert torch.equal(a_p[:, 0], a_s[:, m])
        assert torch.equal(dv_p[:, 0], dv_s[:, m])


def test_tp_pass_reduce_hook_one_lane_each():
    """`sdca.dense_tp_bucket_pass` with its ``reduce`` hook, one lane at a
    time (model_lanes=1, each lane's partials summed with the others' in
    lane order by the hook), gives each lane's rows of v and the duals
    bitwise as the stacked form on every lane; the kernels' wrapper
    (`ops.sdca_bucket_tp_subepoch`, plain versions on the CPU) gives the
    same bits in both forms."""
    rng = np.random.default_rng(2)
    W, M, nb, d, Bk = 2, 4, 3, 40, 8
    xb = torch.as_tensor(0.3 * rng.standard_normal((W, nb, d, Bk)),
                         dtype=torch.float32)
    yb = torch.as_tensor(np.where(rng.random((W, nb, Bk)) < .5, -1., 1.),
                         dtype=torch.float32)
    ab = torch.zeros((W, nb, Bk))
    v0 = torch.as_tensor(0.1 * rng.standard_normal((W, d)),
                         dtype=torch.float32)
    lam, sig = torch.tensor(2.0), torch.tensor(2.0)
    obj = get_objective("logistic")
    a_s, v_s = sdca.dense_tp_bucket_pass(obj, xb, yb, ab, v0, lam, sig, M)
    dl = d // M
    # partials of every lane at every bucket, from the stacked run
    parts = []

    def spy(p):
        parts.append(p)
        return sdca.lane_ordered_sum(p)

    sdca.dense_tp_bucket_pass(obj, xb, yb, ab, v0, lam, sig, M, reduce=spy)
    for m in range(M):
        it = iter(parts)

        def reduce(p, m=m):
            full = next(it).clone()
            assert torch.equal(p[:, 0], full[:, m])
            return sdca.lane_ordered_sum(full)

        a_m, v_m = sdca.dense_tp_bucket_pass(
            obj, xb[:, :, m * dl:(m + 1) * dl], yb, ab,
            v0[:, m * dl:(m + 1) * dl], lam, sig, 1, reduce=reduce)
        assert torch.equal(a_m, a_s)
        assert torch.equal(v_m, v_s[:, m * dl:(m + 1) * dl])
    Xl = xb.movedim(-3, -2).reshape(W, d, nb * Bk)
    a_k, dv_k = ops.sdca_bucket_tp_subepoch(
        obj, Xl, yb.reshape(W, -1), ab.reshape(W, -1), v0, 2.0, 2.0,
        bucket=Bk, model_lanes=M)
    a_t, dv_t = sdca.dense_local_subepoch(obj, Xl, yb.reshape(W, -1),
                                          ab.reshape(W, -1), v0, lam, sig,
                                          Bk, model_lanes=M)
    assert torch.equal(a_k, a_t) and torch.equal(dv_k, dv_t)


def test_feature_rows_gather(tmp_path):
    """A tensor-parallel rank's feed gathers only its feature rows:
    `gather_buckets(rows=(lo, hi))` of a tile cache and of host arrays
    is the full gather's rows lo .. hi-1, labels unchanged, and
    `chunk_specs` says so; the mesh feed copies only those rows."""
    from repro_torch.data.cache import build_cache
    X, y = make_dense_classification(n=256, d=20, seed=1)
    bids = np.array([[3, 0, 7], [1, 2, 4]])
    for src in (build_cache(tmp_path / "c", "t", y=y, X=X, bucket=8),
                ArrayFeed(y, X=X, bucket=8, device="cpu")):
        full, y_full = src.gather_buckets(bids)
        part, y_part = src.gather_buckets(bids, rows=(5, 15))
        np.testing.assert_array_equal(part, full[..., 5:15, :])
        np.testing.assert_array_equal(y_part, y_full)
        assert src.chunk_specs((2,), 3, rows=(5, 15))["X"][0] == (2, 10, 24)
        feed = engine.MeshChunkFeed(src, rows=(5, 15), device="cpu")
        X_t, _ = feed.fetch(bids)
        assert torch.equal(X_t, torch.from_numpy(full[..., 5:15, :]))
        assert feed.bytes_h2d == (2 * 10 * 24 + 2 * 24) * 4
