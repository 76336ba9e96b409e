"""The process mesh: `launch.mesh.DistMesh` and `core.engine.MeshCollectives`
over `torch.distributed`, held bitwise to the stacked mesh.

One module-scoped spawn runs 4 CPU processes on the gloo backend (a
file store under ``tmp_path`` for the rendezvous, so parallel test
workers never share a port; a timeout on the rendezvous, on every
collective and on the join).  Each rank runs every case on one process
group, on (pod, data, model) = (2, 2, 1) and (1, 2, 2) with the model
axis carrying examples: the resident `make_dense_epoch` /
`make_sparse_epoch` on its shards (`glm_input_specs`, `local_shard`),
the streamed `make_streamed_epoch_mesh`, and `Session(mesh=,
streamed=True)`, and writes what it holds after each epoch.  Here the
same scales run on the `StackedMesh`: deterministic results are
`torch.equal` (the shards put together by `assemble_shards`), the
all-reduce (`deterministic=False`) within rtol 1e-6, the int8 pod
reduce and two-phase sync bitwise to the stacked int8 wire, and what a
process mesh still refuses (an indivisible TP split, a mesh larger than
the world; the roles that carry slices are
`tests/test_torch_dist_slices.py`'s).  The spawn
target is a script written to ``tmp_path``: it imports neither this
module nor JAX nor the reference.  About 12 s on the CPU (ridge, whose
delta is closed-form: what is held here is the wire).
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
from repro_torch.core.config import EngineConfig              # noqa: E402
from repro_torch.core.objectives import get_objective         # noqa: E402
from repro_torch.data.synthetic import (make_dense_classification,  # noqa: E402
                                        make_sparse_classification)
from repro_torch.launch import glm                            # noqa: E402
from repro_torch.launch.mesh import make_dist_mesh, make_host_mesh  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
EPOCHS = 3
SPAWN_TIMEOUT = 240          # seconds for the whole world to finish
N, D, SD, NNZ, B = 512, 16, 64, 8, 8
OBJ = "ridge"               # a closed-form delta: the runs are the wire's

#: tag -> (mesh (pod, data, model), kind, GLMScale knobs, runs)
CASES = {
    "ex221": ((2, 2, 1), "dense", dict(deterministic=True),
              ["resident", "streamed", "session"]),
    "ex122": ((1, 2, 2), "dense", dict(deterministic=True),
              ["resident", "streamed"]),
    "nondet221": ((2, 2, 1), "dense", dict(), ["resident"]),
    "cmp221": ((2, 2, 1), "dense", dict(deterministic=True,
                                        compress_pod=True), ["resident"]),
    "cmp122": ((1, 2, 2), "dense", dict(deterministic=True,
                                        compress_sync=True,
                                        compress_pod=True,
                                        redeal_frac=0.25),
               ["resident", "streamed"]),
    "sp221": ((2, 2, 1), "sparse", dict(deterministic=True,
                                        compress_pod=True),
              ["resident", "streamed"]),
    "sp122": ((1, 2, 2), "sparse", dict(deterministic=True,
                                        compress_sync=True,
                                        redeal_frac=0.25),
              ["resident", "streamed", "session"]),
}

_RANK = r'''
import json, sys
import numpy as np
import torch

rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
from repro_torch.api import Session
from repro_torch.core.config import EngineConfig
from repro_torch.core.objectives import get_objective
from repro_torch.data.cache import ArrayFeed
from repro_torch.data.synthetic import (make_dense_classification,
                                        make_sparse_classification)
from repro_torch.launch import glm
from repro_torch.launch.mesh import make_dist_mesh

spec = json.load(open(f"{root}/cases.json"))
N, D, SD, NNZ, B, EPOCHS, OBJ = (spec[k] for k in
                                 ("N", "D", "SD", "NNZ", "B", "EPOCHS", "OBJ"))
obj = get_objective(OBJ)
X, y = make_dense_classification(n=N, d=D, seed=5)
(idx, val), ys, _ = make_sparse_classification(n=N, d=SD, nnz=NNZ, seed=6)
out, meshes = {}, {}


def mesh_of(shape):
    if shape not in meshes:
        meshes[shape] = make_dist_mesh(
            pod=shape[0], data=shape[1], model=shape[2], backend="gloo",
            device="cpu", init_method=f"file://{root}/store", rank=rank,
            world_size=world, timeout=60)
    return meshes[shape]


def session_cfg(shape, knobs):
    keep = ("deterministic", "compress_sync", "compress_pod", "redeal_frac")
    return EngineConfig.make(
        pods=shape[0], lanes=shape[1] * shape[2], bucket=B, chunks=2,
        partition="alltoall", **{k: v for k, v in knobs.items() if k in keep})


for tag, (shape, kind, knobs, runs) in spec["cases"].items():
    shape = tuple(shape)
    mesh = mesh_of(shape)
    sparse = kind == "sparse"
    knobs = {"compress_pod": False, **knobs}
    scale = glm.GLMScale(tag, kind, n=N, d=SD if sparse else D,
                         nnz=NNZ if sparse else 0, bucket=B, chunks=2,
                         lam=1e-3, **knobs)
    arrays = (idx, val, ys) if sparse else (X, y)
    if "resident" in runs:
        specs = glm.glm_input_specs(scale, mesh)
        st = tuple(glm.local_shard(t, s, mesh) for t, s in zip(
            (*arrays, np.zeros(N, np.float32),
             np.zeros(scale.d, np.float32)), specs))
        ep = (glm.make_sparse_epoch if sparse else glm.make_dense_epoch)(
            scale, mesh, obj)
        for e in range(EPOCHS):
            st = ep(*st, e)
            for i, t in enumerate(st):
                out[f"{tag}/resident/{e}/{i}"] = t.numpy()
    if "streamed" in runs:
        feed = (ArrayFeed(ys, idx=idx, val=val, d=SD, bucket=B,
                          device="cpu") if sparse
                else ArrayFeed(y, X=X, bucket=B, device="cpu"))
        em = glm.make_streamed_epoch_mesh(scale, mesh, feed, obj)
        a, v = torch.zeros(N), torch.zeros(scale.d)
        for e in range(EPOCHS):
            a, v = em(a, v, e)
            out[f"{tag}/streamed/{e}/a"] = a.numpy().copy()
            out[f"{tag}/streamed/{e}/v"] = v.numpy().copy()
    if "session" in runs:
        data = ((idx, val), ys) if sparse else (X, y)
        s = Session(data, objective=OBJ, lam=1e-3,
                    cfg=session_cfg(shape, knobs), streamed=True,
                    mesh=mesh, device="cpu", **({"d": SD} if sparse else {}))
        for e in range(EPOCHS):
            s.epoch()
        out[f"{tag}/session/a"] = s.alpha.numpy()
        out[f"{tag}/session/v"] = s.v.numpy()

refusals = {
    "tp_indivisible": lambda: glm.make_dense_epoch(glm.GLMScale(
        "tp", "dense", n=N, d=D + 1, bucket=B, chunks=2,
        feature_shard=True), mesh_of((1, 2, 2))),
    "mesh_too_large": lambda: make_dist_mesh(
        pod=2, data=2, model=2, backend="gloo", device="cpu", rank=rank,
        world_size=world),
}
for name, fn in refusals.items():
    try:
        fn()
        out[f"refusal/{name}"] = np.array("no error")
    except ValueError as err:
        out[f"refusal/{name}"] = np.array(str(err))
out["coords"] = np.array(mesh_of((2, 2, 1)).coords)
out["foreign"] = np.array(sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")),
    dtype=str)
np.savez(f"{root}/rank{rank}.npz", **out)
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the 4 gloo ranks once; -> each rank's outputs, in rank order."""
    root = tmp_path_factory.mktemp("dist")
    (root / "cases.json").write_text(json.dumps(dict(
        cases=CASES, N=N, D=D, SD=SD, NNZ=NNZ, B=B, EPOCHS=EPOCHS,
        OBJ=OBJ)))
    script = root / "rank.py"
    script.write_text(textwrap.dedent(_RANK))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        log = open(root / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(script), str(r), str(WORLD), str(root)],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
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
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(WORLD)]


def _scale(tag):
    shape, kind, knobs, _ = CASES[tag]
    sparse = kind == "sparse"
    return glm.GLMScale(tag, kind, n=N, d=SD if sparse else D,
                        nnz=NNZ if sparse else 0, bucket=B, chunks=2,
                        lam=1e-3, **{"compress_pod": False, **knobs})


def _arrays(kind):
    if kind == "sparse":
        (idx, val), ys, _ = make_sparse_classification(n=N, d=SD, nnz=NNZ,
                                                       seed=6)
        return idx, val, ys
    return make_dense_classification(n=N, d=D, seed=5)


def _stacked(tag):
    """The stacked mesh's global state after each epoch, and its mesh."""
    shape, kind, _, _ = CASES[tag]
    mesh = make_host_mesh(pod=shape[0], data=shape[1], model=shape[2],
                          device="cpu")
    scale = _scale(tag)
    ep = (glm.make_sparse_epoch if kind == "sparse"
          else glm.make_dense_epoch)(scale, mesh, get_objective(OBJ))
    st = (*_arrays(kind), np.zeros(N, np.float32),
          np.zeros(scale.d, np.float32))
    out = []
    for e in range(EPOCHS):
        st = ep(*st, e)
        out.append(st)
    return out, mesh, scale


def _assembled(ranks, tag, e, i, spec, shape):
    return glm.assemble_shards([r[f"{tag}/resident/{e}/{i}"] for r in ranks],
                               spec, shape)


def _cols(lay):
    return torch.from_numpy((lay.astype(np.int64)[..., None] * B
                             + np.arange(B)).reshape(-1))


RESIDENT = [t for t, c in CASES.items()
            if "resident" in c[3] and t != "nondet221"]


@pytest.mark.parametrize("tag", RESIDENT)
def test_dist_resident_equals_stacked(ranks, tag):
    """Every rank's shards after each of 3 epochs, put together, are
    `torch.equal` to the stacked mesh's global arrays (the re-dealt data,
    labels, alpha and v), with ordered sums and with the int8 wire."""
    stacked, mesh, scale = _stacked(tag)
    specs = glm.glm_input_specs(scale, mesh)
    for e in range(EPOCHS):
        for i, want in enumerate(stacked[e]):
            got = _assembled(ranks, tag, e, i, specs[i], mesh.shape)
            assert torch.equal(got, want), (tag, e, i)
    assert float(stacked[-1][-1].abs().max()) > 0


def test_dist_all_reduce_within_rtol(ranks):
    """`deterministic=False` sums by `all_reduce`: alpha and v within
    rtol 1e-6 of the stacked mesh's ordered sums, the re-dealt data
    exact, and every rank's v the same."""
    tag = "nondet221"
    stacked, mesh, scale = _stacked(tag)
    specs = glm.glm_input_specs(scale, mesh)
    for e in range(EPOCHS):
        for i, want in enumerate(stacked[e]):
            got = _assembled(ranks, tag, e, i, specs[i], mesh.shape)
            if i < 2:
                assert torch.equal(got, want)
            else:
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=1e-6, atol=1e-9)
    vs = [r[f"{tag}/resident/{EPOCHS - 1}/3"] for r in ranks]
    assert all(np.array_equal(v, vs[0]) for v in vs)


STREAMED = [t for t, c in CASES.items() if "streamed" in c[3]]


@pytest.mark.parametrize("tag", STREAMED)
def test_dist_streamed_equals_stacked(ranks, tag):
    """`make_streamed_epoch_mesh` on the process mesh: each rank streams
    only its buckets, and after every epoch every rank holds the whole
    alpha and v of the stacked resident mesh (alpha mapped back to
    global order through `MeshSchedule.layout`)."""
    stacked, mesh, scale = _stacked(tag)
    shape, _, _, _ = CASES[tag]
    lanes = shape[1] * shape[2]
    from repro_torch.core.engine import MeshSchedule
    sched = MeshSchedule(N // B, pods=shape[0], data=shape[1],
                         model=shape[2], seed=scale.seed,
                         redeal_frac=scale.redeal_frac)
    assert sched.lanes == lanes
    for e in range(EPOCHS):
        cols = _cols(sched.layout(e))
        for r in ranks:
            a = torch.from_numpy(r[f"{tag}/streamed/{e}/a"])
            v = torch.from_numpy(r[f"{tag}/streamed/{e}/v"])
            assert torch.equal(v, stacked[e][-1]), (tag, e)
            assert torch.equal(a[cols], stacked[e][-2]), (tag, e)


SESSIONS = [t for t, c in CASES.items() if "session" in c[3]]


@pytest.mark.parametrize("tag", SESSIONS)
def test_dist_session_equals_stacked(ranks, tag):
    """`Session(..., streamed=True, mesh=DistMesh)`: `alpha` and `v` on
    every rank equal the same Session's on the stacked mesh."""
    shape, kind, knobs, _ = CASES[tag]
    knobs = {"compress_pod": False, **knobs}
    keep = ("deterministic", "compress_sync", "compress_pod", "redeal_frac")
    cfg = EngineConfig.make(
        pods=shape[0], lanes=shape[1] * shape[2], bucket=B, chunks=2,
        partition="alltoall", **{k: v for k, v in knobs.items() if k in keep})
    arrays = _arrays(kind)
    data = ((arrays[0], arrays[1]), arrays[2]) if kind == "sparse" \
        else arrays
    s = Session(data, objective=OBJ, lam=1e-3, cfg=cfg,
                streamed=True, device="cpu",
                mesh=make_host_mesh(pod=shape[0], data=shape[1],
                                    model=shape[2], device="cpu"),
                **({"d": SD} if kind == "sparse" else {}))
    for _ in range(EPOCHS):
        s.epoch()
    for r in ranks:
        assert torch.equal(torch.from_numpy(r[f"{tag}/session/a"]), s.alpha)
        assert torch.equal(torch.from_numpy(r[f"{tag}/session/v"]), s.v)


def test_dist_model_slices_raise(ranks):
    """A process mesh whose model axis carries slices runs every role
    (`tests/test_torch_dist_slices.py`); what it still refuses, on a live
    process group: dense tensor parallelism whose d is not a multiple of
    the model axis (the reference's P('model') layout of X and v), and a
    mesh larger than the world."""
    for r in ranks:
        msg = str(r["refusal/tp_indivisible"])
        assert "d=17" in msg and "multiple" in msg, msg
        msg = str(r["refusal/mesh_too_large"])
        assert "needs 8 ranks" in msg and "has 4" in msg, msg


def test_dist_ranks_laid_out_row_major_and_import_no_reference(ranks):
    """Rank r sits at (pod, data, model) = row-major coordinates of r, as
    `jax.make_mesh` lays out devices; no rank imported JAX or the
    reference package."""
    want = [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    for r, out in enumerate(ranks):
        assert tuple(out["coords"]) == want[r]
        assert out["foreign"].size == 0, out["foreign"]


def test_make_dist_mesh_refusals(monkeypatch):
    """Refusals before any process group exists: a world that is not the
    mesh's size, nccl without a card, the card without CUDA, and no rank
    at all."""
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_dist_mesh(pod=2, data=2, rank=0, world_size=2, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        make_dist_mesh(rank=0, world_size=1, backend="nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_dist_mesh(rank=0, world_size=1)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="RANK"):
        make_dist_mesh(world_size=1, device="cpu")
