"""One rank of a process mesh: the GLM mesh program on its own shards.

    python3 tools/mesh_dist_rank.py ROOT RANK WORLD BACKEND POD,DATA,MODEL \
        [--device cuda|cpu]

`chip_smoke.py`'s `mesh_dist` and `mesh_dist_slices` phases start WORLD
of these, one a rank, after they have built the kernels (a rank that
finds one unbuilt exits without compiling), and rendezvous through a
file store in ROOT.  ROOT holds ``cases.json`` (per case: its name,
`GLMScale` fields, the `EngineConfig` fields of its Session, the
``.npy`` files of its global arrays, and how it streams).  For each
case the rank runs, on `launch.mesh.make_dist_mesh(backend=BACKEND)`:

  * resident: `launch.glm.make_dense_epoch`/`make_sparse_epoch` on the
    shards `glm_input_specs` and `local_shard` cut out, 3 epochs;
  * streamed: `Session(..., streamed=True, mesh=)` (``"stream":
    "session"``), or `launch.glm.make_streamed_epoch_mesh` over an
    `ArrayFeed` of the arrays (``"feed"``: a feature-sharded sparse
    scale streams its lane's slice compaction), 3 epochs;
  * each collective of the mesh (`redeal`, `lane_sum`, `pod_reduce`,
    and when the model axis carries slices the per-bucket exchange:
    the working sets' all-gather or the packed partials' sum over
    'model') timed alone at the path's shapes (host clock around a
    device synchronize, median of 5);
  * or, for a case with ``"journal"`` (a Session journaled every
    chunk), in place of the above: an uninterrupted run, then the same
    run killed in epoch 1 at this rank's kill of each schedule of
    ``"kills"`` and resumed by a new Session on its journal;

and writes what it holds after every epoch to ``ROOT/rank{RANK}.npz``
and its times, kernel launches (counted from zero over each run), peak
device bytes and the modules of JAX or the reference it saw imported
(none allowed) to ``ROOT/rank{RANK}.json``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

import numpy as np
import torch


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    _sync(dev)
    t = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t


def _median_s(dev, fn, reps: int = 5) -> float:
    return statistics.median(_timed(dev, fn)[1] for _ in range(reps))


def collective_times(mesh, scale, block, y, v) -> dict:
    """Seconds of each collective alone on this rank's inputs: the
    re-deal of its block, labels and duals, the chunk sync of a dv, the
    pod reduce of v, and with slices on the model axis one bucket's
    exchange (a (B, nnz) working set, or the (B, 1 + B) packed
    partials)."""
    from repro_torch.launch import glm
    coll = glm._collectives(mesh, scale)
    dev = mesh.device
    B = scale.bucket
    nb_local = y.shape[-1] // B
    keys = coll.worker_keys(scale.seed, 0)
    ax = -1 if len(block) == 1 else -2
    arrs = tuple((t[None, None], ax) for t in block) + (
        (y[None, None], -1), (torch.zeros_like(y)[None, None], -1))
    g = torch.Generator().manual_seed(7 + mesh.rank)
    dv = torch.randn((1, 1, v.shape[-1]), generator=g).to(dev)
    v_in = v[None]
    v_new = (v + dv[0, 0])[None]
    out = {
        "redeal_s": _median_s(dev, lambda: coll.redeal(
            arrs, nb_local, keys, scale.redeal_frac)),
        "lane_sum_s": _median_s(dev, lambda: coll.lane_sum(
            dv, compress=scale.compress_sync)),
        "pod_reduce_s": _median_s(dev, lambda: coll.pod_reduce(v_new, v_in)),
    }
    lane, exchange = coll.model_exchange()
    if lane is not None:
        shape = ((1, B, scale.nnz) if scale.kind == "sparse"
                 else (1, 1, B, B + 1))
        t = torch.randn(shape, generator=g).to(dev)
        out["exchange_s"] = _median_s(dev, lambda: exchange(t), reps=21)
        out["exchange_bytes"] = t.numel() * 4
    return out


def _zero_launches() -> None:
    from repro_torch.kernels import sdca_bucket as kd
    from repro_torch.kernels import sdca_sparse_bucket as ks
    kd.launches = ks.launches = 0
    kd.tp_step_launches = 0
    ks.gather_launches = ks.sharded_launches = 0


def _launches() -> dict:
    from repro_torch.kernels import sdca_bucket as kd
    from repro_torch.kernels import sdca_sparse_bucket as ks
    return {"sdca_bucket": kd.launches, "sdca_sparse_bucket": ks.launches,
            "sdca_bucket_tp_step": kd.tp_step_launches,
            "sdca_sparse_gather_bucket": ks.gather_launches,
            "sdca_sparse_sharded_bucket": ks.sharded_launches}


def run_journal(mesh, case: dict, root: pathlib.Path, out: dict) -> dict:
    """A journaled feature-sharded Session: the uninterrupted run, then
    for each kill schedule the run killed in epoch 1 and resumed by a new
    Session on its journal; what each ends with, the cursors each rank
    held when the world stopped, and the seconds of each run."""
    from repro_torch.api import Session
    from repro_torch.core.config import EngineConfig
    from repro_torch.launch import glm
    from repro_torch.resilience import FaultInjector, SimulatedCrash
    name = case["name"]
    scale = glm.GLMScale(**case["scale"])
    arrays = [np.load(root / f) for f in case["arrays"]]
    data = ((arrays[0], arrays[1]), arrays[2]) \
        if scale.kind == "sparse" else (arrays[0], arrays[1])
    dev = mesh.device
    rec = {}

    def session(jdir, faults=None):
        return Session(data, cfg=EngineConfig.make(**case["cfg"]),
                       lam=scale.lam, objective="logistic", streamed=True,
                       mesh=mesh, device=dev, journal_dir=jdir,
                       faults=faults, **({"d": scale.d}
                                         if scale.kind == "sparse" else {}))

    _zero_launches()
    s, secs = session(root / f"{name}-straight"), []
    for _ in range(case["epochs"]):
        secs.append(_timed(dev, s.epoch)[1])
    out[f"{name}/journal/straight/a"] = s.alpha.cpu().numpy()
    out[f"{name}/journal/straight/v"] = s.v.cpu().numpy()
    rec["straight"] = {"epoch_s": secs, "launches": _launches()}
    for k, kills in enumerate(case["kills"]):
        jdir = root / f"{name}-kill{k}"
        s = session(jdir, FaultInjector(kills[mesh.rank]))
        try:
            for _ in range(case["epochs"]):
                s.epoch()
            crashed = False
        except SimulatedCrash:
            crashed = True
        held = sorted(p.name for p in (jdir / f"rank{mesh.rank}").iterdir()
                      if p.name.startswith("inflight."))
        t0 = time.perf_counter()
        s = session(jdir)
        setup = time.perf_counter() - t0
        resumed_at = s.epochs_done
        while s.epochs_done < case["epochs"]:
            s.epoch()
        _sync(dev)
        out[f"{name}/journal/kill{k}/a"] = s.alpha.cpu().numpy()
        out[f"{name}/journal/kill{k}/v"] = s.v.cpu().numpy()
        rec[f"kill{k}"] = {"schedule": kills[mesh.rank], "crashed": crashed,
                           "held": held, "resumed_at_epoch": resumed_at,
                           "resume_setup_s": setup,
                           "resume_s": time.perf_counter() - t0}
    return rec


def run_case(mesh, case: dict, root: pathlib.Path, out: dict) -> dict:
    from repro_torch.api import Session
    from repro_torch.core.config import EngineConfig
    from repro_torch.launch import glm
    dev = mesh.device
    name = case["name"]
    scale = glm.GLMScale(**case["scale"])
    sparse = scale.kind == "sparse"
    arrays = [np.load(root / f) for f in case["arrays"]]
    rec = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # resident: this rank's shards through the mesh program
    specs = glm.glm_input_specs(scale, mesh)
    st = tuple(glm.local_shard(t, s, mesh) for t, s in zip(
        (*arrays, np.zeros(scale.n, np.float32),
         np.zeros(scale.d, np.float32)), specs))
    ep = (glm.make_sparse_epoch if sparse else glm.make_dense_epoch)(
        scale, mesh)
    _zero_launches()
    secs = []
    for e in range(case["epochs"]):
        st, s = _timed(dev, lambda: ep(*st, e))
        secs.append(s)
        for i, t in enumerate(st):
            if i >= len(st) - 3 or e == case["epochs"] - 1:
                out[f"{name}/resident/{e}/{i}"] = t.cpu().numpy()
    rec["resident"] = {"epoch_s": secs, "launches": _launches()}

    # streamed: the front door on the process mesh, or the feed
    if case.get("stream", "session") == "session":
        data = ((arrays[0], arrays[1]), arrays[2]) if sparse \
            else (arrays[0], arrays[1])
        ses = Session(data, cfg=EngineConfig.make(**case["cfg"]),
                      lam=scale.lam, objective="logistic", streamed=True,
                      mesh=mesh, device=dev,
                      **({"d": scale.d} if sparse else {}))

        def epoch(e, stats):
            ses.epoch(stats=stats)
            return ses.alpha, ses.v
    else:
        from repro_torch.data.cache import ArrayFeed
        feed = (ArrayFeed(arrays[2], idx=arrays[0], val=arrays[1], d=scale.d,
                          bucket=scale.bucket, device=dev) if sparse
                else ArrayFeed(arrays[1], X=arrays[0], bucket=scale.bucket,
                               device=dev))
        fn = glm.make_streamed_epoch_mesh(scale, mesh, feed)
        state = [torch.zeros(scale.n, device=dev),
                 torch.zeros(scale.d, device=dev)]

        def epoch(e, stats):
            state[:] = fn(*state, e, stats=stats)
            return state
    _zero_launches()
    stats_all = []
    for e in range(case["epochs"]):
        st_e = {}
        a_e, v_e = epoch(e, st_e)
        stats_all.append(st_e)
        out[f"{name}/streamed/{e}/a"] = a_e.cpu().numpy()
        out[f"{name}/streamed/{e}/v"] = v_e.cpu().numpy()
    mf = ses.mesh_feed if case.get("stream", "session") == "session" \
        else fn.feed
    rec["streamed"] = {"stats": stats_all, "launches": _launches(),
                       "bytes_h2d": mf.bytes_h2d,
                       "width": getattr(mf, "width", None)}
    rec["collectives"] = collective_times(
        mesh, scale, st[:2] if sparse else st[:1], st[-3], st[-1])
    if dev.type == "cuda":
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", type=pathlib.Path)
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("backend", choices=("gloo", "nccl"))
    ap.add_argument("mesh")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_dist_mesh
    if args.device == "cuda" and build.unbuilt():
        raise SystemExit(f"rank {args.rank}: kernels not built "
                         f"({build.unbuilt()}); the parent builds them")
    pod, data, model = (int(x) for x in args.mesh.split(","))
    spec = json.loads((args.root / "cases.json").read_text())
    mesh = make_dist_mesh(pod=pod, data=data, model=model,
                          backend=args.backend, device=args.device,
                          init_method=f"file://{args.root / 'store'}",
                          rank=args.rank, world_size=args.world,
                          timeout=spec["timeout"])
    out: dict = {}
    rec = {"rank": args.rank, "coords": list(mesh.coords),
           "device": str(mesh.device), "backend": mesh.backend,
           "stages": mesh.stages, "cases": {}}
    for case in spec["cases"]:
        run = run_journal if case.get("journal") else run_case
        rec["cases"][case["name"]] = run(mesh, case, args.root, out)
    rec["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    np.savez(args.root / f"rank{args.rank}.npz", **out)
    (args.root / f"rank{args.rank}.json").write_text(json.dumps(rec))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
