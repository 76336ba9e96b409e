"""One rank of a process mesh: the GLM mesh program on its own shards.

    python3 tools/mesh_dist_rank.py ROOT RANK WORLD BACKEND POD,DATA,MODEL \
        [--device cuda|cpu]

`chip_smoke.py`'s `mesh_dist` phase starts WORLD of these, one a rank,
after it has built the kernels (a rank that finds one unbuilt exits
without compiling), and rendezvous through a file store in ROOT.  ROOT
holds ``cases.json`` (per case: its name, `GLMScale` fields, the
`EngineConfig` fields of its Session, and the ``.npy`` files of its
global arrays).  For each case the rank runs, on
`launch.mesh.make_dist_mesh(backend=BACKEND)`:

  * resident: `launch.glm.make_dense_epoch`/`make_sparse_epoch` on the
    shards `glm_input_specs` and `local_shard` cut out, 3 epochs;
  * streamed: `Session(..., streamed=True, mesh=)`, 3 epochs;
  * each collective of the mesh (`redeal`, `lane_sum`, `pod_reduce`)
    timed alone at the path's shapes (host clock around a device
    synchronize, median of 5);

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
    pod reduce of v."""
    from repro_torch.launch import glm
    coll = glm._collectives(mesh, scale)
    dev = mesh.device
    nb_local = y.shape[-1] // scale.bucket
    keys = coll.worker_keys(scale.seed, 0)
    ax = -1 if len(block) == 1 else -2
    arrs = tuple((t[None, None], ax) for t in block) + (
        (y[None, None], -1), (torch.zeros_like(y)[None, None], -1))
    g = torch.Generator().manual_seed(7 + mesh.rank)
    dv = torch.randn((1, 1, scale.d), generator=g).to(dev)
    v_in = v[None]
    v_new = (v + dv[0, 0])[None]
    return {
        "redeal_s": _median_s(dev, lambda: coll.redeal(
            arrs, nb_local, keys, scale.redeal_frac)),
        "lane_sum_s": _median_s(dev, lambda: coll.lane_sum(
            dv, compress=scale.compress_sync)),
        "pod_reduce_s": _median_s(dev, lambda: coll.pod_reduce(v_new, v_in)),
    }


def run_case(mesh, case: dict, root: pathlib.Path, out: dict) -> dict:
    from repro_torch.api import Session
    from repro_torch.core.config import EngineConfig
    from repro_torch.kernels import sdca_bucket as kd
    from repro_torch.kernels import sdca_sparse_bucket as ks
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
    kd.launches = ks.launches = 0
    secs = []
    for e in range(case["epochs"]):
        st, s = _timed(dev, lambda: ep(*st, e))
        secs.append(s)
        for i, t in enumerate(st):
            if i >= len(st) - 3 or e == case["epochs"] - 1:
                out[f"{name}/resident/{e}/{i}"] = t.cpu().numpy()
    rec["resident"] = {"epoch_s": secs, "launches": {
        "sdca_bucket": kd.launches, "sdca_sparse_bucket": ks.launches}}

    # streamed: the front door on the process mesh
    data = ((arrays[0], arrays[1]), arrays[2]) if sparse \
        else (arrays[0], arrays[1])
    ses = Session(data, cfg=EngineConfig.make(**case["cfg"]),
                  lam=scale.lam, objective="logistic", streamed=True,
                  mesh=mesh, device=dev, **({"d": scale.d} if sparse else {}))
    kd.launches = ks.launches = 0
    stats = []
    for e in range(case["epochs"]):
        st_e = {}
        ses.epoch(stats=st_e)
        stats.append(st_e)
        out[f"{name}/streamed/{e}/a"] = ses.alpha.cpu().numpy()
        out[f"{name}/streamed/{e}/v"] = ses.v.cpu().numpy()
    rec["streamed"] = {"stats": stats, "launches": {
        "sdca_bucket": kd.launches, "sdca_sparse_bucket": ks.launches},
        "bytes_h2d": ses.mesh_feed.bytes_h2d}
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
        rec["cases"][case["name"]] = run_case(mesh, case, args.root, out)
    rec["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    np.savez(args.root / f"rank{args.rank}.npz", **out)
    (args.root / f"rank{args.rank}.json").write_text(json.dumps(rec))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
