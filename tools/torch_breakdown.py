"""Where an epoch's time goes on the card, for the port's main paths.

    python3 tools/torch_breakdown.py [--paths dense,sparse,sharded]
                                     [--out breakdown.json]

Builds the dense HIGGS and sparse criteo-shaped sessions of
`chip_smoke.py` (same sizes and 2 pods x 16 lanes), runs one warm-up
epoch, then measures on the card:

  * `epoch_s`     one whole epoch, host clock around a synchronize;
  * `schedule_s`  the host-side schedule (`plan.schedule` + gather ids);
  * `kernel_ms`   the kernel alone on that epoch's tiles, once per
                  objective (CUDA events, 1 launch each after warm-up):
                  ridge and hinge skip the 40-step logistic bisection,
                  so logistic - ridge is the bisection's share;
  * `profile`     a torch.profiler trace of one epoch: device time by
                  kernel name, and the device's busy share of an
                  unprofiled epoch (device time / `epoch_s`).

The `sharded` path is `chip_smoke.py`'s feature-sharded webspam run
(`make_sparse_epoch` on the stacked (2, 4, 4) mesh).  After a warm-up
epoch it times, on chunk 0 of the next epoch's tiles: the layout
(`ops.sharded_tiles`: the q precompute `row_sq_norms`, the links'
sort) per chunk, one launch of each kernel (the sharded bucket once per
objective) and the exchange per bucket; then one whole epoch and a
profiled one.

Prints one JSON object per path and, with --out, writes them all to a
file.  Needs one CUDA GPU and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs                                       # noqa: E402


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_epoch(run_epoch, epoch_s: float) -> dict:
    """Device time by kernel over one profiled epoch.  Only the device
    (kernel) events are summed — an operator's device time repeats its
    kernels' — and the busy share is taken against `epoch_s`, an
    unprofiled epoch's wall time: the profiler's own host cost inflates
    the profiled epoch's wall time on paths of many small launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_epoch()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if evt.device_type == DeviceType.CUDA and us > 0:
            by_name[evt.key] = us
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    busy = sum(by_name.values())
    return {"profiled_wall_us": wall_us, "device_us": busy,
            "busy_share": busy / (epoch_s * 1e6), "top_device_us": top}


def breakdown(label, make_session, kernel) -> dict:
    from repro_torch.core import engine
    from repro_torch.core.objectives import get_objective
    s = make_session()
    s.epoch()                                     # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    engine._sim_gather(s.plan, s.bplan.bucket, s.epochs_done)
    schedule_s = time.perf_counter() - t
    args, shape = cs.epoch_kernel_args(s)
    kernel_ms = {}
    for name in ("ridge", "hinge", "logistic"):
        obj = get_objective(name)
        kernel(obj, *args)                        # warm-up per objective
        kernel_ms[name] = cs.cuda_ms(lambda: kernel(obj, *args), 1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    s.epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t
    rec = {"path": label, "shape": shape, "objective": s.obj.name,
           "epoch_s": epoch_s, "schedule_s": schedule_s,
           "kernel_ms": kernel_ms,
           "per_coordinate_us": {k: v * 1e3 / (shape["n"] / shape["W"])
                                 for k, v in kernel_ms.items()},
           "profile": profile_epoch(s.epoch, epoch_s)}
    print(json.dumps(rec), flush=True)
    return rec


def breakdown_sharded() -> dict:
    from repro_torch.core import sdca
    from repro_torch.core.objectives import get_objective
    from repro_torch.kernels import ops
    from repro_torch.kernels import sdca_sparse_bucket as ks
    run = cs.sharded_setup()
    scale, epoch = run["scale"], run["epoch"]
    run["state"] = epoch(*run["state"], 0)        # warm-up
    tiles, lam_n, sig = cs.sharded_path_tiles(run, epoch=1)
    idxb, valb, yb, ab, qb, links, v_loc = tiles
    Wk, nb, B, nnz = idxb.shape
    d_loc = v_loc.shape[-1]
    per_chunk_ms = {
        "q_precompute": cs.cuda_ms(lambda: sdca.row_sq_norms(valb), 1),
        "links": cs.cuda_ms(lambda: ops._bucket_links(idxb), 1)}
    w_loc = ks.sdca_sparse_gather_bucket(idxb, 0, v_loc)
    W = ops.exchange_working_set(w_loc, idxb, 0, d_loc)
    per_bucket_ms = {
        "sdca_sparse_gather_bucket": cs.cuda_ms(
            lambda: ks.sdca_sparse_gather_bucket(idxb, 0, v_loc), 20),
        "exchange": cs.cuda_ms(
            lambda: ops.exchange_working_set(w_loc, idxb, 0, d_loc), 20)}
    for name in ("ridge", "hinge", "logistic"):
        obj = get_objective(name)
        v_t = v_loc.clone()
        per_bucket_ms[f"sdca_sparse_sharded_bucket_{name}"] = cs.cuda_ms(
            lambda: ks.sdca_sparse_sharded_bucket(
                obj, idxb, valb, yb, ab, qb, links, 0, W, v_t, lam_n, sig),
            3)

    def one_epoch(e):
        run["state"] = epoch(*run["state"], e)

    torch.cuda.synchronize()
    t = time.perf_counter()
    one_epoch(1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t
    rec = {"path": "sharded", "objective": "logistic",
           "shape": {"Wk": Wk, "M": v_loc.shape[1], "B": B, "nnz": nnz,
                     "d": scale.d, "d_loc": d_loc, "n": scale.n,
                     "chunks": scale.chunks, "buckets_per_chunk": nb},
           "epoch_s": epoch_s, "per_chunk_ms": per_chunk_ms,
           "per_bucket_ms": per_bucket_ms,
           "profile": profile_epoch(lambda: one_epoch(2), epoch_s)}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default="dense,sparse,sharded",
                    help="comma-separated subset of dense,sparse,sharded")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    paths = args.paths.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("torch_breakdown: no CUDA device")
    from repro_torch.api import Session
    from repro_torch.kernels import build, sdca_bucket, sdca_sparse_bucket
    _, smi = cs.phase_device()
    build.build_all()
    recs = []
    if "dense" in paths:
        recs.append(breakdown("dense", lambda: Session(
            "higgs", n=11_000_000, bucket=cs.BUCKET, cfg=cs._cfg()),
            sdca_bucket.sdca_bucket_kernel))
    if "sparse" in paths:
        recs.append(breakdown("sparse", lambda: Session(
            "criteo-kaggle-sub", n=2_097_152, d=1_000_000, bucket=cs.BUCKET,
            cfg=cs._cfg()),
            sdca_sparse_bucket.sdca_sparse_bucket_kernel))
    if "sharded" in paths:
        recs.append(breakdown_sharded())
    out = {"card": smi, "paths": recs}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
