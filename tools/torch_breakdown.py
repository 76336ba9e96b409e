"""Where an epoch's time goes on the card, for the port's two main paths.

    python3 tools/torch_breakdown.py [--out breakdown.json]

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
                  kernel name and the device's busy share of the epoch.

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


def profile_epoch(s) -> dict:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s.epoch()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0:
            by_name[evt.key] = us
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    busy = sum(by_name.values())
    return {"wall_us": wall_us, "device_us": busy,
            "busy_share": busy / wall_us, "top_device_us": top}


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
           "profile": profile_epoch(s)}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_breakdown: no CUDA device")
    from repro_torch.api import Session
    from repro_torch.kernels import build, sdca_bucket, sdca_sparse_bucket
    _, smi = cs.phase_device()
    build.build_all()
    recs = [
        breakdown("dense", lambda: Session(
            "higgs", n=11_000_000, bucket=cs.BUCKET, cfg=cs._cfg()),
            sdca_bucket.sdca_bucket_kernel),
        breakdown("sparse", lambda: Session(
            "criteo-kaggle-sub", n=2_097_152, d=1_000_000, bucket=cs.BUCKET,
            cfg=cs._cfg()),
            sdca_sparse_bucket.sdca_sparse_bucket_kernel),
    ]
    out = {"card": smi, "paths": recs}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
