"""Where an epoch's time goes on the card, for the port's main paths.

    python3 tools/torch_breakdown.py [--paths dense,sparse,sharded,lm,train]
                                     [--out breakdown.json]

Builds the dense HIGGS and sparse criteo-shaped sessions of
`chip_smoke.py` (same sizes and 2 pods x 16 lanes), runs one warm-up
epoch, then measures on the card:

  * `epoch_s`     one whole epoch, host clock around a synchronize;
  * `schedule_s`  the host-side schedule (`plan.schedule` + gather ids);
  * `kernel_ms`   the kernel alone on that epoch's tiles, once per
                  objective (CUDA events, 1 launch each after warm-up):
                  ridge and hinge skip the 40-step logistic bisection,
                  so `bisection_ms` = logistic - ridge is the
                  bisection's share;
  * `profile`     a torch.profiler trace of one epoch: device time by
                  kernel name, and the device's busy share of an
                  unprofiled epoch (device time / `epoch_s`).

The `sharded` path is `chip_smoke.py`'s feature-sharded webspam run
(`make_sparse_epoch` on the stacked (2, 4, 4) mesh).  After a warm-up
epoch it times, on chunk 0 of the next epoch's tiles: the layout
(`ops.sharded_tiles`: the q precompute `row_sq_norms`, the links'
sort) per chunk, one launch of each kernel (the sharded bucket once per
objective) and the library call that computes B3's function
(`torch.gather` on the flattened slices, int64 index built beforehand)
per bucket; then one whole epoch and a profiled one, with the pair's
device time and launches in that epoch (`pair_device_us`).

The `lm` path is `chip_smoke.py`'s recurrentgemma-2b serving run
(random weights, batch 2 x 4,096 prompt tokens).  After a warm-up
prefill it times one prefill (host clock around a synchronize), then a
profiled one, whose device time it splits into B5 flash attention
(the bf16 tensor-core kernel on this path; the CUDA-core kernel apart,
should it run), B6 RG-LRU, the matrix products (cuBLAS kernels) and the
rest (elementwise and reductions), with the host's share (prefill wall
time less device busy time); the logits product (x @ lm_head, (8,192 x
2,560) by (2,560 x 256,000)) alone by CUDA events; and a profiled run
of 4 decode steps.  Not in the default `--paths`.

The `train` path is `chip_smoke.py`'s three full-width train runs
(`TRAIN_RUNS`: smollm-360m, recurrentgemma-2b, whisper-base; seeded
weights, the Markov stream).  For each, after two warm-up steps it
times one step (host clock, ending in the loss's read, as
`launch.train` does) and profiles the next, whose device time it
splits by kernel (`train_category`: B5's and B6's forward and backward
kernels, the matrix products, the rest), with the device's busy share
of the unprofiled step and the host's gap (step time less device busy
time).  Not in the default `--paths`.

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


def profile_epoch(run_epoch, epoch_s: float, full: bool = False) -> dict:
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
    by_name, counts = {}, {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if evt.device_type == DeviceType.CUDA and us > 0:
            by_name[evt.key] = us
            counts[evt.key] = evt.count
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    busy = sum(by_name.values())
    out = {"profiled_wall_us": wall_us, "device_us": busy,
           "busy_share": busy / (epoch_s * 1e6), "top_device_us": top}
    if full:
        out["by_name"] = {k: (v, counts[k]) for k, v in by_name.items()}
    return out


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
           "bisection_ms": kernel_ms["logistic"] - kernel_ms["ridge"],
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
    W = ks.sdca_sparse_gather_bucket(idxb, 0, v_loc)
    v_flat = v_loc.view(Wk, -1)
    idx64 = idxb[:, 0].reshape(Wk, -1).long()
    per_bucket_ms = {
        "sdca_sparse_gather_bucket": cs.cuda_ms(
            lambda: ks.sdca_sparse_gather_bucket(idxb, 0, v_loc), 20),
        "library_gather": cs.cuda_ms(
            lambda: torch.gather(v_flat, 1, idx64), 20)}
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
           "per_bucket_ms": per_bucket_ms}
    prof = profile_epoch(lambda: one_epoch(2), epoch_s, full=True)
    rec["pair_device_us"] = {          # (device us, launches) in the epoch
        k: v for k, v in prof.pop("by_name").items()
        if "sdca_sparse_gather_bucket_kernel" in k
        or "sdca_sparse_sharded_bucket_kernel" in k}
    rec["profile"] = prof
    print(json.dumps(rec), flush=True)
    return rec


#: kernel-name pieces of the matrix products (cuBLAS / CUTLASS kernels)
GEMM_NAMES = ("gemm", "Gemm", "GEMM", "xmma", "cutlass", "nvjet", "sm90_")


def lm_category(name: str) -> str:
    if "flash_attention_tc_kernel" in name:
        return "flash_attention_tc (B5, bf16 tensor cores)"
    if "flash_attention_kernel" in name:
        return "flash_attention (B5, CUDA cores)"
    if "rglru_kernel" in name:
        return "rglru (B6)"
    if any(p in name for p in GEMM_NAMES):
        return "matmul"
    return "other (elementwise, reductions, copies)"


def train_category(name: str) -> str:
    """`lm_category`, with the backward kernels apart."""
    if "fa_bwd_tc" in name:
        return "flash_attention_bwd_tc (B5 backward, tensor cores)"
    if "fa_bwd_" in name:
        return "flash_attention_bwd (B5 backward, CUDA cores)"
    if "rglru_bwd" in name:
        return "rglru_bwd (B6 backward)"
    return lm_category(name)


def breakdown_train() -> list:
    """Where a warm train step's time goes, for each full-width run."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import batch_at
    from repro_torch.optim import adamw
    dev = torch.device("cuda")
    recs = []
    for name, run in cs.TRAIN_RUNS.items():
        cfg = get_config(name)
        opt_cfg = steps_lib.make_opt_cfg(cfg)
        params = steps_lib.init_params(cfg, 0, dev)
        state = adamw.init(params, opt_cfg)
        step_fn = steps_lib.make_train_step(cfg, opt_cfg)
        s = [0]

        def step():
            nonlocal params, state
            b = batch_at(cfg, run["batch"], run["seq"], s[0], 0, dev)
            params, state, metrics = step_fn(params, state, b)
            s[0] += 1
            return float(metrics["loss"])

        for _ in range(2):                            # warm-up
            step()
        t = time.perf_counter()
        step()
        step_s = time.perf_counter() - t
        prof = profile_epoch(step, step_s, full=True)
        cats: dict[str, list] = {}
        for kname, (us, n) in prof.pop("by_name").items():
            c = cats.setdefault(train_category(kname), [0.0, 0])
            c[0] += us
            c[1] += n
        rec = {"path": "train", "config": name, **run, "step_s": step_s,
               "device_ms": {k: v[0] / 1e3 for k, v in cats.items()},
               "launches": {k: v[1] for k, v in cats.items()},
               "host_gap_ms": step_s * 1e3 - prof["device_us"] / 1e3,
               "profile": prof}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
        del params, state, step_fn
        torch.cuda.empty_cache()
    return recs


def breakdown_lm() -> dict:
    """Where recurrentgemma-2b's prefill time goes (and a decode step's)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.serve import widen_cache
    from repro_torch.models import lm
    from repro_torch.models.layers import rmsnorm
    name = "recurrentgemma-2b"
    cfg, run = get_config(name), cs.LM_RUNS[name]
    B, P, gen = run["batch"], run["prompt_len"], run["gen"]
    dev = torch.device("cuda")
    with torch.inference_mode():
        params = steps.init_params(cfg, 0, dev)
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (B, P)), device=dev)

        def prefill():
            return lm.forward(params, toks, cfg, mode="prefill")

        out = prefill()                               # warm-up
        del out
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = prefill()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        del logits
        prof = profile_epoch(lambda: prefill(), prefill_s, full=True)
        cats: dict[str, list] = {}
        for kname, (us, n) in prof.pop("by_name").items():
            c = cats.setdefault(lm_category(kname), [0.0, 0])
            c[0] += us
            c[1] += n
        device_ms = {k: v[0] / 1e3 for k, v in cats.items()}
        launches = {k: v[1] for k, v in cats.items()}
        host_ms = prefill_s * 1e3 - prof["device_us"] / 1e3

        x = rmsnorm(torch.randn((B, P, cfg.d_model), device=dev,
                                dtype=cfg.dtype), params["final_norm"]["g"])
        logits_ms = cs.cuda_ms(lambda: x @ params["lm_head"], 5)

        cache = widen_cache(cache, cfg, B, P + gen)
        decode = steps.make_decode_step(cfg)
        tok = toks[:, -1:]
        pos = [P]

        def decode_steps(n=4):
            nonlocal tok, cache
            for _ in range(n):
                nt, cache = decode(params, {"tokens": tok, "cache": cache,
                                            "pos": pos[0]})
                tok = nt[:, None]
                pos[0] += 1

        decode_steps()                                # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        decode_steps()
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t
        dprof = profile_epoch(decode_steps, decode_s)
    rec = {"path": "lm", "config": name, **run,
           "prefill_s": prefill_s, "prefill_device_ms": device_ms,
           "prefill_launches": launches, "prefill_host_gap_ms": host_ms,
           "logits_product_ms": logits_ms, "profile": prof,
           "decode_4_steps_s": decode_s, "decode_profile": dprof}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default="dense,sparse,sharded",
                    help="comma-separated subset of dense,sparse,sharded,"
                         "lm,train")
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
    if "lm" in paths:
        recs.append(breakdown_lm())
    if "train" in paths:
        recs += breakdown_train()
    out = {"card": smi, "paths": recs}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
