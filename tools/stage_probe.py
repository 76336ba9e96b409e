"""Rates of the two ways a gloo process mesh on one card can move a
payload: gloo's own collectives, and a host buffer the ranks map
together (`sharding.collectives.HostStage`).

    python3 tools/stage_probe.py [--mb 256]

Starts 4 ranks on cuda:0 over gloo (a file store in a temporary
directory); each times, median of 3 and with all 4 at work: a pair's
and the world's `all_gather` and a pair's `all_to_all_single` of a CPU
tensor of --mb MiB, device-to-host and host-to-device copies of it
into a fresh CPU tensor, a page-locked one and a shared file mapping
reused across calls, and reports whether `cudaHostRegister` accepts
that mapping.  Rank 0 prints one JSON line of seconds, with the card's
name and power limit.  Needs one CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import mmap
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist


def _rank(rank: int, root: str, mb: int) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{root}/store",
                            rank=rank, world_size=4)
    pair = None
    for members in ([0, 1], [2, 3]):
        g = dist.new_group(members)
        if rank in members:
            pair = g
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    n = mb << 20
    x = torch.zeros(n, dtype=torch.uint8, device=dev)
    out: dict = {}

    def timed(name, fn, reps=3):
        fn()
        secs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out[name] = statistics.median(secs)

    xc = x.cpu()
    outs2 = [torch.empty_like(xc) for _ in range(2)]
    outs4 = [torch.empty_like(xc) for _ in range(4)]
    a2a = torch.empty_like(xc)
    timed("gloo_all_gather_pair_s", lambda: dist.all_gather(
        outs2, xc, group=pair))
    timed("gloo_all_gather_world_s", lambda: dist.all_gather(outs4, xc))
    timed("gloo_all_to_all_pair_s", lambda: dist.all_to_all_single(
        a2a, xc, group=pair))
    timed("d2h_fresh_s", lambda: x.cpu())
    pin = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    timed("d2h_pinned_s", lambda: pin.copy_(x))
    timed("h2d_pinned_s", lambda: x.copy_(pin))
    path = os.path.join(root, f"map{rank}")
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o600)
    os.ftruncate(fd, n)
    mm = mmap.mmap(fd, n)
    os.close(fd)
    os.unlink(path)
    buf = torch.frombuffer(mm, dtype=torch.uint8)
    timed("d2h_mapping_s", lambda: buf.copy_(x))
    timed("h2d_mapping_s", lambda: x.copy_(buf))
    dist.barrier()
    # last: a refused registration fails the next kernel launch
    rc = int(torch.cuda.cudart().cudaHostRegister(buf.data_ptr(), n, 0))
    out["mapping_register_rc"] = rc
    if rc == 0:
        torch.cuda.cudart().cudaHostUnregister(buf.data_ptr())
    if rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(json.dumps({"mb": mb, "ranks": 4, "card": smi,
                          "tmpdir": tempfile.gettempdir(), **out}),
              flush=True)
    del buf
    mm.close()
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mb", type=int, default=256)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        _rank(args.rank, args.root, args.mb)
        return
    if not torch.cuda.is_available():
        raise SystemExit("stage_probe: no CUDA device")
    root = tempfile.mkdtemp(prefix="stage-probe-")
    try:
        procs = [subprocess.Popen([sys.executable, __file__, "--mb",
                                   str(args.mb), "--rank", str(r), "--root",
                                   root]) for r in range(4)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if any(rcs):
        raise SystemExit(f"stage_probe: ranks exited {rcs}")


if __name__ == "__main__":
    main()
