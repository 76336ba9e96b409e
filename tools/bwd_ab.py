"""Time B5's and B6's backward kernels of two trees in one call, in turns.

    python3 tools/bwd_ab.py --arm parent=build/parent --arm change=.

Each arm runs in a worker process of its own (`--worker TREE`), which
imports that tree's `repro_torch` (building its kernels into the tree's
own build directory) and prints one JSON line: the ms a call of its
`flash_attention.flash_attention_bwd` at the five B5 shapes of the
full-width train runs (`chip_smoke.FA_BWD_SHAPES`) and of its
`rglru.rglru_bwd` at recurrentgemma-2b's (1, 2,048, 2,560), on the
same seeded bf16 inputs, timed by this checkout's `chip_smoke.cuda_ms`.
A tree whose forward keeps each row's lse (`with_lse`) hands it to its
backward.  Arms run in the order A B B A, `--rounds` times; the last
line holds each arm's readings.  To compare a commit with its parent,
unpack the parent by `git archive` into a git-ignored directory (say
`build/parent`).  Needs one CUDA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def _timer():
    """This checkout's `chip_smoke.cuda_ms`, with sys.path left as it was
    (chip_smoke puts its own src first)."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("_ab_chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = path
    return mod.cuda_ms, mod.FA_BWD_SHAPES


def worker(tree: pathlib.Path) -> dict:
    import torch
    cuda_ms, shapes = _timer()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev  # noqa: E731
                                 ).bfloat16()
    keeps_lse = "with_lse" in inspect.signature(
        fa.flash_attention_kernel).parameters
    fa_ms = {}
    for label, (B, Sq, Sk, H, Hkv, hd, kind, w) in shapes.items():
        q, k, v = rnd(B, Sq, H, hd), rnd(B, Sk, Hkv, hd), rnd(B, Sk, Hkv, hd)
        kw = dict(kind=kind, window=w)
        if keeps_lse:
            o, lse = fa.flash_attention_kernel(q, k, v, with_lse=True, **kw)
            kw["lse"] = lse
        else:
            o = fa.flash_attention_kernel(q, k, v, **kw)
        do = rnd(*o.shape)
        fa.flash_attention_bwd(q, k, v, o, do, **kw)
        fa_ms[label] = cuda_ms(
            lambda: fa.flash_attention_bwd(q, k, v, o, do, **kw), 10)
        del q, k, v, o, do, kw
    B, T, D = 1, 2048, 2560
    x, ga, gx, dh = (rnd(B, T, D) for _ in range(4))
    a_log = -torch.rand(D, generator=gen, device=dev) * 0.5
    h0 = torch.zeros((B, D), device=dev)
    args = (x, a_log, ga, gx, h0, dh, torch.zeros_like(h0))
    rg.rglru_bwd(*args)
    return {"tree": str(tree), "card": torch.cuda.get_device_name(0),
            "fa_bwd_ms": fa_ms,
            "rglru_bwd_ms": cuda_ms(lambda: rg.rglru_bwd(*args), 20)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arm", action="append", default=[],
                    help="NAME=TREE; two arms")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(pathlib.Path(a.worker).resolve())),
              flush=True)
        return
    arms = dict(s.split("=", 1) for s in a.arm)
    if len(arms) != 2:
        raise SystemExit("bwd_ab: give two --arm NAME=TREE")
    first, second = arms
    runs = {name: [] for name in arms}
    for _ in range(a.rounds):
        for name in (first, second, second, first):
            out = subprocess.run(
                [sys.executable, __file__, "--worker", arms[name]],
                check=True, capture_output=True, text=True).stdout
            rec = json.loads(out.strip().splitlines()[-1])
            print(json.dumps({"arm": name, **rec}), flush=True)
            runs[name].append(rec)
    print(json.dumps({"bwd_ab": {n: {"fa_bwd_ms": [r["fa_bwd_ms"]
                                                   for r in rs],
                                     "rglru_bwd_ms": [r["rglru_bwd_ms"]
                                                      for r in rs]}
                                 for n, rs in runs.items()}}), flush=True)


if __name__ == "__main__":
    main()
