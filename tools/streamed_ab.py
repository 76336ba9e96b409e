"""Streamed epoch seconds of several arms, alternated epoch by epoch on
one card.

    python3 tools/streamed_ab.py --arm parent=build/parent --arm change=. \
        --arm journal=.+journal [--paths dense,sparse] [--rounds 16] \
        [--out chiprun_out/streamed_ab.jsonl]

An arm is a source tree (its ``src/`` goes first on the path of a worker
process of its own, and its kernels build from its own ``csrc/``),
optionally with a crash-safe journal (``+journal``: ``journal_dir=``,
``journal_every=1``, the one setting under which a streamed epoch saves
its state after every chunk).  For each path every arm's worker opens
the streamed `Session` of `chip_smoke.py`'s streamed phase on one
shared tile cache (dense: HIGGS n 11,000,000; sparse: criteo-shaped
2^21 rows; 2 x 16 workers, 4 chunks, bucket 16), one worker at a time.
Then the arms run one epoch each per round, the arm that goes first
rotating from round to round, so every arm's k-th epoch does the same
work from the same state while the others wait.  After each round the
arms' (alpha, v) must hash alike: a journal or a tree that changes the
result fails the run.

Prints one JSON line per epoch (seconds, the epoch's ``stats``, and
for a journaled arm the host seconds inside its saves) and one summary
line per path: per arm the median and quartiles of the epoch seconds,
the loop's wait on the feed and the journal's seconds, and against
each arm named before it the median and quartiles of the per-round
differences and the rounds in which it was the slower.  Round 0 warms
each worker up and is left out of the summary.  ``--device cpu --n
4096`` rehearses it without a card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parents[1]


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize()


def worker(args) -> None:
    """One arm: build its kernels, open its Session, then run an epoch
    for each ``epoch`` line read from stdin and answer with a JSON
    line."""
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch
    import repro_torch                 # the arm's tree, before HERE/src
    from repro_torch.api import Session
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs            # the streamed phase's settings
    assert pathlib.Path(repro_torch.__file__).is_relative_to(
        pathlib.Path(args.src).resolve())
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    run = cs.STREAM_RUNS[args.path]
    kw = {}
    if args.journal:
        kw = dict(journal_dir=args.journal, journal_every=1)
    s = Session(run["name"], n=args.n or run["n"], d=run["d"],
                bucket=cs.BUCKET, cfg=cs._stream_cfg(), cache_dir=args.cache,
                streamed=True, device=dev, **kw)
    spent = [0.0]
    if args.journal:                   # time the saves where they run
        j = s._journal
        for name in ("post_chunk", "commit_epoch"):
            def timed(*a, _f=getattr(j, name), **k):
                t = time.perf_counter()
                try:
                    return _f(*a, **k)
                finally:
                    spent[0] += time.perf_counter() - t
            setattr(j, name, timed)
    print(json.dumps({"ready": True, "tree": str(repro_torch.__file__)}),
          flush=True)
    for line in sys.stdin:
        if line.strip() != "epoch":
            break
        stats, spent[0] = {}, 0.0
        _sync(dev)
        t = time.perf_counter()
        s.epoch(stats=stats)
        _sync(dev)
        secs = time.perf_counter() - t
        digest = hashlib.sha256(s.alpha.cpu().numpy().tobytes()
                                + s.v.cpu().numpy().tobytes()).hexdigest()
        print(json.dumps({"seconds": secs, "stats": stats,
                          "journal_s": spent[0] if args.journal else None,
                          "epochs_done": s.epochs_done,
                          "sha256": digest}), flush=True)


def _quartiles(xs) -> dict:
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return {"median": q[1], "q1": q[0], "q3": q[2], "min": min(xs),
            "max": max(xs)}


def _start(arm, path, cache, args, tmp) -> subprocess.Popen:
    cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
           "--worker", "--src", str(pathlib.Path(arm["tree"]) / "src"),
           "--path", path, "--cache", str(cache), "--device", args.device]
    if args.n:
        cmd += ["--n", str(args.n)]
    if arm["journal"]:
        cmd += ["--journal", str(tmp / f"journal-{arm['name']}-{path}")]
    p = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         text=True, cwd=arm["tree"])
    got = p.stdout.readline()
    if not got or not json.loads(got).get("ready"):
        p.kill()
        raise RuntimeError(f"arm {arm['name']} ({path}): its worker did not "
                           f"start (exit {p.wait()})")
    return p


def _ask(p: subprocess.Popen, name: str) -> dict:
    p.stdin.write("epoch\n")
    p.stdin.flush()
    got = p.stdout.readline()
    if not got:
        raise RuntimeError(f"arm {name}: its worker died (exit {p.wait()})")
    return json.loads(got)


def ab_path(path, arms, args, tmp, out) -> dict:
    cache = tmp / "cache"
    procs = {}
    try:
        for arm in arms:               # one at a time: the first builds
            procs[arm["name"]] = _start(arm, path, cache, args, tmp)
        got = {a["name"]: [] for a in arms}
        for r in range(args.rounds):
            k = r % len(arms)
            order = arms[k:] + arms[:k]
            for arm in order:
                rec = _ask(procs[arm["name"]], arm["name"])
                rec.update(path=path, round=r, arm=arm["name"],
                           position=order.index(arm))
                got[arm["name"]].append(rec)
                out(rec)
            digests = {got[a["name"]][-1]["sha256"] for a in arms}
            if len(digests) != 1:
                raise AssertionError(f"{path}: round {r}: the arms' states "
                                     f"differ")
    finally:
        for p in procs.values():
            try:
                p.stdin.close()        # the worker's loop ends with stdin
            except OSError:
                pass
        for p in procs.values():
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    summary = {"path": path, "rounds": args.rounds, "warm_up_rounds": 1,
               "arms": {}, "bitwise_alike": True}
    for arm in arms:
        recs = got[arm["name"]][1:]
        one = {"seconds": _quartiles([x["seconds"] for x in recs]),
               "ingest_wait_s": _quartiles(
                   [x["stats"]["ingest_wait_s"] for x in recs])}
        if arm["journal"]:
            one["journal_s"] = _quartiles([x["journal_s"] for x in recs])
        for other in arms[:arms.index(arm)]:
            diffs = [x["seconds"] - y["seconds"]
                     for x, y in zip(recs, got[other["name"]][1:])]
            one[f"minus_{other['name']}_s"] = _quartiles(diffs)
            one[f"rounds_slower_than_{other['name']}"] = sum(
                d > 0 for d in diffs)
        summary["arms"][arm["name"]] = one
    return summary


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arm", action="append", default=[],
                    help="NAME=TREE or NAME=TREE+journal")
    ap.add_argument("--paths", default="dense,sparse")
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=0,
                    help="rows (default: the streamed phase's)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--src", help=argparse.SUPPRESS)
    ap.add_argument("--path", help=argparse.SUPPRESS)
    ap.add_argument("--cache", help=argparse.SUPPRESS)
    ap.add_argument("--journal", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args)
    if len(args.arm) < 2 or args.rounds < 3:
        raise SystemExit("give two --arm or more and --rounds 3 or more")
    arms = []
    for spec in args.arm:
        name, _, tree = spec.partition("=")
        journal = tree.endswith("+journal")
        tree = tree.removesuffix("+journal")
        arms.append({"name": name, "journal": journal,
                     "tree": str(pathlib.Path(tree).resolve())})
    sink = open(args.out, "w") if args.out else None

    def out(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink is not None:
            sink.write(line + "\n")
            sink.flush()

    if args.device == "cuda":
        out({"card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()})
    for path in args.paths.split(","):
        tmp = pathlib.Path(tempfile.mkdtemp(prefix=f"streamed-ab-{path}-"))
        try:
            out({"summary": ab_path(path, arms, args, tmp, out)})
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    if sink is not None:
        sink.close()


if __name__ == "__main__":
    main()
