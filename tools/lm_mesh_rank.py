"""One rank of a process mesh: the LM's train and serve steps on its shards.

    python3 tools/lm_mesh_rank.py ROOT RANK WORLD [--device cuda|cpu]

`chip_smoke.py`'s `lm_mesh` phase and `tests/test_torch_lm_mesh.py`
start WORLD of these, one a rank, after the kernels are built (a rank
on the card that finds one unbuilt exits without compiling), and they
rendezvous through a file store in ROOT (gloo; several ranks may share
one card).  ROOT holds ``cases.json``: ``{"timeout": s, "cases":
[...]}``, each case a config (``arch``, ``smoke``, ``fields`` replaced
in it, ``dtype``), a ``mesh`` (pod, data, model), optional weights
(``weights``: an ``.npz`` of the whole one-card tree, keyed by its leaf
paths joined by ``/``, in place of the seeded draw; ``fsdp_min``: the
FSDP size floor in entries) and what to run on it:

  * ``train``: `launch.train.train(mesh=)` ``runs`` times from the same
    start (each run's losses, grad norms, host seconds a step, the
    collectives' calls / bytes / seconds / payload shapes, B5's forward
    and backward launches by route, peak device bytes, the card's peak
    while the ranks drew the weights, a MoE's kept and dropped pairs,
    and a digest of each leaf of its parameters and moments with the
    shard it holds), with ``ckpt_dir`` / ``ckpt_every`` when given;
  * ``grads``: step 0's loss and gradients (`steps.make_grad_step`),
    gathered whole and written by rank 0, with a MoE's global ``slot``
    and ``keep`` of each call;
  * ``f32``: on f32 copies of the seeded draw, step 0's forward (each
    MoE call's global ``slot`` and ``keep`` written by rank 0) and a
    greedy generation from step 0's tokens (the whole ids): f32, so that
    the mesh's reordered sums do not move a near-tied top-k choice or
    greedy token as bf16's roundings can;
  * ``serve``: `launch.serve.serve(mesh=)` (the whole ids, this rank's
    seconds, the prefill's last logits gathered whole, a MoE's kept and
    dropped pairs);
  * ``resave``: the state ``train`` restored (from another mesh's
    checkpoint), gathered and saved again by rank 0 in the one-card
    format under this directory.

Each rank writes ``ROOT/rank{RANK}.json`` (and, rank 0, ``rank0.npz``
with the gathered arrays), and the modules of JAX or the reference it
saw imported (none allowed).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np
import torch


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_cfg(case: dict):
    from repro_torch.configs import get_config, get_smoke
    cfg = (get_smoke if case.get("smoke") else get_config)(case["arch"])
    fields = dict(case.get("fields", {}))
    if case.get("dtype"):
        fields["dtype"] = getattr(torch, case["dtype"])
    return dataclasses.replace(cfg, **fields)


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def load_weights(path: str, cfg):
    """The whole one-card tree from an .npz keyed by leaf path."""
    from repro_torch.models import lm
    from repro_torch.models.layers import tree_map_path
    z = np.load(path)
    return tree_map_path(lambda p, _s: torch.from_numpy(z[_key(p)]),
                         lm.param_specs(cfg))


def use_weights(whole):
    """`steps.init_params` replaced by `whole` (sliced by the mesh's
    layout, on the caller's device)."""
    from repro_torch.launch import steps
    from repro_torch.models.layers import tree_map

    def init(cfg, seed=0, device="cpu", mesh=None):
        if mesh is None:
            return tree_map(lambda t: t.to(device), whole)
        lay = steps.layout_for(cfg, mesh)
        return tree_map(lambda t, pl: lay.local(t, pl).to(mesh.device),
                        whole, lay.params)

    steps.init_params = init


def _digest(t: torch.Tensor) -> str:
    """A fingerprint of `t`'s bytes, on its device: their 64-bit words'
    wrapping sum and position-weighted sum (equal tensors always agree;
    unequal ones almost surely differ), and the shape."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 8:
        b = torch.cat([b, b.new_zeros(8 - b.numel() % 8)])
    v = b.view(torch.int64)
    i = torch.arange(v.numel(), device=v.device, dtype=torch.int64)
    h1, h2 = int(v.sum()), int((v * (i * 2654435761 + 1)).sum())
    return f"{tuple(t.shape)}:{h1 & (2**64 - 1):x}:{h2 & (2**64 - 1):x}"


def digests(lay, params, state) -> dict:
    """Each leaf's digest and the shard it is (its coordinates on the
    axes it is split over): leaves that share a shard must share bits."""
    from repro_torch.models.layers import tree_items
    coords = dict(zip(("pod", "data", "model"), lay.mesh.coords))
    places = lay.state_places(state)
    out = {}

    def add(name, tree, where):
        pl = dict(tree_items(where))
        for path, t in tree_items(tree):
            p = pl[path]
            out[f"{name}/{_key(path)}"] = (
                _digest(t), [coords[a] for a in sorted(set(p.axes))])

    add("params", params, lay.params)
    for name in ("mu", "nu"):
        mom = getattr(state, name)
        add(name, mom, getattr(places, name))
    return out


def _fa_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    return {"flash_attention": fa.launches,
            "flash_attention_bwd": fa.bwd_launches,
            "bwd_tc": fa.bwd_tc_launches, "bwd_core": fa.bwd_core_launches}


def _zero_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    fa.launches = fa.tc_launches = fa.core_launches = 0
    fa.bwd_launches = fa.bwd_tc_launches = fa.bwd_core_launches = 0


def _init_stats(dev) -> dict:
    from repro_torch.launch import steps
    return dict(steps.INIT_STATS) if dev.type == "cuda" else {}


def run_train(mesh, cfg, case: dict, root: pathlib.Path) -> dict:
    from repro_torch.launch import steps, train as train_lib
    from repro_torch.models import moe
    from repro_torch.sharding import collectives as coll
    tr = case["train"]
    dev = mesh.device
    lay = steps.layout_for(cfg, mesh)
    runs = []
    for _ in range(tr.get("runs", 1)):
        coll.reset_stats()
        _zero_counts()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        hist: list = []
        ckpt = tr.get("ckpt_dir")
        _sync(dev)
        t0 = time.perf_counter()
        with moe.record_dispatch() as log:
            params, state, losses = train_lib.train(
                cfg, steps=tr["steps"], batch=tr["batch"], seq=tr["seq"],
                verbose=False, history=hist, mesh=mesh,
                ckpt_dir=str(root / ckpt) if ckpt else None,
                ckpt_every=tr.get("ckpt_every", 0))
        _sync(dev)
        n = max(len(hist), 1)
        rec = {"losses": losses,
               "grad_norms": [h["grad_norm"] for h in hist],
               "seconds": [h["seconds"] for h in hist],
               "wall_s": time.perf_counter() - t0,
               "collectives": {k: dict(v) for k, v in coll.STATS.items()},
               "collective_s_per_step": {k: v["seconds"] / n
                                         for k, v in coll.STATS.items()},
               "launches": _fa_counts(),
               "pairs": moe.dispatch_counts(log),
               "init": _init_stats(dev),
               "digests": digests(lay, params, state)}
        if dev.type == "cuda":
            rec["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
        if tr.get("resave"):
            whole = lay.state_full(params, state)
            if mesh.rank == 0:
                from repro_torch.checkpoint import CheckpointManager
                mgr = CheckpointManager(root / tr["resave"])
                mgr.save(int(state.step), whole,
                         meta={"step": int(state.step)})
                mgr.wait()
            del whole
            lay.barrier()
        runs.append(rec)
        del params, state
    return {"runs": runs}


def run_grads(mesh, cfg, case: dict, out: dict) -> dict:
    from repro_torch.launch import steps, train as train_lib
    from repro_torch.models import moe
    from repro_torch.models.layers import tree_items, tree_map
    g = case["grads"]
    lay = steps.layout_for(cfg, mesh)
    params = steps.init_params(cfg, 0, mesh.device, mesh=mesh)
    b = train_lib.batch_at(cfg, g["batch"], g["seq"], 0, device=mesh.device)
    b = {k: lay.batch_slice(v) for k, v in b.items()}
    with moe.record_dispatch() as log:
        loss, grads = steps.make_grad_step(cfg, mesh)(params, b)
    whole = tree_map(lay.full, grads, lay.params)
    if mesh.rank == 0:
        for path, t in tree_items(whole):
            out[f"{case['name']}/grads/{_key(path)}"] = t.float().cpu().numpy()
        for i, rec in enumerate(log):
            for k, v in rec.items():
                out[f"{case['name']}/dispatch/{i}/{k}"] = v.numpy()
    return {"loss": float(loss), "pairs": moe.dispatch_counts(log)}


def run_f32(mesh, cfg, case: dict, out: dict) -> dict:
    from repro_torch import sharding
    from repro_torch.launch import serve as serve_lib, steps
    from repro_torch.launch import train as train_lib
    from repro_torch.models import lm, moe
    from repro_torch.models.layers import tree_map
    f = case["f32"]
    lay = steps.layout_for(cfg, mesh)
    params = tree_map(lambda t: t.float(),
                      steps.init_params(cfg, 0, mesh.device, mesh=mesh))
    tokens = lay.batch_slice(train_lib.batch_at(
        cfg, f["batch"], f["seq"], 0, device=mesh.device)["tokens"])
    with torch.no_grad(), sharding.use_layout(lay), \
            moe.record_dispatch() as log:
        lm.forward(params, tokens, cfg, mode="train")
    if mesh.rank == 0:
        for i, rec in enumerate(log):
            for k, v in rec.items():
                out[f"{case['name']}/dispatch/{i}/{k}"] = v.numpy()
    ids = lay.batch_gather(serve_lib.generate(params, tokens, cfg, f["gen"],
                                              mesh=mesh))
    return {"pairs": moe.dispatch_counts(log), "calls": len(log),
            "ids": ids.cpu().tolist()}


def run_serve(mesh, cfg, case: dict, out: dict) -> dict:
    from repro_torch.launch import serve as serve_lib, steps
    from repro_torch.models import moe
    from repro_torch.sharding import collectives as coll
    sv = case["serve"]
    coll.reset_stats()
    _zero_counts()
    st: dict = {}
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(mesh.device)
    with moe.record_dispatch() as log:
        ids = serve_lib.serve(cfg, batch=sv["batch"],
                              prompt_len=sv["prompt"], gen=sv["gen"],
                              verbose=False, stats=st, mesh=mesh)
    lay = steps.layout_for(dataclasses.replace(cfg, layout="tp"), mesh)
    logits = st.pop("prefill_logits").to(mesh.device)
    if lay.tp > 1:
        logits = coll.all_gather(logits.contiguous(), mesh, lay.tp_axes, -1)
    logits = lay.batch_gather(logits)
    if mesh.rank == 0:
        out[f"{case['name']}/serve/ids"] = ids.cpu().numpy()
        out[f"{case['name']}/serve/logits"] = logits.cpu().numpy()
    return {"ids": ids.cpu().tolist(), "launches": _fa_counts(),
            "collectives": {k: dict(v) for k, v in coll.STATS.items()},
            "pairs": moe.dispatch_counts(log), "init": _init_stats(mesh.device),
            **({"peak_device_bytes": torch.cuda.max_memory_allocated(
                mesh.device)} if mesh.device.type == "cuda" else {}),
            **{k: v for k, v in st.items() if isinstance(v, (int, float))}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", type=pathlib.Path)
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    torch.set_num_threads(1 if args.device == "cpu" else 2)
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_dist_mesh
    if args.device == "cuda" and build.unbuilt():
        raise SystemExit(f"rank {args.rank}: kernels not built "
                         f"({build.unbuilt()}); the parent builds them")
    spec = json.loads((args.root / "cases.json").read_text())
    meshes: dict = {}
    out: dict = {}
    rec = {"rank": args.rank, "cases": {}}
    real_init = steps.init_params
    floor = steps._FSDP_MIN_SIZE
    for case in spec["cases"]:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_dist_mesh(
                pod=shape[0], data=shape[1], model=shape[2], backend="gloo",
                device=args.device, rank=args.rank, world_size=args.world,
                init_method=f"file://{args.root / 'store'}",
                timeout=spec["timeout"])
        mesh = meshes[shape]
        cfg = make_cfg(case)
        steps._FSDP_MIN_SIZE = case.get("fsdp_min", floor)
        steps.init_params = real_init
        if case.get("weights"):
            use_weights(load_weights(str(args.root / case["weights"]), cfg))
        got = {"coords": list(mesh.coords), "device": str(mesh.device)}
        print(f"rank {args.rank}: case {case['name']}", flush=True)
        if "grads" in case:
            got["grads"] = run_grads(mesh, cfg, case, out)
        if "f32" in case:
            got["f32"] = run_f32(mesh, cfg, case, out)
        if "train" in case:
            got["train"] = run_train(mesh, cfg, case, args.root)
        if "serve" in case:
            got["serve"] = run_serve(mesh, cfg, case, out)
        rec["cases"][case["name"]] = got
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    steps.init_params = real_init
    rec["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if args.rank == 0:
        np.savez(args.root / "rank0.npz", **out)
    (args.root / f"rank{args.rank}.json").write_text(json.dumps(rec))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
