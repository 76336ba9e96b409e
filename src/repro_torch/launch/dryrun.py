"""Dry run: every (arch x shape x mesh) cell's memory and roofline,
counted on the `meta` device.

The reference lowers and compiles each cell for its production meshes
(a 16 x 16 pod, two of them) on 512 forced host devices and reads XLA's
memory and cost analyses.  The port compiles nothing: a cell's
arguments come from the spec transforms (`launch/steps.py`
`abstract_params`, `abstract_opt_state`; `launch/specs.py`
`input_specs`), exact per device, and its step is run once on `meta`
under `launch/counting.py`'s `CountingMode` (flops, bytes accessed,
temp peak; B5's and B6's own costs for their calls).  GLM cells take
`launch.glm.glm_analytic`'s closed form, as the reference's do.

Meshes: `card` (1, 1, 1), one H100, where the count is one device's
exactly and there are no collectives: the record one card can be held
to (`chip_smoke.py`'s `dryrun` phase); `pod` (16, 16) and `multipod`
(2, 16, 16), the reference's.  There an LM record's arguments are
exact per device, its flops, bytes and temp peak are the global count
divided over the chips (`method` says so), and its collective term is
0 (`coll_method`: not modeled until the LM runs on a mesh, A16 step
4b); a GLM record has `glm_analytic`'s collective bytes.  A GLM record
is bounded by the card's f32 peak (its kernels compute in f32), an LM
record by the bf16 tensor-core peak.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k --mesh card

Records go to experiments/dryrun_torch/<arch>__<shape>__<mesh>.json, one
a cell, as each finishes; a failing cell is recorded with status
"error" and the run exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import time
import traceback

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import glm as glm_launch
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.cost_analysis import Roofline, memory_analysis_dict
from repro_torch.launch.counting import count_step, per_device
from repro_torch.launch.glm import InputSpec
from repro_torch.launch.mesh import (H2D_BW, HBM_BW, LINK_BW, PEAK_FLOPS,
                                     PEAK_FLOPS_F32, abstract_mesh,
                                     mesh_chips)
from repro_torch.launch.specs import (SHAPES, applicable, input_specs,
                                      spec_bytes)

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")

#: mesh name -> (sizes, axis names)
MESHES = {"card": ((1, 1, 1), ("pod", "data", "model")),
          "pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}

COLL_NOT_MODELED = "not modeled: waits on A16 step 4b"


def make_mesh(name: str):
    return abstract_mesh(*MESHES[name])


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6 N_active tokens (train) / 2 N_active tokens
    (inference), N_active without the embedding table (the lm_head's
    product is counted)."""
    n_act = cfg.active_param_count() - cfg.vocab * cfg.d_model
    if shape.kind == "train":
        return 6.0 * n_act * shape.batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.batch * shape.seq
    return 2.0 * n_act * shape.batch          # decode: one token a row


def _bytes(tree, mesh) -> int:
    """Per-device bytes of a tree of `InputSpec`s or
    `steps.AbstractArray`s (an int8 moment's two leaves both)."""
    if isinstance(tree, InputSpec):
        return spec_bytes(tree, mesh)
    if isinstance(tree, steps_lib.AbstractArray):
        return tree.shard_bytes
    if isinstance(tree, dict):
        tree = tree.values()
    return sum(_bytes(t, mesh) for t in tree)


def lower_lm_cell(cfg, shape_name: str, mesh) -> dict:
    """The per-device memory of one LM cell from its specs: arguments
    (parameters, optimizer state, inputs), outputs and the part of them
    written into arguments (the train step's parameters and moments,
    updated in place; a decode step's caches)."""
    shape = SHAPES[shape_name]
    if cfg.layout != "tp":
        chips = mesh_chips(mesh)
        if shape.kind != "train" or shape.batch % chips:
            # the fsdp layout is train-only and needs batch >= all chips
            cfg = dataclasses.replace(cfg, layout="tp")
    inputs = input_specs(cfg, shape, mesh)
    params = _bytes(steps_lib.abstract_params(cfg, mesh), mesh)
    in_bytes = _bytes(inputs, mesh)
    if shape.kind == "train":
        opt = _bytes(steps_lib.abstract_opt_state(
            cfg, mesh, steps_lib.make_opt_cfg(cfg)), mesh)
        alias = params + opt
        out = alias + 2 * 4                    # + the loss, the grad norm
        return {"argument_bytes": params + opt + in_bytes,
                "output_bytes": out, "alias_bytes": alias}
    if shape.kind == "prefill":
        bspec = inputs["tokens"].partition[0]
        cache = _bytes(input_specs(cfg, dataclasses.replace(
            shape, kind="decode"), mesh)["cache"], mesh)
        logits = spec_bytes(InputSpec((shape.batch, 1, cfg.padded_vocab),
                                      cfg.dtype, (bspec, None, "model")),
                            mesh)
        return {"argument_bytes": params + in_bytes,
                "output_bytes": logits + cache, "alias_bytes": 0}
    cache = _bytes(inputs["cache"], mesh)
    tok = spec_bytes(InputSpec((shape.batch,), torch.int64,
                               (inputs["tokens"].partition[0],)), mesh)
    return {"argument_bytes": params + in_bytes,
            "output_bytes": tok + cache, "alias_bytes": cache}


def lower_cell(arch: str, shape_name: str, mesh) -> dict:
    if arch.startswith("glm-"):
        return glm_launch.lower_glm(arch, mesh)
    return lower_lm_cell(get_config(arch), shape_name, mesh)


@functools.lru_cache(maxsize=None)
def global_count(arch: str, shape_name: str) -> dict:
    """One step of (arch, shape) counted on `meta` at its global size
    (shared by the meshes of one process)."""
    shape = SHAPES[shape_name]
    return count_step(get_config(arch), shape.kind, shape.batch, shape.seq,
                      "meta")


def _count(arch: str, shape_name: str, mesh, chips: int) -> dict:
    if arch.startswith("glm-"):
        return glm_launch.glm_analytic(glm_launch.GLM_CONFIGS[arch], mesh,
                                       streamed=True)
    cnt = per_device(global_count(arch, shape_name), chips)
    cnt["coll"] = 0.0
    cnt["coll_method"] = ("none: one device" if chips == 1
                          else COLL_NOT_MODELED)
    return cnt


def run_cell(arch: str, shape_name: str, mesh_name: str,
             out_dir: pathlib.Path, skip_existing: bool = False,
             counting: bool = True) -> dict:
    tag = f"{arch}__{shape_name}__{mesh_name}"
    path = out_dir / f"{tag}.json"
    if skip_existing and path.exists():
        rec = json.loads(path.read_text())
        print(f"[skip] {tag}: cached ({rec['status']})", flush=True)
        return rec
    mesh = make_mesh(mesh_name)
    chips = mesh_chips(mesh)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": chips}
    glm = arch.startswith("glm-")
    if not glm:
        ok, why = applicable(get_config(arch), SHAPES[shape_name])
        if not ok:
            rec.update(status="skipped", reason=why)
            path.write_text(json.dumps(rec, indent=1))
            print(f"[skip] {tag}: {why}", flush=True)
            return rec
    t0 = time.perf_counter()
    try:
        low = lower_cell(arch, shape_name, mesh)
        t_lower = time.perf_counter() - t0
        rec.update(status="ok", t_lower_s=t_lower)
        if glm:
            rec["lowered"] = low
            args, outs, alias = (low["argument_bytes"],) * 3
        else:
            args, outs, alias = (low["argument_bytes"], low["output_bytes"],
                                 low["alias_bytes"])
        mem = {"temp peak bytes": 0.0}
        if counting:
            cnt = _count(arch, shape_name, mesh, chips)
            rec["t_count_s"] = time.perf_counter() - t0 - t_lower
            if not glm:
                mem = cnt
            rl = Roofline(flops=cnt["flops"], hbm_bytes=cnt["bytes accessed"],
                          coll_bytes=cnt["coll"],
                          peak_flops=PEAK_FLOPS_F32 if glm else PEAK_FLOPS,
                          hbm_bw=HBM_BW, link_bw=LINK_BW)
            mf = (glm_launch.glm_model_flops(glm_launch.GLM_CONFIGS[arch],
                                             mesh) if glm
                  else model_flops(get_config(arch), SHAPES[shape_name])
                  / chips)
            rec["raw_roofline"] = rl.as_dict()
            rec["roofline"] = dict(rl.as_dict(), model_flops_per_dev=mf,
                                   model_over_hlo=(mf / rl.flops if rl.flops
                                                   else float("nan")))
            if "h2d bytes" in cnt:
                rec["roofline"]["t_h2d_s"] = cnt["h2d bytes"] / H2D_BW
            rec["counting"] = cnt
        rec["memory_analysis"] = memory_analysis_dict(args, outs, mem, alias)
        rec["memory_method"] = (
            "arguments and outputs exact from the specs; temp: "
            + ("not counted (the epoch is not traced)" if glm or not counting
               else "the meta trace's peak" + (
                   "" if chips == 1 else f", global / {chips} chips")))
        rl_show = rec.get("roofline")
        shown = (f"bottleneck={rl_show['bottleneck']} t=("
                 f"{rl_show['t_compute_s']:.2e},{rl_show['t_memory_s']:.2e},"
                 f"{rl_show['t_collective_s']:.2e})s" if rl_show
                 else "not counted")
        print(f"[ ok ] {tag}: specs {t_lower:.1f}s count "
              f"{rec.get('t_count_s', 0.0):.1f}s {shown}", flush=True)
    # audit: except-ok the sweep records the failure row and moves on
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:300]}",
              flush=True)
    path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id(s) or glm-* config(s), comma "
                         "separated (default: all)")
    ap.add_argument("--shape", default=None,
                    help="shape name (default: all four)")
    ap.add_argument("--mesh", default="card,pod,multipod")
    ap.add_argument("--all", action="store_true",
                    help="every architecture, shape and GLM config (the "
                         "default when no --arch is given)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-counting", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    archs = (args.arch.split(",") if args.arch and not args.all else
             list_archs() + list(glm_launch.GLM_CONFIGS))
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = args.mesh.split(",")

    results = []
    t0 = time.perf_counter()
    for arch in archs:
        cell_shapes = ["epoch"] if arch.startswith("glm-") else shapes
        for shape in cell_shapes:
            for mesh_name in meshes:
                results.append(run_cell(
                    arch, shape, mesh_name, out_dir, args.skip_existing,
                    counting=not args.no_counting))
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} failed "
          f"of {len(results)} cells in {time.perf_counter() - t0:.1f} s")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
