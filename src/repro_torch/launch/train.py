"""End-to-end LM training on one device or on a process mesh: the
reference's `launch/train.py` (`device=` picks the card or the CPU;
`mesh=` a `launch.mesh.DistMesh`, each process one rank, as
`tools/lm_mesh_rank.py` runs it).

    python -m repro_torch.launch.train --arch smollm-360m --steps 20 \\
        --batch 4 --seq 2048 --device cuda
    python -m repro_torch.launch.train --arch smollm-360m --smoke \\
        --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 20 --device cpu

  * registry configs (--arch; --smoke for the reduced config)
  * the seeded Markov-chain token stream (`data.loader.markov_batch`;
    learnable structure, so the loss decreases), seeded frames or
    patches for the audio and vision stubs
  * checkpoint/restart: auto-resume from the latest step in --ckpt-dir
    (params and the AdamW state, int8 moments included), bitwise by step
    because the data stream is indexed by step and the step is
    deterministic (on the card too: see `models.lm._embed` and the
    backward kernels)

  * on a mesh: each rank draws the one-card batch and keeps its rows;
    a checkpoint is the one-card format, its shards gathered and saved
    by rank 0, and a restore slices it by the specs of the mesh (or the
    card) that loads it

The parameters are the port's seeded draws, not the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.data.loader import markov_batch
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.optim import adamw


def batch_at(cfg, batch: int, seq: int, step: int, seed: int = 0,
             device="cuda") -> dict:
    """The batch of `step` (a restartable stream) on `device`: the
    reference's integers and f32 draws, from the same seeds."""
    dev = resolve_device(device)
    b = markov_batch(cfg.vocab, batch, seq, table_seed=seed, step=step)
    out = {"tokens": torch.from_numpy(b["tokens"]).to(dev),
           "labels": torch.from_numpy(b["labels"]).to(dev)}
    if cfg.frontend == "audio":
        rng = np.random.default_rng(seed + step)
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model), np.float32)).to(dev)
    if cfg.frontend == "vision":
        rng = np.random.default_rng(seed + step)
        out["patches"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model), np.float32)).to(dev)
    return out


def train(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
          ckpt_dir: str | None = None, ckpt_every: int = 0, seed: int = 0,
          verbose: bool = True, device="cuda", history: list | None = None,
          mesh=None):
    """Train `steps` steps from the latest checkpoint in `ckpt_dir` (or
    from the seeded initialisation); save every `ckpt_every` steps.
    Returns (params, opt_state, losses of the steps run here).  Each
    step's {"step", "loss", "grad_norm", "seconds"} (host clock, ending
    in the loss's read) is appended to `history` when given.

    With `mesh` (a `DistMesh`, on its device) every rank calls this:
    it returns this rank's shards, and the global losses (the same on
    every rank).  `batch` is the global batch."""
    dev = resolve_device(device) if mesh is None else mesh.device
    opt_cfg = dataclasses.replace(steps_lib.make_opt_cfg(cfg), lr=lr)
    if mesh is None:
        params = steps_lib.init_params(cfg, seed, dev)
        opt_state = adamw.init(params, opt_cfg)
        lay = None
    else:
        params = steps_lib.init_params(cfg, seed, dev, mesh=mesh)
        opt_state = steps_lib.init_opt_state(cfg, params, opt_cfg, mesh)
        lay = steps_lib.layout_for(cfg, mesh)
    step_fn = steps_lib.make_train_step(cfg, opt_cfg, mesh=mesh)

    start = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        if mgr.latest_step() is not None:
            if lay is None:
                (params, opt_state), meta = mgr.restore((params, opt_state),
                                                        device=dev)
            else:
                whole, meta = mgr.restore(
                    lay.state_targets(params, opt_state), device="cpu")
                params, opt_state = lay.state_local(*whole, dev)
                del whole
            start = int(meta["step"])
            if verbose:
                print(f"resumed from step {start}")

    losses = []
    t0 = time.perf_counter()
    for s in range(start, steps):
        ts = time.perf_counter()
        b = batch_at(cfg, batch, seq, s, seed, dev)
        if lay is not None:
            b = {k: lay.batch_slice(v) for k, v in b.items()}
        params, opt_state, metrics = step_fn(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        if history is not None:
            history.append({"step": s, "loss": losses[-1],
                            "grad_norm": float(metrics["grad_norm"]),
                            "seconds": time.perf_counter() - ts})
        if verbose and (s % max(1, steps // 10) == 0 or s == steps - 1):
            print(f"step {s:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({time.perf_counter() - t0:.1f}s)")
        if mgr and ckpt_every and (s + 1) % ckpt_every == 0:
            if lay is None:
                mgr.save(s + 1, (params, opt_state), meta={"step": s + 1})
            else:                       # the one-card format, by rank 0
                whole = lay.state_full(params, opt_state)
                if mesh.rank == 0:
                    mgr.save(s + 1, whole, meta={"step": s + 1})
                del whole
    if mgr:
        mgr.wait()
        if lay is not None:             # every rank sees the files
            lay.barrier()
    return params, opt_state, losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    _, _, losses = train(cfg, steps=args.steps, batch=args.batch,
                         seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, seed=args.seed,
                         device=args.device)
    k = max(len(losses) // 5, 1)
    print(f"first-{k} mean loss {np.mean(losses[:k]):.4f} -> "
          f"last-{k} mean loss {np.mean(losses[-k:]):.4f}")


if __name__ == "__main__":
    main()
