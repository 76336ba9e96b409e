"""LM parameter initialisation, the train step and the prefill / decode
steps, on one card or on a process mesh, and the spec transforms that
lay them over a mesh.

Mirrors the reference's `launch/steps.py`: `make_opt_cfg`, `loss_fn`
and `make_train_step` (autograd's gradient, then `optim.adamw.apply`),
`make_prefill_step`, `make_decode_step` and `step_for`.  The FSDP and
ZeRO spec transforms (`fsdp_spec`, `model_param_specs`,
`opt_state_specs`) and `abstract_params` / `abstract_opt_state` (each
leaf's global shape, dtype, partition and per-device shard shape) are
the reference's, on its stacked layout of the repeated blocks
(`lm.param_specs(stacked=True)`); the dry run reads them, and so does a
step on a process mesh (`mesh=`, a `launch.mesh.DistMesh`): each rank
holds its shards of the parameters, gradients and moments as those
specs split them (`sharding.layout.LMLayout`), and the arithmetic is the
one-card step's.  Parameters are drawn on their device from a seeded
`torch.Generator` following each `ParamSpec` (on a mesh each rank keeps
its slice of the same draw); they are not JAX's draws.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.specs import clean_pspec, shard_shape
from repro_torch.models import lm
from repro_torch.models.layers import materialize, tree_leaves, tree_map
from repro_torch.optim import adamw

# params below this size are never FSDP-sharded (norms, biases, routers)
_FSDP_MIN_SIZE = 1 << 22


def fsdp_spec(s, data_div: int, axes: tuple = ("data",)):
    """Also split the largest replicated dim over `axes`.

    Skips specs that already use any of `axes` (the experts' weights)
    and small ones (norms, routers)."""
    if math.prod(s.shape) < _FSDP_MIN_SIZE or len(s.shape) < 2:
        return s
    flat_axes = [a for e in s.pspec if e is not None
                 for a in (e if isinstance(e, tuple) else (e,))]
    if any(a in flat_axes for a in axes):
        return s
    entries = list(s.pspec) + [None] * (len(s.shape) - len(s.pspec))
    cands = [i for i, (e, dim) in enumerate(zip(entries, s.shape))
             if e is None and dim % data_div == 0 and dim >= data_div]
    if not cands:
        return s
    best = max(cands, key=lambda i: s.shape[i])     # the first of equals
    entries[best] = axes if len(axes) > 1 else axes[0]
    return dataclasses.replace(s, pspec=tuple(entries))


def _strip_model(s):
    """The fsdp layout: 'model' out of every partition (no tensor
    parallelism; the model axis is more batch)."""
    def keep(e):
        if e is None:
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a != "model")
            return kept if kept else None
        return None if e == "model" else e

    return dataclasses.replace(s, pspec=tuple(keep(e) for e in s.pspec))


def model_param_specs(cfg, mesh=None) -> dict:
    """The parameters' specs (the stacked layout) with the config's ZeRO
    policy applied.

    zero3: big parameters also split over 'data' (gathered a layer at a
           time: least memory, most collective bytes).
    zero1: parameters stay tensor-parallel only; the optimizer's moments
           alone split over 'data' (`opt_state_specs`).
    The fsdp layout drops 'model' and splits over ('data', 'model')."""
    specs = lm.param_specs(cfg, stacked=True)
    if mesh is None:
        return specs
    if cfg.layout == "fsdp":
        div = mesh.shape.get("data", 1) * mesh.shape.get("model", 1)
        return tree_map(lambda s: fsdp_spec(_strip_model(s), div,
                                            axes=("data", "model")), specs)
    if cfg.zero_stage == "zero3":
        data_div = mesh.shape.get("data", 1)
        if data_div > 1:
            specs = tree_map(lambda s: fsdp_spec(s, data_div), specs)
    return specs


def opt_state_specs(cfg, mesh) -> dict:
    """The AdamW moments' specs (ZeRO-1: also split over 'data')."""
    specs = model_param_specs(cfg, mesh)
    if cfg.zero_stage == "zero1" and cfg.layout != "fsdp":
        data_div = mesh.shape.get("data", 1) if mesh is not None else 1
        if data_div > 1:
            specs = tree_map(lambda s: fsdp_spec(s, data_div), specs)
    return specs


@dataclasses.dataclass(frozen=True)
class AbstractArray:
    """One array of a step's arguments, allocated nowhere: its global
    shape and dtype, its partition on the mesh (cleaned of the axes the
    mesh lacks) and the shape of one device's shard."""
    shape: tuple
    dtype: torch.dtype
    partition: tuple
    shard: tuple

    @property
    def shard_bytes(self) -> int:
        return math.prod(self.shard) * self.dtype.itemsize


def abstract_array(shape, dtype, partition, mesh) -> AbstractArray:
    """The record of a (shape, dtype, partition) on `mesh` (None: one
    device)."""
    shape = tuple(shape)
    if mesh is None:
        return AbstractArray(shape, dtype, tuple(partition), shape)
    part = clean_pspec(mesh, partition)
    return AbstractArray(shape, dtype, part, shard_shape(shape, part, mesh))


def abstract_params(cfg, mesh) -> dict:
    return tree_map(lambda s: abstract_array(s.shape, s.dtype, s.pspec,
                                             mesh),
                    model_param_specs(cfg, mesh))


def abstract_opt_state(cfg, mesh, opt_cfg: adamw.AdamWConfig):
    """The AdamW state with the ZeRO-1/3 policy applied; an int8 moment
    is a `QMoment` whose scale leaf (the last axis 1) keeps the
    partition of the other axes."""
    def mom(s):
        if opt_cfg.state_dtype == "int8":
            nd = len(s.shape)
            return adamw.QMoment(
                q=abstract_array(s.shape, torch.int8, s.pspec, mesh),
                scale=abstract_array(
                    tuple(s.shape[:-1]) + (1,), torch.float32,
                    tuple(list(s.pspec)[:nd - 1] + [None]), mesh))
        return abstract_array(s.shape, opt_cfg.state_dtype, s.pspec, mesh)

    m = tree_map(mom, opt_state_specs(cfg, mesh))
    return adamw.AdamWState(
        step=abstract_array((), torch.int32, (), mesh), mu=m, nu=m)


_LAYOUTS: dict = {}


def layout_for(cfg, mesh):
    """`cfg`'s `sharding.layout.LMLayout` on the process mesh `mesh`
    (one per (config, mesh))."""
    from repro_torch.sharding.layout import LMLayout
    key = (cfg, id(mesh))
    if key not in _LAYOUTS or _LAYOUTS[key].mesh is not mesh:
        _LAYOUTS[key] = LMLayout(cfg, mesh)
    return _LAYOUTS[key]


def _on(lay):
    """The layout registered for a step's body (nothing on one card)."""
    from repro_torch import sharding
    return contextlib.nullcontext() if lay is None \
        else sharding.use_layout(lay)


#: the last `init_params(mesh=)` on a card shared by its ranks: its
#: seconds and the card's most bytes in use seen right after a draw
INIT_STATS: dict = {}


def init_params(cfg, seed: int = 0, device="cuda", mesh=None) -> dict:
    """Random parameters of `cfg` on `device` (the card unless the
    caller asks for the CPU).  With `mesh` (a `DistMesh`; its device),
    this rank's shards: each leaf drawn whole in the one-card order, a
    leaf at a time, and this rank's slice kept, so the shards are
    `torch.equal` to the slices of the one-card draw.  Where the ranks
    share a card (`mesh.stages`: gloo on CUDA) they draw each leaf in
    turn, rank by rank with the layout's barrier between them, and each
    returns its cached blocks to the card after its draw: a whole leaf
    drawn in f32 is 22.5 GB for one of kimi-k2's expert leaves, more
    than the card holds four times.  A rank casts only its slice of the
    f32 draw, into a shard allocated before the draw (so that the shard
    does not pin the draw's blocks in the allocator's cache): the cast
    is elementwise, so the shard is the slice of the one-card draw.
    `INIT_STATS` then holds the card's most bytes in use, read right
    after each draw."""
    dev = resolve_device(device) if mesh is None else mesh.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if mesh is None:
        return materialize(lm.param_specs(cfg), gen, dev)
    lay = layout_for(cfg, mesh)
    if not mesh.stages:
        return tree_map(lambda s, pl: lay.local(s.initializer(gen, dev), pl),
                        lm.param_specs(cfg), lay.params)
    t0 = time.perf_counter()
    peak = 0

    def in_turn(s, pl):
        nonlocal peak
        shard = None
        for r in range(mesh.size):
            if r == mesh.rank:
                shard = torch.empty([n // mesh.group_size(a) for n, a in
                                     zip(pl.shape, pl.part)],
                                    dtype=s.dtype, device=dev)
                whole = s.draw(gen, dev)
                free, total = torch.cuda.mem_get_info(dev)
                peak = max(peak, total - free)
                part = whole
                for dim, axes in enumerate(pl.part):
                    if axes:
                        n = part.shape[dim] // mesh.group_size(axes)
                        part = part.narrow(dim, mesh.group_index(axes) * n, n)
                shard.copy_(part)
                del whole, part
                torch.cuda.empty_cache()
            lay.barrier()
        return shard

    out = tree_map(in_turn, lm.param_specs(cfg), lay.params)
    INIT_STATS.clear()
    INIT_STATS.update(seconds=time.perf_counter() - t0,
                      card_peak_bytes=peak)
    return out


def init_opt_state(cfg, params, opt_cfg: adamw.AdamWConfig, mesh=None):
    """AdamW's zero state for `params` (on a mesh, on this rank's update
    shards: ZeRO-1 splits them over 'data')."""
    if mesh is None:
        return adamw.init(params, opt_cfg)
    return adamw.init(layout_for(cfg, mesh).update_views(params), opt_cfg)


def _full_forward(params, batch, cfg, mode):
    """The modality stubs resolved: an audio config's `batch["frames"]`
    (B, enc_seq, d) through the encoder, a vision config's
    `batch["patches"]` (B, n_patches, d) ahead of the tokens."""
    enc_out = extra = None
    if cfg.frontend == "audio":
        enc_out = lm.encoder_fwd(params, batch["frames"], cfg)
    if cfg.frontend == "vision":
        extra = batch["patches"]
    return lm.forward(params, batch["tokens"], cfg, mode=mode,
                      enc_out=enc_out, extra_embeds=extra)


def make_opt_cfg(cfg) -> adamw.AdamWConfig:
    """AdamW's defaults with the config's moment dtype (`opt_dtype`)."""
    state_dtype = {"bf16": torch.bfloat16, "int8": "int8"}.get(
        cfg.opt_dtype, torch.float32)
    return adamw.AdamWConfig(state_dtype=state_dtype)


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy of `batch` ({"tokens", "labels"}
    (B, S)[, "frames" | "patches"]); a vision config's logits are cut to
    the token positions that predict a label, `logits[:, P - 1:-1]`."""
    logits, _ = _full_forward(params, batch, cfg, "train")
    if cfg.frontend == "vision" and cfg.n_patches:
        logits = logits[:, cfg.n_patches - 1:-1]
    return lm.lm_loss(logits, batch["labels"])


def _loss_and_grads(params, batch, cfg, lay):
    """(loss, the gradient of every leaf of `params`) by autograd.  On a
    mesh the loss is this rank's part (its tokens' losses over the
    global token count) and the gradients are its parts, not yet summed
    over the ranks."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(live)
    tracked = tree_map(lambda _p: next(it), params)
    with _on(lay):
        if lay is None:
            loss = loss_fn(tracked, batch, cfg)
        else:
            logits, _ = lm.forward(tracked, batch["tokens"], cfg,
                                   mode="train")
            loss = lay.loss(logits, batch["labels"])
            del logits
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    # a leaf the loss never reads gets zeros, as jax.grad gives it
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(live, grads))
    return loss.detach(), tree_map(lambda _p: next(it), params)


def make_grad_step(cfg, mesh=None):
    """(params, batch) -> (loss, grads): the mean next-token loss and its
    gradient with respect to every parameter (on a mesh, the global
    loss, the same on every rank, and the gradient of each of this
    rank's parameter shards)."""
    lay = None if mesh is None else layout_for(cfg, mesh)

    def grad_step(params, batch):
        loss, grads = _loss_and_grads(params, batch, cfg, lay)
        if lay is None:
            return loss, grads
        return lay.batch_sum(loss), lay.sync_grads(grads, zero=False)

    return grad_step


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig | None = None,
                    mesh=None):
    """(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}): the loss's gradient with respect to every parameter
    by autograd (on the card attention and RG-LRU run B5 and B6 forward
    and their backward kernels), then one AdamW step, which writes the
    parameters and moments IN PLACE and returns them (the reference's
    train loop donates both to its jitted step): a step holds one copy
    of the optimizer state.

    With `mesh` (a `DistMesh`), every argument is this rank's shards
    (`init_params(mesh=)`, `init_opt_state(mesh=)`, the batch's rows of
    `sharding.layout.LMLayout.batch_slice`): the gradients are summed
    over the ranks in rank order (reduce-scattered over 'data' under
    ZeRO-1), AdamW updates this rank's shards, and "loss" and
    "grad_norm" are the global ones, the same bits on every rank."""
    opt_cfg = opt_cfg or make_opt_cfg(cfg)
    lay = None if mesh is None else layout_for(cfg, mesh)

    def train_step(params, opt_state, batch):
        loss, grads = _loss_and_grads(params, batch, cfg, lay)
        if lay is None:
            params, opt_state, metrics = adamw.apply(params, grads,
                                                     opt_state, opt_cfg)
            metrics["loss"] = loss
            return params, opt_state, metrics
        grads = lay.sync_grads(grads)
        views = lay.update_views(params)
        _, opt_state, metrics = adamw.apply(views, grads, opt_state,
                                            opt_cfg, shards=lay)
        del grads
        lay.zero_gather(params, views)
        metrics["loss"] = lay.batch_sum(loss)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg, mesh=None):
    """(params, {"tokens": (B, S)[, "frames" | "patches"]}) ->
    (last-position logits (B, 1, V), caches).  On a mesh: this rank's
    rows, its vocab slice under tensor parallelism, and its caches
    (its kv heads)."""
    lay = None if mesh is None else layout_for(cfg, mesh)

    def prefill_step(params, batch):
        with _on(lay):
            logits, cache = _full_forward(params, batch, cfg, "prefill")
        return logits[:, -1:], cache

    return prefill_step


def step_for(cfg, kind: str):
    """The step of a shape's kind: train, prefill or decode."""
    return {"train": make_train_step, "prefill": make_prefill_step,
            "decode": make_decode_step}[kind](cfg)


def make_decode_step(cfg, mesh=None):
    """(params, {"tokens": (B, 1), "cache", "pos": int}) -> (greedy next
    token (B,), caches).  The attention caches are written in place.
    On a mesh the greedy token is taken over the vocab-parallel logits
    (`LMLayout.argmax`: `torch.argmax`'s rule over the whole vocab)."""
    lay = None if mesh is None else layout_for(cfg, mesh)

    def decode_step(params, batch):
        with _on(lay):
            logits, cache = lm.forward(params, batch["tokens"], cfg,
                                       mode="decode", cache=batch["cache"],
                                       pos=batch["pos"])
            last = logits[:, -1]
            tok = (torch.argmax(last, dim=-1) if lay is None
                   else lay.argmax(last))
        return tok, cache

    return decode_step
