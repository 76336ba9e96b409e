"""Mixture-of-Experts: sort-based capacity dispatch, on one card and
with expert parallelism on a process mesh.

Mirrors the reference's `models/moe.py`: the router's top-k in f32, a
stable argsort of the chosen experts, each pair's rank within its
expert, tokens beyond an expert's capacity dropped (they contribute
zero from the MoE branch), the kept tokens placed in an (E, C, d)
buffer, the grouped expert products (`torch.bmm`, cuBLAS, as the
reference's einsums are XLA's), and the outputs weighted back to their
tokens.  The slot assignment is integer for integer the reference's.

Nothing here accumulates into indices, so a run is bitwise repeatable on
the card: kept slots are unique, so the dispatch is a plain indexed
write (dropped pairs go to a spare row that is cut off), and each
token's k weighted outputs are gathered back to (T, k) and summed in a
fixed order, ascending expert id, the order in which the reference's
scatter-add meets them.  The reference rounds that sum through its
scatter, so in bf16 the two may differ in the last bit of a sum.

On a process mesh (`moe_apply(layout=)`, a `sharding.layout.LMLayout`)
the experts are split as the reference's specs put them, E over 'data'
and d over 'model', and stay resident: tokens move to them.  The slots
are the one-card program's: each rank's top-k ids are all-gathered over
the batch axes in rank order and `dispatch_slots` runs on the global
ids, so `slot` and `keep` are integer for integer one process's (and
capacity counts the global tokens).  Each rank sends the d-slice of its
kept pairs' rows to the experts' owners in one all-to-all over 'data'
(`sharding.collectives.all_to_all`; a chunk a destination, padded to
the largest (source, owner) count, in slot order), the owner places
them at their slots (kept slots are unique, so rows from different
ranks never meet), runs the expert products on its E / data experts
and d / model columns (the gate and up products' partials summed over
'model' in rank order), and the reverse all-to-all brings each pair's
output row back to its token's rank.  The rows are all-gathered over
'model' before the router's weighting, so `gate_w`, and through it the
router, gets its whole gradient on every model rank, and a token's k
outputs are summed in ascending expert id as on one card.  Every
integer of the plan is known to every rank from the global ids, so no
counts are exchanged.  The shared experts are an MLP, column- then
row-parallel.  On a mesh with pods each pod's owners take their own
pod's tokens (the other rows of the buffer are zero) and the experts'
gradients are summed over 'pod' with the other replicated weights'.

`record_dispatch()` collects each call's global (slot, keep), on one
card and on a mesh alike.
"""
from __future__ import annotations

import contextlib

import torch

from .layers import ParamSpec, act_fn

_LOG: list | None = None


@contextlib.contextmanager
def record_dispatch():
    """Collect, in a list that the body receives, each `moe_apply`
    call's global `slot` and `keep` (sorted order, on the CPU) as
    {"slot", "keep"}.  The copies synchronise the device."""
    global _LOG
    before, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = before


def dispatch_counts(log: list) -> dict:
    """{"kept", "dropped"} pairs over the calls of a `record_dispatch`
    log."""
    kept = sum(int(r["keep"].sum()) for r in log)
    return {"kept": kept, "dropped": sum(r["keep"].numel()
                                         for r in log) - kept}


def moe_specs(cfg) -> dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    sp = {
        "router": ParamSpec((d, E), torch.float32, pspec=(None, None)),
        "w_gate": ParamSpec((E, d, ff), pspec=("data", "model", None)),
        "w_up": ParamSpec((E, d, ff), pspec=("data", "model", None)),
        "w_down": ParamSpec((E, ff, d), pspec=("data", None, "model")),
    }
    if cfg.n_shared_experts:
        sff = cfg.moe_d_ff * cfg.n_shared_experts
        sp["shared"] = {"w_gate": ParamSpec((d, sff), pspec=(None, "model")),
                        "w_up": ParamSpec((d, sff), pspec=(None, "model")),
                        "w_down": ParamSpec((sff, d), pspec=("model", None))}
    return sp


def capacity(tokens: int, n_experts: int, top_k: int,
             factor: float = 1.25) -> int:
    c = int(tokens * top_k * factor / n_experts) + 1
    return max(8, -(-c // 8) * 8)   # round up to 8


def route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """(T, d) tokens -> (gate_w (T, k) f32, renormalised, gate_ids (T, k)):
    the top-k of the router's softmax, in f32.  A stable descending sort
    picks them, so equal probabilities keep the lower expert first, as
    `jax.lax.top_k` does."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_ids = vals[:, :k], ids[:, :k]
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    return gate_w, gate_ids


def dispatch_slots(gate_ids: torch.Tensor, n_experts: int, cap: int):
    """The reference's slot assignment.  gate_ids (T, k) -> (order, slot,
    keep, src_tok), each (T*k,) in expert-sorted order: `order` the
    stable argsort of the flat ids, `slot` = expert * C + min(rank, C-1)
    with `rank` the pair's place within its expert, `keep` = rank < C,
    `src_tok` the pair's token.  Each expert's first sorted position is
    searched in the sorted ids (the reference's cumsum(bincount) -
    bincount, without a count's atomics)."""
    flat = gate_ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_ids = flat[order]
    experts = torch.arange(n_experts, device=flat.device,
                           dtype=sorted_ids.dtype)
    starts = torch.searchsorted(sorted_ids, experts)
    rank = torch.arange(flat.numel(), device=flat.device) - starts[sorted_ids]
    keep = rank < cap
    slot = sorted_ids * cap + torch.clamp_max(rank, cap - 1)
    return order, slot, keep, order // gate_ids.shape[1]


def _record(slot, keep) -> None:
    if _LOG is not None:
        _LOG.append({"slot": slot.cpu(), "keep": keep.cpu()})


def moe_apply(p: dict, x: torch.Tensor, cfg, *, act: str = "silu",
              layout=None) -> torch.Tensor:
    """x: (..., d) -> (..., d).  Flattens leading dims to tokens.  With
    `layout` (an `LMLayout`), `p` and `x` are this rank's shards and
    rows (x whole along d) and the experts run expert-parallel."""
    if layout is not None:
        return _moe_mesh(p, x, cfg, layout, act)
    orig_shape = x.shape
    d, E, k = cfg.d_model, cfg.n_experts, cfg.top_k
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    C = capacity(T, E, k, cfg.moe_capacity)

    gate_w, gate_ids = route(xt, p["router"], k)
    order, slot, keep, src_tok = dispatch_slots(gate_ids, E, C)
    _record(slot, keep)

    # kept slots are unique: write them; dropped pairs land in row E*C
    buf = xt.new_zeros((E * C + 1, d))
    buf[torch.where(keep, slot, E * C)] = xt[src_tok]
    buf = buf[:E * C].view(E, C, d)

    a = act_fn(act)
    h = a(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"]).reshape(E * C, d)

    # each token's k pairs, by sorted position: ascending expert id
    inv = torch.argsort(order)
    pos = torch.sort(inv.view(T, k), dim=1).values
    w_sorted = gate_w.reshape(-1)[order]
    contrib = out_buf[slot[pos]] * (w_sorted[pos] * keep[pos])[..., None].to(
        out_buf.dtype)                                       # (T, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]

    if cfg.n_shared_experts:
        sp = p["shared"]
        out = out + (a(xt @ sp["w_gate"]) * (xt @ sp["w_up"])) @ sp["w_down"]
    return out.reshape(orig_shape).to(x.dtype)


def _moe_mesh(p: dict, x: torch.Tensor, cfg, lay, act: str) -> torch.Tensor:
    """`moe_apply` on a process mesh (see the module's docstring)."""
    from repro_torch.sharding import collectives as coll
    mesh = lay.mesh
    orig_shape = x.shape
    d, E, k = cfg.d_model, cfg.n_experts, cfg.top_k
    xt = x.reshape(-1, d)
    Tl = xt.shape[0]
    nb = lay.batch_div
    C = capacity(Tl * nb, E, k, cfg.moe_capacity)
    D = mesh.group_size(lay.ep_axes)         # owners; El experts each
    El = E // D
    me = mesh.group_index(lay.batch_axes) if lay.batch_axes else 0
    own = me % D                             # my data index: my experts
    dev = xt.device

    gate_w, gate_ids = route(xt, p["router"], k)
    ids = coll.all_gather(gate_ids.contiguous(), mesh, lay.batch_axes, 0,
                          "moe_ids")
    order, slot, keep, _ = dispatch_slots(ids, E, C)
    _record(slot, keep)

    # the plan, the same on every rank: each kept pair (slot order), its
    # token's batch rank `src`, its expert's owner `dst` and its place
    # `pos` in the (src, dst) chunk, the chunks padded to M rows
    pair, kslot = order[keep], slot[keep]
    src, dst = pair // (Tl * k), kslot // (El * C)
    key = src * D + dst
    perm = torch.argsort(key, stable=True)
    skey = key[perm]
    starts = torch.searchsorted(skey, torch.arange(nb * D, device=dev))
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(perm.numel(), device=dev) - starts[skey]
    ends = torch.cat([starts[1:], starts.new_tensor([perm.numel()])])
    M = int((ends - starts).max())
    mine = src == me
    inbox = (dst == own) & (src // D == me // D)
    at_src = dst[mine] * M + pos[mine]       # my pairs in what I send
    at_dst = (src[inbox] % D) * M + pos[inbox]   # ... and what I get
    local = pair[mine] - me * Tl * k         # my pairs, t * k + j
    lslot = kslot[inbox] - own * El * C      # my experts' slots filled

    def spread(n, at, val, fill):
        out = torch.full((n,), fill, dtype=torch.long, device=dev)
        out[at] = val
        return out

    def rows(t, idx):                        # t[idx], idx == len(t): 0
        return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])[idx]

    # dispatch: my tokens' d-slices, a row a pair (no row is read twice,
    # so the backward adds nothing into an index)
    xm = coll.slice_act(xt, mesh, lay.tp_axes, -1, "moe_slice")
    dm = xm.shape[-1]
    xk = xm[:, None, :].expand(Tl, k, dm).reshape(Tl * k, dm)
    send = rows(xk, spread(D * M, at_src, local, Tl * k))
    recv = coll.all_to_all(send, mesh, lay.ep_axes, "moe_dispatch")
    buf = rows(recv, spread(El * C, lslot, at_dst, D * M)).view(El, C, dm)

    a = act_fn(act)
    ff = p["w_gate"].shape[-1]
    gu = lay.row_out(torch.cat([torch.bmm(buf, p["w_gate"]),
                                torch.bmm(buf, p["w_up"])], dim=-1),
                     "moe_expert_sum")
    h = lay.col_in(a(gu[..., :ff]) * gu[..., ff:], "moe_expert_sum")
    out_buf = torch.bmm(h, p["w_down"]).reshape(El * C, dm)

    # combine: each pair's row back to its token's rank, whole along d
    back = rows(out_buf, spread(D * M, at_dst, lslot, El * C))
    got = coll.all_to_all(back, mesh, lay.ep_axes, "moe_combine")
    got = coll.gather_act(got, mesh, lay.tp_axes, -1, "moe_gather")
    # a dropped pair reads the zero row: it adds nothing, as on one card
    row_of = spread(Tl * k, local, at_src, D * M).view(Tl, k)
    up = torch.argsort(gate_ids, dim=1, stable=True)   # ascending expert
    contrib = rows(got, torch.gather(row_of, 1, up)) * torch.gather(
        gate_w, 1, up)[..., None].to(got.dtype)        # (Tl, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]

    if cfg.n_shared_experts:
        sp = p["shared"]
        xs = lay.col_in(xt)
        out = out + lay.row_out(
            (a(xs @ sp["w_gate"]) * (xs @ sp["w_up"])) @ sp["w_down"])
    return out.reshape(orig_shape).to(x.dtype)
