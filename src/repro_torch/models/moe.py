"""Mixture-of-Experts: sort-based capacity dispatch on one card.

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
"""
from __future__ import annotations

import torch

from .layers import ParamSpec, act_fn


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


def moe_apply(p: dict, x: torch.Tensor, cfg, *,
              act: str = "silu") -> torch.Tensor:
    """x: (..., d) -> (..., d).  Flattens leading dims to tokens."""
    orig_shape = x.shape
    d, E, k = cfg.d_model, cfg.n_experts, cfg.top_k
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    C = capacity(T, E, k, cfg.moe_capacity)

    gate_w, gate_ids = route(xt, p["router"], k)
    order, slot, keep, src_tok = dispatch_slots(gate_ids, E, C)

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
