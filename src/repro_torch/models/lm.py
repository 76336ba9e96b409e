"""LM assembly for the decoder-only block kinds: prefill and decode.

Mirrors the reference's `models/lm.py` for `attn` (GQA, local or MLA
attention + MLP), `moe` (the same attention + a mixture of experts) and
`rec` (RG-LRU + MLP) blocks.  The reference stacks the repeated
superblocks and drives them with `lax.scan`; here `params["blocks"]`
(and `cache["blocks"]`) is a list with one entry per superblock, walked
by a Python loop.  MoE configs lead with `first_dense_layers` unrolled
`attn` blocks (`params["head_blocks"]`).  The xLSTM blocks, the
encoder-decoder, the modality frontends, learned positions and
layernorm raise `NotImplementedError` (ROADMAP A16).

Modes (the reference's `train` mode waits with the train step):
  prefill — full-sequence forward that also fills the KV/state caches
  decode  — one token against the caches (written in place for
            attention: see `attention.gqa_decode`, `attention.mla_decode`)
"""
from __future__ import annotations

from typing import Any

import torch

from . import attention as attn
from . import moe as moe_lib
from . import recurrent as rec
from .layers import ParamSpec, apply_rope, mlp_apply, mlp_specs, rmsnorm

_TODO = "is not ported to repro_torch yet (ROADMAP A16)"


def _check_supported(cfg) -> None:
    for what, bad in (("the encoder-decoder stack", cfg.is_encoder_decoder),
                      (f"the {cfg.frontend} frontend", cfg.frontend),
                      ("learned positions", cfg.learned_pos),
                      (f"{cfg.norm}", cfg.norm != "rmsnorm")):
        if bad:
            raise NotImplementedError(f"{cfg.name}: {what} {_TODO}")


def layer_layout(cfg) -> tuple[list[str], list[str], int, list[str]]:
    """-> (head_kinds, pattern, n_rep, tail_kinds)."""
    _check_supported(cfg)
    if cfg.block_pattern:
        pat = list(cfg.block_pattern)
        n_rep, rem = divmod(cfg.n_layers, len(pat))
        return [], pat, n_rep, pat[:rem]
    if cfg.n_experts:
        fd = cfg.first_dense_layers
        return ["attn"] * fd, ["moe"], cfg.n_layers - fd, []
    return [], ["attn"], cfg.n_layers, []


def _norm_specs(cfg) -> dict:
    return {"g": ParamSpec((cfg.d_model,), torch.float32, "ones")}


def block_specs(cfg, kind: str) -> dict:
    sp: dict[str, Any] = {"ln1": _norm_specs(cfg)}
    if kind in ("attn", "moe"):
        sp["attn"] = (attn.mla_specs(cfg) if cfg.attention == "mla"
                      else attn.gqa_specs(cfg))
    elif kind == "rec":
        sp["rec"] = rec.rglru_block_specs(cfg)
    else:
        raise NotImplementedError(f"block kind {kind!r} {_TODO}")
    sp["ln2"] = _norm_specs(cfg)
    if kind == "moe":
        sp["moe"] = moe_lib.moe_specs(cfg)
    else:
        sp["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp)
    return sp


def block_cache_shape(cfg, kind: str, batch: int, max_seq: int) -> dict:
    if kind in ("attn", "moe"):
        if cfg.attention == "mla":
            return attn.mla_cache_shape(cfg, batch, max_seq)
        if cfg.attention == "local":
            # ring buffer: local attention only ever sees the last
            # `window` keys, so the cache is O(window), not O(seq)
            return attn.gqa_cache_shape(cfg, batch, min(cfg.window, max_seq))
        return attn.gqa_cache_shape(cfg, batch, max_seq)
    if kind == "rec":
        return rec.rglru_cache_shape(cfg, batch)
    raise NotImplementedError(f"block kind {kind!r} {_TODO}")


def apply_block(p: dict, x, cfg, kind: str, *, positions=None,
                mode: str = "prefill", cache=None, pos=None):
    """Returns (x_new, new_cache)."""
    h = rmsnorm(x, p["ln1"]["g"])
    if kind in ("attn", "moe"):
        akind = "local" if cfg.attention == "local" else "causal"
        mla = cfg.attention == "mla"
        if mode == "decode" and mla:
            a, new_cache = attn.mla_decode(p["attn"], h, cache, cfg, pos=pos)
        elif mode == "decode":
            a, new_cache = attn.gqa_decode(p["attn"], h, cache, cfg, pos=pos,
                                           kind=akind, use_rope=cfg.use_rope)
        else:
            a = (attn.mla_fwd(p["attn"], h, cfg, positions=positions) if mla
                 else attn.gqa_fwd(p["attn"], h, cfg, positions=positions,
                                   kind=akind, use_rope=cfg.use_rope))
            new_cache = _prefill_cache(p["attn"], h, cfg, positions)
    elif kind == "rec":
        if mode == "decode":
            a, new_cache = rec.rglru_block_decode(p["rec"], h, cache, cfg)
        else:
            a, new_cache = rec.rglru_block_fwd(p["rec"], h, cfg)
    else:
        raise NotImplementedError(f"block kind {kind!r} {_TODO}")
    x = x + a
    h2 = rmsnorm(x, p["ln2"]["g"])
    if kind == "moe":
        return x + moe_lib.moe_apply(p["moe"], h2, cfg, act=cfg.act), new_cache
    return x + mlp_apply(p["mlp"], h2, cfg.act), new_cache


def _prefill_cache(p, h, cfg, positions) -> dict:
    """Recompute K/V, or MLA's latent and rotary key (cheap projections),
    to fill the decode cache."""
    B, S, _ = h.shape
    if cfg.attention == "mla":
        c_kv, k_rope = attn._mla_latent(p, h, cfg, positions)
        return {"c_kv": c_kv.to(torch.bfloat16),
                "k_rope": k_rope[:, :, 0, :].to(torch.bfloat16)}
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim
    k = (h @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (h @ p["wv"]).reshape(B, S, Hkv, hd)
    if cfg.use_rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.attention == "local" and S > cfg.window:
        # ring cache: keep the last `window` keys, laid out at slot
        # (abs_pos % window) so decode's pos % W writes line up
        W = cfg.window
        k, v = k[:, -W:], v[:, -W:]
        slots = torch.arange(S - W, S, device=h.device) % W
        inv = torch.argsort(slots)
        k, v = k[:, inv], v[:, inv]
    return {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}


def param_specs(cfg) -> dict:
    head, pat, n_rep, tail = layer_layout(cfg)
    return {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model), scale=0.02),
        "final_norm": _norm_specs(cfg),
        "lm_head": ParamSpec((cfg.d_model, cfg.padded_vocab), scale=0.02),
        "head_blocks": [block_specs(cfg, k) for k in head],
        "blocks": [{str(i): block_specs(cfg, k) for i, k in enumerate(pat)}
                   for _ in range(n_rep)],
        "tail_blocks": [block_specs(cfg, k) for k in tail],
    }


def cache_shapes(cfg, batch: int, max_seq: int) -> dict:
    head, pat, n_rep, tail = layer_layout(cfg)
    return {
        "head": [block_cache_shape(cfg, k, batch, max_seq) for k in head],
        "blocks": [{str(i): block_cache_shape(cfg, k, batch, max_seq)
                    for i, k in enumerate(pat)} for _ in range(n_rep)],
        "tail": [block_cache_shape(cfg, k, batch, max_seq) for k in tail],
    }


def _embed(params, tokens, cfg):
    return params["embed"][tokens].to(cfg.dtype)


def forward(params, tokens, cfg, *, mode: str = "prefill", cache=None,
            pos=None):
    """tokens: (B, S) integer (S = 1 for decode, at position `pos`, a
    Python int).  Returns (logits (B, S, padded_vocab), caches).  The
    reference's activation sharding constraints are no-ops without a
    mesh; on one card there is none, so they are left out."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    head, pat, n_rep, tail = layer_layout(cfg)
    x = _embed(params, tokens, cfg)
    S = x.shape[1]
    positions = (torch.arange(S, device=x.device) if mode == "prefill"
                 else None)
    kw = dict(positions=positions, mode=mode, pos=pos)

    def run(kinds, blocks, caches):
        nonlocal x
        out = []
        for i, (kind, bp) in enumerate(zip(kinds, blocks)):
            x, c = apply_block(bp, x, cfg, kind,
                               cache=caches[i] if caches else None, **kw)
            out.append(c)
        return out

    new_head = run(head, params["head_blocks"],
                   cache["head"] if cache is not None else None)
    new_blocks = []
    for r in range(n_rep):
        names = [str(i) for i in range(len(pat))]
        c_in = ([cache["blocks"][r][n] for n in names]
                if cache is not None else None)
        c_out = run(pat, [params["blocks"][r][n] for n in names], c_in)
        new_blocks.append(dict(zip(names, c_out)))
    new_tail = run(tail, params["tail_blocks"],
                   cache["tail"] if cache is not None else None)

    x = rmsnorm(x, params["final_norm"]["g"])
    logits = x @ params["lm_head"].to(cfg.dtype)
    return logits, {"head": new_head, "blocks": new_blocks, "tail": new_tail}

