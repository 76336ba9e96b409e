"""LM assembly: prefill and decode for every block kind.

Mirrors the reference's `models/lm.py`: `attn` (GQA, local or MLA
attention + MLP), `moe` (the same attention + a mixture of experts),
`rec` (RG-LRU + MLP), the xLSTM blocks `mlstm` and `slstm` (no MLP),
and the encoder-decoder's `enc_attn` (full self-attention + MLP) and
`xattn` (causal self-attention, cross-attention over the encoder's
output, MLP).  The reference stacks the repeated superblocks and drives
them with `lax.scan`; here `params["blocks"]` (and `cache["blocks"]`)
is a list with one entry per superblock, walked by a Python loop.  MoE
configs lead with `first_dense_layers` unrolled `attn` blocks
(`params["head_blocks"]`); the encoder's blocks are `params
["enc_blocks"]`, run by `encoder_fwd`.  Norms are RMSNorm or LayerNorm
(`cfg.norm`), positions RoPE or learned (`cfg.learned_pos`); a vision
config's patch embeddings go ahead of the tokens (`extra_embeds`).

Modes:
  train   — full-sequence forward for the train step: prefill's
            arithmetic with no cache built or returned; with `cfg.remat`
            each repeated superblock runs under
            `torch.utils.checkpoint.checkpoint` (its activations are
            recomputed in the backward), as the reference wraps its
            `superblock` in `jax.checkpoint`; head, tail and encoder
            blocks are not rematerialised there either
  prefill — full-sequence forward that also fills the KV/state caches
  decode  — one token against the caches (written in place for
            attention: see `attention.gqa_decode`, `attention.mla_decode`)

`lm_loss` is the reference's cross-entropy: f32, logsumexp over the
padded vocab, an optional mask.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from . import attention as attn
from . import moe as moe_lib
from . import recurrent as rec
from .layers import (CacheSpec, ParamSpec, apply_rope, layernorm, mlp_apply,
                     mlp_specs, rmsnorm, tree_map)


def layer_layout(cfg) -> tuple[list[str], list[str], int, list[str]]:
    """-> (head_kinds, pattern, n_rep, tail_kinds)."""
    if cfg.is_encoder_decoder:
        return [], ["xattn"], cfg.n_layers, []
    if cfg.block_pattern:
        pat = list(cfg.block_pattern)
        n_rep, rem = divmod(cfg.n_layers, len(pat))
        return [], pat, n_rep, pat[:rem]
    if cfg.n_experts:
        fd = cfg.first_dense_layers
        return ["attn"] * fd, ["moe"], cfg.n_layers - fd, []
    return [], ["attn"], cfg.n_layers, []


def _norm_specs(cfg) -> dict:
    g = ParamSpec((cfg.d_model,), torch.float32, "ones", pspec=(None,))
    if cfg.norm == "layernorm":
        return {"g": g, "b": ParamSpec((cfg.d_model,), torch.float32,
                                       "zeros", pspec=(None,))}
    return {"g": g}


def _norm(p: dict, x):
    if "b" in p:
        return layernorm(x, p["g"], p["b"])
    return rmsnorm(x, p["g"])


_ATTN_KINDS = ("attn", "moe", "enc_attn", "xattn")


def block_specs(cfg, kind: str) -> dict:
    sp: dict[str, Any] = {"ln1": _norm_specs(cfg)}
    if kind in ("mlstm", "slstm"):       # the block's projections are its FFN
        sp["core"] = (rec.mlstm_specs(cfg) if kind == "mlstm"
                      else rec.slstm_specs(cfg))
        return sp
    if kind in _ATTN_KINDS:
        sp["attn"] = (attn.mla_specs(cfg) if cfg.attention == "mla"
                      else attn.gqa_specs(cfg))
        if kind == "xattn":
            sp["ln_x"] = _norm_specs(cfg)
            sp["xattn"] = attn.gqa_specs(cfg)
    elif kind == "rec":
        sp["rec"] = rec.rglru_block_specs(cfg)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
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
    if kind == "xattn":
        enc = attn.gqa_cache_shape(cfg, batch, cfg.enc_seq)
        return {"self": attn.gqa_cache_shape(cfg, batch, max_seq),
                "cross_k": enc["k"], "cross_v": enc["v"]}
    if kind == "rec":
        return rec.rglru_cache_shape(cfg, batch)
    if kind == "mlstm":
        return rec.mlstm_cache_shape(cfg, batch)
    if kind == "slstm":
        return rec.slstm_cache_shape(cfg, batch)
    raise ValueError(f"unknown block kind {kind!r}")


def _attn_kind(cfg, kind: str) -> str:
    if kind == "enc_attn":
        return "full"
    return "local" if cfg.attention == "local" else "causal"


def apply_block(p: dict, x, cfg, kind: str, *, positions=None,
                mode: str = "prefill", cache=None, pos=None, enc_out=None):
    """Returns (x_new, new_cache); an encoder block (`enc_attn`) keeps no
    cache and returns None, and in train mode no attention block builds
    one (the recurrent blocks' final states come from their one scan and
    are dropped by the caller)."""
    h = _norm(p["ln1"], x)
    if kind in ("mlstm", "slstm"):
        if mode == "decode":
            step = rec.mlstm_decode if kind == "mlstm" else rec.slstm_decode
            r, new_cache = step(p["core"], h, cache, cfg)
        else:
            fwd = rec.mlstm_fwd if kind == "mlstm" else rec.slstm_fwd
            r, new_cache = fwd(p["core"], h, cfg)
        return x + r, new_cache
    lay = sharding.get_layout()
    if kind in _ATTN_KINDS:
        akind = _attn_kind(cfg, kind)
        mla = cfg.attention == "mla"
        self_cache = cache["self"] if kind == "xattn" and cache else cache
        pa, acfg, seam = p["attn"], cfg, None
        if lay is not None:             # this rank's heads
            pa, acfg = lay.attn_params(pa)
            if mla:                     # after MLA's replicated latent
                seam = lay.col_in
            else:
                h = lay.col_in(h)
        if mode == "decode" and mla:
            a, new_cache = attn.mla_decode(pa, h, self_cache, acfg, pos=pos,
                                           seam=seam)
        elif mode == "decode":
            a, new_cache = attn.gqa_decode(pa, h, self_cache, acfg,
                                           pos=pos, kind=akind,
                                           use_rope=cfg.use_rope)
        else:
            a = (attn.mla_fwd(pa, h, acfg, positions=positions, seam=seam)
                 if mla
                 else attn.gqa_fwd(pa, h, acfg, positions=positions,
                                   kind=akind, use_rope=cfg.use_rope))
            new_cache = (None if kind == "enc_attn" or mode == "train"
                         else _prefill_cache(pa, h, acfg, positions))
        x = x + (a if lay is None else lay.row_out(a))
        if kind == "xattn":
            a, cross = _cross_attention(p, _norm(p["ln_x"], x), cfg,
                                        positions=positions, mode=mode,
                                        cache=cache, enc_out=enc_out)
            x = x + a
            new_cache = {"self": new_cache, **cross}
    elif kind == "rec":
        if mode == "decode":
            a, new_cache = rec.rglru_block_decode(p["rec"], h, cache, cfg)
        else:
            a, new_cache = rec.rglru_block_fwd(p["rec"], h, cfg)
        x = x + a
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    h2 = _norm(p["ln2"], x)
    if kind == "moe":
        return x + moe_lib.moe_apply(p["moe"], h2, cfg, act=cfg.act,
                                     layout=lay), new_cache
    if lay is not None:                 # column- then row-parallel
        return x + lay.row_out(mlp_apply(p["mlp"], lay.col_in(h2),
                                         cfg.act)), new_cache
    return x + mlp_apply(p["mlp"], h2, cfg.act), new_cache


def _cross_attention(p: dict, hx, cfg, *, positions, mode: str, cache,
                     enc_out):
    """The `xattn` block's attention over the encoder's output: hx the
    normed residual (B, S, d).  Prefill runs B5 (full, Sq != Sk) and
    caches the encoder's K/V in bf16; decode attends over them in f32
    with no kernel, as the reference writes it inline.  Returns (out,
    {"cross_k", "cross_v"})."""
    px = p["xattn"]
    B = hx.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if mode == "decode":
        ck, cv = cache["cross_k"], cache["cross_v"]
        qg = (hx @ px["wq"]).reshape(B, Hkv, H // Hkv, hd).float()
        s = torch.einsum("bkgh,bskh->bkgs", qg, ck.float()) * (hd ** -0.5)
        o = torch.einsum("bkgs,bskh->bkgh", torch.softmax(s, dim=-1),
                         cv.float())
        a = o.reshape(B, 1, H * hd).to(hx.dtype) @ px["wo"]
        return a, {"cross_k": ck, "cross_v": cv}
    a = attn.gqa_fwd(px, hx, cfg, positions=positions, kind="full",
                     kv_x=enc_out, use_rope=False)
    if mode == "train":
        return a, {}
    Se = enc_out.shape[1]
    ck = (enc_out @ px["wk"]).reshape(B, Se, Hkv, hd).to(torch.bfloat16)
    cv = (enc_out @ px["wv"]).reshape(B, Se, Hkv, hd).to(torch.bfloat16)
    return a, {"cross_k": ck, "cross_v": cv}


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


def _stack(tree, n_rep: int):
    """The reference's stacked view of a repeated block's specs: each
    leaf with a leading n_rep axis, replicated along it."""
    def one(s):
        if isinstance(s, ParamSpec):
            return dataclasses.replace(s, shape=(n_rep,) + tuple(s.shape),
                                       pspec=(None,) + tuple(s.pspec))
        return CacheSpec((n_rep,) + tuple(s.shape), s.dtype)
    return tree_map(one, tree)


def param_specs(cfg, *, stacked: bool = False) -> dict:
    """The parameters' specs.  The port's tree keeps a dict a superblock
    under "blocks" (a list of n_rep); ``stacked=True`` gives the
    reference's layout instead, one dict of leaves with a leading n_rep
    axis (absent without repeats), which the dry run's spec transforms
    partition as the reference's mesh program holds them."""
    head, pat, n_rep, tail = layer_layout(cfg)
    sp: dict[str, Any] = {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model), scale=0.02,
                           pspec=(None, "model")),
        "final_norm": _norm_specs(cfg),
        "lm_head": ParamSpec((cfg.d_model, cfg.padded_vocab), scale=0.02,
                             pspec=(None, "model")),
    }
    if cfg.learned_pos:
        sp["pos_embed"] = ParamSpec((cfg.max_seq, cfg.d_model), scale=0.02,
                                    pspec=(None, None))
    sp["head_blocks"] = [block_specs(cfg, k) for k in head]
    if stacked:
        if n_rep:
            sp["blocks"] = _stack({str(i): block_specs(cfg, k)
                                   for i, k in enumerate(pat)}, n_rep)
    else:
        sp["blocks"] = [{str(i): block_specs(cfg, k)
                         for i, k in enumerate(pat)} for _ in range(n_rep)]
    sp["tail_blocks"] = [block_specs(cfg, k) for k in tail]
    if cfg.is_encoder_decoder:
        sp["enc_blocks"] = [block_specs(cfg, "enc_attn")
                            for _ in range(cfg.n_enc_layers)]
        sp["enc_norm"] = _norm_specs(cfg)
        if cfg.learned_pos:
            sp["enc_pos"] = ParamSpec((cfg.enc_seq, cfg.d_model),
                                      scale=0.02, pspec=(None, None))
    return sp


def cache_shapes(cfg, batch: int, max_seq: int, *,
                 stacked: bool = False) -> dict:
    """The decode caches' specs; ``stacked=True``: "blocks" in the
    reference's stacked layout (as `param_specs`; {} without repeats)."""
    head, pat, n_rep, tail = layer_layout(cfg)
    per = {str(i): block_cache_shape(cfg, k, batch, max_seq)
           for i, k in enumerate(pat)}
    return {
        "head": [block_cache_shape(cfg, k, batch, max_seq) for k in head],
        "blocks": ((_stack(per, n_rep) if n_rep else {}) if stacked else
                   [{str(i): block_cache_shape(cfg, k, batch, max_seq)
                     for i, k in enumerate(pat)} for _ in range(n_rep)]),
        "tail": [block_cache_shape(cfg, k, batch, max_seq) for k in tail],
    }


def _embed(params, tokens, cfg, *, pos_offset: int = 0):
    # F.embedding, the same gather as indexing: its backward on the card
    # sorts the tokens and sums each row's gradients in a fixed order, so
    # a train step is deterministic without the deterministic-algorithms
    # mode (indexing's backward is an accumulating index_put_)
    lay = sharding.get_layout()
    table = params["embed"]
    if lay is not None:
        table = lay.gather(table, lay.params["embed"])
    x = F.embedding(tokens, table)
    if lay is not None and lay.tp > 1:  # the table's d-slices, gathered
        x = sharding.constrain(x, cfg.batch_axes, None, None,
                               held=(cfg.batch_axes, None, "model"))
    if cfg.learned_pos:
        S = tokens.shape[1]
        if pos_offset + S > cfg.max_seq:
            # the reference's dynamic slice would clamp the offset and
            # give these tokens other positions' embeddings
            raise ValueError(f"{cfg.name}: positions up to "
                             f"{pos_offset + S} exceed the {cfg.max_seq} "
                             f"learned positions")
        pe = params["pos_embed"]
        if lay is not None:
            pe = lay.gather(pe, lay.params["pos_embed"])
        pe = pe[pos_offset:pos_offset + S].to(x.dtype)
        x = x + pe[None]
    return x.to(cfg.dtype)


def encoder_fwd(params, frames, cfg):
    """frames: (B, enc_seq, d), the audio frontend's stub embeddings.
    Returns the encoder's normed output (B, enc_seq, d) in cfg.dtype."""
    x = frames.to(cfg.dtype)
    if cfg.learned_pos:
        x = x + params["enc_pos"][None, :x.shape[1]].to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for bp in params["enc_blocks"]:
        x, _ = apply_block(bp, x, cfg, "enc_attn", positions=positions)
    return _norm(params["enc_norm"], x)


def _shard_act(x, cfg):
    """The reference's layer-boundary constraint: the batch over
    `cfg.batch_axes`, and under `shard_resid` (the "tp" layout) d over
    'model' too, so the remat'd boundary activation is held sliced.
    `x` itself on one card."""
    axes = cfg.batch_axes
    if cfg.shard_resid and cfg.layout != "fsdp":
        return sharding.constrain(x, axes, *([None] * (x.ndim - 2)), "model")
    return sharding.constrain(x, axes, *([None] * (x.ndim - 1)))


def _whole_act(x, cfg):
    """A block's input whole again: under `shard_resid`, the sliced
    boundary activation all-gathered over 'model' (`x` itself on one
    card)."""
    if cfg.shard_resid and cfg.layout != "fsdp":
        axes = cfg.batch_axes
        return sharding.constrain(
            x, axes, *([None] * (x.ndim - 1)),
            held=(axes,) + (None,) * (x.ndim - 2) + ("model",))
    return x


def forward(params, tokens, cfg, *, mode: str = "prefill", cache=None,
            pos=None, enc_out=None, extra_embeds=None):
    """tokens: (B, S) integer (S = 1 for decode, at position `pos`, a
    Python int).  `enc_out`: the encoder's output (`encoder_fwd`), which
    an encoder-decoder's prefill attends to (its decode reads the cached
    cross K/V).  `extra_embeds`: (B, P, d) embeddings put ahead of the
    tokens (a vision config's patches), positions then running over
    P + S.  Returns (logits (B, P + S, padded_vocab), caches), the
    caches None in train mode.

    On a process mesh (a `sharding.layout.LMLayout` registered by the
    steps) `params`, `tokens` and the caches are this rank's shards:
    each block's weights are gathered over their FSDP / ZeRO-3 axes at
    its entry (inside the remat'd superblock, so the backward gathers
    them again), the layer boundaries carry the reference's activation
    constraints (`_shard_act`), and under tensor parallelism the logits
    are this rank's vocab slice.  On one card the constraints return
    their input."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    lay = sharding.get_layout()
    places = lay.params if lay is not None else None
    head, pat, n_rep, tail = layer_layout(cfg)
    x = _embed(params, tokens, cfg, pos_offset=pos if mode == "decode" else 0)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    x = _shard_act(x, cfg)
    S = x.shape[1]
    positions = (torch.arange(S, device=x.device) if mode != "decode"
                 else None)
    kw = dict(positions=positions, mode=mode, pos=pos, enc_out=enc_out)

    def run(kinds, blocks, caches, x, where):
        out = []
        for i, (kind, bp) in enumerate(zip(kinds, blocks)):
            if lay is not None:
                bp = lay.gather_tree(bp, where[i])
            x, c = apply_block(bp, _whole_act(x, cfg), cfg, kind,
                               cache=caches[i] if caches else None, **kw)
            x = _shard_act(x, cfg)
            out.append(c)
        return x, out

    def superblock(blocks, x, where):  # train mode under remat
        return run(pat, blocks, None, x, where)[0]

    def at(key, i=None):
        if places is None:
            return None
        return places[key] if i is None else places[key][i]

    x, new_head = run(head, params["head_blocks"],
                      cache["head"] if cache is not None else None, x,
                      at("head_blocks"))
    new_blocks = []
    names = [str(i) for i in range(len(pat))]
    for r in range(n_rep):
        blocks = [params["blocks"][r][n] for n in names]
        where = [at("blocks", r)[n] for n in names] if places else None
        if mode == "train" and cfg.remat:
            x = checkpoint(superblock, blocks, x, where, use_reentrant=False)
            continue
        c_in = ([cache["blocks"][r][n] for n in names]
                if cache is not None else None)
        x, c_out = run(pat, blocks, c_in, x, where)
        new_blocks.append(dict(zip(names, c_out)))
    x, new_tail = run(tail, params["tail_blocks"],
                      cache["tail"] if cache is not None else None, x,
                      at("tail_blocks"))

    x = _whole_act(x, cfg)
    fnorm, w_head = params["final_norm"], params["lm_head"]
    if lay is not None:
        fnorm = lay.gather_tree(fnorm, places["final_norm"])
        w_head = lay.gather(w_head, places["lm_head"])
    x = _norm(fnorm, x)
    if lay is not None:                 # the vocab-parallel head's input
        x = lay.col_in(x)
    logits = x @ w_head.to(cfg.dtype)
    vocab = None if cfg.layout == "fsdp" else "model"
    logits = sharding.constrain(
        logits, cfg.batch_axes, None, vocab,
        held=(cfg.batch_axes, None, vocab if lay and lay.tp > 1 else None))
    if mode == "train":
        return logits, None
    return logits, {"head": new_head, "blocks": new_blocks, "tail": new_tail}


def lm_loss(logits, labels, mask=None):
    """Cross-entropy in f32: logits (B, S, V), labels (B, S) integer, mask
    (B, S) optional (the masked mean, over at least 1)."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
