"""GQA / MQA attention, full (causal) or sliding-window (local).

Mirrors the GQA half of the reference's `models/attention.py`; the MLA
functions wait (ROADMAP A16).  All softmax math in f32.  Prefill runs
the flash kernel (B5) when the tensors are on the card, else the blocked
online-softmax formulation, which never materialises the (S x S)
scores.  Decode is one token against a KV
cache; local attention keeps a ring cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from .layers import CacheSpec, ParamSpec, apply_rope

NEG_INF = -1e30


def attention(q, k, v, *, q_positions, kind: str = "causal", window: int = 0,
              chunk: int = 512):
    """Dispatch: the flash kernel for CUDA tensors, `blocked_attention`
    for CPU tensors.  The port never pads kv, so neither takes the
    reference's `kv_len` mask."""
    if q.is_cuda:
        return kops.flash_attention(q, k, v, kind=kind, window=window)
    return blocked_attention(q, k, v, q_positions=q_positions, kind=kind,
                             window=window, chunk=chunk)


def blocked_attention(q, k, v, *, q_positions, kind: str = "causal",
                      window: int = 0, chunk: int = 512):
    """q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd); grouped heads
    (H % Hkv == 0).  kind: causal | local (causal within `window`) |
    full.  Returns (B, Sq, H, hd_v)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    scale = hd ** -0.5
    chunk = min(chunk, Sk)
    seq_k = Sk
    if Sk % chunk:              # pad KV to a chunk multiple; mask the tail
        pad = chunk - Sk % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        Sk = Sk + pad
    qpos = q_positions[:, None]
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, hd_v), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Sk, chunk):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        kpos = c0 + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqkgh,bckh->bkgqc", qg, kb) * scale
        if kind == "causal":
            ok = qpos >= kpos[None, :]
        elif kind == "local":
            dist = qpos - kpos[None, :]
            ok = (dist >= 0) & (dist < window)
        else:
            ok = torch.ones((Sq, chunk), dtype=torch.bool, device=q.device)
        ok = ok.expand(B, Sq, chunk) & (kpos < seq_k)
        s = torch.where(ok[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bckh->bkgqh", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd_v).to(q.dtype)


def gqa_specs(cfg) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": ParamSpec((d, H * hd)), "wk": ParamSpec((d, Hkv * hd)),
            "wv": ParamSpec((d, Hkv * hd)), "wo": ParamSpec((H * hd, d))}


def gqa_fwd(p: dict, x, cfg, *, positions, kind: str = "causal",
            use_rope: bool = True):
    """Full-sequence forward (prefill).  x: (B, S, d)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = attention(q, k, v, q_positions=positions, kind=kind,
                    window=cfg.window, chunk=cfg.attn_chunk)
    return out.reshape(B, S, H * hd) @ p["wo"]


def gqa_cache_shape(cfg, batch: int, max_seq: int) -> dict:
    shp = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": CacheSpec(shp, torch.bfloat16),
            "v": CacheSpec(shp, torch.bfloat16)}


def gqa_decode(p: dict, x, cache: dict, cfg, *, pos: int,
               kind: str = "causal", use_rope: bool = True):
    """x: (B, 1, d); cache k/v: (B, Smax, Hkv, hd); pos: the token's
    position.  Writes the new key and value into `cache` IN PLACE (the
    reference donates the cache instead) and returns (out, cache).

    Local attention uses a RING cache: when Smax <= window the slot is
    pos % Smax and the ring itself enforces the window; a larger cache
    falls back to masked lookup."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ck, cv = cache["k"], cache["v"]
    Smax = ck.shape[1]
    ring = kind == "local" and Smax <= cfg.window
    q = (x @ p["wq"]).reshape(B, 1, H, hd)
    k = (x @ p["wk"]).reshape(B, 1, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, 1, Hkv, hd)
    if use_rope:
        pp = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
        q = apply_rope(q, pp, cfg.rope_theta)
        k = apply_rope(k, pp, cfg.rope_theta)
    slot = pos % Smax if ring else pos
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    kpos = torch.arange(Smax, device=x.device)
    # ring: every slot holds one of the last Smax (<= window) keys once
    # pos >= Smax - 1, and `kpos <= pos` is then all-true; before that,
    # slots above pos are unwritten and masked by the same predicate
    ok = kpos <= pos
    if kind == "local" and not ring:
        ok = ok & (kpos > pos - cfg.window)
    qg = q.reshape(B, Hkv, H // Hkv, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, ck.float()) * (hd ** -0.5)
    s = torch.where(ok, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w, cv.float())
    o = o.reshape(B, 1, H * hd).to(x.dtype)
    return o @ p["wo"], cache
