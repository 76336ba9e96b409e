"""Attention variants: GQA / MQA causal, sliding-window (local) or full,
cross-attention (`gqa_fwd(kv_x=)`), and MLA (multi-head latent
attention).

Mirrors the reference's `models/attention.py`.  All softmax math
in f32.  Prefill runs the flash kernel (B5) when the tensors are on the
card, else the blocked online-softmax formulation, which never
materialises the (S x S) scores.  Decode is one token against a cache,
written in place: K/V for GQA (a ring for local attention), the latent
c_kv and the shared rotary key for MLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import costs, ops as kops
from .layers import CacheSpec, ParamSpec, apply_rope, rmsnorm

NEG_INF = -1e30


def attention(q, k, v, *, q_positions, kind: str = "causal", window: int = 0,
              chunk: int = 512):
    """Dispatch: the flash kernel (B5) for CUDA tensors and on `meta`
    (the dry run's trace: shapes only), and for CPU tensors while a step
    is counted (`launch/counting.py` counts the card's program: B5's
    plain version runs inside its wrapper); `blocked_attention` for CPU
    tensors otherwise.  The port never pads kv, so neither takes the
    reference's `kv_len` mask."""
    if q.is_cuda or q.device.type == "meta" or costs.counting():
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
    return {"wq": ParamSpec((d, H * hd), pspec=(None, "model")),
            "wk": ParamSpec((d, Hkv * hd), pspec=(None, "model")),
            "wv": ParamSpec((d, Hkv * hd), pspec=(None, "model")),
            "wo": ParamSpec((H * hd, d), pspec=("model", None))}


def gqa_fwd(p: dict, x, cfg, *, positions, kind: str = "causal",
            kv_x=None, use_rope: bool = True):
    """Full-sequence forward (prefill).  x: (B, S, d).  With `kv_x`
    (B, Sk, d), cross-attention: k and v come from it, and RoPE, if
    any, rotates q alone."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (src @ p["wk"]).reshape(B, src.shape[1], Hkv, hd)
    v = (src @ p["wv"]).reshape(B, src.shape[1], Hkv, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        if kv_x is None:
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


def mla_specs(cfg) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    sp = {"wkv_a": ParamSpec((d, kvr + rd), pspec=(None, None)),
          "kv_norm": ParamSpec((kvr,), torch.float32, "ones",
                               pspec=(None,)),
          "wkv_b": ParamSpec((kvr, H * (nd + vd)), pspec=(None, "model")),
          "wo": ParamSpec((H * vd, d), pspec=("model", None))}
    if qr:
        sp["wq_a"] = ParamSpec((d, qr), pspec=(None, None))
        sp["q_norm"] = ParamSpec((qr,), torch.float32, "ones",
                                 pspec=(None,))
        sp["wq_b"] = ParamSpec((qr, H * (nd + rd)), pspec=(None, "model"))
    else:
        sp["wq"] = ParamSpec((d, H * (nd + rd)), pspec=(None, "model"))
    return sp


def _same(t):
    return t


def _mla_q(p, x, cfg, seam=None):
    """x -> q (B, S, H, nd + rd).  `seam` marks where the per-head part
    begins (on a mesh, the column-parallel input: x, or the normed q
    latent under a q-LoRA); None, the identity, on one card."""
    B, S, _ = x.shape
    seam = seam or _same
    if cfg.q_lora_rank:
        q = seam(rmsnorm(x @ p["wq_a"], p["q_norm"])) @ p["wq_b"]
    else:
        q = seam(x) @ p["wq"]
    return q.reshape(B, S, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)


def _mla_latent(p, x, cfg, positions, seam=None):
    """x -> (c_kv (B, S, kvr), the rotated shared key (B, S, 1, rd)),
    each through `seam` (see `_mla_q`)."""
    seam = seam or _same
    kvr = cfg.kv_lora_rank
    kv_a = x @ p["wkv_a"]
    c_kv = rmsnorm(kv_a[..., :kvr], p["kv_norm"])
    k_rope = apply_rope(kv_a[..., kvr:][:, :, None, :], positions,
                        cfg.rope_theta)
    return seam(c_kv), seam(k_rope)


def mla_fwd(p: dict, x, cfg, *, positions, seam=None):
    """Prefill: per-head K/V materialised from the latent.  B5 runs at
    hd = nope + rope with hd_v = v_head_dim, scaled by (nope + rope)^-0.5
    (standard MLA scaling).  `seam`: see `_mla_q`."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    q = _mla_q(p, x, cfg, seam)
    q_rope = apply_rope(q[..., nd:], positions, cfg.rope_theta)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions, seam)
    kv = (c_kv @ p["wkv_b"]).reshape(B, S, H, nd + vd)

    qf = torch.cat([q[..., :nd], q_rope], dim=-1)
    # the shared rotary key broadcast over heads, made contiguous once
    kf = torch.cat([kv[..., :nd], k_rope.expand(B, S, H, rd)], dim=-1)
    out = attention(qf, kf, kv[..., nd:], q_positions=positions,
                    kind="causal", chunk=cfg.attn_chunk)
    return out.reshape(B, S, H * vd) @ p["wo"]


def mla_cache_shape(cfg, batch: int, max_seq: int) -> dict:
    return {"c_kv": CacheSpec((batch, max_seq, cfg.kv_lora_rank),
                              torch.bfloat16),
            "k_rope": CacheSpec((batch, max_seq, cfg.qk_rope_dim),
                                torch.bfloat16)}


def mla_decode(p: dict, x, cache: dict, cfg, *, pos: int, seam=None):
    """Latent (absorbed) decode: attention runs in the kv_lora space, in
    f32.  x: (B, 1, d); pos: the token's position.  Writes c_kv and
    k_rope into `cache` IN PLACE and returns (out, cache).  `seam`: see
    `_mla_q`."""
    B = x.shape[0]
    H = cfg.n_heads
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    Smax = c_kv.shape[1]

    pp = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q = _mla_q(p, x, cfg, seam)                          # (B, 1, H, nd+rd)
    q_rope = apply_rope(q[..., nd:], pp, cfg.rope_theta)
    c_new, kr_new = _mla_latent(p, x, cfg, pp, seam)
    c_kv[:, pos] = c_new[:, 0].to(c_kv.dtype)
    k_rope[:, pos] = kr_new[:, 0, 0].to(k_rope.dtype)

    wkv_b = p["wkv_b"].reshape(kvr, H, nd + vd).float()
    w_uk, w_uv = wkv_b[..., :nd], wkv_b[..., nd:]        # (kvr, H, nd/vd)
    # absorb W_uk into q: q_lat (B, H, kvr)
    q_lat = torch.einsum("bhn,rhn->bhr", q[:, 0, :, :nd].float(), w_uk)
    s = (torch.einsum("bhr,bsr->bhs", q_lat, c_kv.float())
         + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(),
                        k_rope.float()))
    s = s * (nd + rd) ** -0.5
    ok = torch.arange(Smax, device=x.device) <= pos
    s = torch.where(ok, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", w, c_kv.float())
    o = torch.einsum("bhr,rhv->bhv", o_lat, w_uv)
    o = o.reshape(B, 1, H * vd).to(x.dtype)
    return o @ p["wo"], cache
