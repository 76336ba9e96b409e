"""Recurrent blocks: RG-LRU (Griffin / RecurrentGemma) and xLSTM's
mLSTM and sLSTM.

Mirrors the reference's `models/recurrent.py`.  RG-LRU: in -> (x
branch, GELU gate branch) -> causal conv1d -> RG-LRU -> out projection.
Prefill runs the recurrence through `kernels.ops.rglru_scan` (the B6
kernel on the card, its plain version on the CPU), which computes the
same function as the reference's associative scan; decode is one O(1)
state update.

mLSTM prefill is the reference's chunkwise-parallel form (quadratic
within a chunk, the (C, n, m) state carried across chunks); sLSTM is a
loop over the tokens, as the reference's `lax.scan`.  Neither has a
kernel in the reference: both are plain PyTorch here.  Each prefill
returns its final state as the decode cache, where the reference runs
its decode step over the prompt once more (`models/lm.py`
`_xlstm_prefill_cache`): the same state, and for mLSTM with another
stabilizer m (see `mlstm_fwd`).  The reference multiplies a bf16 x by
the f32 gate weights `w_i` and `w_f`, which JAX promotes to an f32
product; PyTorch refuses mixed dtypes, so x is cast to f32 first.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from .layers import CacheSpec, ParamSpec, act_fn, rmsnorm

RG_C = 8.0


def rglru_block_specs(cfg) -> dict:
    d, dr = cfg.d_model, cfg.rglru_dim
    return {
        "w_x": ParamSpec((d, dr), pspec=(None, "model")),
        "w_gate": ParamSpec((d, dr), pspec=(None, "model")),
        "conv_w": ParamSpec((4, dr), torch.float32, scale=0.5,
                            pspec=(None, "model")),
        "conv_b": ParamSpec((dr,), torch.float32, "zeros",
                            pspec=("model",)),
        "a_param": ParamSpec((dr,), torch.float32, "ones",
                             pspec=("model",)),
        "gate_a_w": ParamSpec((dr, dr), pspec=(None, "model")),
        "gate_x_w": ParamSpec((dr, dr), pspec=(None, "model")),
        "w_out": ParamSpec((dr, d), pspec=("model", None)),
    }


def _a_log(a_param):
    """log a in (-inf, 0): a = sigmoid(a_param)."""
    return F.logsigmoid(a_param.float())


def _causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width 4.  x: (B, S, D); state: (B, 3, D).
    A bf16 x times the f32 weights promotes to f32, then casts back."""
    B, S, D = x.shape
    if state is None:
        state = torch.zeros((B, 3, D), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                   # (B, S+3, D)
    out = sum(xp[:, i:i + S] * w[i] for i in range(4)) + b
    return out.to(x.dtype), xp[:, -3:]


def _rglru_scan(x, a_log, ga, gx, h0):
    """RG-LRU over S.  x/ga/gx: (B, S, D); h0: (B, D) f32.
    Returns (h in x's dtype, the final state in f32)."""
    return kops.rglru_scan(x, a_log, ga, gx, h0)


def rglru_block_fwd(p: dict, x, cfg):
    """Prefill.  x: (B, S, d).  Returns (out, the decode state after the
    prompt): the scan's f32 final state (not the last row of its output,
    which is rounded to x's dtype) and the conv window in bf16, from the
    one scan this block runs."""
    gelu = act_fn("gelu")
    xb = x @ p["w_x"]
    gb = gelu(x @ p["w_gate"])
    xb, conv_state = _causal_conv(xb, p["conv_w"], p["conv_b"])
    ga = xb @ p["gate_a_w"]
    gx = xb @ p["gate_x_w"]
    h0 = torch.zeros((x.shape[0], cfg.rglru_dim), dtype=torch.float32,
                     device=x.device)
    h, h_last = _rglru_scan(xb, _a_log(p["a_param"]), ga, gx, h0)
    state = {"h": h_last, "conv": conv_state.to(torch.bfloat16)}
    return (h * gb) @ p["w_out"], state


def rglru_cache_shape(cfg, batch: int) -> dict:
    dr = cfg.rglru_dim
    return {"h": CacheSpec((batch, dr), torch.float32),
            "conv": CacheSpec((batch, 3, dr), torch.bfloat16)}


def rglru_block_decode(p: dict, x, cache: dict, cfg):
    """x: (B, 1, d), one token.  Returns (out, new cache)."""
    gelu = act_fn("gelu")
    xb = x @ p["w_x"]
    gb = gelu(x @ p["w_gate"])
    xb, conv_state = _causal_conv(xb, p["conv_w"], p["conv_b"],
                                  cache["conv"].to(xb.dtype))
    ga = xb @ p["gate_a_w"]
    gx = xb @ p["gate_x_w"]
    a_log = _a_log(p["a_param"])
    r = torch.sigmoid(ga[:, 0].float())
    i = torch.sigmoid(gx[:, 0].float())
    log_a = RG_C * a_log * r
    at = torch.exp(log_a)
    bt = torch.sqrt(torch.clamp_min(1 - torch.exp(2 * log_a), 1e-12)) \
        * (i * xb[:, 0].float())
    h = at * cache["h"] + bt
    out = (h[:, None].to(x.dtype) * gb) @ p["w_out"]
    return out, {"h": h, "conv": conv_state.to(torch.bfloat16)}


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM): chunkwise-parallel prefill, recurrent decode
# ---------------------------------------------------------------------------

def mlstm_specs(cfg) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    return {"wq": ParamSpec((d, d), pspec=(None, "model")),
            "wk": ParamSpec((d, d), pspec=(None, "model")),
            "wv": ParamSpec((d, d), pspec=(None, "model")),
            "w_i": ParamSpec((d, H), torch.float32, pspec=(None, None)),
            "w_f": ParamSpec((d, H), torch.float32, pspec=(None, None)),
            "w_o": ParamSpec((d, d), pspec=(None, "model")),
            "wo": ParamSpec((d, d), pspec=("model", None)),
            "ln_g": ParamSpec((d,), torch.float32, "ones",
                              pspec=("model",))}


def _mlstm_heads(p, x, cfg):
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    # the reference divides a bf16 k by a weakly typed sqrt(hd), which
    # JAX rounds to k's dtype first
    rs = float(torch.tensor(math.sqrt(hd)).to(x.dtype))
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, H, hd) / rs
    v = (x @ p["wv"]).reshape(B, S, H, hd)
    xf = x.float()
    return q, k, v, xf @ p["w_i"], xf @ p["w_f"]        # gates (B, S, H)


def _mlstm_chunk(qc, kc, vc, lf, ic, C0, n0, m0, mask):
    """One chunk of c tokens: qc/kc/vc (B, c, H, hd) f32, lf/ic (B, c, H)
    log forget gates and input pre-activations; (C0, n0, m0) the state
    before it.  Returns (h (B, c, H, hd), the state after it)."""
    F_ = torch.cumsum(lf, dim=1)                      # within-chunk log f
    # stabilizer per position: max(F_t + m0, max_{s<=t} F_t - F_s + i_s)
    Dm = F_[:, :, None, :] - F_[:, None, :, :] + ic[:, None, :, :]
    Dm = torch.where(mask[None, :, :, None], Dm, -math.inf)  # (B, t, s, H)
    m_t = torch.maximum(F_ + m0[:, None, :], Dm.amax(dim=2))  # (B, c, H)
    w_inter = torch.exp(F_ + m0[:, None, :] - m_t)
    h_inter = torch.einsum("bchk,bhkv->bchv", qc, C0) * w_inter[..., None]
    n_inter = torch.einsum("bchk,bhk->bch", qc, n0) * w_inter
    sc = (torch.einsum("bthd,bshd->btsh", qc, kc)
          * torch.exp(Dm - m_t[:, :, None, :]))
    h_intra = torch.einsum("btsh,bshd->bthd", sc, vc)
    den = torch.maximum(torch.abs(n_inter + sc.sum(dim=2)), torch.exp(-m_t))
    h = (h_inter + h_intra) / den[..., None]
    # the state at the chunk's end
    Fc, m_c = F_[:, -1], m_t[:, -1]
    wC = torch.exp(Fc + m0 - m_c)                                # (B, H)
    wk = torch.exp(Fc[:, None, :] - F_ + ic - m_c[:, None, :])   # (B, c, H)
    C1 = wC[..., None, None] * C0 + torch.einsum(
        "bshk,bshv->bhkv", kc * wk[..., None], vc)
    n1 = wC[..., None] * n0 + torch.einsum("bsh,bshk->bhk", wk, kc)
    return h, (C1, n1, m_c)


def mlstm_fwd(p: dict, x, cfg):
    """Stabilized chunkwise-parallel mLSTM prefill.  x: (B, S, d), S a
    multiple of the chunk, min(cfg.attn_chunk, S).  Returns (out, the
    decode state after the prompt): the last chunk's carry (C, n, m).

    The reference's decode cache comes from its decode step run over the
    prompt from m = 0; this carry starts from m = -1e30, as the forward
    does.  (C, n) are held scaled by exp(-m), and the output q.C /
    max(|q.n|, exp(-m)) is the same for every m, so the two caches are
    one state: C_ref = C exp(m - m_ref), likewise n."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    c = min(cfg.attn_chunk or 256, S)
    if S % c:
        raise ValueError(f"mLSTM prefill: {S} tokens are not a multiple of "
                         f"the chunk {c}")
    nc = S // c
    q, k, v, i_pre, f_pre = _mlstm_heads(p, x, cfg)
    qf, kf, vf = (t.float().reshape(B, nc, c, H, hd) for t in (q, k, v))
    logf = F.logsigmoid(f_pre).reshape(B, nc, c, H)
    ii = i_pre.reshape(B, nc, c, H)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    state = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=x.device),
             torch.zeros((B, H, hd), dtype=torch.float32, device=x.device),
             torch.full((B, H), -1e30, dtype=torch.float32, device=x.device))
    hs = []
    for j in range(nc):
        h, state = _mlstm_chunk(qf[:, j], kf[:, j], vf[:, j], logf[:, j],
                                ii[:, j], *state, mask)
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, d)
    o = torch.sigmoid((x @ p["w_o"]).float())
    out = rmsnorm(h.to(x.dtype), p["ln_g"]) * o.to(x.dtype)
    return out @ p["wo"], dict(zip(("C", "n", "m"), state))


def mlstm_cache_shape(cfg, batch: int) -> dict:
    H = cfg.n_heads
    hd = cfg.d_model // H
    return {"C": CacheSpec((batch, H, hd, hd), torch.float32),
            "n": CacheSpec((batch, H, hd), torch.float32),
            "m": CacheSpec((batch, H), torch.float32)}


def mlstm_decode(p: dict, x, cache: dict, cfg):
    """x: (B, 1, d), one token.  Returns (out, new state)."""
    B, _, d = x.shape
    q, k, v, i_pre, f_pre = _mlstm_heads(p, x, cfg)
    q, k, v = (t[:, 0].float() for t in (q, k, v))
    i_pre, f_pre = i_pre[:, 0], f_pre[:, 0]               # (B, H)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + cache["m"], i_pre)
    f_sc = torch.exp(logf + cache["m"] - m_new)[..., None]
    i_sc = torch.exp(i_pre - m_new)[..., None]
    C = (f_sc[..., None] * cache["C"]
         + i_sc[..., None] * torch.einsum("bhk,bhv->bhkv", k, v))
    n = f_sc * cache["n"] + i_sc * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q, n)),
                        torch.exp(-m_new))[..., None]
    h = (num / den).reshape(B, 1, d).to(x.dtype)
    o = torch.sigmoid((x @ p["w_o"]).float())
    out = rmsnorm(h, p["ln_g"]) * o.to(x.dtype)
    return out @ p["wo"], {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with exponential gating): strictly sequential
# ---------------------------------------------------------------------------

def slstm_specs(cfg) -> dict:
    d = cfg.d_model
    return {"w_z": ParamSpec((d, d), pspec=(None, "model")),
            "w_i": ParamSpec((d, d), torch.float32, pspec=(None, "model")),
            "w_f": ParamSpec((d, d), torch.float32, pspec=(None, "model")),
            "w_o": ParamSpec((d, d), pspec=(None, "model")),
            "r_z": ParamSpec((d, d), pspec=(None, "model")),
            "wo": ParamSpec((d, d), pspec=("model", None))}


def slstm_cache_shape(cfg, batch: int) -> dict:
    return {k: CacheSpec((batch, cfg.d_model), torch.float32)
            for k in ("c", "n", "m", "h")}


def _slstm_gates(p, x):
    """The pre-activations of every token at once: z, i, log f and
    sigmoid(o), (B, S, d) f32."""
    xf = x.float()
    return ((x @ p["w_z"]).float(), xf @ p["w_i"],
            F.logsigmoid(xf @ p["w_f"]), torch.sigmoid((x @ p["w_o"]).float()))


def _slstm_step(zt, it, ft, so, rz, st: dict) -> dict:
    """One token: zt/it/ft (B, d) f32 pre-activations, so = sigmoid(o),
    rz the f32 recurrent weights; st the state before it."""
    z = torch.tanh(zt + st["h"] @ rz)
    fm = ft + st["m"]
    m_new = torch.maximum(fm, it)
    i_sc = torch.exp(it - m_new)
    f_sc = torch.exp(fm - m_new)
    c = f_sc * st["c"] + i_sc * z
    n = f_sc * st["n"] + i_sc
    h = so * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "m": m_new, "h": h}


def slstm_fwd(p: dict, x, cfg):
    """Prefill, one step a token.  x: (B, S, d).  Returns (out, the
    state after the last token)."""
    B, S, d = x.shape
    z, i, f, so = _slstm_gates(p, x)
    rz = p["r_z"].float()
    st = {k: torch.zeros((B, d), dtype=torch.float32, device=x.device)
          for k in ("c", "n", "m", "h")}
    st["m"].fill_(-1e30)
    hs = []
    for t in range(S):
        st = _slstm_step(z[:, t], i[:, t], f[:, t], so[:, t], rz, st)
        hs.append(st["h"])
    return torch.stack(hs, dim=1).to(x.dtype) @ p["wo"], st


def slstm_decode(p: dict, x, cache: dict, cfg):
    """x: (B, 1, d), one token.  Returns (out, new state)."""
    z, i, f, so = _slstm_gates(p, x)
    st = _slstm_step(z[:, 0], i[:, 0], f[:, 0], so[:, 0], p["r_z"].float(),
                     cache)
    return st["h"][:, None].to(x.dtype) @ p["wo"], st
