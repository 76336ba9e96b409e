"""The RG-LRU recurrent block (Griffin / RecurrentGemma).

Mirrors the RG-LRU half of the reference's `models/recurrent.py`
(mLSTM and sLSTM wait: ROADMAP A16): in -> (x branch, GELU gate branch)
-> causal conv1d -> RG-LRU -> out projection.  Prefill runs the
recurrence through `kernels.ops.rglru_scan` (the B6 kernel on the card,
its plain version on the CPU), which computes the same function as the
reference's associative scan; decode is one O(1) state update.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from .layers import CacheSpec, ParamSpec, act_fn

RG_C = 8.0


def rglru_block_specs(cfg) -> dict:
    d, dr = cfg.d_model, cfg.rglru_dim
    return {
        "w_x": ParamSpec((d, dr)),
        "w_gate": ParamSpec((d, dr)),
        "conv_w": ParamSpec((4, dr), torch.float32, scale=0.5),
        "conv_b": ParamSpec((dr,), torch.float32, "zeros"),
        "a_param": ParamSpec((dr,), torch.float32, "ones"),
        "gate_a_w": ParamSpec((dr, dr)),
        "gate_x_w": ParamSpec((dr, dr)),
        "w_out": ParamSpec((dr, d)),
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
