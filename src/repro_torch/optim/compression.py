"""Int8 error-feedback compression for the simulated wire.

Deterministic int8 quantization with error feedback: `compress` returns
the residual so a caller can carry it to the next round
(`ef_allreduce`).  The engine models its int8 reductions with
`quantize` + `dequantize` (`engine._quantize_roundtrip`,
`engine.q_psum`), which throw the residual away.

The scale is max|x| times f32(1/127), the form the reference's compiled
programs compute: every one of its reductions runs jitted or inside
shard_map, where XLA rewrites its division by 127 as a multiply by the
reciprocal.  The residual x - q * scale is rounded once, as XLA's fused
multiply-add gives it.  Both give the same bits on the CPU and on the
card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

QMAX = 127.0
#: f32(1 / 127), the multiplier of the reference's compiled scale
INV_QMAX = float(torch.tensor(1.0) / torch.tensor(QMAX))


class Quantized(NamedTuple):
    q: Tensor          # int8 payload
    scale: Tensor      # f32 per-row (or scalar) scale


def quantize(x: Tensor, *, axis: int | None = None) -> Quantized:
    """Quantize to int8, the scale taken over the whole array
    (`axis=None`) or along `axis`."""
    xf = x.float()
    amax = torch.clamp_min(xf.abs().amax() if axis is None
                           else xf.abs().amax(dim=axis, keepdim=True), 1e-30)
    # a Python float multiplies in f32 on either device; INV_QMAX is an
    # f32 value, so no rounding is added
    scale = amax * INV_QMAX
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return Quantized(q, scale)


def compress(x: Tensor, *, axis: int | None = None
             ) -> tuple[Quantized, Tensor]:
    """`quantize`, and the error residual: -> (payload, residual)."""
    qz = quantize(x, axis=axis)
    # XLA fuses the residual into one multiply-add; q * scale and
    # x - q * scale are exact in f64, so one rounding reproduces it
    err = (x.double() - qz.q.double() * qz.scale.double()).float()
    return qz, err.to(x.dtype)


def dequantize(qz: Quantized) -> Tensor:
    return qz.q.float() * qz.scale


def ef_allreduce(x: Tensor, err: Tensor) -> tuple[Tensor, Tensor]:
    """Error-feedback int8 all-reduce over a stacked lane axis.

    x, err: (L, ...) each lane's array and its carried residual.  Each
    lane compresses x + err with one scale over its whole array (the
    reference's `compress` inside shard_map), the dequantized arrays are
    summed over the lanes left to right, and each lane keeps its new
    residual.  Returns (reduced (...), new_err (L, ...)), the
    reference's `ef_allreduce` on every lane at once (there each lane
    holds the same reduced array).
    """
    lanes = []
    errs = []
    for xl, el in zip(x.unbind(0), err.unbind(0)):
        qz, e = compress(xl + el)
        lanes.append(dequantize(qz))
        errs.append(e)
    out = lanes[0]
    for t in lanes[1:]:
        out = out + t
    return out, torch.stack(errs)
