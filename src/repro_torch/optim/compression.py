"""Int8 error-feedback compression for the simulated wire.

Deterministic int8 quantization with error feedback: the residual is
returned so a caller can carry it to the next round.  The simulator
uses `compress` + `dequantize` to model an int8 reduction
(`engine._quantize_roundtrip`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class Quantized(NamedTuple):
    q: Tensor          # int8 payload
    scale: Tensor      # f32 per-row (or scalar) scale


def compress(x: Tensor, *, axis: int | None = None
             ) -> tuple[Quantized, Tensor]:
    """Quantize to int8; returns (payload, error_residual)."""
    xf = x.float()
    amax = (xf.abs().amax() if axis is None
            else xf.abs().amax(dim=axis, keepdim=True))
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    err = xf - q.float() * scale
    return Quantized(q, scale), err.to(x.dtype)


def dequantize(qz: Quantized) -> Tensor:
    return qz.q.float() * qz.scale
