"""RG-LRU recurrence: the CUDA kernel and its plain version.

`rglru_kernel` walks h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (sigmoid(gx_t)
x_t), a_t = exp(8 a_log sigmoid(ga_t)), over T for every (batch row,
channel) in one launch (`csrc/rglru.cu`, which replaces the reference's
Pallas kernel `repro/kernels/rglru.py:rglru_kernel`).  On a CPU tensor
the same function runs `rglru_plain`, the plain PyTorch version (the
sequential recurrence of the reference's `kernels/ref.py` `rglru_ref`,
batched over a leading B); on a CUDA tensor it launches the kernel or
raises.  Both return the final state in f32 beside h, and are bitwise
equal on the card.

The kernel runs one block per (batch row, GROUP channels): a chain warp
walks t over tiles of TILE steps in a ring of STAGES stages, which
producer warps fill with a_t and b_t, one (step, CHUNK channels) item
per thread and tile.  The constants below mirror the kernel's; the CPU
tests walk the same tiling in numpy.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: the RG-LRU decay constant c (Griffin: a_t = a^(c r_t))
RG_C = 8.0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: the kernel's tiling (`kGroup`, `kChunk`, `kProducerWarps`, `kStages`
#: in csrc/rglru.cu): channels per block, channels per producer item,
#: producer warps, ring stages; a tile has one item per producer thread
GROUP, CHUNK, PRODUCER_WARPS, STAGES = 16, 8, 4, 4
TILE = 32 * PRODUCER_WARPS * CHUNK // GROUP

#: launches of the CUDA kernel (the plain version does not count)
launches = 0


def _fn():
    fn = build.load("rglru").rglru_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _exp(v):
    """f32 exp through f64, so correctly rounded (as nearly as f64 allows).
    PyTorch's vectorised f32 exp on the CPU is off by up to about an ulp,
    which the recurrence accumulates past the reference's rtol 1e-5 /
    atol 1e-6 over a few hundred steps; the CUDA kernel rounds its exps
    the same way, so kernel and plain version agree on the card too."""
    return torch.exp(v.double()).float()


def rglru_gates(x, a_log, gate_a, gate_x):
    """a_t and b_t (f32) of every step, with the reference's operation
    order and clamp."""
    r = torch.sigmoid(gate_a.float())
    i = torch.sigmoid(gate_x.float())
    log_a = RG_C * a_log.float() * r
    a = _exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - _exp(2.0 * log_a), 1e-12)) \
        * (i * x.float())
    return a, b


def rglru_plain(x, a_log, gate_a, gate_x, h0):
    """The plain PyTorch version of `rglru_kernel`, same contract: the
    gates of every step (`rglru_gates`), then h_t = a_t h_{t-1} + b_t in
    order."""
    a, b = rglru_gates(x, a_log, gate_a, gate_x)
    h = h0.float()
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out.to(x.dtype), h


def rglru_kernel(x, a_log, gate_a, gate_x, h0):
    """x, gate_a, gate_x: (B, T, D) f32 or bf16, one dtype;
    a_log: (D,) f32 (log a < 0);  h0: (B, D) f32.
    Returns (h (B, T, D) in x's dtype, h_T (B, D) f32)."""
    global launches
    if x.device.type == "cpu":
        return rglru_plain(x, a_log, gate_a, gate_x, h0)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_kernel: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"rglru_kernel: x must be (B, T, D), got "
                         f"{tuple(x.shape)}")
    B, T, D = x.shape
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"rglru_kernel: dtype {x.dtype} not supported "
                         f"(f32 or bf16)")
    for name, t, shape, dtype in (
            ("gate_a", gate_a, (B, T, D), x.dtype),
            ("gate_x", gate_x, (B, T, D), x.dtype),
            ("a_log", a_log, (D,), torch.float32),
            ("h0", h0, (B, D), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != x.device):
            raise ValueError(
                f"rglru_kernel: {name} must be {shape} {dtype} on "
                f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    x, gate_a, gate_x, a_log, h0 = (t.contiguous() for t in
                                    (x, gate_a, gate_x, a_log, h0))
    out = torch.empty_like(x)
    h_last = torch.empty((B, D), dtype=torch.float32, device=x.device)
    err = _fn()(x.data_ptr(), gate_a.data_ptr(), gate_x.data_ptr(),
                a_log.data_ptr(), h0.data_ptr(), out.data_ptr(),
                h_last.data_ptr(), B, T, D, DTYPE_CODES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err} "
                           f"(B={B}, T={T}, D={D})")
    launches += 1
    return out, h_last
