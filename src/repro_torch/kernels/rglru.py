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

The backward, `rglru_bwd` (`csrc/rglru_bwd.cu`: the gates of every
step in parallel, then the two chains a warp of channels at a time,
their operands staged through shared memory, then every step's
gradients in parallel, then d a_log summed over t from the end), has
the plain version `rglru_bwd_plain`, to which it is bitwise equal;
`RGLRUFn` is the differentiable form, which `ops.rglru_scan` always
runs (it saves nothing where no grad is recorded).

The kernel runs one block per (batch row, GROUP channels): a chain warp
walks t over tiles of TILE steps in a ring of STAGES stages, which
producer warps fill with a_t and b_t, one (step, CHUNK channels) item
per thread and tile.  The constants below mirror the kernel's; the CPU
tests walk the same tiling in numpy.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, costs

#: the RG-LRU decay constant c (Griffin: a_t = a^(c r_t))
RG_C = 8.0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: the kernel's tiling (`kGroup`, `kChunk`, `kProducerWarps`, `kStages`
#: in csrc/rglru.cu): channels per block, channels per producer item,
#: producer warps, ring stages; a tile has one item per producer thread
GROUP, CHUNK, PRODUCER_WARPS, STAGES = 16, 8, 4, 4
TILE = 32 * PRODUCER_WARPS * CHUNK // GROUP

#: the backward's chains (`kLanes`, `kTile`, `kStages` in
#: csrc/rglru_bwd.cu): channels a block (one warp), steps a ring stage,
#: ring stages
BWD_LANES, BWD_TILE, BWD_STAGES = 32, 32, 12

#: launches of the CUDA kernel (the plain version does not count), and of
#: the backward kernel
launches = 0
bwd_launches = 0


def _fn():
    fn = build.load("rglru").rglru_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _fn_bwd():
    fn = build.load("rglru_bwd").rglru_bwd_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 13 + [i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def bwd_smem_bytes() -> int:
    """Dynamic shared memory of the backward's chains block: the ring of
    a_t and b_t (or dh_t) tiles, f32."""
    return 2 * BWD_STAGES * BWD_TILE * BWD_LANES * 4


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


@costs.counted("rglru", costs.rglru_call)
def rglru_kernel(x, a_log, gate_a, gate_x, h0):
    """x, gate_a, gate_x: (B, T, D) f32 or bf16, one dtype;
    a_log: (D,) f32 (log a < 0);  h0: (B, D) f32.
    Returns (h (B, T, D) in x's dtype, h_T (B, D) f32).  On the `meta`
    device: the same checks, then empty outputs; nothing runs or
    loads."""
    global launches
    if x.device.type == "cpu":
        return rglru_plain(x, a_log, gate_a, gate_x, h0)
    if x.device.type not in ("cuda", "meta"):
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
    if x.device.type == "meta":
        return out, h_last
    err = _fn()(x.data_ptr(), gate_a.data_ptr(), gate_x.data_ptr(),
                a_log.data_ptr(), h0.data_ptr(), out.data_ptr(),
                h_last.data_ptr(), B, T, D, DTYPE_CODES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err} "
                           f"(B={B}, T={T}, D={D})")
    launches += 1
    return out, h_last


def rglru_bwd_plain(x, a_log, gate_a, gate_x, h0, dh, dh_last):
    """The plain PyTorch version of `rglru_bwd`, same contract and the
    kernel's operations in its order: the gates, h in f32 from h0, the
    total gradient g_t = dh_t + a_{t+1} g_{t+1} walked back from
    dh_{T-1} + dh_last, then each step's gradients elementwise, and d
    a_log summed over t from the end, then over the batch rows in
    order.  Returns (dx, da_log (D,), dgate_a, dgate_x, dh0 (B, D))."""
    r = torch.sigmoid(gate_a.float())
    iv = torch.sigmoid(gate_x.float())
    al8 = RG_C * a_log.float()
    la = al8 * r
    a = _exp(la)
    e2 = _exp(2.0 * la)
    z = 1.0 - e2
    sq = torch.sqrt(torch.clamp_min(z, 1e-12))
    xf = x.float()
    u = iv * xf
    T = x.shape[1]
    h = h0.float()
    hs = torch.empty_like(a)
    for t in range(T):
        h = a[:, t] * h + sq[:, t] * u[:, t]
        hs[:, t] = h
    hp = torch.cat([h0.float()[:, None], hs[:, :-1]], dim=1)
    dhf = dh.float()
    g = torch.empty_like(a)
    carry = dh_last.float()
    for t in range(T - 1, -1, -1):
        g[:, t] = dhf[:, t] + carry
        carry = a[:, t] * g[:, t]
    da = g * hp
    du = g * sq
    dsq = g * u
    dx = du * iv
    dgx = (du * xf) * (iv * (1.0 - iv))
    dmax = dsq * (torch.full_like(sq, 0.5) / sq)   # a division, as the
    # kernel's 0.5f / sq (a Python scalar over a tensor is a reciprocal)
    dz = torch.where(z > 1e-12, dmax,
                     torch.where(z == 1e-12, 0.5 * dmax,
                                 torch.zeros_like(dmax)))
    dla = da * a + 2.0 * (-dz * e2)
    term = dla * r
    dal = torch.zeros_like(h)
    for t in range(T - 1, -1, -1):
        dal = dal + term[:, t]
    dga = (dla * al8) * (r * (1.0 - r))
    return (dx.to(x.dtype), _batch_sum(8.0 * dal), dga.to(gate_a.dtype),
            dgx.to(gate_x.dtype), carry)


def _batch_sum(part):
    """(B, D) -> (D,): the batch rows' partials added in order."""
    out = part[0]
    for b in range(1, part.shape[0]):
        out = out + part[b]
    return out


@costs.counted("rglru_bwd", costs.rglru_bwd_call)
def rglru_bwd(x, a_log, gate_a, gate_x, h0, dh, dh_last):
    """The gradients of `rglru_kernel`'s (h, h_T) = RG-LRU(x, a_log,
    gate_a, gate_x, h0) given dh (B, T, D) and dh_last (B, D):
    (dx, da_log (D,) f32, dgate_a, dgate_x, dh0 (B, D) f32).  CPU tensors
    run `rglru_bwd_plain`; CUDA tensors launch `csrc/rglru_bwd.cu` (its
    f32 scratch: a, b then h, e2 then d a_log's terms, dh then g) or
    raise.  On the `meta` device: the same checks, then empty gradients;
    nothing runs or loads."""
    global bwd_launches
    if x.device.type == "cpu":
        return rglru_bwd_plain(x, a_log, gate_a, gate_x, h0, dh, dh_last)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rglru_bwd: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype not in DTYPE_CODES:
        raise ValueError(f"rglru_bwd: x must be (B, T, D) f32 or bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    B, T, D = x.shape
    for name, t, shape, dtype in (
            ("gate_a", gate_a, (B, T, D), x.dtype),
            ("gate_x", gate_x, (B, T, D), x.dtype),
            ("dh", dh, (B, T, D), x.dtype),
            ("a_log", a_log, (D,), torch.float32),
            ("h0", h0, (B, D), torch.float32),
            ("dh_last", dh_last, (B, D), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != x.device):
            raise ValueError(
                f"rglru_bwd: {name} must be {shape} {dtype} on {x.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    x, gate_a, gate_x, dh, a_log, h0, dh_last = (
        t.contiguous() for t in (x, gate_a, gate_x, dh, a_log, h0, dh_last))
    if x.device.type == "meta":
        return (torch.empty_like(x), torch.empty_like(a_log),
                torch.empty_like(gate_a), torch.empty_like(gate_x),
                torch.empty_like(h0))
    scratch = torch.empty((4, B, T, D), dtype=torch.float32,
                          device=x.device)
    dx, dga, dgx = (torch.empty_like(x) for _ in range(3))
    dh0 = torch.empty((B, D), dtype=torch.float32, device=x.device)
    part = torch.empty_like(dh0)
    err = _fn_bwd()(x.data_ptr(), gate_a.data_ptr(), gate_x.data_ptr(),
                    a_log.data_ptr(), h0.data_ptr(), dh.data_ptr(),
                    dh_last.data_ptr(), scratch.data_ptr(), dx.data_ptr(),
                    dga.data_ptr(), dgx.data_ptr(), dh0.data_ptr(),
                    part.data_ptr(), B, T, D, DTYPE_CODES[x.dtype],
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru backward kernel launch failed: CUDA "
                           f"error {err} (B={B}, T={T}, D={D})")
    bwd_launches += 1
    return dx, _batch_sum(part), dga, dgx, dh0


class RGLRUFn(torch.autograd.Function):
    """B6 with its backward: `rglru_kernel` forward, `rglru_bwd` on the
    saved inputs (a missing gradient of h or of the final state counts
    as zeros)."""

    @staticmethod
    def forward(ctx, x, a_log, gate_a, gate_x, h0):
        h, h_last = rglru_kernel(x, a_log, gate_a, gate_x, h0)
        ctx.save_for_backward(x, a_log, gate_a, gate_x, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        x, a_log, gate_a, gate_x, h0 = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(x)
        if dh_last is None:
            dh_last = torch.zeros_like(h0, dtype=torch.float32)
        return rglru_bwd(x, a_log, gate_a, gate_x, h0, dh.to(x.dtype),
                         dh_last.float())
