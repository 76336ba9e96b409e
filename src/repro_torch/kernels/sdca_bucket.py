"""Dense bucketed SDCA sub-epoch: the CUDA kernel and its plain version.

`sdca_bucket_kernel` runs every worker's pass over its (d x B) bucket
tiles: one thread block per worker, all workers in one launch
(`csrc/sdca_bucket.cu`, which replaces the reference's Pallas kernel
`repro/kernels/sdca_bucket.py:sdca_bucket_kernel`).  On a CPU tensor
the same function runs `sdca_bucket_plain`, the plain PyTorch version;
on a CUDA tensor it launches the kernel or raises.

d and B need no alignment (`ops.dense_tiles` pads neither).  B is
capped at `MAX_BUCKET`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import sdca
from repro_torch.core.objectives import Objective
from . import build
from .contracts import SMEM_OPTIN_BYTES

#: Largest bucket the in-bucket Gram recursion supports.
MAX_BUCKET = 512

OBJ_CODES = {"ridge": 0, "hinge": 1, "logistic": 2}

#: shared-memory stages the producer warps fill ahead of the chain
#: (csrc/sdca_bucket.cu)
STAGES = 2
#: levels of the bisection tree the chain warp walks per round
#: (`kTreeLevels` in csrc/sdca_bucket.cu)
TREE_LEVELS = 5

#: launches of the CUDA kernel (the plain version does not count)
launches = 0


def smem_layout(B: int, d: int) -> tuple[bool, bool, int]:
    """-> (tile in shared memory, G in shared memory, dynamic bytes).

    The block always keeps the bucket's deltas and, for each of its
    `STAGES` stages, the staged a, y and q in shared memory; the worker's
    v and a (d, B) tile per stage join them when they fit the opt-in
    (16 bytes of slack align the tiles for 16-byte copies), and a (B, B)
    Gram matrix per stage when it fits beside them.  What does not fit is
    read from global memory (v from v_out, G from a (W, STAGES, B, B)
    scratch)."""
    base = (B + 3 * B * STAGES) * 4
    tile = (d + STAGES * d * B) * 4 + 16
    gram = STAGES * B * B * 4
    x_in = base + tile <= SMEM_OPTIN_BYTES
    used = base + (tile if x_in else 0)
    g_in = used + gram <= SMEM_OPTIN_BYTES
    return x_in, g_in, used + (gram if g_in else 0)


def _fn():
    fn = build.load("sdca_bucket").sdca_bucket_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, f, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def sdca_bucket_plain(obj: Objective, xb, yb, ab, v0, lam_n: float,
                      sig: float):
    """The plain PyTorch version of `sdca_bucket_kernel`, same contract."""
    lam = torch.tensor(lam_n, dtype=torch.float32, device=xb.device)
    s = torch.tensor(sig, dtype=torch.float32, device=xb.device)
    return sdca.dense_bucket_pass(obj, xb, yb, ab, v0, lam, s)


def sdca_bucket_kernel(obj: Objective, xb, yb, ab, v0, lam_n: float,
                       sig: float, source: str = "ad-hoc arrays"):
    """Run every worker's dense sub-epoch.

    xb: (W, nb, d, B) f32 bucket tiles in visiting order
    yb, ab: (W, nb, B) f32;  v0: (W, d) f32 per-worker replicas
    lam_n, sig: lam*n and sigma'
    Returns (a_new (W, nb, B), v_final (W, d)); v_final includes the
    sigma'-scaled local evolution (callers unscale the global delta).
    """
    global launches
    if xb.device.type == "cpu":
        return sdca_bucket_plain(obj, xb, yb, ab, v0, lam_n, sig)
    if xb.device.type != "cuda":
        raise ValueError(f"sdca_bucket_kernel: unsupported device {xb.device}")
    W, nb, d, B = xb.shape
    if B > MAX_BUCKET:
        raise ValueError(
            f"dense bucket tiles from {source} have B={B}; the kernel's "
            f"in-bucket Gram recursion supports B <= {MAX_BUCKET}.  Use a "
            f"smaller bucket, or local_solver='torch'.")
    for name, t, shape in (("yb", yb, (W, nb, B)), ("ab", ab, (W, nb, B)),
                           ("v0", v0, (W, d))):
        if tuple(t.shape) != shape or t.device != xb.device:
            raise ValueError(f"{name}: expected {shape} on {xb.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    xb, yb, ab, v0 = (t.float().contiguous() for t in (xb, yb, ab, v0))
    x_in, g_in, smem = smem_layout(B, d)
    a_out = torch.empty_like(ab)
    v_out = torch.empty_like(v0)
    g_scratch = (torch.empty((W, STAGES, B, B), dtype=torch.float32,
                             device=xb.device) if not g_in else None)
    err = _fn()(xb.data_ptr(), yb.data_ptr(), ab.data_ptr(), v0.data_ptr(),
                a_out.data_ptr(), v_out.data_ptr(),
                g_scratch.data_ptr() if g_scratch is not None else None,
                W, nb, d, B, lam_n, sig, OBJ_CODES[obj.name],
                int(x_in), int(g_in), smem,
                torch.cuda.current_stream(xb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sdca_bucket kernel launch failed: CUDA error "
                           f"{err} (W={W}, nb={nb}, d={d}, B={B})")
    launches += 1
    return a_out, v_out
