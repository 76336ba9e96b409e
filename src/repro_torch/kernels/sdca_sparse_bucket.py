"""Sparse bucketed SDCA sub-epoch: the CUDA kernel and its plain version.

`sdca_sparse_bucket_kernel` runs every worker's pass over its padded-CSR
(B x nnz) bucket tiles against a per-worker replica of v held in global
memory: one thread block per worker, all workers in one launch
(`csrc/sdca_sparse_bucket.cu`, which replaces the reference's Pallas
kernel `repro/kernels/sdca_sparse_bucket.py:sdca_sparse_bucket_kernel`).
On a CPU tensor it runs `sdca_sparse_bucket_plain`; on a CUDA tensor it
launches the kernel or raises.

The kernel is BITWISE equal to the plain scan on the same card: both
sum margins left to right, form u = (sigma' delta / lam_n) * val once
and add it entry by entry in visiting order, with no fused multiply-add
(the source is built with -fmad=false), and both read q = sum val^2
precomputed by `core.sdca.row_sq_norms`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import sdca
from repro_torch.core.objectives import Objective
from . import build
from .contracts import SMEM_OPTIN_BYTES
from .sdca_bucket import OBJ_CODES

#: launches of the CUDA kernel (the plain version does not count)
launches = 0


def smem_bytes(B: int, nnz: int) -> int:
    """Dynamic shared memory of one block: the idx/val tile, the working
    set W and the update rows U (B*nnz each), the deltas and a slot."""
    return (4 * B * nnz + B + 4) * 4


def fits_smem(B: int, nnz: int) -> bool:
    return smem_bytes(B, nnz) <= SMEM_OPTIN_BYTES


def _fn():
    fn = build.load("sdca_sparse_bucket").sdca_sparse_bucket_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, f, f, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def sdca_sparse_bucket_plain(obj: Objective, idx, val, yb, ab, qb, v0,
                             lam_n: float, sig: float):
    """The plain PyTorch version of `sdca_sparse_bucket_kernel`."""
    W, nb, B, nnz = idx.shape
    lam = torch.tensor(lam_n, dtype=torch.float32, device=idx.device)
    s = torch.tensor(sig, dtype=torch.float32, device=idx.device)
    a_new, v_fin = sdca.sparse_scan(
        obj, idx.reshape(W, nb * B, nnz), val.reshape(W, nb * B, nnz),
        yb.reshape(W, nb * B), ab.reshape(W, nb * B),
        qb.reshape(W, nb * B), v0, lam, s)
    return a_new.reshape(W, nb, B), v_fin


def sdca_sparse_bucket_kernel(obj: Objective, idx, val, yb, ab, qb, v0,
                              lam_n: float, sig: float,
                              source: str = "ad-hoc arrays"):
    """Run every worker's sparse sub-epoch.

    idx/val: (W, nb, B, nnz) int32/f32 bucket tiles in visiting order;
    yb, ab, qb: (W, nb, B) f32, qb the per-row sum(val^2) from
    `core.sdca.row_sq_norms`; v0: (W, d_pad) f32 per-worker replicas.
    Returns (a_new (W, nb, B), v_final (W, d_pad)); v_final includes the
    sigma'-scaled local evolution.
    """
    global launches
    if idx.device.type == "cpu":
        return sdca_sparse_bucket_plain(obj, idx, val, yb, ab, qb, v0,
                                        lam_n, sig)
    if idx.device.type != "cuda":
        raise ValueError(
            f"sdca_sparse_bucket_kernel: unsupported device {idx.device}")
    W, nb, B, nnz = idx.shape
    d_pad = v0.shape[-1]
    if not fits_smem(B, nnz):
        raise ValueError(
            f"sparse bucket tiles from {source} with (B={B}, nnz={nnz}) "
            f"need {smem_bytes(B, nnz)} bytes of shared memory per block, "
            f"over the {SMEM_OPTIN_BYTES}-byte opt-in.  Use a smaller "
            f"bucket, or local_solver='torch'.")
    for name, t, shape in (("val", val, (W, nb, B, nnz)),
                           ("yb", yb, (W, nb, B)), ("ab", ab, (W, nb, B)),
                           ("qb", qb, (W, nb, B)), ("v0", v0, (W, d_pad))):
        if tuple(t.shape) != shape or t.device != idx.device:
            raise ValueError(f"{name}: expected {shape} on {idx.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    idx = idx.to(torch.int32).contiguous()
    val, yb, ab, qb, v0 = (t.float().contiguous()
                           for t in (val, yb, ab, qb, v0))
    a_out = torch.empty_like(ab)
    v_out = torch.empty_like(v0)
    err = _fn()(idx.data_ptr(), val.data_ptr(), yb.data_ptr(), ab.data_ptr(),
                qb.data_ptr(), v0.data_ptr(), a_out.data_ptr(),
                v_out.data_ptr(), W, nb, B, nnz, d_pad, lam_n, sig,
                OBJ_CODES[obj.name], smem_bytes(B, nnz),
                torch.cuda.current_stream(idx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sdca_sparse_bucket kernel launch failed: CUDA error {err} "
            f"(W={W}, nb={nb}, B={B}, nnz={nnz}, d_pad={d_pad})")
    launches += 1
    return a_out, v_out
