"""Dense bucketed SDCA sub-epoch: the CUDA kernel and its plain version.

`sdca_bucket_kernel` runs every worker's pass over its (d x B) bucket
tiles: one thread block per worker, all workers in one launch
(`csrc/sdca_bucket.cu`, which replaces the reference's Pallas kernel
`repro/kernels/sdca_bucket.py:sdca_bucket_kernel`).  On a CPU tensor
the same function runs `sdca_bucket_plain`, the plain PyTorch version;
on a CUDA tensor it launches the kernel or raises.

d and B need no alignment (`ops.dense_tiles` pads neither).  B is
capped at `MAX_BUCKET`.

The tensor-parallel pair (`csrc/sdca_bucket_tp.cu`) splits the same
arithmetic around the model lanes' per-bucket exchange, so that a lane
can run in its own process: `sdca_bucket_tp_partials` forms each lane's
packed [m0 | G] partials from its rows of a bucket's tile, the caller
sums them over the model lanes in lane order, and
`sdca_bucket_tp_solve` runs the recursion on the sum and updates each
lane's rows of v.  The sums and the recursion are B1's
(`csrc/dense_recursion.cuh`).
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


def tp_solve_smem_bytes(B: int) -> int:
    """Dynamic shared memory of one `sdca_bucket_tp_solve` block: the
    bucket's a, y, q and deltas (4 B each a coordinate), as
    csrc/sdca_bucket_tp.cu's launcher sizes it (8 KiB at `MAX_BUCKET`,
    within the 48 KiB a launch takes without opting in)."""
    return 4 * B * 4


def c_entry(stem: str, argtypes: str, entry: str = ""):
    """The C entry point of `csrc/<stem>.cu` (``entry``, by default
    ``<stem>_launch``), built at first use; argtypes: p pointer, i int,
    f float, one letter each."""
    fn = getattr(build.load(stem), entry or f"{stem}_launch")
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    fn.argtypes = [kinds[c] for c in argtypes]
    fn.restype = ctypes.c_int
    return fn


def check_tensor(name, t, shape, dtype, device):
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` (what a kernel's pointer arithmetic assumes)."""
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
            + ("" if t.is_contiguous() else " (not contiguous)"))


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
    err = c_entry("sdca_bucket", "ppppppp" "iiii" "ff" "iiii" "p")(
        xb.data_ptr(), yb.data_ptr(), ab.data_ptr(), v0.data_ptr(),
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


# ---------------------------------------------------------------------------
# Tensor-parallel pair (`csrc/sdca_bucket_tp.cu`): B1's arithmetic split
# around the model lanes' exchange, one launch of each per bucket;
# `ops.sdca_bucket_tp_subepoch` drives them.
# ---------------------------------------------------------------------------

#: launches of the pair's two kernels (the plain versions do not count)
tp_partials_launches = 0
tp_solve_launches = 0


def _tp_lanes(xb, v, model_lanes: int):
    W, nb, d, B = xb.shape
    Mh = int(model_lanes)
    if Mh < 1 or d % Mh:
        raise ValueError(f"tensor-parallel tiles of {d} rows do not split "
                         f"into {Mh} lanes")
    return W, nb, d, B, Mh, d // Mh


def sdca_bucket_tp_partials_plain(xb, v, b: int, model_lanes: int):
    """The plain PyTorch version of `sdca_bucket_tp_partials`
    (`core.sdca.tp_partials`)."""
    W, nb, d, B, Mh, d_loc = _tp_lanes(xb, v, model_lanes)
    return sdca.tp_partials(xb[:, b].reshape(W, Mh, d_loc, B),
                            v.reshape(W, Mh, d_loc))


def sdca_bucket_tp_partials(xb, v, b: int, *, model_lanes: int,
                            source: str = "ad-hoc arrays"):
    """Bucket `b`'s packed [m0 | G] partials of every held lane.

    xb: (W, nb, Mh*d_loc, B) f32 tiles, each worker's held lanes' rows
    stacked in lane order (`ops.dense_tiles`); v: (W, Mh*d_loc) f32 the
    lanes' slices of v.  Returns (W, Mh, B, 1 + B): column 0 is
    m0 = X_m^T v_m, column 1 + i is G's column i, each a sum over the
    lane's rows in B1's order.
    """
    global tp_partials_launches
    if xb.device.type == "cpu":
        return sdca_bucket_tp_partials_plain(xb, v, b, model_lanes)
    if xb.device.type != "cuda":
        raise ValueError(
            f"sdca_bucket_tp_partials: unsupported device {xb.device}")
    W, nb, d, B, Mh, d_loc = _tp_lanes(xb, v, model_lanes)
    if B > MAX_BUCKET or not 0 <= b < nb:
        raise ValueError(f"dense tiles from {source}: bucket {b} of {nb}, "
                         f"B={B} (at most {MAX_BUCKET})")
    check_tensor("xb", xb, (W, nb, d, B), torch.float32, xb.device)
    check_tensor("v", v, (W, d), torch.float32, xb.device)
    out = torch.empty((W, Mh, B, B + 1), dtype=torch.float32,
                      device=xb.device)
    err = c_entry("sdca_bucket_tp", "ppp" "iiiiii" "p",
                  "sdca_bucket_tp_partials_launch")(
        xb.data_ptr(), v.data_ptr(), out.data_ptr(), W, Mh, nb, b, d_loc, B,
        torch.cuda.current_stream(xb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sdca_bucket_tp_partials kernel launch failed "
                           f"on tiles from {source}: CUDA error {err} "
                           f"(W={W}, Mh={Mh}, d_loc={d_loc}, B={B})")
    tp_partials_launches += 1
    return out


def sdca_bucket_tp_solve_plain(obj: Objective, total, xb, yb, ab, v,
                               b: int, lam_n: float, sig: float,
                               model_lanes: int):
    """The plain PyTorch version of `sdca_bucket_tp_solve`
    (`core.sdca.tp_solve`); v is updated in place."""
    W, nb, d, B, Mh, d_loc = _tp_lanes(xb, v, model_lanes)
    lam = torch.tensor(lam_n, dtype=torch.float32, device=xb.device)
    s = torch.tensor(sig, dtype=torch.float32, device=xb.device)
    deltas, v_new = sdca.tp_solve(
        obj, total, xb[:, b].reshape(W, Mh, d_loc, B), ab[:, b], yb[:, b],
        v.reshape(W, Mh, d_loc), lam, s)
    v.copy_(v_new.reshape(W, d))
    return (ab[:, b] + deltas)[:, None].expand(W, Mh, B).contiguous()


def sdca_bucket_tp_solve(obj: Objective, total, xb, yb, ab, v, b: int,
                         lam_n: float, sig: float, *, model_lanes: int,
                         source: str = "ad-hoc arrays"):
    """Bucket `b`'s recursion on every held lane from its worker's
    lane-summed partials, and each lane's update of its rows of v.

    total: (W, B, 1 + B) f32, the sum over every model lane of the
    `sdca_bucket_tp_partials`; xb (W, nb, Mh*d_loc, B); yb/ab (W, nb,
    B); v (W, Mh*d_loc) f32, UPDATED IN PLACE.  Returns a_new (W, Mh,
    B): every held lane's copy of the bucket's duals (all equal).
    """
    global tp_solve_launches
    if xb.device.type == "cpu":
        return sdca_bucket_tp_solve_plain(obj, total, xb, yb, ab, v, b,
                                          lam_n, sig, model_lanes)
    if xb.device.type != "cuda":
        raise ValueError(
            f"sdca_bucket_tp_solve: unsupported device {xb.device}")
    W, nb, d, B, Mh, d_loc = _tp_lanes(xb, v, model_lanes)
    if B > MAX_BUCKET or not 0 <= b < nb:
        raise ValueError(f"dense tiles from {source}: bucket {b} of {nb}, "
                         f"B={B} (at most {MAX_BUCKET})")
    dev = xb.device
    for name, t, shape in (("total", total, (W, B, B + 1)),
                           ("xb", xb, (W, nb, d, B)), ("yb", yb, (W, nb, B)),
                           ("ab", ab, (W, nb, B)), ("v", v, (W, d))):
        check_tensor(name, t, shape, torch.float32, dev)
    a_out = torch.empty((W, Mh, B), dtype=torch.float32, device=dev)
    err = c_entry("sdca_bucket_tp", "pppppp" "iiiiii" "ff" "i" "p",
                  "sdca_bucket_tp_solve_launch")(
        total.data_ptr(), xb.data_ptr(), yb.data_ptr(), ab.data_ptr(),
        v.data_ptr(), a_out.data_ptr(), W, Mh, nb, b, d_loc, B, lam_n, sig,
        OBJ_CODES[obj.name], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sdca_bucket_tp_solve kernel launch failed on "
                           f"tiles from {source}: CUDA error {err} (W={W}, "
                           f"Mh={Mh}, d_loc={d_loc}, B={B})")
    tp_solve_launches += 1
    return a_out
