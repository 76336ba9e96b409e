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
can run in its own process: each lane forms its packed [m0 | G]
partials from its rows of a bucket's tile, the caller sums them over
the model lanes in lane order, and every lane runs B1's recursion
(`csrc/dense_recursion.cuh`) on the sum and updates its rows of v.
`sdca_bucket_tp_step` does bucket b's solve and bucket b+1's partials
in one launch, the lane's rows staged in shared memory; its plain
version is `sdca_bucket_tp_solve_plain` then
`sdca_bucket_tp_partials_plain`.
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


#: the TP step's compute warps, the rows f = w (mod TP_COMPUTE_WARPS)
#: of warp w (csrc/sdca_bucket_tp.cu kComputeWarps); the block has a
#: chain warp and a producer warp beside them (kThreads)
TP_COMPUTE_WARPS = 8
TP_THREADS = 64 + 32 * TP_COMPUTE_WARPS
#: shared-memory slots of the step's ring and the floats of x and v rows
#: a slot is sized for (kSlots, kSlotFloats)
TP_SLOTS = 10
TP_SLOT_FLOATS = 4096
#: a lane's tile of G (kTile x kTile; 32 tiles a pass of the rows)
TP_TILE = 4
#: the worker's [m0 | G] is staged in shared memory up to this B
#: (kTotalSmemMaxB), else read in place
TP_TOTAL_SMEM_MAX_B = 64


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def tp_gram_tiles(B: int) -> int:
    """G's upper-triangle TP_TILE x TP_TILE tiles (`gram_tiles`)."""
    nt = -(-B // TP_TILE)
    return nt * (nt + 1) // 2


def tp_gram_passes(B: int) -> int:
    """Passes over bucket b+1's rows that form its G: 32 tiles a pass,
    one a lane."""
    return -(-tp_gram_tiles(B) // 32)


def tp_lane_groups(B: int) -> int:
    """Groups of lanes a compute warp splits its rows over while forming
    G (`lane_groups`): a pass's tiles fit a warp this many times."""
    return 32 // min(tp_gram_tiles(B), 32)


def tp_stage_rows(B: int) -> int:
    """Rows of a lane's span in one stage of the TP step (`layout_of` in
    csrc/sdca_bucket_tp.cu): as many as a slot's floats hold with their
    v rows, a multiple of the rows' groups (`TP_COMPUTE_WARPS` x
    `tp_lane_groups`), at least one per group."""
    ng = TP_COMPUTE_WARPS * tp_lane_groups(B)
    return max(TP_SLOT_FLOATS // (B + 1) // ng * ng, ng)


def tp_step_smem_bytes(B: int) -> int:
    """Dynamic shared memory of one `sdca_bucket_tp_step` block, as
    csrc/sdca_bucket_tp.cu's `layout_of` sizes it and its launcher
    requires: the slots' FULL and EMPTY mbarriers; `TP_SLOTS` slots of
    a stage's x rows and v rows (each with room for a 3-float offset);
    a row of partials per compute warp; two v_new buffers; a, y, q and
    the deltas; the worker's [m0 | G] up to `TP_TOTAL_SMEM_MAX_B`.  It
    does not depend on d_loc (the stages stream the rows); 183,328 B at
    B 16, above the 48 KiB a launch takes without opting in."""
    rows = tp_stage_rows(B)
    slot = _round4(rows * B + 3) + _round4(rows + 3)
    floats = (4 * TP_SLOTS + TP_SLOTS * slot
              + TP_COMPUTE_WARPS * 32 * TP_TILE * TP_TILE
              + 2 * _round4(rows) + 4 * _round4(B)
              + (_round4(B * (B + 1)) if B <= TP_TOTAL_SMEM_MAX_B else 0))
    return 4 * floats


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
# around the model lanes' exchange, bucket b's solve and bucket b+1's
# partials in one launch; `ops.sdca_bucket_tp_subepoch` drives it.
# ---------------------------------------------------------------------------

#: launches of the pair's step kernel, nb + 1 a sub-epoch (the plain
#: versions do not count)
tp_step_launches = 0


def _tp_lanes(xb, v, model_lanes: int):
    W, nb, d, B = xb.shape
    Mh = int(model_lanes)
    if Mh < 1 or d % Mh:
        raise ValueError(f"tensor-parallel tiles of {d} rows do not split "
                         f"into {Mh} lanes")
    return W, nb, d, B, Mh, d // Mh


def sdca_bucket_tp_partials_plain(xb, v, b: int, model_lanes: int):
    """Bucket `b`'s packed [m0 | G] partials of every held lane, plain
    PyTorch (`core.sdca.tp_partials`): xb (W, nb, Mh*d_loc, B) f32
    tiles, each worker's held lanes' rows stacked in lane order
    (`ops.dense_tiles`); v (W, Mh*d_loc) the lanes' slices of v ->
    (W, Mh, B, 1 + B), column 0 m0 = X_m^T v_m, column 1 + i G's
    column i."""
    W, nb, d, B, Mh, d_loc = _tp_lanes(xb, v, model_lanes)
    return sdca.tp_partials(xb[:, b].reshape(W, Mh, d_loc, B),
                            v.reshape(W, Mh, d_loc))


def sdca_bucket_tp_solve_plain(obj: Objective, total, xb, yb, ab, v,
                               b: int, lam_n: float, sig: float,
                               model_lanes: int):
    """Bucket `b`'s recursion on every held lane from its worker's
    lane-summed partials total (W, B, 1 + B), and each lane's update of
    its rows of v (W, Mh*d_loc), IN PLACE; plain PyTorch
    (`core.sdca.tp_solve`).  Returns a_new (W, Mh, B): every held
    lane's copy of the bucket's duals (all equal)."""
    W, nb, d, B, Mh, d_loc = _tp_lanes(xb, v, model_lanes)
    lam = torch.tensor(lam_n, dtype=torch.float32, device=xb.device)
    s = torch.tensor(sig, dtype=torch.float32, device=xb.device)
    deltas, v_new = sdca.tp_solve(
        obj, total, xb[:, b].reshape(W, Mh, d_loc, B), ab[:, b], yb[:, b],
        v.reshape(W, Mh, d_loc), lam, s)
    v.copy_(v_new.reshape(W, d))
    return (ab[:, b] + deltas)[:, None].expand(W, Mh, B).contiguous()


def sdca_bucket_tp_step(obj: Objective, total, xb, yb, ab, v, b: int,
                        lam_n: float, sig: float, *, model_lanes: int,
                        source: str = "ad-hoc arrays"):
    """Bucket `b`'s solve and bucket b+1's partials on every held lane,
    in one launch.

    b >= 0: the recursion on the worker's lane-summed partials ``total``
    (W, B, 1 + B) and each lane's update of its rows of v; b + 1 < nb:
    bucket b+1's packed [m0 | G] from the updated v.  b = -1 forms
    bucket 0's partials alone (``total`` unused).  xb (W, nb,
    Mh*d_loc, B) f32, each worker's held lanes' rows stacked in lane
    order; yb/ab (W, nb, B); v (W, Mh*d_loc) f32, UPDATED IN PLACE.
    Returns (a_new (W, Mh, B) or None, parts (W, Mh, B, 1 + B) or None):
    every held lane's copy of bucket b's duals (all equal) and the
    partials, column 0 m0 = X_m^T v_m, column 1 + i G's column i.
    """
    global tp_step_launches
    W, nb, d, B, Mh, d_loc = _tp_lanes(xb, v, model_lanes)
    nxt = b + 1 if b + 1 < nb else -1
    if xb.device.type == "cpu":
        a_new = (sdca_bucket_tp_solve_plain(obj, total, xb, yb, ab, v, b,
                                            lam_n, sig, model_lanes)
                 if b >= 0 else None)
        parts = (sdca_bucket_tp_partials_plain(xb, v, nxt, model_lanes)
                 if nxt >= 0 else None)
        return a_new, parts
    if xb.device.type != "cuda":
        raise ValueError(
            f"sdca_bucket_tp_step: unsupported device {xb.device}")
    if B > MAX_BUCKET or not -1 <= b < nb:
        raise ValueError(f"dense tiles from {source}: bucket {b} of {nb}, "
                         f"B={B} (at most {MAX_BUCKET})")
    dev = xb.device
    for name, t, shape in ((("total", total, (W, B, B + 1)),) if b >= 0
                           else ()) + (
            ("xb", xb, (W, nb, d, B)), ("yb", yb, (W, nb, B)),
            ("ab", ab, (W, nb, B)), ("v", v, (W, d))):
        check_tensor(name, t, shape, torch.float32, dev)
    a_new = (torch.empty((W, Mh, B), dtype=torch.float32, device=dev)
             if b >= 0 else None)
    parts = (torch.empty((W, Mh, B, B + 1), dtype=torch.float32,
                         device=dev) if nxt >= 0 else None)
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    err = c_entry("sdca_bucket_tp", "ppppppp" "iiiiiii" "ff" "ii" "p",
                  "sdca_bucket_tp_step_launch")(
        ptr(total if b >= 0 else None), xb.data_ptr(), yb.data_ptr(),
        ab.data_ptr(), v.data_ptr(), ptr(a_new), ptr(parts), W, Mh, nb, b,
        nxt, d_loc, B, lam_n, sig, OBJ_CODES[obj.name],
        tp_step_smem_bytes(B), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sdca_bucket_tp_step kernel launch failed on "
                           f"tiles from {source}: CUDA error {err} (W={W}, "
                           f"Mh={Mh}, d_loc={d_loc}, B={B}, b={b})")
    tp_step_launches += 1
    return a_new, parts
