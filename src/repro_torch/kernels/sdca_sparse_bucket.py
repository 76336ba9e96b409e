"""Sparse bucketed SDCA sub-epoch: the CUDA kernels and their plain versions.

`sdca_sparse_bucket_kernel` (replicated v) runs every worker's pass
over its padded-CSR (B x nnz) bucket tiles against a per-worker
replica of v held in global memory: one thread block per worker, all
workers in one launch
(`csrc/sdca_sparse_bucket.cu`, which replaces the reference's Pallas
kernel `repro/kernels/sdca_sparse_bucket.py:sdca_sparse_bucket_kernel`).
One chain warp walks each row over the bucket's links
(`csrc/sparse_recursion.cuh`) while producer warps build the next
bucket's links and working set in shared memory.
On a CPU tensor it runs `sdca_sparse_bucket_plain`; on a CUDA tensor it
launches the kernel or raises.

The kernel is BITWISE equal to the plain scan on the same card: both
sum margins left to right, form u = (sigma' delta / lam_n) * val once
and add it entry by entry in visiting order, with no fused multiply-add
(the source is built with -fmad=false), and both read q = sum val^2
precomputed by `core.sdca.row_sq_norms`.

Feature-sharded pair (every `model` lane owns a d_loc slice of v; the
driver is `ops.sdca_sparse_sharded_subepoch`, which exchanges the
lanes' partial working sets between the two launches of each bucket):

  * `sdca_sparse_gather_bucket` (`csrc/sdca_sparse_gather_bucket.cu`,
    replaces `sdca_sparse_gather_bucket` of the reference): one lane's
    partial working set, v_slice[idx - lo] where the lane owns the
    feature, else exact +0.0;
  * `sdca_sparse_sharded_bucket` (`csrc/sdca_sparse_sharded_bucket.cu`,
    replaces `sdca_sparse_sharded_bucket`): the bucket's recursion on
    the exchanged working set, on every lane, then the scatter of the
    entries the lane owns into its slice, in visiting order.

Both are bitwise equal to their plain versions on the same card; the
pair together is bitwise equal to the replicated scan.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import sdca
from repro_torch.core.objectives import Objective
from . import build
from .contracts import SMEM_OPTIN_BYTES
from .sdca_bucket import OBJ_CODES

#: shared-memory stages the replicated kernel's producer warps fill
#: ahead of its chain warp (`kStages` in csrc/sdca_sparse_bucket.cu)
STAGES = 2
#: link planes of the sharded kernel (`ops.sharded_tiles`)
LINK_PLANES = 5

#: launches of each CUDA kernel (the plain versions do not count)
launches = 0
gather_launches = 0
sharded_launches = 0


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def table_cells(E: int) -> int:
    """Cells of the replicated kernel's hash table of a bucket's ids:
    the power of two at or above 2E (`table_bits` in the source)."""
    return 1 << (2 * E - 1).bit_length()


def region_words(B: int, nnz: int) -> int:
    """4-byte words of the replicated kernel's stage region (`carve` in
    csrc/sdca_sparse_bucket.cu): the producers' copy of the bucket's ids
    (E = B*nnz), and two stages of val, slot, run_len, rpos, rval (val
    in run order), the distinct ids' cells and the patch pairs (8E), the
    hash table and the cells' values (2H, `table_cells`), a, y,
    sigma' q / lam_n (3B) and 4 counts."""
    E = B * nnz
    return E + STAGES * (8 * E + 2 * table_cells(E) + 3 * B + 4)


def smem_bytes(B: int, nnz: int) -> int:
    """Dynamic shared memory of one replicated-kernel block with its
    stages in it: the chain's row of products (nnz, rounded up to 4)
    and the stage region (`region_words`)."""
    return 4 * (_round4(nnz) + region_words(B, nnz))


def fits_smem(B: int, nnz: int) -> bool:
    """Whether the stage region fits shared memory; a larger bucket
    keeps it in global memory, one region per block, with the same
    code."""
    return smem_bytes(B, nnz) <= SMEM_OPTIN_BYTES


#: products per published chunk of the sharded kernel's row
#: (`kChunk` in csrc/sdca_sparse_sharded_bucket.cu)
SHARDED_CHUNK = 256


def sharded_row_words(nnz: int) -> int:
    """4-byte words of one row's operands in the sharded kernel (`carve`
    in csrc/sdca_sparse_sharded_bucket.cu): products, update values,
    val, slot, run_len and rpos (nnz each, rounded up to 4)."""
    return 6 * _round4(nnz)


def sharded_smem_bytes(nnz: int) -> int:
    """Dynamic shared memory of one sharded-kernel block with the row's
    operands in it (`sharded_row_words`), a ready flag per chunk of
    products and the row's coefficient."""
    return 4 * (sharded_row_words(nnz) + -(-nnz // SHARDED_CHUNK) + 1)


def sharded_fits_smem(nnz: int) -> bool:
    """Whether a row's operands fit shared memory; a wider row keeps
    them in a global scratch row per block, with the same code."""
    return sharded_smem_bytes(nnz) <= SMEM_OPTIN_BYTES


def _fn(stem: str, argtypes: str):
    """The C entry point `<stem>_launch`; argtypes: p pointer, i int,
    f float, one letter each."""
    fn = getattr(build.load(stem), f"{stem}_launch")
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    fn.argtypes = [kinds[c] for c in argtypes]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtype, device):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
            + ("" if t.is_contiguous() else " (not contiguous)"))


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
    stages, smem = None, smem_bytes(B, nnz)
    if not fits_smem(B, nnz):
        stages = torch.empty((W, region_words(B, nnz)), dtype=torch.float32,
                             device=idx.device)
        smem = 4 * _round4(nnz)
    fn = _fn("sdca_sparse_bucket", "ppppppppp" "iiiii" "ff" "ii" "p")
    err = fn(idx.data_ptr(), val.data_ptr(), yb.data_ptr(), ab.data_ptr(),
             qb.data_ptr(), v0.data_ptr(), a_out.data_ptr(),
             v_out.data_ptr(), None if stages is None else stages.data_ptr(),
             W, nb, B, nnz, d_pad, lam_n, sig, OBJ_CODES[obj.name], smem,
             torch.cuda.current_stream(idx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sdca_sparse_bucket kernel launch failed on tiles from "
            f"{source}: CUDA error {err} (W={W}, nb={nb}, B={B}, "
            f"nnz={nnz}, d_pad={d_pad})")
    launches += 1
    return a_out, v_out


# ---------------------------------------------------------------------------
# Feature-sharded pair: one launch of each per bucket, over every
# (worker, lane) block; `ops.sdca_sparse_sharded_subepoch` drives them and
# `ops.sharded_tiles` lays out their arguments.
# ---------------------------------------------------------------------------


def sdca_sparse_gather_plain(idxb, b: int, v_loc):
    """The plain PyTorch version of `sdca_sparse_gather_bucket`."""
    Wk, M, d_loc = v_loc.shape
    idx = idxb[:, b].long()                                 # (Wk, B, nnz)
    lo = torch.arange(M, device=idx.device).view(1, M, 1, 1) * d_loc
    q = idx[:, None] - lo                                   # (Wk, M, B, nnz)
    own = (q >= 0) & (q < d_loc)
    w = torch.gather(v_loc, 2, q.clamp(0, d_loc - 1).reshape(Wk, M, -1))
    return torch.where(own, w.reshape(q.shape),
                       torch.zeros((), dtype=v_loc.dtype, device=idx.device))


def sdca_sparse_gather_bucket(idxb, b: int, v_loc,
                              source: str = "ad-hoc arrays"):
    """Every lane's partial working set of bucket `b`.

    idxb: (Wk, nb, B, nnz) int32 bucket tiles; v_loc: (Wk, M, d_loc) f32,
    lane m of worker w owning features [m*d_loc, (m+1)*d_loc).  Returns
    W_loc (Wk, M, B, nnz) f32: v_loc[w, m, idx - m*d_loc] where lane m
    owns the feature, exact +0.0 elsewhere.
    """
    global gather_launches
    if idxb.device.type == "cpu":
        return sdca_sparse_gather_plain(idxb, b, v_loc)
    if idxb.device.type != "cuda":
        raise ValueError(
            f"sdca_sparse_gather_bucket: unsupported device {idxb.device}")
    Wk, nb, B, nnz = idxb.shape
    M, d_loc = v_loc.shape[1:]
    dev = idxb.device
    _check("idxb", idxb, (Wk, nb, B, nnz), torch.int32, dev)
    _check("v_loc", v_loc, (Wk, M, d_loc), torch.float32, dev)
    if not 0 <= b < nb or Wk * M > 65_535:
        raise ValueError(f"sparse tiles from {source}: bucket {b} of {nb}, "
                         f"{Wk * M} (worker, lane) blocks (at most 65,535)")
    out = torch.empty((Wk, M, B, nnz), dtype=torch.float32, device=dev)
    fn = _fn("sdca_sparse_gather_bucket", "ppp" "iiiiii" "p")
    err = fn(idxb.data_ptr(), v_loc.data_ptr(), out.data_ptr(), Wk * M, M,
             nb, b, B * nnz, d_loc, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sdca_sparse_gather_bucket kernel launch failed: CUDA error "
            f"{err} (Wk={Wk}, M={M}, B={B}, nnz={nnz}, d_loc={d_loc})")
    gather_launches += 1
    return out


def sdca_sparse_sharded_plain(obj: Objective, idxb, valb, yb, ab, qb, links,
                              b: int, W, v_loc, lam_n: float, sig: float):
    """The plain PyTorch version of `sdca_sparse_sharded_bucket`.

    It does not read `links`: it runs the scan of `core.sdca.sparse_scan`
    over the bucket's rows on two full-width vectors per block, one
    holding the exchanged working set W (what the margins read) and one
    holding the lane's slice (what the owned entries are scattered
    into), so it checks the kernel's layout as well as its arithmetic.
    """
    del links
    Wk, M, d_loc = v_loc.shape
    G, dev = Wk * M, v_loc.device
    nnz = idxb.shape[-1]
    lam = torch.tensor(lam_n, dtype=torch.float32, device=dev)
    s = torch.tensor(sig, dtype=torch.float32, device=dev)

    def per_lane(t):                     # (Wk, ...) -> (G, ...)
        return t[:, None].expand((Wk, M) + tuple(t.shape[1:])).reshape(
            (G,) + tuple(t.shape[1:]))

    idx, val = per_lane(idxb[:, b].long()), per_lane(valb[:, b])
    y, a, q = (per_lane(t[:, b]) for t in (yb, ab, qb))
    vw = torch.zeros((G, M * d_loc), dtype=torch.float32, device=dev)
    vw.scatter_(1, idx.reshape(G, -1), W.reshape(G, -1))
    vs = torch.zeros((Wk, M, M, d_loc), dtype=torch.float32, device=dev)
    torch.diagonal(vs, dim1=1, dim2=2).copy_(v_loc.transpose(1, 2))
    V = torch.cat([vw, vs.reshape(G, -1)])                  # (2G, d_pad)
    a_new = torch.empty_like(a)
    for i in range(idx.shape[1]):
        ii, vv = idx[:, i], val[:, i]
        wi = torch.gather(V[:G], 1, ii)
        m = torch.zeros(G, dtype=torch.float32, device=dev)
        for k in range(nnz):
            m = m + wi[:, k] * vv[:, k]
        d = obj.delta(m, a[:, i], y[:, i], s * q[:, i] / lam)
        u = (s * d / lam)[:, None] * vv
        ii2, u2 = torch.cat([ii, ii]), torch.cat([u, u])
        for k in range(nnz):
            col = ii2[:, k:k + 1]
            V.scatter_(1, col, V.gather(1, col) + u2[:, k:k + 1])
        a_new[:, i] = a[:, i] + d
    vs = V[G:].reshape(Wk, M, M, d_loc)
    v_loc.copy_(torch.diagonal(vs, dim1=1, dim2=2).transpose(1, 2))
    return a_new.reshape(Wk, M, -1)


def sdca_sparse_sharded_bucket(obj: Objective, idxb, valb, yb, ab, qb,
                               links, b: int, W, v_loc, lam_n: float,
                               sig: float, source: str = "ad-hoc arrays"):
    """Bucket `b`'s recursion on every lane, and the owned scatter.

    idxb/valb: (Wk, nb, B, nnz) int32/f32; yb/ab/qb: (Wk, nb, B) f32;
    links: (Wk, nb, 5, B*nnz) int32 from `ops.sharded_tiles`; W: (Wk, M,
    B, nnz) f32 the EXCHANGED working set, `ops.exchange_working_set` of
    this v_loc's partial working sets (the same bits on every lane of a
    worker, and the lane's own slice bits where it owns the feature: the
    kernel's scatter relies on it); v_loc: (Wk, M, d_loc) f32, UPDATED
    IN PLACE (each lane adds its owned entries' updates into its slice,
    in visiting order).
    Returns a_new (Wk, M, B): every lane's copy of the bucket's duals.
    """
    global sharded_launches
    if idxb.device.type == "cpu":
        return sdca_sparse_sharded_plain(obj, idxb, valb, yb, ab, qb, links,
                                         b, W, v_loc, lam_n, sig)
    if idxb.device.type != "cuda":
        raise ValueError(
            f"sdca_sparse_sharded_bucket: unsupported device {idxb.device}")
    Wk, nb, B, nnz = idxb.shape
    M, d_loc = v_loc.shape[1:]
    E, dev, f32 = B * nnz, idxb.device, torch.float32
    for name, t, shape, dt in (
            ("idxb", idxb, (Wk, nb, B, nnz), torch.int32),
            ("valb", valb, (Wk, nb, B, nnz), f32),
            ("yb", yb, (Wk, nb, B), f32), ("ab", ab, (Wk, nb, B), f32),
            ("qb", qb, (Wk, nb, B), f32),
            ("links", links, (Wk, nb, LINK_PLANES, E), torch.int32),
            ("W", W, (Wk, M, B, nnz), f32),
            ("v_loc", v_loc, (Wk, M, d_loc), f32)):
        _check(name, t, shape, dt, dev)
    if not 0 <= b < nb:
        raise ValueError(f"sparse tiles from {source}: bucket {b} of {nb}")
    a_out = torch.empty((Wk, M, B), dtype=f32, device=dev)
    S = torch.empty((Wk * M, E), dtype=f32, device=dev)     # scratch
    rows, smem = None, sharded_smem_bytes(nnz)
    if not sharded_fits_smem(nnz):
        rows = torch.empty((Wk * M, sharded_row_words(nnz)), dtype=f32,
                           device=dev)
        smem -= 4 * sharded_row_words(nnz)
    fn = _fn("sdca_sparse_sharded_bucket", "ppppp" "pppppp" "iiiiiii" "ff"
             "ii" "p")
    err = fn(idxb.data_ptr(), valb.data_ptr(), yb.data_ptr(), ab.data_ptr(),
             qb.data_ptr(), links.data_ptr(), W.data_ptr(),
             v_loc.data_ptr(), a_out.data_ptr(), S.data_ptr(),
             None if rows is None else rows.data_ptr(),
             Wk * M, M, nb, b, B, nnz, d_loc, lam_n, sig,
             OBJ_CODES[obj.name], smem,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sdca_sparse_sharded_bucket kernel launch failed: CUDA error "
            f"{err} (Wk={Wk}, M={M}, B={B}, nnz={nnz}, d_loc={d_loc})")
    sharded_launches += 1
    return a_out
