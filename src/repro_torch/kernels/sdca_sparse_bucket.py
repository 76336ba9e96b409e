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
driver is `ops.sdca_sparse_sharded_subepoch`, two launches per bucket):

  * `sdca_sparse_gather_bucket` (`csrc/sdca_sparse_gather_bucket.cu`,
    replaces `sdca_sparse_gather_bucket` of the reference and the
    all-gather and owner-select after it): each worker's working set,
    every entry the bits of the held slice that owns its feature
    (exact +0.0 where none is held); with all M slices held that is
    the exchanged working set, with one it is the reference's
    per-lane partial;
  * `sdca_sparse_sharded_bucket` (`csrc/sdca_sparse_sharded_bucket.cu`,
    replaces `sdca_sparse_sharded_bucket`): the bucket's recursion on
    the exchanged working set, on every lane, then the scatter of the
    entries the lane owns into its slice, in visiting order.

Both are bitwise equal to their plain versions on the same card; the
pair together is bitwise equal to the replicated scan.
"""
from __future__ import annotations

import torch

from repro_torch.core import sdca
from repro_torch.core.objectives import Objective
from . import build
from .contracts import SMEM_OPTIN_BYTES
from .sdca_bucket import OBJ_CODES, c_entry, check_tensor

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


def row_fits_smem(nnz: int) -> bool:
    """Whether the chain's row of products fits shared memory, where it
    stays in both layouts: up to 58,112 nonzeros at the H100's opt-in;
    a wider row is a misfit of the replicated kernel
    (`ops.sparse_solver_plan`)."""
    return 4 * _round4(nnz) <= SMEM_OPTIN_BYTES


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
    if not row_fits_smem(nnz):
        raise ValueError(
            f"sdca_sparse_bucket_kernel: rows of {nnz} nonzeros need "
            f"{4 * _round4(nnz)} B of shared memory for their products, "
            f"above the {SMEM_OPTIN_BYTES}-byte opt-in")
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
    fn = c_entry("sdca_sparse_bucket", "ppppppppp" "iiiii" "ff" "ii" "p")
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
# Feature-sharded pair: one launch of each per bucket, the gather over
# every worker, the recursion over every (worker, lane) block;
# `ops.sdca_sparse_sharded_subepoch` drives them and `ops.sharded_tiles`
# lays out their arguments.
# ---------------------------------------------------------------------------


def sdca_sparse_gather_plain(idxb, b: int, v_held, m0: int = 0):
    """The plain PyTorch version of `sdca_sparse_gather_bucket`."""
    Wk, Mh, d_loc = v_held.shape
    span = Mh * d_loc
    q = idxb[:, b].reshape(Wk, -1).long() - m0 * d_loc      # (Wk, E)
    held = (q >= 0) & (q < span)
    w = torch.gather(v_held.reshape(Wk, span), 1, q.clamp(0, span - 1))
    out = torch.where(held, w, torch.zeros((), dtype=v_held.dtype,
                                           device=v_held.device))
    return out.reshape(idxb[:, b].shape)


def sdca_sparse_gather_bucket(idxb, b: int, v_held, m0: int = 0, *,
                              source: str = "ad-hoc arrays"):
    """Bucket `b`'s working set from the held v slices.

    idxb: (Wk, nb, B, nnz) int32 bucket tiles; v_held: (Wk, Mh, d_loc)
    f32, the slices of lanes m0 .. m0+Mh-1 (lane m owns features
    [m*d_loc, (m+1)*d_loc)).  Returns W (Wk, B, nnz) f32: each entry
    whose owner id // d_loc is held gets that slice's bits,
    v_held[w, owner - m0, id - owner*d_loc]; any other entry exact
    +0.0.  With every slice held (Mh = M, m0 = 0) W is the exchanged
    working set that `sdca_sparse_sharded_bucket` reads; with Mh = 1,
    m0 = m it is lane m's partial working set, the reference kernel's.
    """
    global gather_launches
    if idxb.device.type == "cpu":
        return sdca_sparse_gather_plain(idxb, b, v_held, m0)
    if idxb.device.type != "cuda":
        raise ValueError(
            f"sdca_sparse_gather_bucket: unsupported device {idxb.device}")
    Wk, nb, B, nnz = idxb.shape
    Mh, d_loc = v_held.shape[1:]
    dev = idxb.device
    check_tensor("idxb", idxb, (Wk, nb, B, nnz), torch.int32, dev)
    check_tensor("v_held", v_held, (Wk, Mh, d_loc), torch.float32, dev)
    if (not 0 <= b < nb or Wk > 65_535 or m0 < 0
            or (m0 + Mh) * d_loc >= 2 ** 31):
        raise ValueError(
            f"sparse tiles from {source}: bucket {b} of {nb}, {Wk} workers "
            f"(at most 65,535), slices {m0}..{m0 + Mh - 1} of {d_loc} "
            f"features (ids must stay below 2^31)")
    out = torch.empty((Wk, B, nnz), dtype=torch.float32, device=dev)
    fn = c_entry("sdca_sparse_gather_bucket", "ppp" "iiiiiii" "p")
    err = fn(idxb.data_ptr(), v_held.data_ptr(), out.data_ptr(), Wk, nb, b,
             B * nnz, Mh, m0, d_loc,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sdca_sparse_gather_bucket kernel launch failed: CUDA error "
            f"{err} (Wk={Wk}, Mh={Mh}, m0={m0}, B={B}, nnz={nnz}, "
            f"d_loc={d_loc})")
    gather_launches += 1
    return out


def sdca_sparse_sharded_plain(obj: Objective, idxb, valb, yb, ab, qb, links,
                              b: int, W, v_loc, lam_n: float, sig: float,
                              m0: int = 0):
    """The plain PyTorch version of `sdca_sparse_sharded_bucket`.

    It does not read `links`: it runs the scan of `core.sdca.sparse_scan`
    over the bucket's rows on two full-width vectors per block, one
    holding its worker's exchanged working set W (what the margins
    read) and one holding the lane's slice at its place in v (what the
    owned entries are scattered into), so it checks the kernel's layout
    as well as its arithmetic.
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
    span = max((m0 + M) * d_loc, int(idx.max()) + 1 if idx.numel() else 0)
    vw = torch.zeros((G, span), dtype=torch.float32, device=dev)
    vw.scatter_(1, idx.reshape(G, -1), per_lane(W).reshape(G, -1))
    vs = torch.zeros((Wk, M, span), dtype=torch.float32, device=dev)
    for h in range(M):
        lo = (m0 + h) * d_loc
        vs[:, h, lo:lo + d_loc] = v_loc[:, h]
    V = torch.cat([vw, vs.reshape(G, -1)])                  # (2G, span)
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
    vs = V[G:].reshape(Wk, M, span)
    for h in range(M):
        lo = (m0 + h) * d_loc
        v_loc[:, h] = vs[:, h, lo:lo + d_loc]
    return a_new.reshape(Wk, M, -1)


def sdca_sparse_sharded_bucket(obj: Objective, idxb, valb, yb, ab, qb,
                               links, b: int, W, v_loc, lam_n: float,
                               sig: float, source: str = "ad-hoc arrays",
                               m0: int = 0):
    """Bucket `b`'s recursion on every held lane, and the owned scatter.

    idxb/valb: (Wk, nb, B, nnz) int32/f32; yb/ab/qb: (Wk, nb, B) f32;
    links: (Wk, nb, 5, B*nnz) int32 from `ops.sharded_tiles`; W: (Wk, B,
    nnz) f32 the EXCHANGED working set, one per worker, read by each of
    its lanes: `sdca_sparse_gather_bucket(idxb, b, v_loc)` of this very
    v_loc (each entry the owner slice's own bits: the kernel's scatter
    relies on it, and with any other W only the plain version is
    right); v_loc: (Wk, M, d_loc) f32, the slices of lanes m0 .. m0+M-1
    (every lane, m0 = 0, on a stacked mesh; the rank's own, M = 1 and
    m0 = its lane, on a process mesh), UPDATED IN PLACE (each lane adds
    its owned entries' updates into its slice, in visiting order).
    Returns a_new (Wk, M, B): every held lane's copy of the bucket's
    duals.
    """
    global sharded_launches
    if idxb.device.type == "cpu":
        return sdca_sparse_sharded_plain(obj, idxb, valb, yb, ab, qb, links,
                                         b, W, v_loc, lam_n, sig, m0)
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
            ("W", W, (Wk, B, nnz), f32),
            ("v_loc", v_loc, (Wk, M, d_loc), f32)):
        check_tensor(name, t, shape, dt, dev)
    if not 0 <= b < nb or m0 < 0 or (m0 + M) * d_loc >= 2 ** 31:
        raise ValueError(f"sparse tiles from {source}: bucket {b} of {nb}, "
                         f"lanes {m0}..{m0 + M - 1} of {d_loc} features "
                         f"(ids must stay below 2^31)")
    a_out = torch.empty((Wk, M, B), dtype=f32, device=dev)
    S = torch.empty((Wk * M, E), dtype=f32, device=dev)     # scratch
    rows, smem = None, sharded_smem_bytes(nnz)
    if not sharded_fits_smem(nnz):
        rows = torch.empty((Wk * M, sharded_row_words(nnz)), dtype=f32,
                           device=dev)
        smem -= 4 * sharded_row_words(nnz)
    fn = c_entry("sdca_sparse_sharded_bucket", "ppppp" "pppppp" "iiiiiiii"
                 "ff" "ii" "p")
    err = fn(idxb.data_ptr(), valb.data_ptr(), yb.data_ptr(), ab.data_ptr(),
             qb.data_ptr(), links.data_ptr(), W.data_ptr(),
             v_loc.data_ptr(), a_out.data_ptr(), S.data_ptr(),
             None if rows is None else rows.data_ptr(),
             Wk * M, M, m0, nb, b, B, nnz, d_loc, lam_n, sig,
             OBJ_CODES[obj.name], smem,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sdca_sparse_sharded_bucket kernel launch failed: CUDA error "
            f"{err} (Wk={Wk}, M={M}, m0={m0}, B={B}, nnz={nnz}, "
            f"d_loc={d_loc})")
    sharded_launches += 1
    return a_out
