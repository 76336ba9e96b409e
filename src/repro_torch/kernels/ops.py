"""Wrappers around the CUDA kernels: padding, unscaling, misfit checks.

`sdca_bucket_subepoch` and `sdca_sparse_bucket_subepoch` are
call-compatible with `core.sdca.dense_local_subepoch` and
`core.sdca.sparse_local_subepoch` (with any number of leading worker
axes), so the engine routes a whole P*K worker stack through one kernel
launch; `dense_tiles` and `sparse_tiles` own the layout of the
kernels' arguments (padding, tiling, the q precompute).  The misfit
predicates say, on static shapes, whether a kernel
can take a workload; their budgets are the H100's: 227 KB of opt-in
shared memory per block, and global memory for what does not fit.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.objectives import Objective
from repro_torch.core.sdca import row_sq_norms
from . import sdca_bucket, sdca_sparse_bucket


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class MisfitCode:
    """Stable enum-style codes for kernel misfit reasons."""
    BUCKET_INDIVISIBLE = "BUCKET_INDIVISIBLE"   # B does not divide n_local
    BUCKET_CAP = "BUCKET_CAP"                   # dense recursion cap B<=512
    SMEM_TOTAL = "SMEM_TOTAL"                   # sparse working set > opt-in


class Misfit(str):
    """A misfit reason string carrying its stable `MisfitCode`."""
    __slots__ = ("code",)
    code: str

    def __new__(cls, code: str, text: str) -> "Misfit":
        self = super().__new__(cls, text)
        self.code = code
        return self


def sparse_solver_plan(n_local: int, nnz: int, d: int, bucket: int
                       ) -> tuple[str, Misfit | None]:
    """-> (route, reason): "kernel" (v replicas in global memory, the
    bucket's working set in shared memory) or "torch" with the misfit.

    d never misfits: the replicas live in global memory, where the
    card's 50 MB L2 holds the hot entries.
    """
    del d
    if bucket <= 0 or n_local % bucket:
        return "torch", Misfit(
            MisfitCode.BUCKET_INDIVISIBLE,
            f"bucket={bucket} does not divide n_local={n_local}")
    if not sdca_sparse_bucket.fits_smem(bucket, nnz):
        return "torch", Misfit(
            MisfitCode.SMEM_TOTAL,
            f"{sdca_sparse_bucket.smem_bytes(bucket, nnz)}-byte shared-"
            f"memory working set for (B={bucket}, nnz={nnz}) exceeds the "
            f"{sdca_sparse_bucket.SMEM_OPTIN_BYTES}-byte per-block opt-in")
    return "kernel", None


def sparse_kernel_misfit(n_local: int, nnz: int, d: int,
                         bucket: int) -> Misfit | None:
    """Why the sparse kernel cannot run this workload, or None."""
    route, reason = sparse_solver_plan(n_local, nnz, d, bucket)
    return reason if route != "kernel" else None


def dense_kernel_misfit(d: int, n_local: int, bucket: int) -> Misfit | None:
    """Why the dense kernel cannot run this workload, or None.

    The wrapper zero-pads d and B, and tiles or Gram matrices that do
    not fit shared memory are read from global memory, so the only
    misfits are bucket divisibility and the recursion's B cap.
    """
    del d
    if bucket <= 0 or n_local % bucket:
        return Misfit(MisfitCode.BUCKET_INDIVISIBLE,
                      f"bucket={bucket} does not divide n_local={n_local}")
    B_pad = _round_up(max(bucket, 8), 8)
    if B_pad > sdca_bucket.MAX_BUCKET:
        return Misfit(MisfitCode.BUCKET_CAP,
                      f"bucket={bucket} exceeds the kernel's in-bucket "
                      f"recursion cap of B <= {sdca_bucket.MAX_BUCKET}")
    return None


#: provenances whose rows are vouched for upstream: the Session checks
#: array sources at entry, and the registry's samplers dedupe rows.
#: Every other label gets checked host-side.
_TRUSTED_SOURCES = ("resident arrays",)


def _check_csr_invariant(idx, val, source: str) -> None:
    """Host-side check of the no-duplicate-nonzero CSR invariant for
    rows of untrusted provenance (a device-to-host copy and a sort)."""
    if any(source.startswith(s) for s in _TRUSTED_SOURCES):
        return
    from repro_torch.data.formats import raise_on_duplicate_nonzeros
    i = idx.detach().cpu().numpy()
    v = val.detach().cpu().numpy()
    raise_on_duplicate_nonzeros(i.reshape(-1, i.shape[-1]),
                                v.reshape(-1, v.shape[-1]),
                                f"{source}: sparse rows")


def _scalar(x, device) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def dense_tiles(Xl, yl, al, v0, *, bucket: int):
    """The dense kernel's arguments for a worker stack, as the wrapper
    launches it: (xb (W, nb, d_pad, B_pad), yb, ab (W, nb, B_pad),
    v0 (W, d_pad)), all f32.

    Xl: (*w, d, n_local) columns in visiting order; yl/al (*w, n_local);
    v0 (*w, d).  d and B are zero-padded to multiples of 8 (the
    reference's tile geometry); padded coordinates get y=0 and a=0.
    """
    *w, d, n_local = Xl.shape
    W = math.prod(w)
    B = bucket
    nb = n_local // B
    d_pad = _round_up(max(d, 8), 8)
    B_pad = _round_up(max(B, 8), 8)

    xb = Xl.reshape(W, d, nb, B).permute(0, 2, 1, 3)       # (W, nb, d, B)
    yb = yl.reshape(W, nb, B)
    ab = al.reshape(W, nb, B)
    if d_pad != d or B_pad != B:
        xb = torch.nn.functional.pad(xb, (0, B_pad - B, 0, d_pad - d))
    if B_pad != B:
        # padded coordinates: zero x column => q=0, m=0, and y=0, a=0
        # give delta == 0 for every objective; their alpha is dropped
        yb = torch.nn.functional.pad(yb, (0, B_pad - B))
        ab = torch.nn.functional.pad(ab, (0, B_pad - B))
    v0p = torch.nn.functional.pad(v0.reshape(W, d).float(), (0, d_pad - d))
    return xb.float(), yb.float(), ab.float(), v0p


def sparse_tiles(idx, val, yl, al, v0, *, bucket: int,
                 source: str = "ad-hoc arrays"):
    """The sparse kernel's arguments for a worker stack, as the wrapper
    launches it: (idxb, valb (W, nb, B, nnz), yb, ab, qb (W, nb, B),
    v0 (W, d_pad)).

    idx/val: (*w, n_local, nnz) padded-CSR rows in visiting order; v0:
    (*w, d).  Only d is padded (zero entries, never indexed).  q = sum
    val^2 is computed over the full chunk with the plain scan's exact
    expression, which carries the bitwise result.
    """
    *w, n_local, nnz = idx.shape
    W = math.prod(w)
    B = bucket
    if B <= 0 or n_local % B:
        raise ValueError(
            f"bucket={B} must divide the {source} chunk's row count "
            f"{n_local} (the engine hands the kernel whole buckets)")
    d = v0.shape[-1]
    d_pad = _round_up(max(d, 8), 8)
    nb = n_local // B
    qb = row_sq_norms(val.float()).reshape(W, nb, B)
    v0p = torch.nn.functional.pad(v0.reshape(W, d).float(), (0, d_pad - d))
    return (idx.reshape(W, nb, B, nnz), val.reshape(W, nb, B, nnz),
            yl.reshape(W, nb, B), al.reshape(W, nb, B), qb, v0p)


def sdca_bucket_subepoch(obj: Objective, Xl, yl, al, v0, lam_n, sig, *,
                         bucket: int, source: str = "ad-hoc arrays"):
    """Every worker's dense sub-epoch through the kernel.

    Xl: (*w, d, n_local) columns in visiting order; yl/al (*w, n_local);
    v0 (*w, d).  Returns (a_new, dv) with dv the UNSCALED global delta
    (CoCoA+ convention, as `dense_local_subepoch`).
    """
    *w, d, n_local = Xl.shape
    xb, yb, ab, v0p = dense_tiles(Xl, yl, al, v0, bucket=bucket)
    a_new, v_fin = sdca_bucket.sdca_bucket_kernel(
        obj, xb, yb, ab, v0p, float(lam_n), float(sig), source)

    a_out = a_new[..., :bucket].reshape(*w, n_local)
    dv = (v_fin[:, :d] - v0p[:, :d]) / _scalar(sig, v0.device)
    return a_out.to(al.dtype), dv.reshape(*w, d).to(v0.dtype)


def sdca_sparse_bucket_subepoch(obj: Objective, idx, val, yl, al, v0,
                                lam_n, sig, *, bucket: int,
                                source: str = "ad-hoc arrays"):
    """Every worker's SPARSE sub-epoch through the kernel.

    idx/val: (*w, n_local, nnz) padded-CSR rows in visiting order; v0:
    (*w, d) replicated shared vector.  Returns (a_new, dv) with dv the
    UNSCALED global delta — call-compatible with
    `core.sdca.sparse_local_subepoch` and BITWISE equal to it on the
    same device.
    """
    _check_csr_invariant(idx, val, source)
    *w, n_local, _ = idx.shape
    d = v0.shape[-1]
    args = sparse_tiles(idx, val, yl, al, v0, bucket=bucket, source=source)
    a_new, v_fin = sdca_sparse_bucket.sdca_sparse_bucket_kernel(
        obj, *args, float(lam_n), float(sig), source)

    v0p = args[-1]
    a_out = a_new.reshape(*w, n_local)
    dv = (v_fin[:, :d] - v0p[:, :d]) / _scalar(sig, v0.device)
    return a_out.to(al.dtype), dv.reshape(*w, d).to(v0.dtype)
