"""SDCA primitives: bucket recursion and per-worker local sub-epochs.

The plain PyTorch versions of the port: the `"torch"` local solver and
the oracles the CUDA kernels are held against.  A bucket of B
consecutive coordinates is processed through its Gram matrix

    m0 = X_b^T v          (B,)    margins at bucket entry
    G  = X_b^T X_b        (B,B)

after which the sequential SDCA recursion over the bucket only touches
(m, G, alpha_b, y_b), and the shared vector is updated once per bucket:
v += (sigma'/lam_n) X_b @ delta.  This is EXACTLY sequential SDCA in
the same visiting order.

Every function takes any number of leading worker axes (`*w`): the
engine hands all P*K simulated workers over in one call, the way the
kernels take them in one launch.

sigma' is the CoCoA(+) subproblem scaling: 1 for a truly sequential
solver, K for safe additive aggregation, 1-with-summing for "wild".
`lam_n` and `sigma_p` are 0-d tensors on the data's device (PyTorch may
run a CUDA division by a Python scalar as a reciprocal multiply).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .objectives import Objective

Tensor = torch.Tensor


def bucket_solve(obj: Objective, G: Tensor, m0: Tensor, a0: Tensor,
                 y: Tensor, lam_n: Tensor, sigma_p: Tensor) -> Tensor:
    """Sequential SDCA over one bucket via its Gram matrix.

    G (*w, B, B); m0, a0, y (*w, B).  Returns delta (*w, B) such that
    alpha_bucket += delta reproduces the visiting order 0..B-1 exactly.
    """
    B = m0.shape[-1]
    gdiag = torch.diagonal(G, dim1=-2, dim2=-1)
    m = m0
    deltas = torch.zeros_like(m0)
    for i in range(B):
        q = sigma_p * gdiag[..., i] / lam_n
        d = obj.delta(m[..., i], a0[..., i], y[..., i], q)
        m = m + (sigma_p * d / lam_n)[..., None] * G[..., i, :]
        deltas[..., i] = d
    return deltas


def dense_bucket_pass(obj: Objective, xb: Tensor, yb: Tensor, ab: Tensor,
                      v0: Tensor, lam_n: Tensor, sigma_p: Tensor
                      ) -> tuple[Tensor, Tensor]:
    """Walk bucket tiles in order: xb (*w, nb, d, B), yb/ab (*w, nb, B),
    v0 (*w, d).  Returns (a_new (*w, nb, B), v_final (*w, d)), v_final
    carrying the sigma'-scaled local evolution."""
    v = v0
    a_new = torch.empty_like(ab)
    for b in range(xb.shape[-3]):
        Xt = xb[..., b, :, :]                            # (*w, d, B)
        # the matrix-vector products are elementwise products summed:
        # a CPU matmul takes another kernel for one worker than for a
        # stack, so its bits would depend on the worker count, and one
        # process of a process mesh is one worker of the stacked mesh
        m0 = (Xt * v[..., None]).sum(-2)
        G = Xt.transpose(-1, -2) @ Xt
        deltas = bucket_solve(obj, G, m0, ab[..., b, :], yb[..., b, :],
                              lam_n, sigma_p)
        v = v + (sigma_p / lam_n) * (Xt * deltas[..., None, :]).sum(-1)
        a_new[..., b, :] = ab[..., b, :] + deltas
    return a_new, v


def lane_ordered_sum(packed: Tensor) -> Tensor:
    """(*w, M, B, 1 + B) the lanes' packed partials -> (*w, B, 1 + B),
    summed over the lanes in lane order: the stacked form of the
    model-axis sum (`dense_tp_bucket_pass`'s default ``reduce``)."""
    parts = packed.unbind(-3)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def tp_partials(Xt: Tensor, v: Tensor) -> Tensor:
    """One bucket's packed partials per lane: Xt (*w, M, d/M, B) the
    lanes' rows of the tile, v (*w, M, d/M) their slices of v ->
    (*w, M, B, 1 + B), [m0 | G] with m0 = X_m^T v_m and G = X_m^T X_m.

    Both products are elementwise products summed over the lane's rows,
    not matmuls: a CPU matmul takes another kernel for one lane than for
    a stack, and one process of a process mesh holds one lane."""
    m0 = (Xt * v[..., None]).sum(-2)                      # (*w, M, B)
    G = (Xt[..., :, :, None] * Xt[..., :, None, :]).sum(-3)
    return torch.cat([m0[..., None], G], dim=-1)


def tp_solve(obj: Objective, total: Tensor, Xt: Tensor, a: Tensor,
             y: Tensor, v: Tensor, lam_n: Tensor, sigma_p: Tensor
             ) -> tuple[Tensor, Tensor]:
    """Every lane's recursion on its worker's lane-summed [m0 | G]:
    total (*w, B, 1 + B), Xt (*w, M, d/M, B), a/y (*w, B), v (*w, M,
    d/M) -> (deltas (*w, B), v with each lane's rows updated by
    (sigma'/lam_n) X_m delta)."""
    deltas = bucket_solve(obj, total[..., 1:], total[..., 0], a, y, lam_n,
                          sigma_p)
    upd = (Xt * deltas[..., None, None, :]).sum(-1)       # (*w, M, d/M)
    return deltas, v + (sigma_p / lam_n) * upd


def dense_tp_bucket_pass(obj: Objective, xb: Tensor, yb: Tensor,
                         ab: Tensor, v0: Tensor, lam_n: Tensor,
                         sigma_p: Tensor, model_lanes: int,
                         reduce: Optional[Callable[[Tensor], Tensor]] = None
                         ) -> tuple[Tensor, Tensor]:
    """`dense_bucket_pass` with the features split over `model_lanes`
    lanes (dense tensor parallelism): each lane holds d/M contiguous
    rows of every tile and of v.  Per bucket each lane forms its partial
    m0 = X_m^T v_m and G = X_m^T X_m (`tp_partials`), the packed
    [m0 | G] partials are summed over the model lanes (the reference's
    model-axis psum of `packed`), every lane runs the same recursion,
    and each lane updates its own rows of v (`tp_solve`).  d must be a
    multiple of M.

    ``reduce`` maps the held lanes' partials (*w, M, B, 1 + B) to the
    sum over every model lane (*w, B, 1 + B).  The default,
    `lane_ordered_sum`, is the stacked form: all M lanes are held and
    summed in lane order.  On a process mesh a rank holds one lane
    (model_lanes=1 here) and ``reduce`` is the ordered all-gather sum
    over 'model' (`engine.MeshCollectives.model_sum`), the same adds in
    the same order."""
    *w, nb, d, B = xb.shape
    M = int(model_lanes)
    if d % M:
        raise ValueError(f"dense tensor parallelism splits d={d} over "
                         f"{M} model lanes; d must be a multiple of it")
    reduce = lane_ordered_sum if reduce is None else reduce
    v = v0.reshape(*w, M, d // M)
    a_new = torch.empty_like(ab)
    for b in range(nb):
        Xt = xb[..., b, :, :].reshape(*w, M, d // M, B)
        total = reduce(tp_partials(Xt, v))              # (*w, B, 1 + B)
        deltas, v = tp_solve(obj, total, Xt, ab[..., b, :], yb[..., b, :],
                             v, lam_n, sigma_p)
        a_new[..., b, :] = ab[..., b, :] + deltas
    return a_new, v.reshape(*w, d)


def dense_local_subepoch(obj: Objective, Xl: Tensor, yl: Tensor,
                         al: Tensor, v0: Tensor, lam_n: Tensor,
                         sigma_p: Tensor, bucket: int,
                         model_lanes: Optional[int] = None,
                         reduce: Optional[Callable[[Tensor], Tensor]] = None
                         ) -> tuple[Tensor, Tensor]:
    """One worker's pass over its buckets: Xl (*w, d, n_local) columns
    in visiting order, yl/al (*w, n_local), v0 (*w, d).
    Returns (al_new, dv) with dv the UNSCALED global delta (CoCoA+).
    `model_lanes` splits the features over that many lanes, whose
    Gram and margin partials are summed per bucket by ``reduce``
    (`dense_tp_bucket_pass`; the reference's `model_axis`)."""
    *w, d, n_local = Xl.shape
    nb = n_local // bucket
    xb = Xl.reshape(*w, d, nb, bucket).movedim(-2, -3)     # (*w, nb, d, B)
    args = (obj, xb, yl.reshape(*w, nb, bucket),
            al.reshape(*w, nb, bucket), v0, lam_n, sigma_p)
    a_new, v1 = (dense_bucket_pass(*args) if model_lanes is None
                 else dense_tp_bucket_pass(*args, model_lanes, reduce))
    # CoCoA+: the local replica evolves with the sigma'-scaled updates,
    # the aggregated global delta is the UNSCALED (1/lam_n) A_k @ dalpha_k
    return a_new.reshape(*w, n_local), (v1 - v0) / sigma_p


def row_sq_norms(val: Tensor) -> Tensor:
    """q_i = sum_k val[i,k]^2, summed left to right over k.

    An explicit loop of separate multiplies and adds: its bits do not
    depend on the tensor's shape or device reduction strategy, so the
    plain scan and the sparse kernel's wrapper see the same q."""
    q = torch.zeros(val.shape[:-1], dtype=val.dtype, device=val.device)
    for k in range(val.shape[-1]):
        q = q + val[..., k] * val[..., k]
    return q


def sparse_scan(obj: Objective, idx: Tensor, val: Tensor, y: Tensor,
                a: Tensor, q: Tensor, v0: Tensor, lam_n: Tensor,
                sigma_p: Tensor) -> tuple[Tensor, Tensor]:
    """The per-coordinate padded-CSR scan: idx/val (*w, n, nnz), y/a/q
    (*w, n), v0 (*w, d).  Returns (a_new, v_final).

    Margins are summed left to right over k; the update row
    u = (sigma' delta / lam_n) * val is computed once and added into v
    one entry at a time in k order (no fused or unordered adds), which
    is the order the sparse kernel reproduces bit for bit."""
    *w, n, nnz = idx.shape
    W = math.prod(w)
    idx2 = idx.reshape(W, n, nnz).long()
    val2 = val.reshape(W, n, nnz)
    y2, a2, q2 = (t.reshape(W, n) for t in (y, a, q))
    v = v0.reshape(W, -1).clone()
    rows = torch.arange(W, device=v.device)
    a_new = torch.empty_like(a2)
    for i in range(n):
        ii, vv = idx2[:, i], val2[:, i]
        wi = torch.gather(v, 1, ii)
        m = torch.zeros(W, dtype=v.dtype, device=v.device)
        for k in range(nnz):
            m = m + wi[:, k] * vv[:, k]
        d = obj.delta(m, a2[:, i], y2[:, i], sigma_p * q2[:, i] / lam_n)
        u = (sigma_p * d / lam_n)[:, None] * vv
        for k in range(nnz):
            col = ii[:, k]
            v[rows, col] = v[rows, col] + u[:, k]
        a_new[:, i] = a2[:, i] + d
    return a_new.reshape(*w, n), v.reshape(v0.shape)


def sparse_local_subepoch(obj: Objective, idx: Tensor, val: Tensor,
                          yl: Tensor, al: Tensor, v0: Tensor,
                          lam_n: Tensor, sigma_p: Tensor
                          ) -> tuple[Tensor, Tensor]:
    """Sparse (padded-CSR) sequential pass: gather/scatter per coordinate.

    idx/val (*w, n_local, nnz), v0 (*w, d) replicated feature vector.
    Returns (a_new, dv) with dv the UNSCALED global delta.  The sparse
    kernel (`kernels.ops.sdca_sparse_bucket_subepoch`) is bitwise equal
    to this on the same device.
    """
    q = row_sq_norms(val)
    a_new, v1 = sparse_scan(obj, idx, val, yl, al, q, v0, lam_n, sigma_p)
    return a_new, (v1 - v0) / sigma_p


def sequential_epoch(obj: Objective, X: Tensor, y: Tensor, alpha: Tensor,
                     v: Tensor, lam: float, perm: Tensor, bucket: int = 1,
                     sigma_p: float = 1.0) -> tuple[Tensor, Tensor]:
    """Single-worker epoch (the paper's sequential baseline), X (d, n).

    bucket=1 reproduces classic per-coordinate SDCA; bucket>1 uses the
    Gram recursion (identical updates for the same perm).
    """
    n = y.shape[0]
    lam_n = torch.tensor(lam * n, dtype=X.dtype, device=X.device)
    sig = torch.tensor(sigma_p, dtype=X.dtype, device=X.device)
    a_new, dv = dense_local_subepoch(obj, X[:, perm], y[perm], alpha[perm],
                                     v, lam_n, sig, bucket)
    alpha = alpha.clone()
    alpha[perm] = a_new
    return alpha, v + dv
