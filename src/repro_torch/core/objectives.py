"""GLM objectives for SDCA (PyTorch port of `repro.core.objectives`).

Primal:  min_w  P(w) = (1/n) sum_i phi(x_i^T w, y_i) + (lam/2) ||w||^2
Dual:    max_a  D(a) = -(1/n) sum_i phi*(-a_i, y_i) - (lam/2) ||v||^2
with the shared vector v = (1/(lam*n)) * A @ a  (A = [x_1 ... x_n], d x n)
and w = v at optimality.

Each objective provides the scalar dual coordinate update

    delta(m, a, y, q) = argmin_d  phi*(-(a+d), y) + m*d + (q/2) d^2

where m = x_i^T v_local is the current margin and q = sigma' * ||x_i||^2
/ (lam*n) is the (CoCoA-scaled) curvature.  All functions are
elementwise over broadcasting tensors.  Every `delta` uses only single
IEEE operations (no fused multiply-add) in the reference's order, so
the CUDA kernels' `__device__` copies in `kernels/csrc/objectives.cuh`
reproduce them bit for bit on the same device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor

_EPS = 1e-12
_BISECT_ITERS = 40


@dataclasses.dataclass(frozen=True)
class Objective:
    """A GLM loss, its conjugate, and its SDCA coordinate update."""

    name: str
    # phi(z, y): per-example primal loss
    loss: Callable[[Tensor, Tensor], Tensor]
    # phi*(-a, y): per-example dual (conjugate) penalty
    conj_neg: Callable[[Tensor, Tensor], Tensor]
    # delta(m, a, y, q): scalar dual coordinate update
    delta: Callable[[Tensor, Tensor, Tensor, Tensor], Tensor]
    # whether labels live in {-1, +1} (classification) or R (regression)
    classification: bool


# ---------------------------------------------------------------------------
# Ridge regression (squared loss)
# ---------------------------------------------------------------------------

def _ridge_loss(z: Tensor, y: Tensor) -> Tensor:
    return 0.5 * (z - y) ** 2


def _ridge_conj_neg(a: Tensor, y: Tensor) -> Tensor:
    # phi*(u) = u^2/2 + u*y  =>  phi*(-a) = a^2/2 - a*y
    return 0.5 * a ** 2 - a * y


def _ridge_delta(m: Tensor, a: Tensor, y: Tensor, q: Tensor) -> Tensor:
    return (y - m - a) / (1.0 + q)


# ---------------------------------------------------------------------------
# SVM (hinge loss, box-constrained dual)
# ---------------------------------------------------------------------------

def _hinge_loss(z: Tensor, y: Tensor) -> Tensor:
    return torch.clamp_min(1.0 - y * z, 0.0)


def _hinge_conj_neg(a: Tensor, y: Tensor) -> Tensor:
    # phi*(-a) = -a*y on the domain a*y in [0, 1] (iterates stay feasible)
    return -a * y


def _hinge_delta(m: Tensor, a: Tensor, y: Tensor, q: Tensor) -> Tensor:
    q = torch.clamp_min(q, _EPS)
    b_new = torch.clamp(a * y + (1.0 - y * m) / q, 0.0, 1.0)
    return y * b_new - a


# ---------------------------------------------------------------------------
# Logistic regression
# ---------------------------------------------------------------------------

def _log_loss(z: Tensor, y: Tensor) -> Tensor:
    # log(1 + exp(-y z)), numerically stable
    return torch.logaddexp(torch.zeros_like(z), -y * z)


def _xlogx(b: Tensor) -> Tensor:
    return torch.where(b > _EPS, b * torch.log(torch.clamp_min(b, _EPS)),
                       torch.zeros_like(b))


def _log_conj_neg(a: Tensor, y: Tensor) -> Tensor:
    # phi*(-a) = b log b + (1-b) log(1-b) with b = a*y in [0, 1]
    b = a * y
    return _xlogx(b) + _xlogx(1.0 - b)


def _log_delta(m: Tensor, a: Tensor, y: Tensor, q: Tensor) -> Tensor:
    """Guarded bisection on the monotone derivative.

    g(d)  = phi*(-(a+d)) + m d + q d^2 / 2,   b = (a+d) y in (0, 1)
    g'(d) = y log(b / (1-b)) + m + q d        (strictly increasing in d)
    """
    b0 = a * y
    # feasible b in [lo, hi]; keep strictly inside for the log (f32-safe)
    lo = torch.full_like(b0, 1e-6)
    hi = torch.full_like(b0, 1.0 - 1e-6)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        d = (mid - b0) * y          # since b = (a+d) y and y^2 = 1
        gp = y * (torch.log(mid) - torch.log1p(-mid)) + m + q * d
        # g' increasing in d; moving b by +y moves d by +1
        go_up = (gp * y) < 0.0
        lo = torch.where(go_up, mid, lo)
        hi = torch.where(go_up, hi, mid)
    b = 0.5 * (lo + hi)
    return (b - b0) * y


RIDGE = Objective("ridge", _ridge_loss, _ridge_conj_neg, _ridge_delta,
                  classification=False)
HINGE = Objective("hinge", _hinge_loss, _hinge_conj_neg, _hinge_delta,
                  classification=True)
LOGISTIC = Objective("logistic", _log_loss, _log_conj_neg, _log_delta,
                     classification=True)

OBJECTIVES = {o.name: o for o in (RIDGE, HINGE, LOGISTIC)}


def get_objective(name: str) -> Objective:
    try:
        return OBJECTIVES[name]
    except KeyError:
        raise ValueError(f"unknown objective {name!r}; have {list(OBJECTIVES)}")


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

def primal_value(obj: Objective, v: Tensor, X: Tensor, y: Tensor,
                 lam: float) -> Tensor:
    """P(v) for dense X of shape (d, n)."""
    margins = X.T @ v
    n = y.shape[0]
    return torch.sum(obj.loss(margins, y)) / n + 0.5 * lam * torch.sum(v * v)


def dual_value(obj: Objective, alpha: Tensor, v: Tensor, y: Tensor,
               lam: float) -> Tensor:
    n = y.shape[0]
    return (-torch.sum(obj.conj_neg(alpha, y)) / n
            - 0.5 * lam * torch.sum(v * v))


def duality_gap(obj: Objective, alpha: Tensor, v: Tensor, X: Tensor,
                y: Tensor, lam: float) -> Tensor:
    """P(v) - D(alpha); -> 0 at the optimum.  v must equal A@alpha/(lam n)."""
    return (primal_value(obj, v, X, y, lam)
            - dual_value(obj, alpha, v, y, lam))
