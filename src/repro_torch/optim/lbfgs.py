"""L-BFGS and gradient descent for GLMs: the general-purpose baselines of
Fig 6 (the paper's scikit-learn lbfgs/liblinear comparison).

The reference's `repro.optim.lbfgs` on tensors: `glm_objective` gives
the regularized primal's value and gradient (autograd through the
objective's loss; X^T w is a plain matmul, with TF32 off on the card),
`lbfgs` keeps the two-loop recursion with a backtracking Armijo line
search, and `gradient_descent` the backtracking step halving, both with
the reference's history rows ``(iter, t, f, |g|)`` and stopping rules.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.core.objectives import Objective
from repro_torch.device import resolve_device

__all__ = ["glm_objective", "lbfgs", "gradient_descent"]


def glm_objective(obj: Objective, X, y, lam: float, *,
                  device="cuda") -> Callable:
    """-> value_and_grad(w) -> (f, g) of P(w) = (1/n) sum phi(x_i^T w,
    y_i) + (lam/2) |w|^2, X (d, n), on `device` (the card unless the
    caller asks for the CPU)."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    n = y.shape[0]

    def value_and_grad(w):
        w = torch.as_tensor(w, dtype=torch.float32, device=dev)
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            m = X.T @ w
            f = torch.sum(obj.loss(m, y)) / n + 0.5 * lam * torch.sum(w * w)
            g, = torch.autograd.grad(f, w)
        return f.detach(), g

    return value_and_grad


def lbfgs(value_and_grad: Callable, w0, *, max_iters: int = 500,
          m: int = 10, tol: float = 1e-7):
    """Returns (w, history) — history rows: (iter, t, f, |g|)."""
    f, g = value_and_grad(w0)
    w = torch.as_tensor(w0, dtype=g.dtype, device=g.device)
    S, Y = [], []
    hist = [(0, 0.0, float(f), float(torch.linalg.vector_norm(g)))]
    t0 = time.perf_counter()
    for it in range(1, max_iters + 1):
        q = g
        alphas = []
        for s, yv in zip(reversed(S), reversed(Y)):
            rho = 1.0 / torch.dot(yv, s)
            a = rho * torch.dot(s, q)
            q = q - a * yv
            alphas.append((a, rho))
        gamma = (torch.dot(S[-1], Y[-1]) / torch.dot(Y[-1], Y[-1])
                 if S else 1.0)
        r = gamma * q
        for (a, rho), s, yv in zip(reversed(alphas), S, Y):
            b = rho * torch.dot(yv, r)
            r = r + (a - b) * s
        d = -r
        # Armijo backtracking
        step, c1 = 1.0, 1e-4
        gtd = torch.dot(g, d)
        for _ in range(30):
            f_new, g_new = value_and_grad(w + step * d)
            if f_new <= f + c1 * step * gtd:
                break
            step *= 0.5
        s = step * d
        yv = g_new - g
        if torch.dot(s, yv) > 1e-10:
            S.append(s)
            Y.append(yv)
            if len(S) > m:
                S.pop(0)
                Y.pop(0)
        w, f, g = w + s, f_new, g_new
        gn = float(torch.linalg.vector_norm(g))
        hist.append((it, time.perf_counter() - t0, float(f), gn))
        if gn < tol:
            break
    return w, hist


def gradient_descent(value_and_grad: Callable, w0, *, lr: float = 1.0,
                     max_iters: int = 2000, tol: float = 1e-7):
    """Plain GD with backtracking — the 'sag-like' slow baseline."""
    w = w0
    hist = []
    t0 = time.perf_counter()
    for it in range(max_iters):
        f, g = value_and_grad(w)
        w = torch.as_tensor(w, dtype=g.dtype, device=g.device)
        gn = float(torch.linalg.vector_norm(g))
        hist.append((it, time.perf_counter() - t0, float(f), gn))
        if gn < tol:
            break
        step = lr
        for _ in range(20):
            f_new, _ = value_and_grad(w - step * g)
            if f_new < f:
                break
            step *= 0.5
        w = w - step * g
    return w, hist
