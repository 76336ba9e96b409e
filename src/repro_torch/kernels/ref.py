"""The naive oracle of the dense SDCA sub-epoch.

Written as the per-coordinate algorithm, with no Gram trick, so that
holding `core.sdca.dense_local_subepoch` (and through it the dense
kernel) against it checks the bucket reformulation itself.
"""
from __future__ import annotations

import torch

from repro_torch.core.objectives import Objective

Tensor = torch.Tensor


def sdca_subepoch_ref(obj: Objective, X: Tensor, y: Tensor, a: Tensor,
                      v0: Tensor, lam_n, sig) -> tuple[Tensor, Tensor]:
    """Per-coordinate sequential SDCA over the columns of X (*w, d,
    n_local), y/a (*w, n_local), v0 (*w, d).

    Returns (a_new, v_final) with v_final = v0 + sigma'/lam_n * X @ da.
    """
    X, y, a, v = (t.float() for t in (X, y, a, v0))
    lam = torch.tensor(float(lam_n), dtype=torch.float32, device=X.device)
    s = torch.tensor(float(sig), dtype=torch.float32, device=X.device)
    a_new = torch.empty_like(a)
    for i in range(X.shape[-1]):
        x = X[..., i]
        m = (x * v).sum(-1)
        q = s * (x * x).sum(-1) / lam
        d = obj.delta(m, a[..., i], y[..., i], q)
        v = v + (s * d / lam)[..., None] * x
        a_new[..., i] = a[..., i] + d
    return a_new, v
