"""Legacy simulator API: thin wrappers over the solver engine.

What remains here is the flat `SolverConfig` (accepted everywhere an
`EngineConfig` is) and the `epoch_sim{,_sparse}` signatures, kept for
compatibility.  New code should use `core.config.EngineConfig` and
`core.engine` directly.

Aggregation modes (paper S3):
  wild       sigma'=1, plain sum of worker deltas (the deterministic
             proxy for Hogwild's stale lock-free updates).
  adding     sigma'=#workers, sum (CoCoA+ safe aggregation; default).
  averaging  sigma'=1, mean (CoCoA v1; safe but slow).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from . import engine
from .config import Aggregation, EngineConfig
from .objectives import Objective

__all__ = ["Aggregation", "SolverConfig", "epoch_sim", "epoch_sim_sparse"]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Flat knobs of the multi-worker solver (paper S3).

    Deprecated in favour of the layered `EngineConfig` (algo x
    deployment); `.to_engine()` converts, and every entry point accepts
    either form.  ``use_kernel=True`` asks for the CUDA kernels
    (``local_solver="kernel"``), as the reference's asks for Pallas.
    """
    pods: int = 1                   # outer (static) worker axis
    lanes: int = 1                  # inner (dynamic) worker axis
    partition: str = "hierarchical"  # static|dynamic|hierarchical|alltoall
    aggregation: Aggregation = "adding"
    bucket: int = 1                 # examples per bucket (1 = off)
    chunks: int = 1                 # v syncs per epoch (within pods)
    seed: int = 0
    use_kernel: bool = False        # route buckets through the kernels
    compress_sync: bool = False     # int8-quantize dv before the sync
    redeal_frac: float = 1.0        # alltoall: bucket fraction exchanged

    @property
    def workers(self) -> int:
        return self.pods * self.lanes

    def sigma_prime(self) -> float:
        if self.aggregation == "adding":
            return float(self.workers)
        return 1.0

    def to_engine(self) -> EngineConfig:
        return EngineConfig.make(
            pods=self.pods, lanes=self.lanes, partition=self.partition,
            aggregation=self.aggregation, bucket=self.bucket,
            chunks=self.chunks, seed=self.seed,
            local_solver="kernel" if self.use_kernel else "auto",
            compress_sync=self.compress_sync,
            redeal_frac=self.redeal_frac)


def epoch_sim(obj: Objective, X, y, alpha, v, lam: float, plan, bplan, cfg,
              epoch: int, straggler_mask: Optional[object] = None, *,
              device="cuda"):
    """One bulk-synchronous epoch over P*K virtual workers (dense path,
    X (d, n)).  Deprecated shim: forwards to `engine.sim_epoch_dense`."""
    from repro_torch.api.deprecation import warn_deprecated
    warn_deprecated("repro_torch.core.cocoa.epoch_sim",
                    "repro_torch.core.engine.sim_epoch_dense (or "
                    "repro_torch.api.Session for training loops)")
    return engine.sim_epoch_dense(obj, X, y, alpha, v, lam, plan, bplan,
                                  cfg, epoch, straggler_mask, device=device)


def epoch_sim_sparse(obj: Objective, idx, val, y, alpha, v, lam: float,
                     plan, bplan, cfg, epoch: int, *, device="cuda"):
    """Sparse-path epoch (padded CSR idx/val (n, nnz), v (d,)).
    Deprecated shim over `engine.sim_epoch_sparse`."""
    from repro_torch.api.deprecation import warn_deprecated
    warn_deprecated("repro_torch.core.cocoa.epoch_sim_sparse",
                    "repro_torch.core.engine.sim_epoch_sparse (or "
                    "repro_torch.api.Session for training loops)")
    return engine.sim_epoch_sparse(obj, idx, val, y, alpha, v, lam, plan,
                                   bplan, cfg, epoch, device=device)
