"""Layered solver configuration: algorithm knobs x deployment knobs.

  * `AlgoConfig` — properties of the *algorithm*: bucket size, sync
    interval, aggregation rule, partition scheme, wire compression.
    These determine convergence and are backend-independent.
  * `DeploymentConfig` — properties of *where it runs*: how many pods
    and lanes (virtual workers in the simulator), feature sharding,
    cross-pod compression, and whether collectives must be
    bit-deterministic.

`EngineConfig` composes the two and is what `core.engine` consumes.
Field names and defaults mirror `repro.core.config`, except the local
solver names (`"torch"`/`"kernel"` for the reference's
`"xla"`/`"pallas"`; `repro_torch.convert` maps them).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Aggregation = Literal["wild", "adding", "averaging"]

#: local-solver implementations the engine can dispatch to, on both the
#: dense and sparse paths.  "auto" resolves to "kernel" on a CUDA device
#: and to "torch" (the plain version) on the CPU — engine.make_local_solver.
LocalSolverKind = Literal["auto", "torch", "kernel"]


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    """Algorithm knobs (paper S3) — identical across backends."""
    bucket: int = 1                 # examples per bucket (1 = off)
    chunks: int = 1                 # v syncs per epoch (within pods)
    aggregation: Aggregation = "adding"
    partition: str = "hierarchical"  # static|dynamic|hierarchical|rotation|alltoall
    redeal_frac: float = 1.0        # alltoall: bucket fraction exchanged
    local_solver: LocalSolverKind = "auto"
    compress_sync: bool = False     # int8-quantize dv on the chunk sync
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class DeploymentConfig:
    """Where the solver runs: worker topology + wire/compute policies."""
    pods: int = 1                   # outer (static) worker axis
    lanes: int = 1                  # inner (dynamic) worker axis
    feature_shard: bool = False     # dense TP: shard d over 'model'
    compress_pod: bool = False      # int8 cross-pod epoch reduce
    # Bit-deterministic collectives.  The simulator's reductions are
    # ordered left-to-right adds either way; the field keeps configs
    # interchangeable with the reference until the multi-GPU path reads it.
    deterministic: bool = False


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The one config the engine's entry points consume."""
    algo: AlgoConfig = AlgoConfig()
    deployment: DeploymentConfig = DeploymentConfig()

    @classmethod
    def make(cls, **kw) -> "EngineConfig":
        """Build from flat kwargs, routing each to its layer."""
        af = {f.name for f in dataclasses.fields(AlgoConfig)}
        df = {f.name for f in dataclasses.fields(DeploymentConfig)}
        unknown = set(kw) - af - df
        if unknown:
            raise TypeError(f"unknown EngineConfig fields: {sorted(unknown)}")
        return cls(
            algo=AlgoConfig(**{k: v for k, v in kw.items() if k in af}),
            deployment=DeploymentConfig(
                **{k: v for k, v in kw.items() if k in df}))

    @property
    def workers(self) -> int:
        return self.deployment.pods * self.deployment.lanes

    def sigma_prime(self, workers: int | None = None) -> float:
        """CoCoA(+) subproblem scaling for `workers` independent solvers."""
        if self.algo.aggregation == "adding":
            return float(workers if workers is not None else self.workers)
        return 1.0


def as_engine_config(cfg) -> EngineConfig:
    """Accept an EngineConfig or anything exposing `.to_engine()`."""
    if isinstance(cfg, EngineConfig):
        return cfg
    to_engine = getattr(cfg, "to_engine", None)
    if to_engine is None:
        raise TypeError(f"cannot convert {type(cfg).__name__} to EngineConfig")
    return to_engine()
