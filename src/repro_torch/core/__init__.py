"""Core: the paper's contribution — system-aware parallel SDCA.

Exports what the reference's `repro.core` does, except
`MeshCollectives` (multi-GPU, ROADMAP A11); the port has no
`Collectives` protocol apart from `SimCollectives`.
"""
from .bucketing import BucketPlan, choose_bucket_size, make_plan
from .cocoa import SolverConfig, epoch_sim, epoch_sim_sparse
from .config import (AlgoConfig, DeploymentConfig, EngineConfig,
                     as_engine_config)
from .engine import (ChunkFeed, DenseBlock, LocalSolver, SimCollectives,
                     SparseBlock, make_local_solver, make_streamed_epoch,
                     run_epoch, run_epoch_streamed, sharded_epoch)
from .objectives import (HINGE, LOGISTIC, OBJECTIVES, RIDGE, Objective,
                         duality_gap, dual_value, get_objective,
                         primal_value)
from .partition import PartitionPlan
from .sdca import (bucket_solve, dense_local_subepoch, sequential_epoch,
                   sparse_local_subepoch)
from .trainer import (FitResult, GLMTrainer, StreamedGLMTrainer,
                      fit_dataset)

__all__ = [
    "BucketPlan", "choose_bucket_size", "make_plan",
    "SolverConfig", "epoch_sim", "epoch_sim_sparse",
    "AlgoConfig", "DeploymentConfig", "EngineConfig", "as_engine_config",
    "ChunkFeed", "DenseBlock", "LocalSolver", "SimCollectives",
    "SparseBlock", "make_local_solver", "make_streamed_epoch",
    "run_epoch", "run_epoch_streamed", "sharded_epoch",
    "HINGE", "LOGISTIC", "OBJECTIVES", "RIDGE", "Objective",
    "duality_gap", "dual_value", "get_objective", "primal_value",
    "PartitionPlan",
    "bucket_solve", "dense_local_subepoch", "sequential_epoch",
    "sparse_local_subepoch",
    "FitResult", "GLMTrainer", "StreamedGLMTrainer", "fit_dataset",
]
