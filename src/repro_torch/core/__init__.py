"""Core: the paper's contribution — system-aware parallel SDCA.

Exports what the reference's `repro.core` does.  The collectives are
`SimCollectives`, its one-device mesh mirror `StackedMeshCollectives`
and `MeshCollectives` across processes (`torch.distributed`); the port
has no `Collectives` protocol apart from them.
`sim_sharded_dense_epoch` and `sim_sharded_sparse_epoch` are the sim
sides of the sim-equals-mesh contract (`launch.glm.make_dense_epoch`,
`make_sparse_epoch`).
"""
from .bucketing import BucketPlan, choose_bucket_size, make_plan
from .cocoa import SolverConfig, epoch_sim, epoch_sim_sparse
from .config import (AlgoConfig, DeploymentConfig, EngineConfig,
                     as_engine_config)
from .engine import (ChunkFeed, DenseBlock, LocalSolver, MeshChunkFeed,
                     MeshCollectives, MeshSchedule, MeshStreamDriver,
                     SimCollectives, SparseBlock, StackedMeshCollectives,
                     make_local_solver, make_mesh_streamed_step,
                     make_streamed_epoch, q_psum, run_epoch,
                     run_epoch_streamed, sharded_epoch,
                     sim_sharded_dense_epoch, sim_sharded_sparse_epoch)
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
    "ChunkFeed", "DenseBlock", "LocalSolver", "MeshChunkFeed",
    "MeshCollectives", "MeshSchedule", "MeshStreamDriver",
    "SimCollectives", "SparseBlock", "StackedMeshCollectives",
    "make_local_solver", "make_mesh_streamed_step", "make_streamed_epoch", "q_psum", "run_epoch", "run_epoch_streamed",
    "sharded_epoch", "sim_sharded_dense_epoch", "sim_sharded_sparse_epoch",
    "HINGE", "LOGISTIC", "OBJECTIVES", "RIDGE", "Objective",
    "duality_gap", "dual_value", "get_objective", "primal_value",
    "PartitionPlan",
    "bucket_solve", "dense_local_subepoch", "sequential_epoch",
    "sparse_local_subepoch",
    "FitResult", "GLMTrainer", "StreamedGLMTrainer", "fit_dataset",
]
