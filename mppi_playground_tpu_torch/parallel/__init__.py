"""Sample sharding and scenario batching over ``torch.distributed`` (the JAX package's
``parallel`` names)."""

from mppi_playground_tpu_torch.core.config import scenario_seed
from mppi_playground_tpu_torch.parallel.mesh import (
    SAMPLE_AXIS,
    SCENARIO_AXIS,
    initialize_distributed,
    make_mesh,
    replicated,
    sample_sharding,
)
from mppi_playground_tpu_torch.parallel.sharded import (
    BatchedFusedSolver,
    BatchedMPPISolver,
    ShardedFusedSolver,
    ShardedMPPISolver,
    make_batched_fused_solver,
    make_batched_solver,
    make_sharded_fused_solver,
    make_sharded_solver,
    scenario,
)

__all__ = [
    "SAMPLE_AXIS",
    "SCENARIO_AXIS",
    "BatchedFusedSolver",
    "BatchedMPPISolver",
    "ShardedFusedSolver",
    "ShardedMPPISolver",
    "initialize_distributed",
    "make_batched_fused_solver",
    "make_batched_solver",
    "make_mesh",
    "make_sharded_fused_solver",
    "make_sharded_solver",
    "replicated",
    "sample_sharding",
    "scenario",
    "scenario_seed",
]
