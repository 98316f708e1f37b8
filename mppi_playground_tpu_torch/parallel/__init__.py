"""Scenario-batched solvers (the JAX package's ``parallel`` names that are ported)."""

from mppi_playground_tpu_torch.core.config import scenario_seed
from mppi_playground_tpu_torch.parallel.sharded import (
    BatchedFusedSolver,
    BatchedMPPISolver,
    make_batched_fused_solver,
    make_batched_solver,
    scenario,
)

__all__ = [
    "BatchedFusedSolver",
    "BatchedMPPISolver",
    "make_batched_fused_solver",
    "make_batched_solver",
    "scenario",
    "scenario_seed",
]
