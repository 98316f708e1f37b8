"""Minimal integrator task of the README quick-start.

Counterpart of ``mppi_playground_tpu/models/integrator.py``: dynamics
``next = state + action``; cost = squared distance to the goal ``(1, 1)``.
The smallest model, and the fused kernels' simplest plug
(``csrc/classic_models.cuh`` ``Integrator``).
"""

from __future__ import annotations

import torch

from mppi_playground_tpu_torch.ops.fused_solve import FusedTask

DIM_STATE = 2
DIM_CONTROL = 2
U_MIN = (-1.0, -1.0)
U_MAX = (1.0, 1.0)

GOAL = (1.0, 1.0)


def dynamics_soa(xs, us):
    """Structure-of-arrays step (the fused kernels' twin)."""
    return tuple(x + u for x, u in zip(xs, us))


def cost_soa(xs, us, ctx):
    d0 = xs[0] - GOAL[0]
    d1 = xs[1] - GOAL[1]
    return d0 * d0 + d1 * d1


def dynamics(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    return state + action


def cost(state: torch.Tensor, action: torch.Tensor, info: dict) -> torch.Tensor:
    return cost_soa((state[:, 0], state[:, 1]), (action[:, 0], action[:, 1]), info)


def fused_task() -> FusedTask:
    """Plug for the fused CUDA solve (``ops/fused_solve.py``)."""
    return FusedTask(model="integrator", dynamics_soa=dynamics_soa, stage_cost_soa=cost_soa)
