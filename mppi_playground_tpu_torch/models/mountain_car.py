"""Continuous mountain-car dynamics and cost.

Counterpart of ``mppi_playground_tpu/models/mountain_car.py`` (gymnasium
MountainCarContinuous-v0 physics): power=0.0015, gravity term
``0.0025*cos(3x)``, velocity clamp +-0.07, position clamp [-1.2, 0.6]; cost
``(0.45 - position)^2``.  State ``[position, velocity]``, control
``[force]`` in +-1.  The SoA functions are the fused kernels' twins
(``csrc/classic_models.cuh`` ``MountainCar``): libm cos, ``x * x``.
"""

from __future__ import annotations

import torch

from mppi_playground_tpu_torch.ops.fused_solve import FusedTask

DIM_STATE = 2
DIM_CONTROL = 1
U_MIN = (-1.0,)
U_MAX = (1.0,)

_POWER = 0.0015
_MIN_POSITION = -1.2
_MAX_POSITION = 0.6
_MAX_SPEED = 0.07
_GOAL_POSITION = 0.45


def dynamics_soa(xs, us):
    """Structure-of-arrays step."""
    position, velocity = xs
    force = torch.clamp(us[0], -1.0, 1.0)
    velocity = velocity + force * _POWER - 0.0025 * torch.cos(3 * position)
    velocity = torch.clamp(velocity, -_MAX_SPEED, _MAX_SPEED)
    position = torch.clamp(position + velocity, _MIN_POSITION, _MAX_POSITION)
    return (position, velocity)


def cost_soa(xs, us, ctx):
    """Distance-to-goal cost on component tensors."""
    d = _GOAL_POSITION - xs[0]
    return d * d


def dynamics(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Mountain-car step over a ``[K, 2]`` batch."""
    return torch.stack(dynamics_soa((state[:, 0], state[:, 1]), (action[:, 0],)), dim=1)


def cost(state: torch.Tensor, action: torch.Tensor, info: dict) -> torch.Tensor:
    """Distance-to-goal cost over a ``[K, 2]`` batch."""
    return cost_soa((state[:, 0], state[:, 1]), (action[:, 0],), info)


def fused_task() -> FusedTask:
    """Plug for the fused CUDA solve (``ops/fused_solve.py``)."""
    return FusedTask(model="mountain_car", dynamics_soa=dynamics_soa, stage_cost_soa=cost_soa)
