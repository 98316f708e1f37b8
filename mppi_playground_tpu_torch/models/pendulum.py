"""Pendulum swing-up dynamics and cost.

Counterpart of ``mppi_playground_tpu/models/pendulum.py`` (gymnasium
Pendulum-v1 physics): g=10, m=1, l=1, dt=0.05, torque clamp +-2, velocity
clamp +-8; stage cost ``angle_normalize(theta)^2 + 0.1*thetadot^2``.  State
``[theta, theta_dot]``, control ``[torque]``.  The SoA functions are the
fused kernels' twins (``csrc/classic_models.cuh`` ``Pendulum``): libm sin,
``x * x`` for the JAX package's ``x ** 2``.
"""

from __future__ import annotations

import math

import torch

from mppi_playground_tpu_torch.ops.fused_solve import FusedTask
from mppi_playground_tpu_torch.utils.angles import angle_normalize

DIM_STATE = 2
DIM_CONTROL = 1
U_MIN = (-2.0,)
U_MAX = (2.0,)

_GRAVITY = 10.0
_MASS = 1.0
_LENGTH = 1.0
_DT = 0.05


def dynamics_soa(xs, us):
    """Structure-of-arrays Euler step."""
    th, thdot = xs
    u = torch.clamp(us[0], -2.0, 2.0)
    newthdot = thdot + (
        -3.0 * _GRAVITY / (2.0 * _LENGTH) * torch.sin(th + math.pi)
        + 3.0 / (_MASS * _LENGTH**2) * u
    ) * _DT
    newth = th + newthdot * _DT
    newthdot = torch.clamp(newthdot, -8.0, 8.0)
    return (newth, newthdot)


def cost_soa(xs, us, ctx):
    """Swing-up stage cost on component tensors."""
    theta, theta_dt = xs
    th = angle_normalize(theta)
    return th * th + 0.1 * (theta_dt * theta_dt)


def dynamics(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Euler pendulum step over a ``[K, 2]`` batch."""
    return torch.stack(dynamics_soa((state[:, 0], state[:, 1]), (action[:, 0],)), dim=1)


def cost(state: torch.Tensor, action: torch.Tensor, info: dict) -> torch.Tensor:
    """Swing-up stage cost over a ``[K, 2]`` batch."""
    return cost_soa((state[:, 0], state[:, 1]), (action[:, 0],), info)


def fused_task() -> FusedTask:
    """Plug for the fused CUDA solve (``ops/fused_solve.py``)."""
    return FusedTask(model="pendulum", dynamics_soa=dynamics_soa, stage_cost_soa=cost_soa)
