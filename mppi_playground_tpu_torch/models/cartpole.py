"""Cartpole swing-up dynamics and cost (gymnasium CartPole-v1 physics).

Counterpart of ``mppi_playground_tpu/models/cartpole.py``: tau=0.02, the
bang-bang mapping of the continuous MPPI action to +-force_mag (``u >= 0``
gives +10 N), the position and angle clamps, and stage cost
``angle_normalize(theta)^2 + 0.1*theta_dot^2 + 0.1*x^2``.  State
``[x, x_dot, theta, theta_dot]``, control ``[u]`` with solver bounds +-3.

The SoA functions are the fused kernels' twins (``csrc/classic_models.cuh``
``Cartpole``): libm sin and cos, ``x * x`` for ``x ** 2``, and division by
0-dim tensors where the model divides by a constant (PyTorch on the card
multiplies by the reciprocal of a Python scalar divisor, which rounds
differently).
"""

from __future__ import annotations

import math

import torch

from mppi_playground_tpu_torch.ops.fused_solve import FusedTask
from mppi_playground_tpu_torch.utils.angles import angle_normalize

DIM_STATE = 4
DIM_CONTROL = 1
U_MIN = (-3.0,)
U_MAX = (3.0,)

_GRAVITY = 9.8
_MASSCART = 1.0
_MASSPOLE = 0.1
_TOTAL_MASS = _MASSPOLE + _MASSCART
_LENGTH = 0.5  # actually half the pole's length
_POLEMASS_LENGTH = _MASSPOLE * _LENGTH
_FORCE_MAG = 10.0
_TAU = 0.02
_X_THRESHOLD = 2.4
_THETA_THRESHOLD = 12 * 2 * math.pi / 360


def dynamics_soa(xs, us):
    """Structure-of-arrays Euler step."""
    x, x_dt, theta, theta_dt = xs
    total_mass = torch.full((), _TOTAL_MASS, dtype=theta.dtype, device=theta.device)

    # bang-bang: continuous sample -> +-force_mag
    force = torch.where(us[0] >= 0, _FORCE_MAG, -_FORCE_MAG).to(theta.dtype)

    costheta = torch.cos(theta)
    sintheta = torch.sin(theta)
    temp = (force + _POLEMASS_LENGTH * (theta_dt * theta_dt) * sintheta) / total_mass
    thetaacc = (_GRAVITY * sintheta - costheta * temp) / (
        _LENGTH * (4.0 / 3.0 - _MASSPOLE * (costheta * costheta) / total_mass)
    )
    xacc = temp - _POLEMASS_LENGTH * thetaacc * costheta / total_mass

    new_x = torch.clamp(x + _TAU * x_dt, -_X_THRESHOLD, _X_THRESHOLD)
    new_x_dt = x_dt + _TAU * xacc
    new_theta = torch.clamp(theta + _TAU * theta_dt, -_THETA_THRESHOLD, _THETA_THRESHOLD)
    new_theta_dt = theta_dt + _TAU * thetaacc
    return (new_x, new_x_dt, new_theta, new_theta_dt)


def cost_soa(xs, us, ctx):
    """Stage cost on component tensors."""
    x, _x_dt, theta, theta_dt = xs
    th = angle_normalize(theta)
    return th * th + 0.1 * (theta_dt * theta_dt) + 0.1 * (x * x)


def dynamics(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Euler cartpole step over a ``[K, 4]`` batch."""
    xs = (state[:, 0], state[:, 1], state[:, 2], state[:, 3])
    return torch.stack(dynamics_soa(xs, (action[:, 0],)), dim=1)


def cost(state: torch.Tensor, action: torch.Tensor, info: dict) -> torch.Tensor:
    """Stage cost over a ``[K, 4]`` batch."""
    xs = (state[:, 0], state[:, 1], state[:, 2], state[:, 3])
    return cost_soa(xs, (action[:, 0],), info)


def fused_task() -> FusedTask:
    """Plug for the fused CUDA solve (``ops/fused_solve.py``)."""
    return FusedTask(model="cartpole", dynamics_soa=dynamics_soa, stage_cost_soa=cost_soa)
