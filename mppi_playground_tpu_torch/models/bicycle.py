"""Kinematic-bicycle dynamics (racing vehicle model).

Counterpart of ``mppi_playground_tpu/models/bicycle.py``: state
``[x, y, theta, v]``, control ``[accel, steer]``; Euler integration at
dt=0.1 of ``xdot = v cos(theta)``, ``ydot = v sin(theta)``,
``thetadot = v tan(steer) / L``, ``vdot = accel``; position clamped to the
map, speed to +-V_MAX.  The operation order is the JAX package's, op for op,
and ``csrc/racing_model.cuh`` repeats it in CUDA; ``RacingEnv.dynamics`` steps
the plant on a card with one launch of it (``ops/racing_plant``), on the CPU
with :func:`make_dynamics`, the kernel's twin.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from mppi_playground_tpu_torch.utils.angles import angle_normalize
from mppi_playground_tpu_torch.utils.fastmath import sincos_npi

DIM_STATE = 4
DIM_CONTROL = 2
U_MIN = (-2.0, -0.25)
U_MAX = (2.0, 0.25)
WHEELBASE = 1.0
V_MAX = 8.0
DELTA_T = 0.1


def _tan_small(x: torch.Tensor) -> torch.Tensor:
    """Degree-7 odd Taylor tan, < 1e-7 from tan on |x| <= 0.25."""
    x2 = x * x
    return x * (
        1.0 + x2 * (1.0 / 3.0 + x2 * (2.0 / 15.0 + x2 * (17.0 / 315.0)))
    )


def make_dynamics_soa(
    x_lim: Tuple[float, float],
    y_lim: Tuple[float, float],
    u_min: Tuple[float, float] = U_MIN,
    u_max: Tuple[float, float] = U_MAX,
    wheelbase: float = WHEELBASE,
    v_max: float = V_MAX,
    delta_t: float = DELTA_T,
) -> Callable:
    """Structure-of-arrays bicycle step on tuples of same-shape tensors.

    The step is ``step_terms(xs, action_terms(us))``, both attributes of the
    returned function: the terms that depend on the action alone (the
    clamped acceleration times dt, tan of the clamped steer), then the step
    from them, as the CUDA kernels split it (``csrc/racing_model.cuh``), so
    that the terms of a whole sequence can be taken at once.
    """
    steer_bound = max(abs(float(u_min[1])), abs(float(u_max[1])))
    tan_fn = _tan_small if steer_bound <= 0.25 + 1e-6 else torch.tan

    def action_terms(us):
        accel_dt = torch.clamp(us[0], u_min[0], u_max[0]) * delta_t
        return accel_dt, tan_fn(torch.clamp(us[1], u_min[1], u_max[1]))

    def step_terms(xs, terms):
        x, y, theta, v = xs
        accel_dt, tan_steer = terms
        theta = angle_normalize(theta)
        sin_t, cos_t = sincos_npi(theta)
        new_x = torch.clamp(x + v * cos_t * delta_t, x_lim[0], x_lim[1])
        new_y = torch.clamp(y + v * sin_t * delta_t, y_lim[0], y_lim[1])
        new_theta = angle_normalize(theta + v * tan_steer / wheelbase * delta_t)
        new_v = torch.clamp(v + accel_dt, -v_max, v_max)
        return (new_x, new_y, new_theta, new_v)

    def dynamics_soa(xs, us):
        return step_terms(xs, action_terms(us))

    dynamics_soa.action_terms = action_terms
    dynamics_soa.step_terms = step_terms
    return dynamics_soa


def make_dynamics(
    x_lim: Tuple[float, float],
    y_lim: Tuple[float, float],
    u_min: Tuple[float, float] = U_MIN,
    u_max: Tuple[float, float] = U_MAX,
    wheelbase: float = WHEELBASE,
    v_max: float = V_MAX,
    delta_t: float = DELTA_T,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Kinematic bicycle Euler step on ``state [..., K, 4]``, ``action [..., K, 2]``."""
    soa = make_dynamics_soa(x_lim, y_lim, u_min, u_max, wheelbase, v_max, delta_t)

    def dynamics(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        xs = soa(
            (state[..., 0], state[..., 1], state[..., 2], state[..., 3]),
            (action[..., 0], action[..., 1]),
        )
        return torch.stack(xs, dim=-1)

    return dynamics
