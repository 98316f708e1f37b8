"""Danger-zone CMDP model: unicycle with goal/centre observation features.

Counterpart of ``mppi_playground_tpu/models/danger_zone.py`` (the
reference's ``GoalInDangerZoneEnv.parallel_step`` / ``parallel_cost``):
7-dim observation ``[x, y, theta, vec_to_goal(2), vec_to_center(2)]``; the
heading integrates *before* the position (unlike the navigation unicycle);
cost = distance to the goal + 1000 * the inside-the-danger-zone indicator.
Goal and centre are recovered from the observation itself (``goal = pos +
vec_to_goal``), so one solver serves every episode.

The SoA forms are the fused kernels' twins (``csrc/danger_zone_model.cuh``):
libm cos and sin; the collision test compares the distance, not its square,
with the radius, as the reference does.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from mppi_playground_tpu_torch.ops.fused_solve import FusedTask
from mppi_playground_tpu_torch.utils.angles import angle_normalize

DIM_STATE = 7
DIM_CONTROL = 2  # [v, omega]
U_MIN = (-1.0, -1.0)
U_MAX = (1.0, 1.0)
DELTA_T = 0.1
COLLISION_WEIGHT = 1000.0


def make_dynamics_soa(
    u_min: Tuple[float, float] = U_MIN,
    u_max: Tuple[float, float] = U_MAX,
    delta_t: float = DELTA_T,
):
    """Structure-of-arrays observation step."""

    def dynamics_soa(xs, us):
        x, y, th, gdx, gdy, cdx, cdy = xs
        gx, gy = x + gdx, y + gdy
        cx, cy = x + cdx, y + cdy
        v = torch.clamp(us[0], u_min[0], u_max[0])
        omega = torch.clamp(us[1], u_min[1], u_max[1])

        # heading updates before position (reference order)
        theta = angle_normalize(th + omega * delta_t)
        new_x = x + v * torch.cos(theta) * delta_t
        new_y = y + v * torch.sin(theta) * delta_t
        return (new_x, new_y, theta, gx - new_x, gy - new_y, cx - new_x, cy - new_y)

    return dynamics_soa


def make_dynamics(
    u_min: Tuple[float, float] = U_MIN,
    u_max: Tuple[float, float] = U_MAX,
    delta_t: float = DELTA_T,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Batched observation step on ``obs [K, 7]``, ``action [K, 2]``."""
    soa = make_dynamics_soa(u_min, u_max, delta_t)

    def dynamics(obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        xs = tuple(obs[:, c] for c in range(DIM_STATE))
        return torch.stack(soa(xs, (action[:, 0], action[:, 1])), dim=1)

    return dynamics


def make_cost_soa(radius: float, collision_weight: float = COLLISION_WEIGHT):
    """SoA CMDP cost."""

    def cost_soa(xs, us, ctx):
        _x, _y, _th, gdx, gdy, cdx, cdy = xs
        dist_to_goal = torch.sqrt(gdx * gdx + gdy * gdy)
        is_collided = torch.sqrt(cdx * cdx + cdy * cdy) < radius
        return dist_to_goal + is_collided.to(gdx.dtype) * collision_weight

    return cost_soa


def make_cost(
    radius: float, collision_weight: float = COLLISION_WEIGHT
) -> Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]:
    """Batched CMDP cost on ``obs [K, 7]``."""
    soa = make_cost_soa(radius, collision_weight)

    def cost(obs: torch.Tensor, action: torch.Tensor, info: dict) -> torch.Tensor:
        xs = tuple(obs[:, c] for c in range(DIM_STATE))
        return soa(xs, (action[:, 0], action[:, 1]), info)

    return cost


def make_fused_task(
    radius: float,
    collision_weight: float = COLLISION_WEIGHT,
    u_min: Tuple[float, float] = U_MIN,
    u_max: Tuple[float, float] = U_MAX,
    delta_t: float = DELTA_T,
) -> FusedTask:
    """The danger-zone model's :class:`FusedTask` for the fused CUDA solve."""
    return FusedTask(
        model="danger_zone",
        dynamics_soa=make_dynamics_soa(u_min, u_max, delta_t),
        stage_cost_soa=make_cost_soa(radius, collision_weight),
        floats=(*u_min, *u_max, delta_t, radius, collision_weight),
    )
