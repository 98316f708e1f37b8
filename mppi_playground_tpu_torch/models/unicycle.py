"""Differential-drive (unicycle) dynamics and the navigation cost.

Counterpart of ``mppi_playground_tpu/models/unicycle.py`` (the reference's
``Navigation2DEnv.dynamics`` / ``cost_function``): Euler unicycle at dt=0.1
with action clamps and map-boundary position clamps; cost =
``||pos - goal|| + 10000 * occupancy``.

Factories return closures so that the environment (or a user) binds goal,
limits and map once.  The SoA forms are the fused kernels' twins
(``csrc/unicycle_model.cuh``): the polynomial sin/cos of the normalized
heading, and the single-grid read of ``maps/grid_cost.grid_occupancy``,
which equals ``grid_cost`` (the JAX package's fused kernel reads the same
map through its row-interval tables, equal by construction).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from mppi_playground_tpu_torch.maps.grid_cost import GridMapData, grid_occupancy, map_query
from mppi_playground_tpu_torch.ops.fused_solve import FusedTask
from mppi_playground_tpu_torch.utils.angles import angle_normalize
from mppi_playground_tpu_torch.utils.fastmath import sincos_npi

DIM_STATE = 3  # [x, y, theta]
DIM_CONTROL = 2  # [v, omega]
U_MIN = (0.0, -1.0)
U_MAX = (2.0, 1.0)
DELTA_T = 0.1
OBSTACLE_WEIGHT = 10000.0


def make_dynamics_soa(
    x_lim: Tuple[float, float],
    y_lim: Tuple[float, float],
    u_min: Tuple[float, float] = U_MIN,
    u_max: Tuple[float, float] = U_MAX,
    delta_t: float = DELTA_T,
):
    """Structure-of-arrays unicycle step."""

    def dynamics_soa(xs, us):
        x, y, theta = xs
        theta = angle_normalize(theta)
        v = torch.clamp(us[0], u_min[0], u_max[0])
        omega = torch.clamp(us[1], u_min[1], u_max[1])

        # polynomial sin/cos on the just-normalized heading (see bicycle)
        sin_t, cos_t = sincos_npi(theta)
        new_x = torch.clamp(x + v * cos_t * delta_t, x_lim[0], x_lim[1])
        new_y = torch.clamp(y + v * sin_t * delta_t, y_lim[0], y_lim[1])
        new_theta = angle_normalize(theta + omega * delta_t)
        return (new_x, new_y, new_theta)

    return dynamics_soa


def make_dynamics(
    x_lim: Tuple[float, float],
    y_lim: Tuple[float, float],
    u_min: Tuple[float, float] = U_MIN,
    u_max: Tuple[float, float] = U_MAX,
    delta_t: float = DELTA_T,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Unicycle Euler step with boundary clamp on ``state [K, 3]``, ``action [K, 2]``."""
    soa = make_dynamics_soa(x_lim, y_lim, u_min, u_max, delta_t)

    def dynamics(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        xs = soa((state[:, 0], state[:, 1], state[:, 2]), (action[:, 0], action[:, 1]))
        return torch.stack(xs, dim=1)

    return dynamics


def make_navigation_cost(
    goal: torch.Tensor,
    obstacle_map: GridMapData,
    obstacle_weight: float = OBSTACLE_WEIGHT,
) -> Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]:
    """Goal-distance + occupancy-penalty cost on ``state [K, 3]`` (``goal [2]`` a tensor).

    ``obstacle_map`` is either form (``maps/grid_cost.map_query``).
    """

    def cost(state: torch.Tensor, action: torch.Tensor, info: dict) -> torch.Tensor:
        d = state[:, :2] - goal
        goal_cost = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])  # the 2-norm
        obstacle_cost = map_query(obstacle_map, state[:, :2])
        return goal_cost + obstacle_weight * obstacle_cost

    return cost


def make_navigation_cost_soa(
    goal: Tuple[float, float],
    grid: torch.Tensor,
    origin: Tuple[float, float],
    cell_size: float,
    obstacle_weight: float = OBSTACLE_WEIGHT,
):
    """SoA navigation cost on a ``[W, H]`` uint8 grid (nonzero = blocked)."""
    gx, gy = float(goal[0]), float(goal[1])

    def cost_soa(xs, us, ctx):
        x, y, _theta = xs
        dx = x - gx
        dy = y - gy
        goal_cost = torch.sqrt(dx * dx + dy * dy)
        obstacle_cost = grid_occupancy(grid, origin, cell_size, x, y)
        return goal_cost + obstacle_weight * obstacle_cost

    return cost_soa


def make_navigation_fused_task(
    grid: torch.Tensor,
    origin: Tuple[float, float],
    cell_size: float,
    goal: Tuple[float, float],
    x_lim: Tuple[float, float],
    y_lim: Tuple[float, float],
    obstacle_weight: float = OBSTACLE_WEIGHT,
) -> FusedTask:
    """The navigation model's :class:`FusedTask` for the fused CUDA solve.

    ``grid`` is the ``[W, H]`` uint8 occupancy on the solver's device,
    ``origin`` the cell coordinates of the world origin.
    """
    origin = (float(origin[0]), float(origin[1]))
    return FusedTask(
        model="navigation",
        dynamics_soa=make_dynamics_soa(x_lim=x_lim, y_lim=y_lim),
        stage_cost_soa=make_navigation_cost_soa(goal, grid, origin, cell_size, obstacle_weight),
        floats=(*x_lim, *y_lim, *origin, cell_size, U_MIN[0], U_MIN[1], U_MAX[0], U_MAX[1],
                DELTA_T, *goal, obstacle_weight),
        ints=tuple(int(v) for v in grid.shape),
        grids=(grid,),
    )
