"""2D navigation environment: a differential-drive robot among obstacles.

Counterpart of ``mppi_playground_tpu/envs/navigation_2d.py``: a 20x20 m map at 0.1 m cells with 7 random circles (r=1) and 7
random 2x2 rectangles inside +-7.5 m (seed 42), start (-9, -9) facing the
goal (9, 9); unicycle dynamics, the goal-plus-occupancy cost, the goal test
and the per-trajectory collision check.  The map is built on the host with
numpy (byte for byte the JAX package's grid) and uploaded once to
``device``; :meth:`fused_task` hands it to the fused kernels as uint8.
``render`` draws the scene with matplotlib (``envs/rendering.py``) and
``close`` writes the captured frames as a GIF.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from mppi_playground_tpu_torch.envs import rendering
from mppi_playground_tpu_torch.maps.obstacle_map import ObstacleMap, generate_random_obstacles
from mppi_playground_tpu_torch.models import unicycle
from mppi_playground_tpu_torch.ops.fused_solve import FusedTask
from mppi_playground_tpu_torch.utils.angles import angle_normalize
from mppi_playground_tpu_torch.utils.device import resolve_device


class Navigation2DEnv:
    GOAL_THRESHOLD = 0.5

    def __init__(
        self,
        dtype: torch.dtype = torch.float32,
        seed: int = 42,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self._dtype = dtype
        self._seed = seed
        self.device = resolve_device(device)
        dev = self.device

        self._obstacle_map = ObstacleMap(map_size=(20, 20), cell_size=0.1, dtype=dtype, device=dev)
        generate_random_obstacles(
            obstacle_map=self._obstacle_map,
            random_x_range=(-7.5, 7.5),
            random_y_range=(-7.5, 7.5),
            num_circle_obs=7,
            radius_range=(1, 1),
            num_rectangle_obs=7,
            width_range=(2, 2),
            height_range=(2, 2),
            max_iteration=1000,
            seed=seed,
        )

        self._start_pos = torch.tensor([-9.0, -9.0], dtype=dtype, device=dev)
        self._goal_pos = torch.tensor([9.0, 9.0], dtype=dtype, device=dev)

        # u: [v, omega] (m/s, rad/s)
        self.u_min = torch.tensor(unicycle.U_MIN, dtype=dtype, device=dev)
        self.u_max = torch.tensor(unicycle.U_MAX, dtype=dtype, device=dev)

        self.dynamics = unicycle.make_dynamics(
            x_lim=tuple(self._obstacle_map.x_lim), y_lim=tuple(self._obstacle_map.y_lim)
        )
        self.cost_function = unicycle.make_navigation_cost(
            goal=self._goal_pos, obstacle_map=self._obstacle_map.device_map
        )
        self._robot_state = self._initial_state()
        self._fig = None
        self._ax = None
        self._rendered_frames = []

    def _initial_state(self) -> torch.Tensor:
        delta = self._goal_pos - self._start_pos
        heading = angle_normalize(torch.atan2(delta[1], delta[0]))
        return torch.cat([self._start_pos, heading[None]])

    @property
    def goal_pos(self) -> torch.Tensor:
        """Goal position ``[2]``."""
        return self._goal_pos

    @property
    def obstacle_map(self) -> ObstacleMap:
        return self._obstacle_map

    def fused_task(self) -> FusedTask:
        """The navigation model's plug for the fused kernels (``core/fused_solver.py``)."""
        grid = torch.as_tensor(self._obstacle_map.grid != 0, dtype=torch.uint8,
                               device=self.device).contiguous()
        return unicycle.make_navigation_fused_task(
            grid,
            origin=tuple(float(v) for v in self._obstacle_map.origin),
            cell_size=float(self._obstacle_map.cell_size),
            goal=tuple(float(v) for v in self._goal_pos.tolist()),
            x_lim=tuple(float(v) for v in self._obstacle_map.x_lim),
            y_lim=tuple(float(v) for v in self._obstacle_map.y_lim),
        )

    def reset(self) -> torch.Tensor:
        """Reset the robot to the start, facing the goal, and the rendering figure."""
        self._robot_state = self._initial_state()
        self._rendered_frames = []
        if self._fig is not None:  # no figure left in pyplot's registry
            from matplotlib import pyplot as plt

            plt.close(self._fig)
        self._fig = None
        return self._robot_state

    def step(self, u: torch.Tensor) -> Tuple[torch.Tensor, bool]:
        """One simulation step and the goal check (reads one bool back to the host)."""
        u = torch.clamp(torch.as_tensor(u, dtype=self._dtype, device=self.device),
                        self.u_min, self.u_max)
        self._robot_state = self.dynamics(self._robot_state[None], u[None])[0]
        distance = torch.linalg.norm(self._robot_state[:2] - self._goal_pos)
        return self._robot_state, bool(distance < self.GOAL_THRESHOLD)

    def collision_check(self, state: torch.Tensor) -> torch.Tensor:
        """Occupancy along trajectories ``[B, T+1, 3]`` -> ``[B, T+1]``."""
        return self._obstacle_map.compute_cost(state[:, :, :2])

    # ------------------------------------------------------------------
    def _ensure_figure(self):
        if self._fig is None:
            from matplotlib import pyplot as plt

            self._fig = plt.figure(layout="tight")
            self._ax = self._fig.add_subplot()
            self._ax.set_xlim(self._obstacle_map.x_lim)
            self._ax.set_ylim(self._obstacle_map.y_lim)
            self._ax.set_aspect("equal")

    def render(
        self,
        predicted_trajectory: Optional[torch.Tensor] = None,
        is_collisions: Optional[torch.Tensor] = None,
        top_samples: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        mode: str = "human",
    ) -> None:
        """Draw the scene; ``mode="rgb_array"`` captures a frame for :meth:`close`.  Reads the
        tensors on the host."""
        from matplotlib import pyplot as plt

        self._ensure_figure()
        ax = self._ax
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        self._obstacle_map.render(ax, zorder=10)
        ax.scatter(*rendering.host(self._start_pos), marker="o", color="red", zorder=10)
        ax.scatter(*rendering.host(self._goal_pos), marker="o", color="orange", zorder=10)
        state = rendering.host(self._robot_state)
        ax.scatter(state[0], state[1], marker="o", color="green", zorder=100)

        if top_samples is not None:
            rendering.draw_top_samples(ax, top_samples[0], top_samples[1])
        if predicted_trajectory is not None:
            rendering.draw_predicted_trajectory(
                ax, predicted_trajectory[None] if predicted_trajectory.ndim == 2
                else predicted_trajectory, is_collisions)

        if mode == "human":
            plt.pause(0.001)
            plt.cla()
        elif mode == "rgb_array":
            self._rendered_frames.append(rendering.fig_to_rgb(self._fig))
            plt.cla()

    def close(self, path: Optional[str] = None) -> Optional[str]:
        """Write the captured frames as a GIF (``video/navigation_2d_<seed>.gif`` by default)."""
        if path is None:
            path = f"video/navigation_2d_{self._seed}.gif"
        return rendering.save_gif(self._rendered_frames, path)
