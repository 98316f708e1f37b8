"""Racing environment: kinematic bicycle on a circuit with obstacles.

Counterpart of ``mppi_playground_tpu/envs/racing_env.py``: 80x80 m maps at 0.1 m cells, a lane corridor of width ``6.5 * 0.8`` around
the circuit centerline, 50 random circle obstacles with r in [0.9, 1.2]
inside +-35 m (seed 42), start and goal at the path ends, and the bicycle
dynamics (each step the span ``env.dynamics`` of ``utils/timing``): on a CUDA
device one launch of ``ops/racing_plant`` (``csrc/racing_plant.cu``), which
raises on what it does not take, under ``torch.func.vmap`` too; elsewhere the
torch ops of ``models/bicycle.make_dynamics``.  The
maps are built on the host with numpy and uploaded once.  ``render``
draws the scene with matplotlib (``envs/rendering.py``) and ``close``
writes the captured frames as a GIF.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from mppi_playground_tpu_torch.envs import rendering
from mppi_playground_tpu_torch.maps.circuit import (
    default_circuit_paths,
    make_csv_paths,
    make_side_lane,
)
from mppi_playground_tpu_torch.maps.lane_map import LaneMap
from mppi_playground_tpu_torch.maps.obstacle_map import ObstacleMap, generate_random_obstacles
from mppi_playground_tpu_torch.models import bicycle
from mppi_playground_tpu_torch.ops import racing_plant
from mppi_playground_tpu_torch.utils.angles import angle_normalize
from mppi_playground_tpu_torch.utils import timing
from mppi_playground_tpu_torch.utils.device import resolve_device

_DYNAMICS = timing.Span("env.dynamics")


class RacingEnv:
    GOAL_THRESHOLD = 1.0

    def __init__(
        self,
        dtype: torch.dtype = torch.float32,
        seed: int = 42,
        csv_path: Optional[str] = None,
        circuit_seed: int = 7,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self._dtype = dtype
        self._seed = seed
        self.device = resolve_device(device)
        dev = self.device

        self.u_min = torch.tensor(bicycle.U_MIN, dtype=dtype, device=dev)
        self.u_max = torch.tensor(bicycle.U_MAX, dtype=dtype, device=dev)
        self.V_MAX = bicycle.V_MAX
        self.L = bicycle.WHEELBASE

        self.dl = 0.1
        self.line_width = 6.5
        if csv_path is not None:
            center, _, _ = make_csv_paths(csv_path, DL=self.dl)
        else:
            center, _, _ = default_circuit_paths(DL=self.dl, seed=circuit_seed)
        self.right_lane, self.left_lane = make_side_lane(center, lane_width=self.line_width)
        self.racing_center_path = torch.as_tensor(center, dtype=dtype, device=dev)

        self.map_size = (80, 80)
        self.cell_size = 0.1
        self._lane_map = LaneMap(
            lane=center,
            lane_width=self.line_width * 0.8,
            map_size=self.map_size,
            cell_size=self.cell_size,
            dtype=dtype,
            device=dev,
        )
        self._obstacle_map = ObstacleMap(
            map_size=self.map_size, cell_size=self.cell_size, dtype=dtype, device=dev
        )
        generate_random_obstacles(
            obstacle_map=self._obstacle_map,
            random_x_range=(-35, 35),
            random_y_range=(-35, 35),
            num_circle_obs=50,
            radius_range=(0.9, 1.2),
            num_rectangle_obs=0,
            width_range=(1.5, 2.0),
            height_range=(1.5, 2.0),
            max_iteration=1000,
            seed=seed,
        )

        self._start_pos = self.racing_center_path[0, :2]
        self._goal_pos = self.racing_center_path[-1, :2]
        x_lim = tuple(self._obstacle_map.x_lim)
        y_lim = tuple(self._obstacle_map.y_lim)
        plain = bicycle.make_dynamics(x_lim=x_lim, y_lim=y_lim)

        def dynamics(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
            with _DYNAMICS:
                return racing_plant.bicycle_step(x, u, plain, x_lim, y_lim)

        self.dynamics = dynamics
        self._robot_state = self._initial_state()
        self._fig = None
        self._ax = None
        self._rendered_frames = []

    def _initial_state(self) -> torch.Tensor:
        """Start at path[0] heading toward path[1], v=0."""
        heading = angle_normalize(
            torch.atan2(
                self.racing_center_path[1, 1] - self._start_pos[1],
                self.racing_center_path[1, 0] - self._start_pos[0],
            )
        )
        return torch.cat(
            [self._start_pos, heading[None], torch.zeros(1, dtype=self._dtype, device=self.device)]
        )

    @property
    def obstacle_map(self) -> ObstacleMap:
        return self._obstacle_map

    @property
    def lane_map(self) -> LaneMap:
        return self._lane_map

    @property
    def obstacle_cost_map(self):
        return self._obstacle_map.device_map

    @property
    def lane_cost_map(self):
        return self._lane_map.device_map

    def reset(self) -> torch.Tensor:
        self._robot_state = self._initial_state()
        self._rendered_frames = []
        if self._fig is not None:  # no figure left in pyplot's registry
            from matplotlib import pyplot as plt

            plt.close(self._fig)
        self._fig = None
        return self._robot_state

    def step(self, u: torch.Tensor) -> Tuple[torch.Tensor, bool]:
        """One simulation step and the goal check (reads one flag back to the host)."""
        u = torch.clamp(torch.as_tensor(u, dtype=self._dtype, device=self.device),
                        self.u_min, self.u_max)
        self._robot_state = self.dynamics(self._robot_state[None], u[None])[0]
        is_goal_reached = bool(
            torch.linalg.norm(self._robot_state[:2] - self._goal_pos) < self.GOAL_THRESHOLD
        )
        return self._robot_state, is_goal_reached

    def collision_check(self, state: torch.Tensor) -> torch.Tensor:
        """Occupancy along trajectories ``[B, T+1, 4]``."""
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
        action: Optional[torch.Tensor] = None,
        predicted_trajectory: Optional[torch.Tensor] = None,
        is_collisions: Optional[torch.Tensor] = None,
        top_samples: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        reference_trajectory: Optional[torch.Tensor] = None,
        mode: str = "human",
    ) -> None:
        """The scene and the car's telemetry; ``mode="rgb_array"`` captures a frame for
        :meth:`close`.  Reads the tensors on the host."""
        from matplotlib import pyplot as plt

        self._ensure_figure()
        ax = self._ax
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        self._obstacle_map.render(ax, zorder=10)

        center = rendering.host(self.racing_center_path)
        ax.plot(center[:, 0], center[:, 1], color="gray", linestyle="--", zorder=5)
        ax.plot(self.right_lane[:, 0], self.right_lane[:, 1], color="green", linestyle="--",
                zorder=5)
        ax.plot(self.left_lane[:, 0], self.left_lane[:, 1], color="green", linestyle="--",
                zorder=5)
        if reference_trajectory is not None:
            ref = rendering.host(reference_trajectory)
            ax.plot(ref[:, 0], ref[:, 1], color="red", linestyle="dotted", zorder=5)

        robot_x, robot_y, robot_theta, robot_v = rendering.host(self._robot_state)
        ax.scatter(robot_x, robot_y, marker="o", color="green", zorder=100)
        ax.quiver(robot_x, robot_y, robot_v * np.cos(robot_theta), robot_v * np.sin(robot_theta),
                  color="green", zorder=100)
        if action is not None:
            accel, steer = (float(v) for v in rendering.host(action)[:2])
            ax.quiver(robot_x, robot_y, self.L * np.cos(robot_theta + steer),
                      self.L * np.sin(robot_theta + steer), color="blue", zorder=100)
            ax.set_title(f"speed {robot_v:.2f} m/s | accel {accel:.2f} m/s^2 | "
                         f"steer {steer:.2f} rad")

        if top_samples is not None:
            rendering.draw_top_samples(ax, top_samples[0], top_samples[1])
        if predicted_trajectory is not None:
            rendering.draw_predicted_trajectory(
                ax, predicted_trajectory[None] if predicted_trajectory.ndim == 2
                else predicted_trajectory, is_collisions)

        if mode == "human":
            plt.pause(0.0001)
            plt.cla()
        elif mode == "rgb_array":
            self._rendered_frames.append(rendering.fig_to_rgb(self._fig))
            plt.cla()

    def close(self, path: Optional[str] = None) -> Optional[str]:
        """Write the captured frames as a GIF (``video/racing_<seed>.gif`` by default)."""
        if path is None:
            path = f"video/racing_{self._seed}.gif"
        return rendering.save_gif(self._rendered_frames, path)
