"""Goal-in-danger-zone CMDP environment.

Counterpart of ``mppi_playground_tpu/envs/goal_in_danger_zone.py``: a
circular danger zone (radius 10 at the origin), the
goal drawn inside it and the start outside; a 7-dim observation; a host
``step`` in numpy returning the CMDP-style (reward, cost); and the batched
``parallel_step`` / ``parallel_cost`` on tensors that the solver takes as
dynamics and cost.  Where gymnasium imports, the env is a ``gym.Env`` with
the JAX env's ``action_space`` and ``observation_space``; without it, a
plain class with the same methods.  ``render`` draws the zone, the goal, the
robot and the solver's plan (``set_render_info``) with matplotlib; in
``render_mode="rgb_array"`` it returns and keeps each frame, and ``close``
writes them as a GIF.

``reset(seed=...)`` draws from ``np.random.default_rng(seed)``, the
generator gymnasium's ``np_random`` builds from a seed, in the JAX env's
order, so a seed gives the JAX env's start, heading and goal; without a
seed the stream continues (a fresh unseeded one on the first reset).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mppi_playground_tpu_torch.envs import rendering
from mppi_playground_tpu_torch.models import danger_zone as dz_model

try:
    import gymnasium as gym
    from gymnasium import spaces

    _GYM_BASE = gym.Env
except ImportError:
    spaces = None
    _GYM_BASE = object


class DangerZone:
    """Circular danger region."""

    def __init__(self, shape: str = "circle", cfg: Optional[dict] = None):
        cfg = cfg or {}
        if shape != "circle":
            raise ValueError(f"Invalid shape: {shape}")
        self._shape = shape
        self.radius = cfg["radius"]
        self.center = np.asarray(cfg["center"], dtype=float)

    def get_random_inside_point(self, rng=None) -> np.ndarray:
        rng = np.random if rng is None else rng
        angle = rng.uniform(0, 2 * np.pi)
        radius = rng.uniform(0, self.radius)
        return np.array([radius * np.cos(angle), radius * np.sin(angle)]) + self.center

    def get_random_outside_point(self, rng=None) -> np.ndarray:
        rng = np.random if rng is None else rng
        angle = rng.uniform(0, 2 * np.pi)
        radius = rng.uniform(self.radius, 2 * self.radius)
        return np.array([radius * np.cos(angle), radius * np.sin(angle)]) + self.center

    def is_inside(self, pos: np.ndarray) -> bool:
        return bool(np.linalg.norm(pos - self.center) < self.radius)

    def render(self, ax) -> None:
        """The zone as a grey disk on a matplotlib axes."""
        from matplotlib import pyplot as plt

        ax.set_xlim(-self.radius * 2, self.radius * 2)
        ax.set_ylim(-self.radius * 2, self.radius * 2)
        ax.add_artist(plt.Circle(self.center, self.radius, color="gray", alpha=0.5))


class GoalInDangerZoneEnv(_GYM_BASE):
    """CMDP navigation env: observation ``[x, y, theta, vec_to_goal, vec_to_center]``."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 50}

    def __init__(self, seed: int = 42, cfg: Optional[dict] = None, render_mode: str = "human"):
        cfg = cfg or {"shape": "circle", "radius": 10.0, "center": [0.0, 0.0]}
        self.render_mode = render_mode
        self._seed = seed
        self._danger_zone = DangerZone(shape=cfg.get("shape", "circle"), cfg=cfg)
        self._v_max, self._omega_max = 1.0, 1.0
        self._v_min, self._omega_min = -1.0, -1.0
        self._dt = 0.1
        self.max_episode_steps = 100
        self._rng: Optional[np.random.Generator] = None
        if spaces is not None:
            self.action_space = spaces.Box(
                low=np.array([self._v_min, self._omega_min]),
                high=np.array([self._v_max, self._omega_max]),
                dtype=np.float32,
            )
            high = np.inf * np.ones(7)
            self.observation_space = spaces.Box(-high, high, dtype=np.float32)

        # batched solver-facing callables (models/danger_zone.py)
        self.parallel_step = dz_model.make_dynamics()
        self._parallel_cost = dz_model.make_cost(radius=self._danger_zone.radius)
        self._step = 0
        self._fig = None
        self._ax = None
        self._frames = []
        self.set_render_info()

    @property
    def danger_zone(self) -> DangerZone:
        """The env's danger region (centre, radius, is_inside)."""
        return self._danger_zone

    def parallel_cost(self, obs: torch.Tensor, action: torch.Tensor, info) -> torch.Tensor:
        """Batched CMDP cost on ``obs [K, 7]``."""
        return self._parallel_cost(obs, action, info)

    def fused_task(self):
        """The danger-zone model's plug for the fused kernels (``core/fused_solver.py``)."""
        return dz_model.make_fused_task(radius=float(self._danger_zone.radius))

    def _observe(self) -> np.ndarray:
        vec_to_goal = self._goal - self._pos
        vec_to_center = self._danger_zone.center - self._pos
        return np.concatenate([self._pos, [self._angle], vec_to_goal, vec_to_center]).astype(
            np.float32
        )

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None
              ) -> Tuple[np.ndarray, dict]:
        """Draw a start outside the zone, a heading and a goal inside it."""
        if seed is not None or self._rng is None:
            self._rng = np.random.default_rng(seed)
        rng = self._rng
        self._pos = self._danger_zone.get_random_outside_point(rng)
        self._angle = rng.uniform(-np.pi, np.pi)
        self._goal = self._danger_zone.get_random_inside_point(rng)
        self._step = 0
        return self._observe(), {"cost": 0.0}

    def step(self, action) -> Tuple[np.ndarray, float, bool, bool, dict]:
        """Host sim step -> (obs, reward, terminated, truncated, {"cost"})."""
        if isinstance(action, torch.Tensor):
            action = action.detach().cpu().numpy()
        action = np.asarray(action)
        prev_pos = self._pos.copy()
        v = np.clip(action[0], self._v_min, self._v_max)
        omega = np.clip(action[1], self._omega_min, self._omega_max)

        self._angle = float(((self._angle + omega * self._dt + np.pi) % (2 * np.pi)) - np.pi)
        self._pos = self._pos + v * self._dt * np.array([np.cos(self._angle),
                                                         np.sin(self._angle)])

        prev_distance = np.linalg.norm(prev_pos - self._goal)
        distance = np.linalg.norm(self._pos - self._goal)
        is_collided = self._danger_zone.is_inside(self._pos)

        reward = float(prev_distance - distance)
        cost = float(is_collided)
        terminated = False
        truncated = self._step >= self.max_episode_steps
        self._step += 1
        return self._observe(), reward, terminated, truncated, {"cost": cost}

    # ------------------------------------------------------------------
    def set_render_info(
        self,
        is_colllision: Optional[bool] = None,
        predicted_trajectory=None,
        top_samples=None,
    ) -> None:
        """What the next :meth:`render` draws besides the scene (tensors or arrays)."""
        self._is_collision = is_colllision
        self._predicted_trajectory = predicted_trajectory
        self._top_samples = top_samples

    def render(self) -> Optional[np.ndarray]:
        """Draw the scene; in ``rgb_array`` mode return the frame and keep it for :meth:`close`."""
        from matplotlib import pyplot as plt

        if self._fig is None:
            self._fig = plt.figure(layout="tight")
            self._ax = self._fig.add_subplot()
            self._ax.set_aspect("equal")
        ax = self._ax

        self._danger_zone.render(ax)
        ax.scatter(self._goal[0], self._goal[1], marker="o", color="orange", zorder=10)
        if self._is_collision is not None:
            color = "red" if self._is_collision else "green"
            ax.scatter(self._pos[0], self._pos[1], marker="o", color=color, zorder=100)
        if self._predicted_trajectory is not None:
            traj = rendering.host(self._predicted_trajectory)
            ax.scatter(traj[:, 0], traj[:, 1], color="darkblue", marker="o", s=3, zorder=2)
        if self._top_samples is not None:
            rendering.draw_top_samples(ax, self._top_samples[0], self._top_samples[1])

        if self.render_mode == "human":
            plt.pause(0.01)
            plt.cla()
        elif self.render_mode == "rgb_array":
            frame = rendering.fig_to_rgb(self._fig)
            plt.cla()
            self._frames.append(frame)
            return frame
        return None

    def close(self, path: Optional[str] = None) -> Optional[str]:
        """Write the kept frames as a GIF (``video/goal_in_danger_zone.gif`` by default) and
        release the figure; the frames are cleared either way."""
        written = None
        if self._frames:
            written = rendering.save_gif(self._frames, path or "video/goal_in_danger_zone.gif")
        self._frames = []
        if self._fig is not None:
            from matplotlib import pyplot as plt

            plt.close(self._fig)
            self._fig = None
        return written
