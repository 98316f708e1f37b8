"""Mujoco inverted-pendulum example (approximate dynamics).

Counterpart of ``examples/mujoco_cartpole.py``: gymnasium's
InvertedPendulum-v4 driven by ``MPPI`` (horizon 50, 1,000 samples, sigma
1, lambda 1) over *approximate* cart-pole dynamics in torch, with
masspole=1.0 and the cart clamped to +-1; the model mismatch makes it a
demo, not a solved task.  The dynamics and cost are this module's own
(the unfused route).

Run: ``python -m mppi_playground_tpu_torch.examples.mujoco_cartpole
[--no-render] [--save-mode] [--steps N] [--device cpu]``.  Needs gymnasium
with mujoco (``gymnasium[mujoco]``).
"""

import argparse
import math
import time

import torch

from mppi_playground_tpu_torch import MPPI
from mppi_playground_tpu_torch.utils.angles import angle_normalize
from mppi_playground_tpu_torch.utils.device import resolve_device
from mppi_playground_tpu_torch.utils.timing import block_until_ready

# approximate dynamics with the mujoco example's constants
_GRAVITY = 9.8
_MASSCART = 1.0
_MASSPOLE = 1.0
_TOTAL_MASS = _MASSPOLE + _MASSCART
_LENGTH = 0.5
_POLEMASS_LENGTH = _MASSPOLE * _LENGTH
_TAU = 0.02
_X_THRESHOLD = 1.0
_THETA_THRESHOLD = 12 * 2 * math.pi / 360


def dynamics(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """One Euler step of the approximate cart-pole over a ``[K, 4]`` batch."""
    x, x_dt, theta, theta_dt = (state[:, i] for i in range(4))
    force = action[:, 0]
    costheta = torch.cos(theta)
    sintheta = torch.sin(theta)
    temp = (force + _POLEMASS_LENGTH * theta_dt**2 * sintheta) / _TOTAL_MASS
    thetaacc = (_GRAVITY * sintheta - costheta * temp) / (
        _LENGTH * (4.0 / 3.0 - _MASSPOLE * costheta**2 / _TOTAL_MASS)
    )
    xacc = temp - _POLEMASS_LENGTH * thetaacc * costheta / _TOTAL_MASS
    new_x = torch.clamp(x + _TAU * x_dt, -_X_THRESHOLD, _X_THRESHOLD)
    new_theta = torch.clamp(theta + _TAU * theta_dt, -_THETA_THRESHOLD, _THETA_THRESHOLD)
    return torch.stack(
        [new_x, x_dt + _TAU * xacc, new_theta, theta_dt + _TAU * thetaacc], dim=1
    )


def cost_func(state: torch.Tensor, action: torch.Tensor, info) -> torch.Tensor:
    """Upright pole, slow pole, centred cart."""
    return (
        angle_normalize(state[:, 2]) ** 2
        + 0.1 * state[:, 3] ** 2
        + 0.1 * state[:, 0] ** 2
    )


def make_solver(device=None) -> MPPI:
    """The example's controller: T=50, K=1,000, sigma 1, lambda 1, this module's model."""
    return MPPI(
        horizon=50,
        num_samples=1000,
        dim_state=4,
        dim_control=1,
        dynamics=dynamics,
        cost_func=cost_func,
        u_min=[-3.0],
        u_max=[3.0],
        sigmas=[1.0],
        lambda_=1.0,
        device=device,
    )


def main(save_mode: bool = False, steps: int = 500, render: bool = True, device=None):
    import gymnasium as gym

    device = resolve_device(device)
    if save_mode:
        env = gym.make("InvertedPendulum-v4", render_mode="rgb_array")
        env = gym.wrappers.RecordVideo(env=env, video_folder="video")
    elif render:
        try:
            env = gym.make("InvertedPendulum-v4", render_mode="human")
        except Exception as exc:  # headless hosts: no GLFW display
            print(f"human rendering unavailable ({exc}); running headless")
            env = gym.make("InvertedPendulum-v4")
    else:
        env = gym.make("InvertedPendulum-v4")
    observation, _ = env.reset(seed=42)

    solver = make_solver(device)

    average_time = 0.0
    for i in range(steps):
        start = time.time()
        action_seq, _ = solver.forward(
            state=torch.as_tensor(observation, dtype=torch.float32, device=device))
        block_until_ready(action_seq)
        elapsed = time.time() - start
        average_time = i / (i + 1) * average_time + elapsed / (i + 1)
        observation, *_ = env.step(action_seq[0].cpu().numpy())
        if env.render_mode is not None:
            env.render()

    print(f"average solve time: {average_time * 1000}  [ms]")
    env.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--save-mode", action="store_true")
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--no-render", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(save_mode=args.save_mode, steps=args.steps, render=not args.no_render,
         device=args.device)
