"""Cartpole balancing example.

Counterpart of ``examples/cartpole.py``: gymnasium CartPole-v1 with
``MPPI`` at horizon 10, 100 samples, sigma 1.0, lambda 0.001; the solver
plans in a continuous action whose sign selects the discrete env action
(the bang-bang gym action).  Falls back to the internal dynamics as
simulator when gymnasium cannot make its env; ``--episode`` runs every
tick through ``MPPI.run_episode``.

Run: ``python -m mppi_playground_tpu_torch.examples.cartpole [--episode]
[--no-gym] [--steps N] [--device cpu]``.  Needs gymnasium (and pygame for
its window) only for the gym plant.
"""

import argparse
import time

import numpy as np
import torch

from mppi_playground_tpu_torch import MPPI
from mppi_playground_tpu_torch.models import cartpole
from mppi_playground_tpu_torch.utils.device import resolve_device
from mppi_playground_tpu_torch.utils.timing import block_until_ready


def make_solver(device=None) -> MPPI:
    """The example's controller: T=10, K=100, sigma 1, lambda 0.001."""
    return MPPI(
        horizon=10,
        num_samples=100,
        dim_state=4,
        dim_control=1,
        dynamics=cartpole.dynamics,
        cost_func=cartpole.cost,
        u_min=[-3.0],
        u_max=[3.0],
        sigmas=[1.0],
        lambda_=0.001,
        device=device,
    )


def main(save_mode: bool = False, steps: int = 500, use_gym: bool = True,
         episode: bool = False, device=None):
    device = resolve_device(device)
    env = None
    if use_gym and not episode:
        try:
            import gymnasium

            if save_mode:
                env = gymnasium.make("CartPole-v1", render_mode="rgb_array")
                env = gymnasium.wrappers.RecordVideo(env=env, video_folder="video")
            else:
                env = gymnasium.make("CartPole-v1", render_mode="human")
            observation, _ = env.reset(seed=42)
        except Exception as exc:  # no gymnasium, no display
            print(f"gymnasium unavailable ({exc}); using internal simulator")
            env = None
    if env is None:
        observation = np.array([0.0, 0.0, 0.05, 0.0], np.float32)
    state = torch.as_tensor(observation, dtype=torch.float32, device=device)

    solver = make_solver(device)

    if episode:
        # --episode: every tick through run_episode on the internal
        # bang-bang dynamics (gymnasium's step cannot run inside a graph)
        if save_mode:
            print("episode mode: gymnasium rendering/video export "
                  "unavailable (states stay on device)")

        def plant_fn(x, u):
            return cartpole.dynamics(x[None], u[None])[0]

        start = time.time()
        xs, _us = solver.run_episode(plant_fn, state, steps)
        angle = float(xs[-1, 2])
        elapsed = time.time() - start
        print(f"episode: {steps} ticks in {elapsed:.2f} s "
              f"({elapsed / steps * 1000:.2f} ms/tick incl. compile)")
        print(f"final pole angle: {angle:.4f}")
        return

    average_time = 0.0
    for i in range(steps):
        start = time.time()
        action_seq, _state_seq = solver.forward(state=state)
        block_until_ready(action_seq)
        elapsed = time.time() - start
        average_time = i / (i + 1) * average_time + elapsed / (i + 1)

        # continuous plan -> discrete env action
        discrete_action = 0 if float(action_seq[0, 0]) < 0 else 1
        if env is not None:
            observation, *_ = env.step(discrete_action)
            env.render()
            state = torch.as_tensor(observation, dtype=torch.float32, device=device)
        else:
            state = cartpole.dynamics(state[None], action_seq[None, 0])[0]

    print(f"average solve time: {average_time * 1000}  [ms]")
    if env is not None:
        env.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--save-mode", action="store_true")
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--no-gym", action="store_true")
    parser.add_argument("--episode", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(save_mode=args.save_mode, steps=args.steps, use_gym=not args.no_gym,
         episode=args.episode, device=args.device)
