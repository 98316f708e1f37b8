"""Goal-in-danger-zone CMDP example.

Counterpart of ``examples/goal_in_danger_zone.py``: global seeding,
``MPPI`` at horizon 30, 3,000 samples, sigma [0.5, 0.5], lambda 1 over the
env's batched ``parallel_step`` / ``parallel_cost``, and the CMDP
bookkeeping of episodic reward and cost.  ``--save-mode`` writes
``video/goal_in_danger_zone_42.gif``; ``--episode`` runs every tick through
``MPPI.run_episode`` and recovers the bookkeeping from the visited states.

Run: ``python -m mppi_playground_tpu_torch.examples.goal_in_danger_zone
[--episode] [--no-render] [--save-mode] [--max-steps N] [--device cpu]``.
Needs matplotlib to render and imageio for the gif; with gymnasium the env
is a ``gym.Env``.
"""

import argparse
import random
import time

import numpy as np
import torch

from mppi_playground_tpu_torch import MPPI
from mppi_playground_tpu_torch.envs import GoalInDangerZoneEnv
from mppi_playground_tpu_torch.utils.device import resolve_device


def make_solver(env: GoalInDangerZoneEnv, device=None) -> MPPI:
    """The example's controller: T=30, K=3,000, sigma 0.5, lambda 1, over ``env``'s model."""
    return MPPI(
        horizon=30,
        num_samples=3000,
        dim_state=7,
        dim_control=2,
        dynamics=env.parallel_step,
        cost_func=env.parallel_cost,
        u_min=[-1.0, -1.0],
        u_max=[1.0, 1.0],
        sigmas=[0.5, 0.5],
        lambda_=1.0,
        device=device,
    )


def main(save_mode: bool = False, render: bool = True, max_steps: int = None,
         episode: bool = False, device=None):
    device = resolve_device(device)
    seed = 42
    random.seed(seed)
    np.random.seed(seed)

    render_mode = "rgb_array" if save_mode else ("human" if render else None)
    env = GoalInDangerZoneEnv(render_mode=render_mode, seed=seed)
    solver = make_solver(env, device)

    obs, info = env.reset(seed=seed)
    episodic_reward = 0.0
    episodic_cost = 0.0
    steps = env.max_episode_steps if max_steps is None else max_steps

    def observed(o):
        return torch.as_tensor(o, dtype=torch.float32, device=device)

    if episode:
        # --episode: every tick through run_episode over the batched model
        # dynamics; the CMDP bookkeeping is recovered from the visited
        # states (the per-step progress reward telescopes to
        # dist(start) - dist(final))
        if render_mode is not None:
            print("episode mode: rendering/gif export unavailable "
                  "(states stay on device)")

        def plant_fn(x, u):
            return env.parallel_step(x[None], u[None])[0]

        start_t = time.time()
        xs, _us = solver.run_episode(plant_fn, observed(obs), steps)
        xs = xs.cpu().numpy()
        elapsed = time.time() - start_t
        goal = obs[:2] + obs[3:5]
        zone = env.danger_zone
        episodic_reward = float(
            np.linalg.norm(obs[:2] - goal)
            - np.linalg.norm(xs[-1, :2] - goal)
        )
        # collisions over the post-step states x_1..x_T, like the host loop
        episodic_cost = float(
            (np.linalg.norm(xs[1:, :2] - zone.center, axis=1) < zone.radius).sum()
        )
        print(f"episode: {steps} ticks in {elapsed:.2f} s "
              f"({elapsed / steps * 1000:.2f} ms/tick incl. compile)")
        print("episodic reward: ", episodic_reward)
        print("episodic cost: ", episodic_cost)
        env.close()
        return

    for i in range(steps):
        action_seq, predicted_traj = solver.forward(state=observed(obs))

        obs, reward, terminated, truncated, info = env.step(action_seq[0])
        episodic_reward += reward
        episodic_cost += info["cost"]

        if render_mode is not None:
            top_samples, top_weights = solver.get_top_samples(num_samples=100)
            env.set_render_info(
                is_colllision=info["cost"] > 0.0,
                predicted_trajectory=predicted_traj[:, :2],
                top_samples=(top_samples, top_weights),
            )
            env.render()

        if truncated or terminated:
            obs, info = env.reset()

    print("episodic reward: ", episodic_reward)
    print("episodic cost: ", episodic_cost)
    # save_mode: write the captured frames as a gif, like the other envs
    env.close(path=f"video/goal_in_danger_zone_{seed}.gif" if save_mode else None)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--save-mode", action="store_true")
    parser.add_argument("--no-render", action="store_true")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--episode", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(save_mode=args.save_mode, render=not args.no_render,
         max_steps=args.max_steps, episode=args.episode, device=args.device)
