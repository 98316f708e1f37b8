"""2D navigation example: obstacle field, top-sample visualization, gif.

Counterpart of ``examples/navigation2d.py``: ``MPPI`` at horizon 30, 3,000
samples, sigma [0.5, 0.5], lambda ESSPS over ``Navigation2DEnv``; loop:
solve -> step -> collision check -> top-300 samples -> render; prints the
average solve time and "Goal Reached!".  ``--save-mode`` writes
``video/navigation_2d_42.gif``; ``--fused`` runs the navigation model's
fused kernels each tick, the top-300 overlay regenerated from the solve's
seed; ``--episode`` runs every tick through ``MPPI.run_episode``, ending at
the goal (a test on the device).

Run: ``python -m mppi_playground_tpu_torch.examples.navigation2d [--fused]
[--episode] [--no-render] [--save-mode] [--max-steps N] [--device cpu]``.
Needs matplotlib to render and imageio for the gif.
"""

import argparse
import time

import torch

from mppi_playground_tpu_torch import MPPI
from mppi_playground_tpu_torch.envs import Navigation2DEnv
from mppi_playground_tpu_torch.utils.timing import block_until_ready


def make_solver(env: Navigation2DEnv, fused: bool = False) -> MPPI:
    """The example's controller on ``env``'s device: T=30, K=3,000, sigma 0.5, ESSPS."""
    return MPPI(
        horizon=30,
        num_samples=3000,
        dim_state=3,
        dim_control=2,
        dynamics=env.dynamics,
        cost_func=env.cost_function,
        u_min=env.u_min,
        u_max=env.u_max,
        sigmas=[0.5, 0.5],
        lambda_="ESSPS",
        store_rollouts=not fused,
        fused_task=env.fused_task() if fused else None,
        device=env.device,
    )


def main(
    save_mode: bool = False,
    max_steps: int = 500,
    render: bool = True,
    fused: bool = False,
    episode: bool = False,
    device=None,
):
    env = Navigation2DEnv(device=device)
    solver = make_solver(env, fused)

    state = env.reset()

    if episode:
        # --episode: every tick through run_episode, ending on the goal test
        # env.step uses (the states stay on the device until the end)
        if render or save_mode:
            print("episode mode: rendering/gif export unavailable "
                  "(states stay on device)")
        goal, thr = env.goal_pos, env.GOAL_THRESHOLD

        def done_fn(x):
            return torch.linalg.norm(x[:2] - goal) < thr

        def plant_fn(x, u):
            return env.dynamics(x[None], u[None])[0]

        start = time.time()
        _xs, _us, ep = solver.run_episode(plant_fn, state, max_steps, done_fn=done_fn)
        done, ticks = bool(ep["done"]), int(ep["ticks"])
        elapsed = time.time() - start
        if done:
            print("Goal Reached!")
        # every tick of the budget runs (a done episode freezes), so the
        # time a tick divides by max_steps, not the ticks before the goal
        print(
            f"episode: {ticks} ticks (budget {max_steps}) in "
            f"{elapsed:.2f} s ({elapsed / max_steps * 1000:.2f} ms per "
            f"budget tick incl. compile)"
        )
        env.close()
        return
    total_time = 0.0
    step_count = 0
    for i in range(max_steps):
        start = time.time()
        action_seq, state_seq = solver.forward(state=state)
        block_until_ready(action_seq)
        total_time += time.time() - start
        step_count += 1

        state, is_goal_reached = env.step(action_seq[0])
        is_collisions = env.collision_check(state=state_seq[None])
        top_samples, top_weights = solver.get_top_samples(num_samples=300)

        if render:
            env.render(
                predicted_trajectory=state_seq,
                is_collisions=is_collisions,
                top_samples=(top_samples, top_weights),
                mode="rgb_array" if save_mode else "human",
            )
        if is_goal_reached:
            print("Goal Reached!")
            break

    print(f"average solve time: {total_time / step_count * 1000:.3f} ms")
    env.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--save-mode", action="store_true")
    parser.add_argument("--max-steps", type=int, default=500)
    parser.add_argument("--no-render", action="store_true")
    parser.add_argument("--fused", action="store_true")
    parser.add_argument("--episode", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(
        save_mode=args.save_mode,
        max_steps=args.max_steps,
        render=not args.no_render,
        fused=args.fused,
        episode=args.episode,
        device=args.device,
    )
