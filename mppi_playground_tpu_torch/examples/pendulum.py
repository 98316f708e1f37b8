"""Pendulum swing-up example.

Counterpart of ``examples/pendulum.py``: gymnasium Pendulum-v1 driven by
``MPPI`` at horizon 15, 1,000 samples, sigma 1.0, lambda ESSPS; reads the
true ``env.unwrapped.state``; prints the average solve time and the final
theta.  Falls back to the internal dynamics as simulator when gymnasium
cannot make its env.  ``--fused`` runs the pendulum's fused kernels each
tick (their twins on the CPU); ``--episode`` runs every tick through
``MPPI.run_episode``, on the card one replayed CUDA graph.

Run: ``python -m mppi_playground_tpu_torch.examples.pendulum [--fused]
[--episode] [--no-gym] [--steps N] [--device cpu]``.  Needs gymnasium (and
pygame for its window) only for the gym plant.
"""

import argparse
import math
import time

import torch

from mppi_playground_tpu_torch import MPPI
from mppi_playground_tpu_torch.models import pendulum
from mppi_playground_tpu_torch.utils.angles import angle_normalize
from mppi_playground_tpu_torch.utils.device import resolve_device
from mppi_playground_tpu_torch.utils.timing import block_until_ready


def make_solver(device=None, fused: bool = False) -> MPPI:
    """The example's controller: T=15, K=1,000, sigma 1, ESSPS; ``fused``: the fused kernels."""
    return MPPI(
        horizon=15,
        num_samples=1000,
        dim_state=2,
        dim_control=1,
        dynamics=pendulum.dynamics,
        cost_func=pendulum.cost,
        u_min=[-2.0],
        u_max=[2.0],
        sigmas=[1.0],
        lambda_="ESSPS",
        store_rollouts=not fused,
        fused_task=pendulum.fused_task() if fused else None,
        device=device,
    )


def main(save_mode: bool = False, steps: int = 200, use_gym: bool = True,
         fused: bool = False, episode: bool = False, device=None):
    device = resolve_device(device)
    env = None
    if use_gym and not episode:
        try:
            import gymnasium

            if save_mode:
                env = gymnasium.make("Pendulum-v1", render_mode="rgb_array")
                env = gymnasium.wrappers.RecordVideo(env=env, video_folder="video")
            else:
                env = gymnasium.make("Pendulum-v1", render_mode="human")
            env.reset(seed=42)
        except Exception as exc:  # no gymnasium, no display
            print(f"gymnasium unavailable ({exc}); using internal simulator")
            env = None

    solver = make_solver(device, fused)

    def observe():
        return torch.as_tensor(env.unwrapped.state.copy(), dtype=torch.float32, device=device)

    state = (torch.tensor([math.pi, 0.0], dtype=torch.float32, device=device) if env is None
             else observe())

    if episode:
        # --episode: every tick through run_episode on the internal simulator
        # (gymnasium's step cannot run inside a captured graph)
        if save_mode:
            print("episode mode: gymnasium rendering/video export "
                  "unavailable (states stay on device)")

        def plant_fn(x, u):
            return pendulum.dynamics(x[None], u[None])[0]

        start = time.time()
        xs, _us = solver.run_episode(plant_fn, state, steps)
        theta = float(angle_normalize(xs[-1, 0]))
        elapsed = time.time() - start
        print(f"episode: {steps} ticks in {elapsed:.2f} s "
              f"({elapsed / steps * 1000:.2f} ms/tick incl. compile)")
        print(f"final theta: {theta:.4f}")
        return

    average_time = 0.0
    for i in range(steps):
        start = time.time()
        action_seq, _state_seq = solver.forward(state=state)
        block_until_ready(action_seq)
        elapsed = time.time() - start
        average_time = i / (i + 1) * average_time + elapsed / (i + 1)

        if env is not None:
            env.step(action_seq[0].cpu().numpy())
            env.render()
            state = observe()
        else:
            state = pendulum.dynamics(state[None], action_seq[None, 0])[0]

    print(f"average solve time: {average_time * 1000}  [ms]")
    print(f"final theta: {float(angle_normalize(state[0])):.4f}")
    if env is not None:
        env.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--save-mode", action="store_true")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--no-gym", action="store_true")
    parser.add_argument("--fused", action="store_true")
    parser.add_argument("--episode", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(save_mode=args.save_mode, steps=args.steps, use_gym=not args.no_gym,
         fused=args.fused, episode=args.episode, device=args.device)
