"""Continuous mountain-car example.

Counterpart of ``examples/mountaincar.py``: MountainCarContinuous-v0 with
``MPPI`` at horizon 100, 1,000 samples, sigma 1.0, lambda 0.1, reading
``env.unwrapped.state``.  Falls back to the internal dynamics as simulator
when gymnasium cannot make its env; ``--episode`` runs every tick through
``MPPI.run_episode``, ending at the hilltop (a test on the device).

Run: ``python -m mppi_playground_tpu_torch.examples.mountaincar [--episode]
[--no-gym] [--steps N] [--device cpu]``.  Needs gymnasium (and pygame for
its window) only for the gym plant.
"""

import argparse
import time

import torch

from mppi_playground_tpu_torch import MPPI
from mppi_playground_tpu_torch.models import mountain_car
from mppi_playground_tpu_torch.utils.device import resolve_device
from mppi_playground_tpu_torch.utils.timing import block_until_ready


def make_solver(device=None) -> MPPI:
    """The example's controller: T=100, K=1,000, sigma 1, lambda 0.1."""
    return MPPI(
        horizon=100,
        num_samples=1000,
        dim_state=2,
        dim_control=1,
        dynamics=mountain_car.dynamics,
        cost_func=mountain_car.cost,
        u_min=[-1.0],
        u_max=[1.0],
        sigmas=[1.0],
        lambda_=0.1,
        device=device,
    )


def main(save_mode: bool = False, steps: int = 300, use_gym: bool = True,
         episode: bool = False, device=None):
    device = resolve_device(device)
    env = None
    if use_gym and not episode:
        try:
            import gymnasium

            if save_mode:
                env = gymnasium.make("MountainCarContinuous-v0", render_mode="rgb_array")
                env = gymnasium.wrappers.RecordVideo(env=env, video_folder="video")
            else:
                env = gymnasium.make("MountainCarContinuous-v0", render_mode="human")
            env.reset(seed=42)
        except Exception as exc:  # no gymnasium, no display
            print(f"gymnasium unavailable ({exc}); using internal simulator")
            env = None

    solver = make_solver(device)

    def observe():
        return torch.as_tensor(env.unwrapped.state.copy(), dtype=torch.float32, device=device)

    state = (torch.tensor([-0.5, 0.0], dtype=torch.float32, device=device) if env is None
             else observe())

    if episode:
        # --episode: every tick through run_episode on the internal
        # simulator, ending on the hilltop test on the device
        if save_mode:
            print("episode mode: gymnasium rendering/video export "
                  "unavailable (states stay on device)")

        def plant_fn(x, u):
            return mountain_car.dynamics(x[None], u[None])[0]

        def done_fn(x):
            return x[0] >= 0.45

        start = time.time()
        xs, _us, ep = solver.run_episode(plant_fn, state, steps, done_fn=done_fn)
        position, done, ticks = float(xs[-1, 0]), bool(ep["done"]), int(ep["ticks"])
        elapsed = time.time() - start
        if done:
            print("Goal Reached!")
        # every tick of the budget runs (a done episode freezes), so the
        # time a tick divides by steps, not the ticks before the goal
        print(f"episode: {ticks} ticks (budget {steps}) in "
              f"{elapsed:.2f} s ({elapsed / steps * 1000:.2f} ms per "
              f"budget tick incl. compile)")
        print(f"final position: {position:.3f} (goal 0.45)")
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
            state = mountain_car.dynamics(state[None], action_seq[None, 0])[0]

    print(f"average solve time: {average_time * 1000}  [ms]")
    print(f"final position: {float(state[0]):.3f} (goal 0.45)")
    if env is not None:
        env.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--save-mode", action="store_true")
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--no-gym", action="store_true")
    parser.add_argument("--episode", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(save_mode=args.save_mode, steps=args.steps, use_gym=not args.no_gym,
         episode=args.episode, device=args.device)
