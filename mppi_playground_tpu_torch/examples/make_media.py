"""Render the three gymnasium workloads' demo gifs.

Counterpart of ``examples/make_media.py``: drives each example's solver
(pendulum, cartpole, mountain car) against its gymnasium plant with
``render_mode="rgb_array"`` and writes the captured frames through the
port's ``envs/rendering.save_gif``.  Navigation and racing write their
gifs from their own examples (``--save-mode``).

Run: ``python -m mppi_playground_tpu_torch.examples.make_media [--out
docs/media] [--max-steps N] [--fast] [--device cpu]``.  Needs gymnasium
(with pygame for the classic-control frames) and imageio.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mppi_playground_tpu_torch import MPPI
from mppi_playground_tpu_torch.envs.rendering import save_gif
from mppi_playground_tpu_torch.models import cartpole, mountain_car, pendulum
from mppi_playground_tpu_torch.utils.device import resolve_device

WORKLOADS = ("pendulum", "cartpole", "mountaincar")


def make_solver(name: str, device=None) -> MPPI:
    """The solver of workload ``name`` (one of :data:`WORKLOADS`), as its example builds it."""
    if name == "pendulum":  # swing-up: T=15, K=1,000, ESSPS
        return MPPI(
            horizon=15, num_samples=1000, dim_state=2, dim_control=1,
            dynamics=pendulum.dynamics, cost_func=pendulum.cost,
            u_min=[-2.0], u_max=[2.0], sigmas=[1.0], lambda_="ESSPS", device=device,
        )
    if name == "cartpole":  # T=10, K=100, lambda 0.001, bang-bang env action
        return MPPI(
            horizon=10, num_samples=100, dim_state=4, dim_control=1,
            dynamics=cartpole.dynamics, cost_func=cartpole.cost,
            u_min=list(cartpole.U_MIN), u_max=list(cartpole.U_MAX),
            sigmas=[1.0], lambda_=0.001, device=device,
        )
    if name == "mountaincar":  # T=100, K=1,000, lambda 0.1
        return MPPI(
            horizon=100, num_samples=1000, dim_state=2, dim_control=1,
            dynamics=mountain_car.dynamics, cost_func=mountain_car.cost,
            u_min=[-1.0], u_max=[1.0], sigmas=[1.0], lambda_=0.1, device=device,
        )
    raise ValueError(f"unknown workload {name!r}; one of {WORKLOADS}")


def _record(name, env_id, solver, get_state, to_env_action, out_dir,
            max_steps, every=2, seed=42, done_on=None):
    import gymnasium

    env = gymnasium.make(env_id, render_mode="rgb_array")
    env.reset(seed=seed)
    state = get_state(env)
    frames = []
    for step in range(max_steps):
        action_seq, _ = solver.forward(
            state=torch.as_tensor(state, dtype=torch.float32, device=solver.device))
        action = action_seq[0].cpu().numpy()
        _, _, terminated, truncated, _ = env.step(to_env_action(action))
        if step % every == 0:
            frames.append(env.render())
        state = get_state(env)
        if done_on is not None and done_on(state):
            frames.append(env.render())
            break
        if terminated or truncated:
            break
    env.close()
    path = os.path.join(out_dir, f"{name}.gif")
    save_gif(frames, path, fps=15)
    print(f"{name}: {len(frames)} frames -> {path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("docs", "media"))
    ap.add_argument("--max-steps", type=int, default=200)
    ap.add_argument("--fast", action="store_true", help="short smoke render")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    max_steps = 20 if args.fast else args.max_steps

    _record(
        "pendulum", "Pendulum-v1", make_solver("pendulum", device),
        get_state=lambda e: e.unwrapped.state.copy(),
        to_env_action=lambda a: a, out_dir=args.out, max_steps=max_steps,
    )
    _record(
        "cartpole", "CartPole-v1", make_solver("cartpole", device),
        get_state=lambda e: np.asarray(e.unwrapped.state, np.float32),
        to_env_action=lambda a: int(a[0] > 0.0),
        out_dir=args.out, max_steps=max_steps,
    )
    _record(
        "mountaincar", "MountainCarContinuous-v0", make_solver("mountaincar", device),
        get_state=lambda e: np.asarray(e.unwrapped.state, np.float32),
        to_env_action=lambda a: a, out_dir=args.out,
        max_steps=max_steps, done_on=lambda s: s[0] >= 0.45,
    )


if __name__ == "__main__":
    main()
