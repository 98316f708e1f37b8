"""Racing example: MPCC contouring control on the circuit.

Counterpart of ``examples/racing.py``: ``RacingController`` (horizon 25,
4,000 samples, sigma [0.5, 0.1], lambda 1, the MPCC cost) in a closed loop
against ``RacingEnv``, with the reference trajectory, the top 300 samples
and the collisions rendered; prints the average solve time and "Goal
Reached!".  Each tick (the reference rows and the solve) runs on the
device, on the card a replayed CUDA graph.

* ``--fused``: the racing model's fused kernels each tick; the top-sample
  overlay is regenerated from the solve's seed.
* ``--episode``: every tick through ``RacingController.run_episode``,
  ending at the goal (a test on the device).
* ``--pipelined N`` (``--no-compensate``): the real-time serving mode,
  ``PipelinedRunner`` with N solves in flight; the applied action comes
  from the solve N ticks ago (its row N, or row 0 without compensation).
* ``--save-mode``: writes ``video/racing_42.gif``.

Run: ``python -m mppi_playground_tpu_torch.examples.racing [--fused]
[--episode] [--pipelined N [--no-compensate]] [--no-render] [--save-mode]
[--max-steps N] [--device cpu]``.  Needs matplotlib to render and imageio
for the gif.
"""

import argparse
import time

import torch

from mppi_playground_tpu_torch.envs import RacingController, RacingEnv
from mppi_playground_tpu_torch.utils.timing import block_until_ready


def make_controller(env: RacingEnv, fused: bool = False) -> RacingController:
    """The example's controller on ``env``'s device; ``fused``: the fused kernels."""
    return RacingController(
        env,
        store_rollouts=not fused,
        solver_backend="fused" if fused else "auto",
    )


def make_pipelined_solver(env: RacingEnv, fused: bool = False):
    """The solver ``--pipelined`` serves: T=25, K=4,000, sigma [0.5, 0.1], lambda 1."""
    from mppi_playground_tpu_torch.core.config import MPPIConfig
    from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
    from mppi_playground_tpu_torch.core.solver import make_solver
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        make_mpcc_cost,
        make_racing_fused_task_from_env,
    )

    config = MPPIConfig(
        horizon=25, num_samples=4000, dim_state=4, dim_control=2,
        u_min=tuple(float(v) for v in env.u_min.tolist()),
        u_max=tuple(float(v) for v in env.u_max.tolist()),
        sigmas=(0.5, 0.1), lambda_=1.0, store_rollouts=False,
    )
    if fused:
        return make_fused_solver(config, make_racing_fused_task_from_env(env), env.dynamics,
                                 device=env.device)
    return make_solver(config, env.dynamics,
                       make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map),
                       device=env.device)


def main(
    save_mode: bool = False,
    max_steps: int = 500,
    render: bool = True,
    debug: bool = False,
    fused: bool = False,
    episode: bool = False,
    pipelined: int = 0,
    no_compensate: bool = False,
    device=None,
):
    env = RacingEnv(device=device)

    if pipelined:
        # --pipelined N: every tick dispatches a solve from the current
        # state, but the applied action comes from the solve N ticks ago
        # (row N of that plan unless --no-compensate), so N solves stay in
        # flight.  What the staleness costs in control quality:
        # tests/test_torch_pipelined_quality.py
        run_pipelined(
            env, depth=pipelined, compensate=not no_compensate,
            max_steps=max_steps, render=render, fused=fused,
            save_mode=save_mode,
        )
        return
    controller = make_controller(env, fused)

    state = env.reset()

    if episode:
        # --episode: every tick through run_episode, ending on the goal
        # test the host loop uses (the states stay on the device)
        if render or save_mode:
            print("episode mode: rendering/gif export unavailable "
                  "(states stay on device)")
        goal, thr = env.racing_center_path[-1, :2], env.GOAL_THRESHOLD

        def done_fn(x):
            return torch.linalg.norm(x[:2] - goal) < thr

        start = time.time()
        _xs, _us, ep = controller.run_episode(state, max_steps, done_fn=done_fn)
        done, ticks = bool(ep["done"]), int(ep["ticks"])
        elapsed = time.time() - start
        if done:
            print("Goal Reached!")
        # every tick of the budget runs (a done episode freezes), so the
        # time a tick divides by max_steps, not the ticks before the goal
        print(
            f"episode: {ticks} ticks (budget {max_steps}) in {elapsed:.2f} s "
            f"({elapsed / max_steps * 1000:.2f} ms per budget tick incl. "
            f"compile)"
        )
        env.close()
        return
    solve_times = []
    for i in range(max_steps):
        start = time.time()
        action_seq, state_seq = controller.update(state)
        block_until_ready(action_seq)
        solve_times.append(time.time() - start)
        if debug:
            print(f"solve time: {round(solve_times[-1] * 1000, 2)}  [ms]")

        state, is_goal_reached = env.step(action_seq[0])
        is_collisions = env.collision_check(state=state_seq[None])
        top = controller.get_top_samples(num_samples=300)

        if render:
            env.render(
                action=action_seq[0],
                predicted_trajectory=state_seq,
                is_collisions=is_collisions,
                top_samples=top,
                reference_trajectory=controller.reference_path,
                mode="rgb_array" if save_mode else "human",
            )
        if is_goal_reached:
            print("Goal Reached!")
            break

    if solve_times:
        avg = sum(solve_times[1:]) / max(len(solve_times) - 1, 1)
        print(f"average solve time: {avg * 1000:.3f} ms")
    env.close()


def run_pipelined(env, depth, compensate, max_steps, render, fused,
                  save_mode=False):
    """Closed racing loop through :class:`PipelinedRunner` (the serving API)."""
    from mppi_playground_tpu_torch.core.closed_loop import PipelinedRunner
    from mppi_playground_tpu_torch.models.racing_mpcc import calc_ref_trajectory

    solver = make_pipelined_solver(env, fused)
    runner = PipelinedRunner(solver, depth=depth, compensate=compensate)

    path = env.racing_center_path
    state = env.reset()
    cind = torch.zeros((), dtype=torch.int64, device=env.device)
    tick_times = []
    for i in range(max_steps):
        xref, cind = calc_ref_trajectory(state, path, cind, solver.config.horizon)
        start = time.time()
        u = runner.step(state, info={"reference_path": xref})
        tick_times.append(time.time() - start)
        state, is_goal_reached = env.step(torch.as_tensor(u))
        if render:
            env.render(
                action=torch.as_tensor(u),
                reference_trajectory=xref,
                mode="rgb_array" if save_mode else "human",
            )
        if is_goal_reached:
            print("Goal Reached!")
            break
    if len(tick_times) > depth:
        steady = tick_times[depth + 1:] or tick_times
        avg = sum(steady) / len(steady)
        print(
            f"pipelined depth={depth} compensate={compensate}: "
            f"{len(tick_times)} ticks, avg step {avg * 1000:.3f} ms "
            f"(dispatch + stale-action read; excludes env/render)"
        )
    env.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--save-mode", action="store_true")
    parser.add_argument("--max-steps", type=int, default=500)
    parser.add_argument("--no-render", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--fused", action="store_true")
    parser.add_argument("--episode", action="store_true")
    parser.add_argument(
        "--pipelined", type=int, default=0, metavar="DEPTH",
        help="real-time serving demo: keep DEPTH solves in flight "
        "(PipelinedRunner); 0 = classic strict loop",
    )
    parser.add_argument(
        "--no-compensate", action="store_true",
        help="with --pipelined: apply the stale plan's row 0 instead of "
        "its row DEPTH (no receding-horizon delay compensation)",
    )
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(
        save_mode=args.save_mode,
        max_steps=args.max_steps,
        render=not args.no_render,
        debug=args.debug,
        fused=args.fused,
        episode=args.episode,
        pipelined=args.pipelined,
        no_compensate=args.no_compensate,
        device=args.device,
    )
