"""Entry points of the PyTorch port: the flagship tick, a multi-rank and a two-process dry run.

The counterpart of ``__graft_entry__.py`` for ``mppi_playground_tpu_torch``.
It imports ``torch`` and the port, never ``jax`` or ``mppi_playground_tpu``.

``entry(device=None)`` returns the flagship racing MPCC tick and its example
arguments, built by ``workloads.build_flagship`` as ``chip_smoke.py``'s
flagship phase builds it: on the card (the default; without one it raises)
K=100,000 and T=50 on the fused kernels (a tick is one launch of the fused
solve and one of the tick's tail); with ``device="cpu"`` the kernels' plain
twins at K=8,192.

``dryrun_multichip(n)`` runs the sharded paths on ``n`` ranks of one process
group, each rank a process spawned by ``torch.multiprocessing``
(``parallel/mesh.run_on_ranks``), on a 2-D ``(scenario, samples)`` mesh at
tiny shapes: the unfused batched solver on the racing MPCC grid-map cost
with ESSPS, the sample-sharded fused solve with a padded last shard and the
two-phase ESSPS λ, the scenario-batched fused fleet, the 2-D fused fleet
(scenarios and samples both sharded) and the fleet episode.  The fused legs
equal the single solver bit for bit on the same noise.  The ranks drive
one card each on a ``cpu:gloo,cuda:nccl`` group (the default; the host
needs ``n`` cards, else it raises), or are CPU processes on a gloo group
with ``device="cpu"``.

``dryrun_multihost(device=None)`` starts two separate Python processes that
meet over an ``env://`` rendezvous on localhost and run one cross-process
sample-sharded solve (``mppi_playground_tpu_torch/parallel/multihost_dryrun.py``),
on two cards by default, on the CPU with ``device="cpu"``.

Run ``python3 graft_entry_torch.py --device cpu`` for both dry runs on the
CPU (``--device cuda``, the default, needs four cards and two).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

CPU_NUM_SAMPLES = 8192  # the twins' K on the CPU, as __graft_entry__.entry takes on a CPU
DRYRUN_HORIZON = 6
FLEET_SAMPLES = 1024


def entry(device=None):
    """``(fn, example_args)``: the flagship racing tick and its arguments.

    ``fn(solver_state, cind, x, noise=None) -> (action_seq [50, 2], state_seq
    [51, 4], new_state, new_cind)``; ``example_args`` are the solver's initial
    state, ``cind`` 0 and the env's start, on the tick's device.
    """
    from mppi_playground_tpu_torch.utils.device import resolve_device
    from mppi_playground_tpu_torch.workloads import (
        FLAGSHIP_HORIZON,
        FLAGSHIP_NUM_SAMPLES,
        build_flagship,
    )

    dev = resolve_device(device)
    num_samples = FLAGSHIP_NUM_SAMPLES if dev.type == "cuda" else CPU_NUM_SAMPLES
    env, solver, tick = build_flagship(horizon=FLAGSHIP_HORIZON, num_samples=num_samples,
                                       device=dev)
    example_args = (solver.init(), torch.zeros((), dtype=torch.int64, device=dev), env.reset())
    return tick, example_args


def _noise(seed: int, batch: tuple, config, device) -> torch.Tensor:
    """``batch + [K, T, m]`` seeded normals times ``config.sigmas``, the same on every rank."""
    gen = torch.Generator().manual_seed(seed)
    shape = (*batch, config.num_samples, config.horizon, config.dim_control)
    return (torch.randn(shape, generator=gen) * torch.tensor(config.sigmas)).to(device)


def _dryrun_rank(rank: int, world: int) -> dict:
    """The five legs on one rank; raises where a leg's check fails."""
    from mppi_playground_tpu_torch.core.closed_loop import (
        bitwise_equal,
        make_fleet_closed_loop,
        result_leaves,
    )
    from mppi_playground_tpu_torch.core.config import MPPIConfig, scenario_seed
    from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory,
        calc_ref_trajectory_batch,
        make_mpcc_cost,
        make_racing_fused_task_from_env,
    )
    from mppi_playground_tpu_torch.parallel import (
        SAMPLE_AXIS,
        make_batched_fused_solver,
        make_batched_solver,
        make_mesh,
        make_sharded_fused_solver,
    )
    from mppi_playground_tpu_torch.parallel.mesh import mesh_device

    # the 2-D mesh: scenarios x samples, both axes real whenever the ranks allow
    scenario_dim = 2 if world % 2 == 0 and world >= 4 else 1
    sample_dim = world // scenario_dim
    mesh = make_mesh(mesh_shape=(scenario_dim, sample_dim))
    dev = mesh_device(mesh)
    horizon = DRYRUN_HORIZON
    env = RacingEnv(device=dev)
    x0 = env.reset()
    path = env.racing_center_path
    xref, _ = calc_ref_trajectory(x0, path, torch.zeros((), dtype=torch.int64, device=dev),
                                  horizon)
    info = {"reference_path": xref}
    bounds = dict(u_min=tuple(float(v) for v in env.u_min.tolist()),
                  u_max=tuple(float(v) for v in env.u_max.tolist()), sigmas=(0.5, 0.1))

    def config(num_samples, lambda_):
        return MPPIConfig(horizon=horizon, num_samples=num_samples, dim_state=4, dim_control=2,
                          lambda_=lambda_, store_rollouts=False, **bounds)

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"rank {rank} of {world}: {what}")

    def fleet_against_single(name, fleet, seed, noise):
        """Each of the rank's scenarios bit for bit the single solver on its state and noise."""
        local = fleet.batch_size
        rows = noise[fleet.first:fleet.first + local]
        got = fleet.solve_batch(fleet.init_batch(seed=seed), x0.expand(local, 4).contiguous(),
                                info=info, noise=rows)
        check(got.action_seq.shape == (local, horizon, 2), f"{name}: action_seq shape")
        check(got.aux.costs.shape == (local, fleet.config.num_samples), f"{name}: costs shape")
        check(bool(torch.isfinite(got.action_seq).all()), f"{name}: non-finite actions")
        check(bool(torch.isfinite(got.aux.lam).all()), f"{name}: non-finite lambda")
        single = fleet.solver
        for i in range(local):
            b = fleet.first + i
            want = single.solve(single.init(seed=scenario_seed(seed, b)), x0, info=info,
                                noise=rows[i])
            check(bitwise_equal([leaf[i] for leaf in result_leaves(got)], result_leaves(want)),
                  f"{name}: scenario {b} is not its single solve bit for bit")

    legs = {}
    # --- leg 1: the unfused batched solver on the MPCC grid-map cost, ESSPS ---
    batch_size = 2 * scenario_dim
    unfused = config(16 * sample_dim, "ESSPS")
    cost_fn = make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map)
    batched = make_batched_solver(unfused, env.dynamics, cost_fn, mesh, batch_size=batch_size)
    local = batched.batch_size
    x0s = x0.expand(local, 4).contiguous()
    result = batched.solve_batch(batched.init_batch(seed=0), x0s, info=info)
    check(result.action_seq.shape == (local, horizon, 2), "leg 1: action_seq shape")
    check(bool(torch.isfinite(result.action_seq).all()), "leg 1: non-finite actions")
    legs["unfused_batched_mpcc_essps"] = dict(B=batch_size, K=unfused.num_samples)

    # --- leg 2: the sample-sharded fused solve, a padded last shard, two-phase ESSPS ---
    task = make_racing_fused_task_from_env(env)
    fused_config = config(FLEET_SAMPLES * sample_dim + 500, "ESSPS")
    sharded = make_sharded_fused_solver(fused_config, task, env.dynamics, mesh)
    noise = _noise(0, (), fused_config, dev)
    got = sharded.solve(sharded.init(), x0, info=info, noise=noise)
    check(bool(torch.isfinite(got.action_seq).all()), "leg 2: non-finite actions")
    check(bool(torch.isfinite(got.aux.lam).all()), "leg 2: non-finite lambda")
    single = make_fused_solver(fused_config, task, env.dynamics, device=dev)
    want = single.solve(single.init(), x0, info=info, noise=noise)
    check(bitwise_equal(result_leaves(got), result_leaves(want)),
          "leg 2: not the single solve bit for bit")
    legs["sharded_fused_racing_essps"] = dict(K=fused_config.num_samples, shards=sample_dim)

    # --- leg 3: the scenario-batched fused fleet ---
    fleet_config = config(FLEET_SAMPLES, 1.0)
    fleet = make_batched_fused_solver(fleet_config, task, env.dynamics, mesh,
                                      batch_size=scenario_dim)
    fleet_against_single("leg 3", fleet, 1, _noise(1, (scenario_dim,), fleet_config, dev))
    legs["batched_fused_racing"] = dict(B=scenario_dim, K=FLEET_SAMPLES)

    # --- leg 3b: the 2-D fused fleet, scenarios and samples both sharded ---
    if scenario_dim > 1 and sample_dim > 1:
        fleet2d_config = config(FLEET_SAMPLES * sample_dim + 500, "ESSPS")
        fleet2d = make_batched_fused_solver(fleet2d_config, task, env.dynamics, mesh,
                                            batch_size=scenario_dim, sample_axis=SAMPLE_AXIS)
        fleet_against_single("leg 3b", fleet2d, 3,
                             _noise(3, (scenario_dim,), fleet2d_config, dev))
        legs["fused_2d_fleet"] = dict(B=scenario_dim, K=fleet2d_config.num_samples,
                                      sample_shards=sample_dim)

    # --- leg 4: the fleet episode, each scenario's reference rows through info_fn ---
    def info_fn(cinds, xs):
        xrefs, new_cinds = calc_ref_trajectory_batch(xs, path, cinds, horizon)
        return {"reference_path": xrefs}, new_cinds

    ticks = 3
    run = make_fleet_closed_loop(batched, env.dynamics, ticks, info_fn=info_fn)
    _, _, xs, us, _ = run(batched.init_batch(seed=2), x0s,
                          torch.zeros(local, dtype=torch.int64, device=dev))
    check(us.shape == (ticks, local, 2), "leg 4: actions shape")
    check(bool(torch.isfinite(xs).all()), "leg 4: non-finite states")
    legs["fleet_episodes"] = dict(B=batch_size, ticks=ticks)
    return dict(mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), device=str(dev), legs=legs)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The sharded paths on ``n_devices`` spawned ranks (tiny K); raises if a rank fails.

    ``device`` ``None`` or ``"cuda"``: the ``cpu:gloo,cuda:nccl`` group, rank
    r on card r (raises unless the host has ``n_devices`` cards); ``"cpu"``:
    CPU ranks on a gloo group, a dry run of the sharded program as
    ``__graft_entry__.dryrun_multichip`` runs it on virtual CPU devices.
    """
    from mppi_playground_tpu_torch.parallel.mesh import run_on_ranks

    ranks = run_on_ranks(_dryrun_rank, n_devices, device=device)
    summary = ranks[0]
    if any(r["legs"] != summary["legs"] or r["mesh"] != summary["mesh"] for r in ranks):
        raise RuntimeError(f"the ranks ran different legs: {ranks}")
    legs = summary["legs"]
    named = ", ".join(f"{name}({','.join(f'{k}={v}' for k, v in leg.items())})"
                      for name, leg in legs.items())
    print(f"dryrun_multichip OK: mesh={summary['mesh']} ranks={n_devices} "
          f"device={summary['device'].split(':')[0]} paths=[{named}]", flush=True)


def dryrun_multihost(device=None) -> None:
    """Two separate processes, one ``env://`` rendezvous, one cross-process sharded solve.

    Runs ``python -m mppi_playground_tpu_torch.parallel.multihost_dryrun``
    and raises with its output if it fails.  ``device`` ``None`` or
    ``"cuda"``: one card a process on NCCL (raises unless the host has two);
    ``"cpu"``: CPU processes on gloo.
    """
    from mppi_playground_tpu_torch.parallel.mesh import device_of_ranks
    from mppi_playground_tpu_torch.parallel.multihost_dryrun import NUM_PROCESSES

    dev = device_of_ranks(device, NUM_PROCESSES)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    # the script's attempts each wait at most its per-attempt deadline for both children
    proc = subprocess.run(
        [sys.executable, "-m", "mppi_playground_tpu_torch.parallel.multihost_dryrun",
         "--device", dev.type],
        capture_output=True, text=True, timeout=900, cwd=root, env=env)
    sys.stdout.write(proc.stdout[-2000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise RuntimeError(f"multihost dryrun failed rc={proc.returncode}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Both dry runs of the port's sharded paths.")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = parser.parse_args().device
    dryrun_multichip(4, device=device)
    dryrun_multihost(device=device)
