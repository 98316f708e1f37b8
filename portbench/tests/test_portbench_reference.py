"""The plain reference against the port's CPU path, at a small K, for each cell's route.

Only this test imports both: the reference (``portbench/reference``) imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import maps
from portbench.reference.racing import Racing, key_words, scenario_seed, tick_seed

from mppi_playground_tpu_torch.core.config import make_key, tick_seed as port_tick_seed
from mppi_playground_tpu_torch.envs.racing_controller import RacingController
from mppi_playground_tpu_torch.envs.racing_env import RacingEnv


@pytest.mark.parametrize("seed", [42, 2_100_000_007])
def test_the_scene_is_the_envs(seed):
    config = harness.load_cell("racing_ref.control_xla").config
    scene = maps.scene(config, seed)
    env = RacingEnv(seed=seed, device="cpu")
    assert np.array_equal(scene.path.astype(np.float32), env.racing_center_path.numpy())
    assert np.array_equal(scene.obstacle_grid, env.obstacle_map.grid)
    assert np.array_equal(scene.lane_grid, env.lane_map.grid)
    assert scene.x_lim == tuple(env.obstacle_map.x_lim)
    assert scene.origin == tuple(float(v) for v in env.obstacle_map.origin)


@pytest.mark.parametrize("seed, tick", [(0, 0), (42, 7), (2_100_000_007, 123_456)])
def test_tick_seeds_and_keys(seed, tick):
    assert tick_seed(seed, tick) == port_tick_seed(seed, tick)
    assert list(key_words(seed, tick)) == make_key(seed, tick, "cpu").tolist()
    assert scenario_seed(seed, 3) == (seed + 3 * 0x9E3779B9) % 2**32


@pytest.mark.parametrize("workload", ["racing_flagship.control", "racing_ref.control_xla",
                                      "racing_flagship.control_essps"])
def test_two_ticks_of_the_controller(workload):
    """The reference's tick from the controller's own state, twice in a row."""
    cell = harness.load_cell(workload)
    s = harness.solver_settings(cell, {"num_samples": 384})
    env = RacingEnv(seed=9, device="cpu")
    ctrl = RacingController(env, horizon=s["horizon"], num_samples=s["num_samples"],
                            lambda_=s["lambda_"], seed=11, store_rollouts=s["store_rollouts"])
    ref = Racing(maps.scene(cell.config, 9), s, torch.float32, "cpu")
    start = 40
    ctrl.current_path_index = start
    path = env.racing_center_path
    x = torch.stack([path[start, 0], path[start, 1], path[start, 2], torch.tensor(0.0)])
    span = torch.tensor(ref.u_max) - torch.tensor(ref.u_min)
    for tick in range(2):
        st, cind = ctrl.solver_state, ctrl.current_path_index.clone()
        plan, states = ctrl.update(x)
        want = ref.tick(x[None], st.previous_action_seq[None], cind[None],
                        [tick_seed(11, tick)])
        assert float(((plan - want["plan"][0]).abs() / span).max()) < 1e-4
        assert float((states - want["states"][0]).abs().max()) < 1e-3
        assert int(ctrl.current_path_index) == int(want["cind"][0])
        assert float(ctrl.solver_state.lam) == pytest.approx(float(want["lam"][0]), rel=1e-5)
        stepped = env.dynamics(x[None], plan[:1])
        assert torch.equal(stepped, ref.plant(x[None], plan[:1]))
        x = stepped[0]


def test_a_fleet_tick():
    from mppi_playground_tpu_torch.core.config import MPPIConfig
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory_batch,
        make_racing_fused_task_from_env,
    )
    from mppi_playground_tpu_torch.parallel import make_batched_fused_solver

    cell = harness.load_cell("racing_ref.fleet32")
    s = harness.solver_settings(cell, {"num_samples": 256})
    env = RacingEnv(seed=5, device="cpu")
    config = MPPIConfig(horizon=s["horizon"], num_samples=s["num_samples"], dim_state=4,
                        dim_control=2, u_min=tuple(s["u_min"]), u_max=tuple(s["u_max"]),
                        sigmas=tuple(s["sigmas"]), lambda_=s["lambda_"], seed=13,
                        store_rollouts=False)
    fleet = make_batched_fused_solver(config, make_racing_fused_task_from_env(env),
                                      env.dynamics, "cpu", 3)
    states = fleet.init_batch(seed=13)
    path = env.racing_center_path
    idx = torch.tensor([0, 300, 600])
    x0s = torch.cat([path[idx], torch.zeros(3, 1)], dim=1)
    xrefs, new = calc_ref_trajectory_batch(x0s, path, idx, s["horizon"])
    result = fleet.solve_batch(states, x0s, batched_info={"reference_path": xrefs})
    ref = Racing(maps.scene(cell.config, 5), s, torch.float32, "cpu")
    want = ref.tick(x0s, states.previous_action_seq, idx,
                    [tick_seed(scenario_seed(13, b), 0) for b in range(3)])
    span = torch.tensor(ref.u_max) - torch.tensor(ref.u_min)
    assert float(((result.action_seq - want["plan"]).abs() / span).max()) < 1e-4
    assert torch.equal(new, want["cind"])
    assert torch.equal(ref.plant(x0s, result.action_seq[:, 0]),
                       env.dynamics(x0s, result.action_seq[:, 0]))
