"""The port's ``utils``: timing, guards and checkpoint, on the CPU.

Mirrors of ``tests/test_timing.py``, ``tests/test_guards.py`` and the
``.npz`` cases of ``tests/test_checkpoint.py``, on the port's solvers, and
what the port's state adds: its host seed and tick, its device key (which,
after a closed loop's ``done_fn`` fired, names another stream than
``make_key(seed, tick)``), the MPO leaves and a batched fleet state all
round-trip, and a resumed solve is bit for bit the uninterrupted one.
``checked_solve`` raises with the JAX package's messages.  The card's
counterparts run in ``chip_smoke.py`` phase 13.
"""

import dataclasses
import json
import math
import os

import pytest
import torch

from mppi_playground_tpu_torch.core.closed_loop import _tensors, make_closed_loop
from mppi_playground_tpu_torch.core.config import MPPIConfig, make_key
from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
from mppi_playground_tpu_torch.core.solver import make_init, make_solver
from mppi_playground_tpu_torch.models import pendulum
from mppi_playground_tpu_torch.parallel import make_batched_fused_solver
from mppi_playground_tpu_torch.utils.checkpoint import load_state, save_state
from mppi_playground_tpu_torch.utils.guards import NonFiniteSolveError, checked_solve
from mppi_playground_tpu_torch.utils.timing import (
    SolveTimer,
    block_until_ready,
    profile_trace,
    time_fn,
)


def _same(a, b) -> bool:
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(ta, tb))


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def test_solve_timer_reference_style_reporting():
    t = SolveTimer()
    with t.measure(result_fn=lambda: torch.ones(4) * 2.0):
        x = torch.ones(4) * 2.0  # noqa: F841
    t.add(0.002)
    assert len(t.times) == 2
    assert t.average_ms > 0
    assert "average solve time" in t.summary()
    assert SolveTimer().average_ms == 0.0


def test_time_fn_sync_correct_stats():
    x = torch.ones(64, 64)
    stats = time_fn(lambda a: (a @ a).sum(), x, warmup=1, iters=5)
    assert stats["mean_s"] > 0
    assert stats["p95_s"] >= stats["p50_s"] > 0
    assert abs(stats["per_s"] * stats["mean_s"] - 1.0) < 1e-6


def test_block_until_ready_passes_trees_through():
    tree = {"a": torch.ones(2), "b": (torch.zeros(()), None, 3)}
    assert block_until_ready(tree) is tree


def test_profile_trace_writes_artifacts(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profile_trace(log_dir) as d:
        torch.ones(8) + 1
    assert d == log_dir
    assert os.path.isdir(log_dir) and os.listdir(log_dir)
    with open(os.path.join(log_dir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

def _guard_solver(cost_scale, fused=False):
    cfg = MPPIConfig(horizon=4, num_samples=64, dim_state=1, dim_control=1,
                     u_min=(-1.0,), u_max=(1.0,), sigmas=(1.0,), lambda_=1.0,
                     store_rollouts=False)

    def dynamics(state, action):
        return state + cost_scale * action

    def cost(state, action, info):
        return torch.sum(state**2, dim=1)

    return make_solver(cfg, dynamics, cost, device="cpu")


def test_checked_solve_passes_finite():
    solver = _guard_solver(0.1)
    solve = checked_solve(solver)
    r = solve(solver.init(), torch.zeros(1))
    assert torch.isfinite(r.action_seq).all()


def test_checked_solve_raises_on_nan():
    solver = _guard_solver(math.inf)  # inf * 0-noise -> nan states -> nan costs
    solve = checked_solve(solver)
    with pytest.raises(NonFiniteSolveError,
                       match=r"non-finite trajectory costs \(dynamics or cost overflow\)"):
        solve(solver.init(), torch.zeros(1))
    assert issubclass(NonFiniteSolveError, RuntimeError)


def test_checked_solve_raises_on_a_nan_racing_state():
    """The fused racing solve from a NaN state: NaN costs, the JAX message, no stray index.

    The kernels read a NaN position's cell 0 (``__float2int_rn`` of NaN is
    0); the twins' cell index does the same instead of indexing far out of
    the grid.
    """
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory,
        make_racing_fused_task_from_env,
    )

    env = RacingEnv(device="cpu")
    config = MPPIConfig(horizon=8, num_samples=256, dim_state=4, dim_control=2,
                        u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1), lambda_=1.0,
                        store_rollouts=False)
    solver = make_fused_solver(config, make_racing_fused_task_from_env(env), env.dynamics,
                               device="cpu")
    x = torch.full((4,), math.nan)
    xref, _ = calc_ref_trajectory(env.reset(), env.racing_center_path, torch.tensor(0), 8)
    with pytest.raises(NonFiniteSolveError, match="non-finite trajectory costs"):
        checked_solve(solver)(solver.init(), x, info={"reference_path": xref})


def test_twin_map_reads_cell_zero_at_a_nan_position():
    from mppi_playground_tpu_torch.maps.grid_cost import grid_cost_pair, grid_occupancy

    grid_a = torch.zeros(4, 5, dtype=torch.uint8)
    grid_b = torch.zeros(4, 5, dtype=torch.uint8)
    grid_a[0, 0] = 1
    px = torch.tensor([math.nan, 0.0, math.nan, 100.0])
    py = torch.tensor([0.0, math.nan, math.nan, 0.0])
    # cell 0 on the grid for a NaN coordinate, as the kernels read it; off the grid 2
    assert grid_cost_pair(grid_a, grid_b, (0.0, 0.0), 1.0, px, py).tolist() == [1, 1, 1, 2]
    assert grid_occupancy(grid_a, (0.0, 0.0), 1.0, px, py).tolist() == [1, 1, 1, 1]


def test_checked_solve_names_non_finite_actions():
    """Finite costs with a non-finite plan raise the JAX package's second message."""

    class Solver:
        def solve(self, state, x0, info=None):
            r = pendulum_solver.solve(state, x0, info=info)
            return r._replace(action_seq=r.action_seq * math.nan)

    pendulum_solver = make_solver(
        MPPIConfig(horizon=4, num_samples=64, dim_state=2, dim_control=1, u_min=(-2.0,),
                   u_max=(2.0,), sigmas=(1.0,), lambda_=1.0),
        pendulum.dynamics, pendulum.cost, device="cpu")
    with pytest.raises(NonFiniteSolveError, match=r"non-finite optimal action sequence "
                                                  r"\(softmin weights collapsed\)"):
        checked_solve(Solver())(pendulum_solver.init(), torch.tensor([math.pi, 0.0]))


def test_checked_solve_forwards_noise_only_when_given():
    """Solve surfaces without a noise parameter work; injected noise reaches a solve that has one."""
    solver = _guard_solver(0.1)

    class NoNoise:
        def solve(self, state, x0, info=None):
            return solver.solve(state, x0, info=info)

    r = checked_solve(NoNoise())(solver.init(), torch.zeros(1))
    assert torch.isfinite(r.action_seq).all()
    noise = torch.full((64, 4, 1), 0.25)
    got = checked_solve(solver)(solver.init(), torch.zeros(1), noise=noise)
    assert torch.equal(got.action_seq, solver.solve(solver.init(), torch.zeros(1),
                                                    noise=noise).action_seq)


# ---------------------------------------------------------------------------
# Checkpoint
# ---------------------------------------------------------------------------

def _pendulum(lambda_, fused=False):
    config = MPPIConfig(horizon=8, num_samples=128, dim_state=2, dim_control=1,
                        u_min=pendulum.U_MIN, u_max=pendulum.U_MAX, sigmas=(1.0,),
                        lambda_=lambda_, store_rollouts=not fused)
    if fused:
        return make_fused_solver(config, pendulum.fused_task(), pendulum.dynamics, device="cpu")
    return make_solver(config, pendulum.dynamics, pendulum.cost, device="cpu")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("lambda_", [1.0, "MPO", "ESSPS"])
def test_checkpoint_roundtrip_resumes_identically(tmp_path, lambda_, fused):
    solver = _pendulum(lambda_, fused)
    state = solver.init(seed=0)
    x = torch.tensor([math.pi, 0.0])
    for _ in range(3):  # every leaf non-trivial
        state = solver.solve(state, x).state
    path = save_state(str(tmp_path / f"ckpt_{lambda_}"), state)
    assert path.endswith(".npz")
    restored = load_state(path, solver.init())
    assert _same(restored, state) and (restored.seed, restored.tick) == (state.seed, state.tick)
    assert (restored.mpo_opt_state is None) == (lambda_ != "MPO")
    # resumed solve == uninterrupted solve, bit for bit
    assert _same(solver.solve(state, x), solver.solve(restored, x))


def test_checkpoint_leaf_mismatch_rejected(tmp_path):
    path = save_state(str(tmp_path / "ckpt"), _pendulum(1.0).init())
    with pytest.raises(ValueError, match="leaves; template expects"):
        load_state(path, _pendulum("MPO").init())  # MPO adds its optimizer's leaves


def test_load_rejects_mismatched_shapes(tmp_path):
    """A checkpoint from a different config must fail loudly, not broadcast."""

    def cfg(horizon):
        return MPPIConfig(horizon=horizon, num_samples=64, dim_state=2, dim_control=2,
                          u_min=(-1.0, -1.0), u_max=(1.0, 1.0), sigmas=(1.0, 1.0), lambda_=1.0)

    small = make_init(cfg(4), torch.device("cpu"))()
    big_template = make_init(cfg(8), torch.device("cpu"))()
    path = save_state(str(tmp_path / "st"), small)
    with pytest.raises(ValueError, match="different solver config"):
        load_state(path, big_template)


def test_checkpoint_host_numbers_and_dtypes_roundtrip(tmp_path):
    """A 64-bit seed, a tick past 2^32 and a tree of mixed leaves come back as they were."""
    solver = _pendulum("MPO")
    state = dataclasses.replace(solver.init(seed=2**64 - 3), tick=2**33 + 5)
    restored = load_state(save_state(str(tmp_path / "big"), state), solver.init())
    assert restored.seed == 2**64 - 3 and restored.tick == 2**33 + 5
    assert restored.mpo_opt_state.count.dtype == torch.int32 and restored.lam.shape == ()
    tree = {"a": torch.arange(4, dtype=torch.int64), "b": [1.5, True, None]}
    back = load_state(save_state(str(tmp_path / "tree"), tree),
                      {"a": torch.zeros(4, dtype=torch.int64), "b": [0.0, False, None]})
    assert torch.equal(back["a"], tree["a"]) and back["b"] == [1.5, True, None]
    with pytest.raises(ValueError, match="different solver config"):
        load_state(str(tmp_path / "tree"), {"a": 0, "b": [0.0, False, None]})


def test_resume_after_a_done_fn_freeze_draws_from_the_saved_key(tmp_path):
    """After a fire the key names another stream than the host pair; the checkpoint keeps it."""
    config = MPPIConfig(horizon=10, num_samples=256, dim_state=2, dim_control=1,
                        u_min=(-2.0,), u_max=(2.0,), sigmas=(1.0,), lambda_="ESSPS",
                        store_rollouts=False)
    solver = make_fused_solver(config, pendulum.fused_task(), pendulum.dynamics, device="cpu")
    plant = lambda x, u: pendulum.dynamics(x[None], u[None])[0]  # noqa: E731
    x0 = torch.tensor([math.pi, 0.0])
    st, xf, *_, episode = make_closed_loop(solver, plant, 12, done_fn=lambda x: x[1] < -0.5)(
        solver.init(), x0)
    fired = int(episode["ticks"])
    assert bool(episode["done"]) and fired < 12
    assert not torch.equal(st.key, make_key(st.seed, st.tick, "cpu"))
    restored = load_state(save_state(str(tmp_path / "frozen"), st), solver.init())
    assert torch.equal(restored.key, make_key(st.seed, fired, "cpu")) and restored.tick == 12
    assert _same(solver.solve(st, xf), solver.solve(restored, xf))


def test_batched_fleet_state_roundtrips(tmp_path):
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory_batch,
        make_racing_fused_task_from_env,
    )

    env = RacingEnv(device="cpu")
    config = MPPIConfig(horizon=8, num_samples=256, dim_state=4, dim_control=2,
                        u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1),
                        lambda_="MPO", store_rollouts=False)
    batched = make_batched_fused_solver(config, make_racing_fused_task_from_env(env),
                                        env.dynamics, "cpu", 3)
    xs = env.reset().repeat(3, 1)
    xs[:, :3] = env.racing_center_path[torch.tensor([0, 300, 700])]
    xrefs, _ = calc_ref_trajectory_batch(xs, env.racing_center_path,
                                         torch.zeros(3, dtype=torch.int64), 8)
    states = batched.init_batch(seed=4)
    for _ in range(2):
        states = batched.solve_batch(states, xs, batched_info={"reference_path": xrefs}).state
    restored = load_state(save_state(str(tmp_path / "fleet"), states), batched.init_batch())
    assert _same(restored, states) and (restored.seed, restored.tick) == (4, 2)
    assert _same(batched.solve_batch(states, xs, batched_info={"reference_path": xrefs}),
                 batched.solve_batch(restored, xs, batched_info={"reference_path": xrefs}))
