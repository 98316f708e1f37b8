"""The unfused rollout's costs summed after the loop (``core/solver._rollout_and_costs``).

Each step's stage cost is kept and the T+1 stages are summed once the loop
has ended, in the loop's order: on the card in one launch (a scan over the
stacked stages), on the CPU by the serial adds, so that no add waits between
one step's state and the next.  Held here, on the CPU and on the card
(marker ``cuda``):

* the rollout against a serial loop written in this file (cost, add,
  dynamics), bit for bit in the costs and the stored rollouts, for the
  mountain car's torch pair and racing's pair, with ``store_rollouts`` on
  and off, eager and (on the card) replayed from a CUDA graph;
* the ordered sum against the serial adds, bit for bit, with -0.0, infinite
  and NaN stages, one column and many, in the stages' dtype and in a wider
  one;
* on the card, the unfused fleet without stored rollouts, scenario by
  scenario the single solve (its stages summed under ``vmap``), and the
  mountain car's capture map: 11 nodes a dynamics call, 2 a cost call, no
  add a step.

Run the card's on the card::

    python -m pytest tests/test_torch_rollout_sum.py -m cuda --noconftest -q
"""

import pytest
import torch

from mppi_playground_tpu_torch.core.closed_loop import TickGraph
from mppi_playground_tpu_torch.core.config import MPPIConfig
from mppi_playground_tpu_torch.core.solver import _ordered_sum, _rollout_and_costs
from mppi_playground_tpu_torch.envs import RacingEnv
from mppi_playground_tpu_torch.models import mountain_car
from mppi_playground_tpu_torch.models.racing_mpcc import calc_ref_trajectory, make_mpcc_cost

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the unfused cells replay this rollout there")
    return torch.device(name)


def _mountain_car(device, rows, horizon, seed):
    g = torch.Generator().manual_seed(seed)
    x0 = torch.tensor([-0.5, 0.0]) + torch.randn(2, generator=g) * torch.tensor([0.05, 0.01])
    actions = (torch.randn(rows, horizon, 1, generator=g) * 1.5).clamp(-1.0, 1.0)
    return (mountain_car.dynamics, mountain_car.cost, x0.to(device), actions.to(device), {})


_envs = {}


def _racing(device, rows, horizon, seed):
    env = _envs.get(device)
    if env is None:
        env = _envs[device] = RacingEnv(device=device)
    g = torch.Generator().manual_seed(seed)
    x0 = env.reset().to(device).clone()
    x0[3] = 2.0 + float(torch.rand((), generator=g))
    bounds = torch.tensor([2.0, 0.25])
    actions = (torch.randn(rows, horizon, 2, generator=g) * torch.tensor([0.5, 0.1])).clamp(
        -bounds, bounds)
    xref, _ = calc_ref_trajectory(x0, env.racing_center_path,
                                  torch.zeros((), dtype=torch.int64, device=device), horizon)
    cost = make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map)
    return env.dynamics, cost, x0, actions.to(device), {"reference_path": xref}


PAIRS = {"mountain_car": (_mountain_car, 1000, 100), "racing": (_racing, 4000, 25)}


def _serial(dynamics, cost, x0, actions, info):
    """The rollout as one chain: each step's cost, its add onto the total, the dynamics."""
    horizon = actions.shape[1]
    x = x_prev = x0
    total = torch.zeros(x0.shape[0], dtype=x0.dtype, device=x0.device)
    states = [x0]
    for t in range(horizon):
        step = dict(info, prev_state=x_prev, prev_action=actions[:, max(t - 1, 0)],
                    initial_state=x0, t=t)
        total = total + cost(x, actions[:, t], step)
        x_prev = x
        x = dynamics(x, actions[:, t])
        states.append(x)
    last = dict(info, prev_state=x_prev, prev_action=actions[:, max(horizon - 2, 0)],
                initial_state=x0, t=horizon - 1)
    total = total + cost(x, torch.zeros_like(actions[:, 0]), last)
    return total, torch.stack(states, dim=1)


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("store", [True, False])
@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("device", DEVICES)
def test_the_rollout_is_the_serial_loop(device, pair, store):
    """Eager twice, then (on the card) captured and replayed on new inputs: the costs and
    the stored rollouts are the serial loop's bit for bit."""
    device = _device(device)
    make, rows, horizon = PAIRS[pair]
    if device.type == "cpu":
        rows, horizon = 64, 8
    for seed in (1, 2):
        dynamics, cost, x0, actions, info = make(device, rows, horizon, seed)
        x0s = x0.expand(rows, x0.shape[0])
        costs, rollouts = _rollout_and_costs(dynamics, cost, x0s, actions, info, store)
        want_costs, want_rollouts = _serial(dynamics, cost, x0s, actions, info)
        assert torch.equal(_bits(costs), _bits(want_costs)), (pair, seed)
        assert (rollouts is None) != store
        if store:
            assert torch.equal(rollouts, want_rollouts)
    if device.type == "cpu":
        return
    dynamics, cost, x0, actions, info = make(device, rows, horizon, 3)
    static_x0, static_actions = x0.clone(), actions.clone()
    graph = TickGraph(lambda: _rollout_and_costs(
        dynamics, cost, static_x0.expand(rows, x0.shape[0]), static_actions, info, store),
        device)
    for seed in (4, 5):
        _, _, x0, actions, _ = make(device, rows, horizon, seed)
        static_x0.copy_(x0)
        static_actions.copy_(actions)
        graph.replay()
        costs, rollouts = graph.out
        want_costs, want_rollouts = _serial(dynamics, cost, x0.expand(rows, x0.shape[0]),
                                            actions, info)
        assert torch.equal(_bits(costs), _bits(want_costs)), (pair, seed)
        if store:
            assert torch.equal(rollouts, want_rollouts)


@pytest.mark.parametrize("rows", [1, 3, 1000])
@pytest.mark.parametrize("device", DEVICES)
def test_the_ordered_sum_is_the_serial_adds(device, rows):
    """-0.0 stages (0 + -0.0 is +0.0), infinities of both signs and NaN among random float32
    stages of every magnitude."""
    device = _device(device)
    g = torch.Generator().manual_seed(rows)
    stages = torch.randn(101, rows, generator=g) * torch.logspace(-30, 30, 101)[:, None]
    specials = torch.tensor([-0.0, float("inf"), -float("inf"), float("nan"), 0.0, -1e38])
    picks = torch.randint(0, 101 * rows, (max(rows // 4, 6),), generator=g)
    stages.view(-1)[picks] = specials[torch.arange(picks.numel()) % specials.numel()]
    stages[:, 0] = -0.0  # a column of negative zeros
    stages = [s.to(device) for s in stages]
    for dtype in (torch.float32, torch.float64):  # the states' dtype: the stages' or wider
        like = torch.zeros(rows, 2, dtype=dtype, device=device)
        total = torch.zeros(rows, dtype=dtype, device=device)
        for stage in stages:
            total = total + stage
        got = _ordered_sum(stages, like)
        assert got.dtype == total.dtype and got.shape == total.shape
        assert torch.equal(_bits(got), _bits(total)), dtype


@pytest.mark.cuda
def test_the_unfused_fleet_without_stored_rollouts_is_the_single_solves():
    """Scenario b of the fleet's vmapped rollout, its costs summed under ``vmap``, bit for
    bit the single solve's, three ticks."""
    from mppi_playground_tpu_torch.models.racing_mpcc import calc_ref_trajectory_batch
    from mppi_playground_tpu_torch.parallel import make_batched_solver, scenario

    device = _device("cuda")
    env = RacingEnv(device=device)
    batch, horizon = 3, 25
    config = MPPIConfig(horizon=horizon, num_samples=1500, dim_state=4, dim_control=2,
                        u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1),
                        lambda_=1.0, store_rollouts=False)
    cost = make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map)
    batched = make_batched_solver(config, env.dynamics, cost, device, batch)
    states = batched.init_batch(seed=5)
    singles = [scenario(states, b) for b in range(batch)]
    path = env.racing_center_path
    x0s = env.reset().repeat(batch, 1)
    x0s[:, :3] = path[torch.tensor([0, 400, 900], device=device)]
    cinds = torch.zeros(batch, dtype=torch.int64, device=device)
    for tick in range(3):
        xrefs, cinds = calc_ref_trajectory_batch(x0s, path, cinds, horizon)
        out = batched.solve_batch(states, x0s, batched_info={"reference_path": xrefs})
        assert out.aux.state_seq_batch is None
        for b in range(batch):
            one = batched.solver.solve(singles[b], x0s[b], info={"reference_path": xrefs[b]})
            assert torch.equal(_bits(one.aux.costs), _bits(out.aux.costs[b])), (tick, b)
            assert torch.equal(one.action_seq, out.action_seq[b]), (tick, b)
            assert torch.equal(one.state_seq, out.state_seq[b]), (tick, b)
            singles[b] = one.state
        states = out.state
        x0s = env.dynamics(x0s, out.action_seq[:, 0])


@pytest.mark.cuda
def test_mountain_cars_capture_map_has_no_add_a_step():
    """The replayed tick's map: each dynamics call 11 nodes and each cost call 2, as before;
    the rollout's own nodes a few (the stacks, the sum, the terminal zeros), no add a step."""
    from mppi_playground_tpu_torch.examples import mountaincar as example

    _device("cuda")
    solver = example.make_solver("cuda")
    horizon = solver.config.horizon
    solver.forward(torch.tensor([-0.5, 0.0]))  # eager, then the capture
    nodes = solver._ticks.graph.span_map.nodes
    leaf = [n.span.split("/") for n in nodes]
    rollout_dyn = [n for n, p in zip(nodes, leaf) if p[-1] == "solver.dynamics"
                   and "solver.rollout" in p]
    cost = [n for n, p in zip(nodes, leaf) if p[-1] == "solver.cost"]
    own = [n for n, p in zip(nodes, leaf) if p[-1] == "solver.rollout"]
    assert len(rollout_dyn) == 11 * horizon and len(cost) == 2 * (horizon + 1)
    assert len(own) < 10, own
    assert any("scan" in (n.base or "") for n in own), own  # the sum, one launch
