"""The benchmark's mountain-car cell (``mountaincar.control``) on the CPU.

* The plain reference (``portbench/reference/mountaincar.py``, which imports
  nothing of the port) against the port's ``MPPI`` facade with
  ``mountain_car.dynamics`` and ``.cost`` on the unfused route at a small
  size: the costs, the stored rollouts, the plan and the re-rolled states,
  three ticks in a row.
* The spans of the user's callables: one eager solve opens
  ``solver.dynamics`` 2T times (T in the rollout, T in the re-roll) and
  ``solver.cost`` T+1 times; racing's ``env.dynamics`` nests inside them.
* The cell's loop over a few ticks reaches its checks, correct; the bfloat16
  control and planted faults (the plant state left unchanged, the solver
  state left unchanged, half the samples left out, the plan shifted by one
  step) are not.
* Each limit lies between the recorded readings of the program and of the
  control.
* The three per-layer readers on synthetic capture maps; on the card (marker
  ``cuda``), the capture map of mountain car's tick charges the rollout's
  nodes to the new spans::

    python -m pytest tests/test_torch_mountaincar_bench.py -m cuda --noconftest -q
"""

import json
import time

import pytest
import torch

from mppi_playground_tpu_torch import MPPI
from mppi_playground_tpu_torch.core import solver as solver_module
from mppi_playground_tpu_torch.examples import mountaincar as example
from mppi_playground_tpu_torch.models import mountain_car
from mppi_playground_tpu_torch.utils import timing
from portbench import harness
from portbench.nav_readings import readings
from portbench.reference.mountaincar import MountainCar
from portbench.reference.racing import tick_seed
from portbench.tracing import Reading, Slice

CELL = "mountaincar.control"
# a short window on the CPU: three warm-up ticks over no boundary, every window tick checked
SHORT = dict(warmup_ticks=3, check_every=1)


def _facade(horizon, num_samples, seed):
    return MPPI(horizon=horizon, num_samples=num_samples, dim_state=2, dim_control=1,
                dynamics=mountain_car.dynamics, cost_func=mountain_car.cost, u_min=[-1.0],
                u_max=[1.0], sigmas=[1.0], lambda_=0.1, seed=seed, device="cpu")


def test_the_facade_on_the_unfused_route_against_the_reference():
    """Three ticks of ``MPPI.forward`` at T=12, K=64 from a start near the valley's floor.

    The costs and the stored rollouts are compared bit for bit: the port's
    CPU route draws the same Philox stream and runs the same float32 ops in
    the same order as the reference (the clamped samples, then each step's
    cost summed onto a zero total before the step, the terminal cost last).
    The plan sums the softmin in another order (block partials of 256
    merged, against one einsum): a few float32 roundings of the action
    range, 1e-6 of it.  The re-rolled states carry that difference through
    T steps of a velocity that moves 0.0015 a unit of force: well under 1e-6.
    """
    seed, horizon, num_samples = 17, 12, 64
    ctrl = _facade(horizon, num_samples, seed)
    assert ctrl.solver_backend == "xla" and ctrl.config.store_rollouts
    settings = dict(u_min=[-1.0], u_max=[1.0], sigmas=[1.0], horizon=horizon,
                    num_samples=num_samples, lambda_=0.1)
    ref = MountainCar(settings)
    x = torch.tensor([-0.52, 0.0])
    for tick in range(3):
        warm = ctrl.solver_state.previous_action_seq.clone()
        plan, states = ctrl.forward(x)
        aux = ctrl._last_aux
        want = ref.tick(x[None], warm[None], [tick_seed(seed, tick)])
        assert torch.equal(aux.costs, want["costs"][0])
        assert torch.equal(aux.state_seq_batch, want["rollouts"][0])
        assert float((plan - want["plan"][0]).abs().max() / 2.0) < 1e-6
        assert torch.equal(ctrl.solver_state.previous_action_seq, plan)
        assert float((states - want["states"][0]).abs().max()) < 1e-6
        x = ref.plant(x[None], plan[:1])[0]


def _spans_of_one_solve(ctrl, x):
    first = timing.opened()
    ctrl.forward(x)
    return timing.spans(since=first)


def test_one_eager_solve_opens_the_user_callables_spans():
    horizon = 6
    ctrl = _facade(horizon, 32, 3)
    records = _spans_of_one_solve(ctrl, torch.tensor([-0.5, 0.0]))
    by_id = {r.id: r for r in records}
    dynamics = [r for r in records if r.name == "solver.dynamics"]
    costs = [r for r in records if r.name == "solver.cost"]
    assert len(dynamics) == 2 * horizon and len(costs) == horizon + 1
    parents = [by_id[r.parent].name for r in dynamics]
    assert parents.count("solver.rollout") == horizon and parents.count("solver.tail") == horizon
    assert {by_id[r.parent].name for r in costs} == {"solver.rollout"}
    assert all(r.start_ns <= r.end_ns for r in dynamics + costs)


def test_racings_plant_span_nests_inside_the_dynamics_span():
    from mppi_playground_tpu_torch.envs import RacingController, RacingEnv

    horizon = 4
    env = RacingEnv(device="cpu")
    ctrl = RacingController(env, horizon=horizon, num_samples=64, store_rollouts=True)
    x = env.reset()
    first = timing.opened()
    ctrl.update(x)
    records = timing.spans(since=first)
    by_id = {r.id: r for r in records}
    plants = [r for r in records if r.name == "env.dynamics"]
    assert len(plants) == 2 * horizon
    assert {by_id[r.parent].name for r in plants} == {"solver.dynamics"}
    assert len([r for r in records if r.name == "solver.cost"]) == horizon + 1


def _line(seed=7, seconds=1.0, **overrides):
    from portbench.tests.common import run_module

    cell = harness.load_cell(CELL)
    job = harness.Job(cell, seed, seconds, False, "cpu", time.perf_counter(),
                      dict(SHORT, **overrides))
    return run_module().execute(job)


def test_the_cells_loop_reaches_its_checks_correct():
    line = _line()
    cell = harness.load_cell(CELL)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"tick_p50_ms", "tick_p95_ms", "setup_s"}
    assert set(line["checks"]) == set(cell.limits)
    assert line["checks"]["missing_checks"]["value"] == 0


def test_the_control_fails_where_the_program_passes():
    got = readings(23, 1.0, "cpu", SHORT, workload=CELL)
    limits = got["limits"]
    assert got["checked"] >= 2
    assert all(got["program"][k] <= limit for k, limit in limits.items()), got["program"]
    failed = [k for k, limit in limits.items() if not got["control"][k] <= limit]
    assert {"plan_gap", "rollout_gap", "plant_gap"} <= set(failed)


def test_the_limits_lie_between_the_recorded_readings():
    body = json.loads((harness.HERE / "limits" / f"{CELL}.json").read_text())
    assert set(body["readings"]) == set(body["limits"])
    for name, limit in body["limits"].items():
        seen = body["readings"][name]
        assert seen["program_max"] <= limit < seen["control_min"] or (
            seen["program_max"] == limit == seen["control_min"] == 0), name
        assert seen["program_seeds"] >= 12 and seen["control_seeds"] >= 3


def plant_state_unchanged(monkeypatch):
    """The solver is built with the true model; the driver's plant then leaves its state."""
    make = example.make_solver

    def build(device=None):
        solver = make(device)
        monkeypatch.setattr(mountain_car, "dynamics", lambda state, action: state.clone())
        return solver

    monkeypatch.setattr(example, "make_solver", build)


def solver_state_unchanged(monkeypatch):
    monkeypatch.setattr(solver_module, "advance_state", lambda config, state, *a, **k: state)


def half_the_samples(monkeypatch):
    plain = solver_module.weighted_update

    def first_half(costs, samples, lam, backend="auto"):
        kept = costs.clone()
        kept[costs.shape[0] // 2:] = 1e30
        return plain(kept, samples, lam, backend=backend)

    monkeypatch.setattr(solver_module, "weighted_update", first_half)


def plan_shifted_by_one_step(monkeypatch):
    plain = solver_module.weighted_update

    def shifted(costs, samples, lam, backend="auto"):
        update, weights, ess = plain(costs, samples, lam, backend=backend)
        return torch.cat([update[1:], update[-1:]]), weights, ess

    monkeypatch.setattr(solver_module, "weighted_update", shifted)


# each fault and a number it must fail
FAULTS = {"plant_state_unchanged": (plant_state_unchanged, "plant_gap"),
          "solver_state_unchanged": (solver_state_unchanged, "key_mismatches"),
          "half_the_samples": (half_the_samples, "plan_gap"),
          "plan_shifted_by_one_step": (plan_shifted_by_one_step, "plan_gap")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    plant, fails = FAULTS[fault]
    plant(monkeypatch)
    line = _line(seed=31)
    failed = [k for k, c in line["checks"].items() if not c["value"] <= c["limit"]]
    assert line["correct"] is False and fails in failed, line["checks"]
    assert "missing_checks" not in failed


def _map():
    """A tick's capture map: a draw, two rollout steps (cost then dynamics), the terminal
    cost, the re-roll's two steps, the weighting, a copy."""
    rollout, tail = "solver.solve/solver.rollout", "solver.solve/solver.tail"
    nodes = [timing.MapNode("solver.solve", "kernel", "x", "regen_rollout_kernel")]
    for _ in range(2):
        nodes += [timing.MapNode(f"{rollout}/solver.cost", "kernel", "x", "cost_kernel"),
                  timing.MapNode(rollout, "kernel", "x", "add_kernel"),
                  timing.MapNode(f"{rollout}/solver.dynamics", "kernel", "x", "cos_kernel"),
                  timing.MapNode(f"{rollout}/solver.dynamics", "kernel", "x", "clamp_kernel")]
    nodes += [timing.MapNode(f"{rollout}/solver.cost", "kernel", "x", "cost_kernel"),
              timing.MapNode("solver.solve", "kernel", "x", "weighted_update_kernel"),
              timing.MapNode("solver.solve", "other")]
    for _ in range(2):
        nodes += [timing.MapNode(f"{tail}/solver.dynamics", "kernel", "x", "cos_kernel"),
                  timing.MapNode(f"{tail}/solver.dynamics", "kernel", "x", "clamp_kernel")]
    nodes.append(timing.MapNode("tick.capture", "memcpy"))
    return timing.SpanMap(nodes=nodes)


def _replay(t0):
    """The device activities of a replay of :func:`_map`: each kernel 1 us, dynamics 2 us."""
    acts, t = [], t0
    for node in _map().visible():
        us = 2.0 if "solver.dynamics" in node.span else 1.0
        name = "memcpy32_post" if node.kind == "memcpy" else f"void {node.base}<4>(...)"
        acts.append((name, t, t + us))
        t += us
    return acts


def _reading(device=(), ticks=2):
    sl = Slice(device=list(device), host=[], start=0.0, end=1000.0, ticks=ticks, spans={})
    return Reading(sl, solver={}, scene={}, traffic={}, card={})


@pytest.mark.parametrize("metric, want", [
    ("model_dynamics_us.control", 8 * 2.0),  # 4 steps of two nodes, 2 us each
    ("model_cost_us.control", 3 * 1.0),  # 3 cost calls of one node
])
def test_the_model_readers_read_the_capture_maps(metric, want, monkeypatch):
    read = harness.reader(metric)
    monkeypatch.setattr(timing, "_maps", {0: _map()})
    got = read(_reading(_replay(100.0) + _replay(300.0)))
    assert got["value"] == want and got["replays_matched"] == 2 and got["ticks_in_slice"] == 2
    assert got["attributed_share"] == 1.0
    assert read(_reading([("void other_kernel<1>(...)", 0.0, 1.0)])) is None
    other = timing.SpanMap(nodes=[timing.MapNode("solver.solve", "kernel", "x", "cos_kernel")])
    monkeypatch.setattr(timing, "_maps", {0: other})  # a map without the span: a parent's
    assert read(_reading([("void cos_kernel<4>(...)", 0.0, 1.0)])) is None


def test_graph_nodes_reads_the_most_replayed_map(monkeypatch):
    read = harness.reader("graph_nodes.control")
    monkeypatch.setattr(timing, "_maps", {})
    assert read(_reading()) is None
    tick, once = _map(), timing.SpanMap(nodes=[timing.MapNode("tick.capture", "memcpy")])
    tick.replays, once.replays = 40, 1
    monkeypatch.setattr(timing, "_maps", {0: once, 1: tick})
    got = read(_reading())
    assert got["value"] == len(tick.nodes) == 17 and got["replays"] == 40
    assert got["by_kind"] == {"kernel": 15, "other": 1, "memcpy": 1}
    assert got["by_span"]["solver.solve/solver.rollout/solver.dynamics"] == 4
    tick.replays = once.replays = 0
    assert read(_reading()) is None


@pytest.mark.cuda
def test_mountain_cars_capture_map_charges_the_rollout_to_the_new_spans():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; portbench's traced runs read the map there")
    from torch.profiler import ProfilerActivity, profile

    solver = example.make_solver("cuda")
    horizon = solver.config.horizon
    x = torch.tensor([-0.5, 0.0])
    solver.forward(x)  # eager, then the capture
    graph = solver._ticks.graph
    nodes = graph.span_map.nodes
    dyn = [n for n in nodes if n.span.split("/")[-1] == "solver.dynamics"]
    cost = [n for n in nodes if n.span.split("/")[-1] == "solver.cost"]
    in_rollout = [n for n in dyn if "solver.rollout" in n.span.split("/")]
    in_tail = [n for n in dyn if "solver.tail" in n.span.split("/")]
    # the same torch ops each call: the calls' nodes divide evenly
    assert len(in_rollout) == len(in_tail) > 0 and len(in_rollout) % horizon == 0
    assert len(cost) > 0 and len(cost) % (horizon + 1) == 0
    assert all("solver.rollout" in n.span.split("/") for n in cost)
    for _ in range(3):
        solver.forward(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(200):  # the trace drops its first device activities: prime it
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(0.2)
        for _ in range(2):
            graph.replay()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    acts = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == cuda and "sleep" not in e.name and "spin_kernel" not in e.name]
    got = timing.attribute(acts, [graph.span_map])
    assert got["replays"] == 2 and got["attributed_share"] == 1.0
    spans = got["us_per_tick"]
    model = timing.under(spans, "solver.dynamics") + timing.under(spans, "solver.cost")
    assert timing.under(spans, "solver.dynamics") > 0 and timing.under(spans, "solver.cost") > 0
    assert model > 0.5 * sum(spans.values())  # the user's model is most of the tick
