"""The benchmark's Navigation2D cell (``navigation.control``) on the CPU.

* The plain reference (``portbench/reference/navigation.py``, which imports
  nothing of the port) against the port's ``MPPI`` facade on the fused route
  (the λ epilogue at this K) at a small size: the plan, λ, and the top
  samples' weights, rows and rollouts, three ticks in a row.
* The scene the reference builds from upstream's description is the
  ``Navigation2DEnv``'s grid.
* ``get_top_samples`` is one span ``solver.top_samples`` with its children
  and one count of the counter, on the fused route and on stored rollouts.
* The cell's loop over a few ticks reaches its checks, correct; the
  bfloat16 control and three planted faults (a state left unchanged, half
  the samples left out, the top samples taken by cost in reverse) are not.
* The per-layer readers of the cell on synthetic traced slices.
"""

import json
import time

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch import MPPI
from mppi_playground_tpu_torch.core import fused_solver
from mppi_playground_tpu_torch.envs import Navigation2DEnv
from mppi_playground_tpu_torch.maps.grid_cost import GridMapData
from mppi_playground_tpu_torch.models import unicycle
from mppi_playground_tpu_torch.ops import fused_solve
from mppi_playground_tpu_torch.utils import timing
from portbench import harness
from portbench.nav_readings import readings
from portbench.reference.navigation import Navigation, Scene, scene
from portbench.reference.racing import tick_seed
from portbench.tracing import Reading, Slice

CELL = "navigation.control"
# a short window on the CPU: three warm-up ticks over no boundary, every window tick checked
# (a loaded CPU may run only a few ticks in the window)
SHORT = dict(warmup_ticks=3, check_every=1)


def _small_problem(seed=5, cells=40, cell_size=0.5):
    """A 40 x 40 grid of 0.5 m cells (20 x 20 m) with seeded blocks, the goal at (9, 9)."""
    rng = np.random.default_rng(seed)
    grid = np.zeros((cells, cells))
    for _ in range(12):
        x, y = rng.integers(4, cells - 6, size=2)
        grid[x:x + 3, y:y + 3] = 1
    half = cell_size * cells / 2
    return Scene(grid, (cells / 2, cells / 2), cell_size, (-half, half), (-half, half),
                 (-9.0, -9.0), (9.0, 9.0))


def _facade(sc, horizon, num_samples, seed, fused=True):
    grid = torch.as_tensor(sc.grid != 0, dtype=torch.uint8)
    goal = torch.tensor(sc.goal)
    task = unicycle.make_navigation_fused_task(grid, sc.origin, sc.cell_size, sc.goal,
                                               sc.x_lim, sc.y_lim)
    cost_map = GridMapData(torch.as_tensor(sc.grid, dtype=torch.float32),
                           torch.tensor(sc.origin), sc.cell_size)
    return MPPI(horizon=horizon, num_samples=num_samples, dim_state=3, dim_control=2,
                dynamics=unicycle.make_dynamics(sc.x_lim, sc.y_lim),
                cost_func=unicycle.make_navigation_cost(goal, cost_map),
                u_min=unicycle.U_MIN, u_max=unicycle.U_MAX, sigmas=(0.5, 0.5), lambda_="ESSPS",
                store_rollouts=not fused, fused_task=task if fused else None, seed=seed,
                device="cpu")


def test_the_reference_scene_is_the_envs():
    sc = scene(harness.load_cell(CELL).config)
    env = Navigation2DEnv(device="cpu")
    assert np.array_equal(sc.grid, env.obstacle_map.grid)
    assert sc.origin == tuple(float(v) for v in env.obstacle_map.origin)
    assert (sc.x_lim, sc.y_lim) == (tuple(env.obstacle_map.x_lim), tuple(env.obstacle_map.y_lim))
    assert sc.goal == tuple(env.goal_pos.tolist())
    assert tuple(env.reset()[:2].tolist()) == sc.start


def test_the_facade_on_the_fused_route_against_the_reference():
    """Three ticks of ``MPPI.forward`` and ``get_top_samples`` at K=256, T=8, a 40 x 40 grid.

    The tolerances are a few float32 roundings of the quantity's scale: the
    reference computes the rollouts and costs in the kernels' order (the same
    bits), and sums the softmin, the ESS and the plan in another order than
    the tail and the search (λ 1.4e-7 relative apart at the cell's size).  λ
    then moves each weight by up to (c - c_min) / λ of that, the plan by as
    much of the action range, and the top rows' states not at all.
    """
    sc = _small_problem()
    seed, top = 17, 32
    settings = dict(u_min=unicycle.U_MIN, u_max=unicycle.U_MAX, sigmas=(0.5, 0.5), horizon=8,
                    num_samples=256, lambda_min=0.01, lambda_max=10.0, essps_iters=40)
    ctrl = _facade(sc, 8, 256, seed)
    assert ctrl.solver_backend == "fused"
    assert fused_solver.takes_lambda_epilogue(ctrl.config)
    ref = Navigation(sc, settings)
    x = torch.tensor([-9.0, -8.5, 0.7])
    for tick in range(3):
        warm = ctrl.solver_state.previous_action_seq.clone()
        plan, states = ctrl.forward(x)
        top_states, top_w = ctrl.get_top_samples(top)
        want = ref.tick(x[None], warm[None], [tick_seed(seed, tick)], top)
        assert float((plan - want["plan"][0]).abs().max() / 2.0) < 1e-5
        assert float((states - want["states"][0]).abs().max()) < 1e-4
        assert float(ctrl.solver_state.lam) == pytest.approx(float(want["lam"][0]), rel=1e-5)
        rows, w = want["top_rows"][0], want["top_weights"][0]
        assert float((top_w - w).abs().max()) < 1e-4 * float(w[0])
        # the rows: each of the port's top rollouts is the reference's of the same sample,
        # in the same order where the reference's weights differ
        distinct = torch.cat([w[:-1] - w[1:] > 1e-3 * w[:-1], torch.tensor([True])])
        distinct &= torch.cat([torch.tensor([True]), distinct[:-1]]) & (w > 0)
        assert int(distinct.sum()) > top // 2
        got_rows = torch.cdist(top_states.flatten(1), want["rollouts"][0].flatten(1),
                               p=float("inf")).argmin(dim=1)
        assert torch.equal(got_rows[distinct], rows[distinct])
        assert float((top_states - want["rollouts"][0][got_rows]).abs().max()) < 1e-4
        x = ref.plant(x[None], plan[:1])[0]


def _spans_of_one_call(ctrl, n):
    first, count = timing.opened(), timing.counter("solver.top_samples")
    ctrl.get_top_samples(n)
    records = timing.spans(since=first)
    return records, timing.counter("solver.top_samples") - count


@pytest.mark.parametrize("fused, children", [
    (True, ["solver.top_indices", "solver.top_rollouts"]),
    (False, ["solver.top_indices"]),
])
def test_top_samples_is_one_span_with_its_children_a_call(fused, children):
    ctrl = _facade(_small_problem(), 6, 256, 3, fused=fused)
    assert ctrl.solver_backend == ("fused" if fused else "xla")
    ctrl.forward(torch.tensor([-9.0, -9.0, 0.78]))
    for _ in range(2):
        records, counted = _spans_of_one_call(ctrl, 10)
        outer = [r for r in records if r.name == "solver.top_samples"]
        assert len(outer) == 1 and counted == 1
        kids = timing.children(records)[outer[0].id]
        assert [r.name for r in kids] == children
        assert all(outer[0].start_ns <= r.start_ns <= r.end_ns <= outer[0].end_ns for r in kids)


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
    got = readings(23, 1.0, "cpu", SHORT)
    limits = got["limits"]
    assert all(got["program"][k] <= limit for k, limit in limits.items()), got["program"]
    failed = [k for k, limit in limits.items() if not got["control"][k] <= limit]
    assert {"plan_gap", "lambda_gap", "top_gap", "top_index_mismatches"} <= set(failed)


def test_the_limits_lie_between_the_recorded_readings():
    body = json.loads((harness.HERE / "limits" / f"{CELL}.json").read_text())
    for name, limit in body["limits"].items():
        seen = body["readings"][name]
        assert seen["program_max"] <= limit < seen["control_min"] or (
            seen["program_max"] == limit == seen["control_min"] == 0), name
        assert seen["program_seeds"] >= 12 and seen["control_seeds"] >= 3


def state_unchanged(monkeypatch):
    monkeypatch.setattr(fused_solver, "advance_state", lambda config, state, *a, **k: state)


def half_the_samples(monkeypatch):
    plain = fused_solve.block_partials_plain

    def first_half(costs, flat, lam):
        kept = costs.clone()
        kept[costs.shape[0] // 2:] = 1e30
        return plain(kept, flat, lam)

    monkeypatch.setattr(fused_solve, "block_partials_plain", first_half)


def top_by_cost_in_reverse(monkeypatch):
    def reversed_order(weights, n):
        order = torch.sort(weights, descending=False, stable=True)
        return order.values[:n], order.indices[:n]

    monkeypatch.setattr(fused_solver, "top_indices", reversed_order)


# each fault and a number it must fail
FAULTS = {"state_unchanged": (state_unchanged, "key_mismatches"),
          "half_the_samples": (half_the_samples, "plan_gap"),
          "top_by_cost_in_reverse": (top_by_cost_in_reverse, "top_gap")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    plant, fails = FAULTS[fault]
    plant(monkeypatch)
    line = _line(seed=31)
    failed = [k for k, c in line["checks"].items() if not c["value"] <= c["limit"]]
    assert line["correct"] is False and fails in failed, line["checks"]
    assert "missing_checks" not in failed


def _reading(host, device, ticks=2):
    cell = harness.load_cell(CELL)
    sl = Slice(device=device, host=host, start=0.0, end=1000.0, ticks=ticks, spans={})
    return Reading(sl, harness.solver_settings(cell), cell.config["scene"], cell.traffic,
                   {"name": "test card", "power_limit": "700.00 W"})


def test_top_samples_us_reads_the_calls_windows_less_the_reads():
    read = harness.reader("top_samples_us.control")
    host = [("facade.forward", 0.0, 40.0), ("solver.top_samples", 100.0, 130.0),
            ("facade.forward", 200.0, 240.0), ("solver.top_samples", 300.0, 320.0)]
    device = [("ampere_sgemm", 10.0, 60.0),  # the tick's
              ("radixSort", 105.0, 115.0), ("regen_rollout_kernel<unicycle::N>", 120.0, 140.0),
              ("Memcpy DtoH (Device -> Pageable)", 150.0, 152.0),  # the loop's read
              ("radixSort", 305.0, 311.0), ("Memcpy DtoH (Device -> Pageable)", 330.0, 331.0)]
    got = read(_reading(host, device))
    assert got["value"] == pytest.approx((30.0 + 6.0) / 2) and got["calls"] == 2
    assert read(_reading([h for h in host if h[0] != "solver.top_samples"], device)) is None


def test_the_rooflines_read_their_kernels_launches():
    ticks = 2
    epi = "void fused::costs_dump_lambda_kernel<unicycle::NavigationModel, false>(x)"
    rows = "void fused::regen_rollout_kernel<unicycle::NavigationModel>(x)"
    device = [(epi, 0, 70.0), (epi, 100, 180.0), (rows, 200, 210.0), (rows, 300, 312.0)]
    epilogue = harness.reader("roofline.costs_dump_lambda")(_reading([], device, ticks))
    assert epilogue["mean_launch_us"] == 75.0 and epilogue["launches_per_tick"] == 1.0
    assert epilogue["row3_launches_per_tick"] == 0 and epilogue["row7_launches_per_tick"] == 0
    assert 0 < epilogue["value"] < 100 and epilogue["bound_by"] == "bytes"
    top = harness.reader("roofline.top_rollouts")(_reading([], device, ticks))
    assert top["mean_launch_us"] == 11.0 and top["launches_per_tick"] == 1.0
    assert 0 < top["value"] < 100
    assert harness.reader("roofline.top_rollouts")(_reading([], device[:2], ticks)) is None
