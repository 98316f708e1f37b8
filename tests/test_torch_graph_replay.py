"""Graph-replayed ticks and the seed by pointer, on the card (marker ``cuda``).

These need an NVIDIA GPU with ``nvcc``; they skip without a card, and import
no jax, so that the card's machine runs them::

    python -m pytest tests/test_torch_graph_replay.py -m cuda --noconftest -q

A graph replay of N closed-loop ticks is bit for bit N eager ticks on both
routes; two replayed ticks draw different streams, each its eager tick's; the
kernels reading the seed by pointer are bit for bit their twins, and the
regeneration kernel moves the key on; a replayed ``update`` then
``get_top_samples(300)`` is bit for bit the eager pair; a dynamics that reads
a device value on the host fails the capture with the requirement named.  ``chip_smoke.py``
phase 12 checks the same at the flagship's size.
"""

import pytest
import torch

from mppi_playground_tpu_torch.core.closed_loop import _tensors, make_closed_loop
from mppi_playground_tpu_torch.core.config import MPPIConfig, make_key, tick_seed
from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
from mppi_playground_tpu_torch.core.solver import make_solver
from mppi_playground_tpu_torch.envs import RacingController, RacingEnv
from mppi_playground_tpu_torch.models.racing_mpcc import (
    calc_ref_trajectory,
    make_mpcc_cost,
    make_racing_fused_task_from_env,
)
from mppi_playground_tpu_torch.ops import fused_solve as fs

pytestmark = pytest.mark.cuda


def _same(a, b) -> bool:
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(ta, tb))



@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py phase 12 runs these on the card")
    return RacingEnv(device="cuda")


@pytest.mark.parametrize("store_rollouts", [True, False], ids=["unfused", "fused"])
def test_graph_replays_are_the_eager_ticks_on_the_card(card, store_rollouts):
    env = card
    config = MPPIConfig(horizon=25, num_samples=4000, dim_state=4, dim_control=2,
                        u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1), lambda_=1.0,
                        store_rollouts=store_rollouts)
    if store_rollouts:
        solver = make_solver(config, env.dynamics,
                             make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map),
                             device="cuda")
    else:
        solver = make_fused_solver(config, make_racing_fused_task_from_env(env), env.dynamics,
                                   device="cuda")
    path = env.racing_center_path

    def info_fn(cind, x):
        xref, new_cind = calc_ref_trajectory(x, path, cind, 25)
        return {"reference_path": xref}, new_cind

    def plant(x, u):
        return env.dynamics(x[None], u[None])[0]

    run = make_closed_loop(solver, plant, 20, info_fn=info_fn)
    x0, c0 = env.reset(), torch.tensor(0, device="cuda")
    first = run(solver.init(), x0, c0)
    again = run(solver.init(), x0, c0)
    st, x, c, xs, us = solver.init(), x0, c0, [], []
    for _ in range(20):
        info, c = info_fn(c, x)
        r = solver.solve(st, x, info=info)
        xs.append(x)
        us.append(r.action_seq[0])
        st, x = r.state, plant(x, r.action_seq[0])
    eager = (st, x, torch.stack(xs), torch.stack(us), c)
    assert _same(first, eager) and _same(again, eager)


def test_two_replays_draw_different_streams_on_the_card(card):
    env = card
    ctrl = RacingController(env, store_rollouts=False)
    x = env.reset()
    ctrl.update(x)  # eager, then the capture
    seeds, costs = [], []
    for _ in range(2):  # two replays
        ctrl.update(x)
        seeds.append(ctrl._last_aux.seed.clone())
        costs.append(ctrl._last_aux.costs.clone())
    assert seeds[0].tolist() == [tick_seed(42, 1)] and seeds[1].tolist() == [tick_seed(42, 2)]
    assert not torch.equal(costs[0], costs[1])


@pytest.mark.parametrize("mode", ["noise", "seeded"])
def test_kernels_with_the_seed_by_pointer_are_their_twins_on_the_card(card, mode):
    env = card
    task = make_racing_fused_task_from_env(env)
    from tests.test_torch_kernels import _inputs

    x0, prev, ref, noise = _inputs(env, 50, 20_000, seed=3)
    nz = noise if mode == "noise" else None
    key = make_key(9, 4, "cuda")
    seed = key[2:]
    bounds = ((0.5, 0.1), (-2.0, -0.25), (2.0, 0.25))
    k, lam = 20_000, torch.ones(1, device="cuda")
    got = fs.fused_costs_dump(x0, prev, seed, ref, task, *bounds, k, k, nz)
    want = fs.fused_costs_dump_plain(x0, prev, seed, ref, task, *bounds, k, k, nz)
    assert _same(got, want)
    rows = torch.arange(k, device="cuda")
    out = torch.empty_like(key)
    regen = fs.fused_regen(prev, seed, rows, *bounds, k, k, nz, key=key, key_out=out)
    assert torch.equal(regen.reshape(k, -1).t(), got[1])
    assert torch.equal(out, make_key(9, 5, "cuda"))
    solved = fs.fused_solve(x0, prev, lam, seed, ref, task, *bounds, k, k, nz)
    assert torch.equal(solved[0], got[0])


@pytest.mark.parametrize("store_rollouts", [True, False], ids=["unfused", "fused"])
def test_replayed_update_then_top_samples_is_the_eager_pair_on_the_card(card, store_rollouts):
    from mppi_playground_tpu_torch.core import diagnostics

    env = card
    ctrl = RacingController(env, store_rollouts=store_rollouts)
    ref = RacingController(env, store_rollouts=store_rollouts)
    x = env.reset()
    st, cind = ref.solver_state, ref.current_path_index
    for _ in range(3):  # eager and the capture, replay, replay
        a, s = ctrl.update(x)
        r, cind, _ = ref._tick(st, x, cind)
        st = r.state
        assert torch.equal(a, r.action_seq) and torch.equal(s, r.state_seq)
        x = env.dynamics(x[None], a[:1])[0]
    got = ctrl.get_top_samples(300)
    want = diagnostics.top_samples_from_last(ref._solver, r.aux, 300)
    assert _same(got, want)


def test_a_tick_that_cannot_be_captured_names_the_requirement_on_the_card(card):
    from mppi_playground_tpu_torch import MPPI
    from mppi_playground_tpu_torch.models import pendulum

    def dynamics(x, u):  # reads a device value on the host: no graph can hold that
        return pendulum.dynamics(x, u * float(u.abs().max() >= 0))

    c = MPPI(horizon=10, num_samples=256, dim_state=2, dim_control=1, dynamics=dynamics,
             cost_func=pendulum.cost, u_min=(-2.0,), u_max=(2.0,), sigmas=(1.0,), lambda_=1.0,
             device="cuda")
    with pytest.raises(RuntimeError, match="must be torch operations"):
        c.forward(torch.tensor([3.0, 0.0], device="cuda"))
    torch.cuda.synchronize()
    a, _ = c.forward(torch.tensor([3.0, 0.0], device="cuda"), info={})  # eager ticks still run
    assert torch.isfinite(a).all()
    # the failed capture left torch's CUDA generator out of capture mode: it still draws
    assert torch.isfinite(torch.randn(4, device="cuda")).all()



def test_a_capture_survives_graphs_left_for_the_collector(card):
    """Graphs in reference cycles, freed by the collector, never land inside a capture.

    Destroying a CUDA graph while another captures invalidates the capture (it
    failed so once, between the two ``RacingController`` cases above, in one
    process). ``TickGraph`` collects first and holds the collector off.
    """
    import gc

    from mppi_playground_tpu_torch.core.closed_loop import TickGraph

    x = torch.zeros(256, device="cuda")
    for _ in range(4):  # captured graphs left in cycles, for the collector
        holder = [TickGraph(lambda: x.add_(1.0), x.device)]
        holder.append(holder)
    del holder
    threshold = gc.get_threshold()
    gc.set_threshold(1)  # collect at every allocation the collector counts
    try:
        graph = TickGraph(lambda: [x.mul(2.0) + float(i) for i in range(64)][-1], x.device)
    finally:
        gc.set_threshold(*threshold)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(graph.out, x * 2.0 + 63.0)
