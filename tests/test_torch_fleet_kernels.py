"""The fleet's batched launches and the fleet loop on the card (marker ``cuda``).

These need an NVIDIA GPU with ``nvcc``; they skip without a card, and import
no jax, so that the card's machine runs them::

    python -m pytest tests/test_torch_fleet_kernels.py -m cuda --noconftest -q

Each batched launch (rows 1-9 with the scenarios on ``blockIdx.y``: row 4's
λ epilogue with a ticket a scenario, row 6's draw and row 9's weighted
update besides) is bit for bit the single launch on each scenario's inputs,
seeded and in noise mode, at a full last block (K=4,096) and a ragged one
(K=1,500), with B=3 scenarios; and its twin (the single twin scenario by
scenario) at the single kernels' bars (``tests/test_torch_kernels.py``).  The
batched fused solver is bit for bit the single solves on every λ route, the
epilogue fleet's replayed ticks the standalone fleet's, the unfused fleet
(one launch of rows 6 and 9 a tick) the single unfused solves, and a fleet
of replayed ticks bit for bit B independent closed loops.
``chip_smoke.py`` phase 13 checks the same at the fleet's full width.
"""

import dataclasses

import pytest
import torch

from mppi_playground_tpu_torch.core.closed_loop import (
    _tensors,
    make_closed_loop,
    make_fleet_closed_loop,
)
from mppi_playground_tpu_torch.core.config import MPPIConfig, make_batch_key
from mppi_playground_tpu_torch.envs import RacingEnv
from mppi_playground_tpu_torch.models.racing_mpcc import (
    calc_ref_trajectory,
    calc_ref_trajectory_batch,
    extend_reference_path,
    make_mpcc_cost,
    make_racing_fused_task_from_env,
)
from mppi_playground_tpu_torch.ops import fused_solve as fs
from mppi_playground_tpu_torch.ops import lambda_search as ls
from mppi_playground_tpu_torch.ops import weighted_update as wu
from mppi_playground_tpu_torch.parallel import (
    make_batched_fused_solver,
    make_batched_solver,
    scenario,
)

pytestmark = pytest.mark.cuda

B, T = 3, 25
BOUNDS = ((0.5, 0.1), (-2.0, -0.25), (2.0, 0.25))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py phase 13 runs these on the card")
    return RacingEnv(device="cuda")


def _inputs(env, k, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    path = env.racing_center_path
    x0s = env.reset().repeat(B, 1)
    x0s[:, :3] = path[torch.tensor([0, 400, 900], device=path.device)]
    xrefs, _ = calc_ref_trajectory_batch(x0s, path, torch.zeros(B, dtype=torch.int64,
                                                               device="cuda"), T)
    refs = extend_reference_path(xrefs).contiguous()
    prevs = (torch.randn(B, T, 2, generator=g) * torch.tensor([0.5, 0.1])).cuda()
    noise = (torch.randn(B, k, T, 2, generator=g) * torch.tensor([0.5, 0.1])).cuda()
    keys = make_batch_key(42, 3, B, "cuda")
    lams = torch.tensor([1.0, 0.5, 2.0], device="cuda")
    return x0s.contiguous(), prevs, refs, noise, keys, lams


def _equal(a, b) -> bool:
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(x.shape == y.shape and torch.equal(x, y)
                                      for x, y in zip(ta, tb))


@pytest.mark.parametrize("mode", ["seeded", "noise"])
@pytest.mark.parametrize("k", [4096, 1500])
def test_batched_rollout_kernels_are_the_single_launches(card, mode, k):
    task = make_racing_fused_task_from_env(card)
    x0s, prevs, refs, noise, keys, lams = _inputs(card, k)
    nz = noise if mode == "noise" else None
    threshold = int(0.7 * k)
    seeds = keys[:, 2]
    solve = fs.fused_solve_batch(x0s, prevs, lams, seeds, refs, task, *BOUNDS, k, threshold, nz)
    dump = fs.fused_costs_dump_batch(x0s, prevs, seeds, refs, task, *BOUNDS, k, threshold, nz)
    for b in range(B):
        one = fs.fused_solve(x0s[b], prevs[b], lams[b:b + 1], keys[b, 2:], refs[b], task,
                             *BOUNDS, k, threshold, None if nz is None else nz[b])
        assert _equal(tuple(t[b] for t in solve), one), b
        one = fs.fused_costs_dump(x0s[b], prevs[b], keys[b, 2:], refs[b], task, *BOUNDS, k,
                                  threshold, None if nz is None else nz[b])
        assert _equal(tuple(t[b] for t in dump), one), b
    twin = fs.fused_solve_batch_plain(x0s, prevs, lams, seeds, refs, task, *BOUNDS, k,
                                      threshold, nz)
    torch.testing.assert_close(solve[0], twin[0], rtol=1e-5, atol=0)
    twin = fs.fused_costs_dump_batch_plain(x0s, prevs, seeds, refs, task, *BOUNDS, k,
                                           threshold, nz)
    torch.testing.assert_close(dump[1], twin[1], rtol=0, atol=0)  # clamped draws: exact


@pytest.mark.parametrize("k", [4096, 1500])
def test_batched_phase2_search_and_tail_are_the_single_launches(card, k):
    task = make_racing_fused_task_from_env(card)
    x0s, prevs, refs, _, keys, _ = _inputs(card, k)
    costs, dump = fs.fused_costs_dump_batch(x0s, prevs, keys[:, 2], refs, task, *BOUNDS, k, k)
    for search in (ls.LambdaSearch("ESSPS", 0.01, 10.0, k / 10.0, 40),
                   ls.LambdaSearch("LBPS", 0.01, 10.0, 0.01, 32)):
        lam = search.run_batch(costs)
        assert lam.shape == (B,)
        for b in range(B):
            assert torch.equal(lam[b], search.run(costs[b])), (search.mode, b)
    # spread costs: each scenario's λ* inside the bracket
    spread = (costs - costs.min(dim=1, keepdim=True).values) * 1e-2
    lam = ls.LambdaSearch("ESSPS", 0.01, 10.0, k / 10.0, 40).run_batch(spread.contiguous())
    stats, numer = fs.fused_weighted_batch(costs, dump, lam)
    keys_out = torch.empty_like(keys)
    history = torch.randn(B, T - 1, 2, device="cuda") * 0.1
    coeffs = torch.tensor([-3.0, 12.0, 17.0, 12.0, -3.0], device="cuda") / 35.0
    tail = fs.fused_tick_tail_batch(x0s, costs, stats, numer, lam, task, history, coeffs,
                                    keys=keys, keys_out=keys_out)
    for b in range(B):
        one = fs.fused_weighted(costs[b], dump[b], lam[b:b + 1])
        assert _equal((stats[b], numer[b]), one), b
        key_out = torch.empty(3, dtype=torch.int32, device="cuda")
        one = fs.fused_tick_tail(x0s[b], costs[b], stats[b], numer[b], lam[b:b + 1], task,
                                 history[b].contiguous(), coeffs, key=keys[b].contiguous(),
                                 key_out=key_out)
        assert _equal(tuple(t[b] for t in tail), one[:3] + (one[3].reshape(()), one[4])), b
        assert torch.equal(keys_out[b], key_out), b
    twin = fs.fused_tick_tail_batch_plain(x0s, costs, stats, numer, lam, task, history, coeffs)
    torch.testing.assert_close(tail[2], twin[2], rtol=0, atol=1e-5)  # weights
    torch.testing.assert_close(tail[0], twin[0], rtol=0, atol=5e-3)  # actions


def _config(lam, k=4096):
    return MPPIConfig(horizon=T, num_samples=k, dim_state=4, dim_control=2,
                      u_min=BOUNDS[1], u_max=BOUNDS[2], sigmas=BOUNDS[0], lambda_=lam,
                      store_rollouts=False)


@pytest.mark.parametrize("lam", [1.0, "MPO", "ESSPS", "LBPS"])
def test_batched_fused_solver_is_the_single_solves(card, lam):
    task = make_racing_fused_task_from_env(card)
    batched = make_batched_fused_solver(_config(lam), task, card.dynamics, "cuda", B)
    states = batched.init_batch(seed=11)
    singles = [scenario(states, b) for b in range(B)]
    x0s, *_ = _inputs(card, 4096)
    cinds = torch.zeros(B, dtype=torch.int64, device="cuda")
    for _ in range(3):
        xrefs, cinds = calc_ref_trajectory_batch(x0s, card.racing_center_path, cinds, T)
        out = batched.solve_batch(states, x0s, batched_info={"reference_path": xrefs})
        for b in range(B):
            one = batched.solver.solve(singles[b], x0s[b], info={"reference_path": xrefs[b]})
            assert _equal((one.action_seq, one.state_seq, one.aux.costs, one.aux.weights),
                          (out.action_seq[b], out.state_seq[b], out.aux.costs[b],
                           out.aux.weights[b])), b
            assert _equal(one.state, scenario(out.state, b)), b
            singles[b] = one.state
        states = out.state
        x0s = card.dynamics(x0s, out.action_seq[:, 0])


def test_fleet_replay_is_the_independent_episodes(card):
    task = make_racing_fused_task_from_env(card)
    batched = make_batched_fused_solver(_config(1.0), task, card.dynamics, "cuda", B)
    path = card.racing_center_path

    def info_fn(cinds, xs):
        xrefs, new = calc_ref_trajectory_batch(xs, path, cinds, T)
        return {"reference_path": xrefs}, new

    ticks = 6
    run = make_fleet_closed_loop(batched, card.dynamics, ticks, info_fn=info_fn)
    x0s, *_ = _inputs(card, 4096)
    states = batched.init_batch(seed=3)
    c0 = torch.zeros(B, dtype=torch.int64, device="cuda")
    first = run(states, x0s, c0)
    second = run(states, x0s, c0)  # every tick replayed
    assert _equal(first, second)
    single = make_closed_loop(batched.solver, lambda x, u: card.dynamics(x[None], u[None])[0],
                              ticks, info_fn=lambda c, x: (
                                  {"reference_path": calc_ref_trajectory(x, path, c, T)[0]},
                                  calc_ref_trajectory(x, path, c, T)[1]))
    for b in range(B):
        st, xf, xs, us, c = single(scenario(states, b), x0s[b], c0[b])
        assert _equal((xs, us, xf), (first[2][:, b], first[3][:, b], first[1][b])), b
        assert _equal(dataclasses.replace(st, tick=0), dataclasses.replace(
            scenario(first[0], b), tick=0)), b


@pytest.mark.parametrize("mode", ["seeded", "noise"])
@pytest.mark.parametrize("k", [4096, 1500])
def test_batched_epilogue_is_the_single_launches(card, mode, k):
    """Row 4 over a fleet: each scenario's costs, dump and λ* bit for bit its single launch's
    and the standalone route's (row 3, then rows 7 and 8), eagerly and from a CUDA graph
    replayed twice, every ticket back at 0; λ* at the search twin's bar."""
    from chip_smoke import lambda_vs_plain

    task = make_racing_fused_task_from_env(card)
    x0s, prevs, refs, noise, keys, _ = _inputs(card, k)
    nz = noise if mode == "noise" else None
    threshold, seeds = int(0.7 * k), keys[:, 2]
    costs, dump = fs.fused_costs_dump_batch(x0s, prevs, seeds, refs, task, *BOUNDS, k,
                                            threshold, nz)
    for search in (ls.LambdaSearch("ESSPS", 0.01, 10.0, k / 10.0, 40),
                   ls.LambdaSearch("LBPS", 0.01, 10.0, 0.01, 32)):
        tickets = torch.zeros(B, dtype=torch.int32, device="cuda")
        args = (x0s, prevs, seeds, refs, task, *BOUNDS, k, threshold, nz, search, tickets)
        want_lam = search.run_batch(costs)
        singles = []
        for b in range(B):
            ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
            singles.append(fs.fused_costs_dump_lambda(
                x0s[b], prevs[b], keys[b, 2:], refs[b], task, *BOUNDS, k, threshold,
                None if nz is None else nz[b], search, ticket))
            assert int(ticket.item()) == 0

        def check(out, how):
            torch.cuda.synchronize()
            assert torch.equal(tickets, torch.zeros_like(tickets)), how
            assert _equal(out[:2], (costs, dump)) and torch.equal(out[2], want_lam), how
            for b, one in enumerate(singles):
                assert _equal((out[0][b], out[1][b], out[2][b:b + 1]), one), (how, b)

        launches = fs.fused_costs_dump_lambda.launches["racing_costs_dump_lambda"]
        for i in range(2):
            check(fs.fused_costs_dump_lambda_batch(*args), f"{search.mode} launch {i}")
        assert fs.fused_costs_dump_lambda.launches["racing_costs_dump_lambda"] == launches + 2
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):  # warm up off the default stream, as capture needs
            fs.fused_costs_dump_lambda_batch(*args)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fs.fused_costs_dump_lambda_batch(*args)
        for i in range(2):
            graph.replay()
            check(out, f"{search.mode} graph replay {i}")
        for b in range(B):
            assert lambda_vs_plain(search, costs[b], out[2][b])[1], (search.mode, b)


@pytest.mark.parametrize("mode", ["seeded", "noise"])
@pytest.mark.parametrize("m", [1, 2])
def test_batched_draw_and_weighted_update_are_the_single_launches(card, m, mode):
    """Rows 6 and 9 over a fleet: each scenario's draw and next key bit for bit its single
    launch's and the twin's; each scenario's partials its single launch's, and at the twin's
    bar (weights atol 1e-5, update atol 5e-3 from the merged partials)."""
    k = 1500
    _, prevs, _, noise, keys, lams = _inputs(card, k)
    prevs, noise = prevs[..., :m].contiguous(), noise[..., :m].contiguous()
    nz = noise if mode == "noise" else None
    bounds = tuple(b[:m] for b in BOUNDS)
    rows = torch.arange(k, device="cuda")
    keys_out = torch.empty_like(keys)
    launches = fs.fused_regen.launches[f"fused_regen_m{m}"]
    drawn = fs.fused_regen_batch(prevs, keys[:, 2], rows, *bounds, k, 1000, nz, keys=keys,
                                 keys_out=keys_out)
    assert fs.fused_regen.launches[f"fused_regen_m{m}"] == launches + 1
    twin_out = torch.empty_like(keys)
    twin = fs.fused_regen_batch_plain(prevs, keys[:, 2], rows, *bounds, k, 1000, nz, keys,
                                      twin_out)
    assert torch.equal(drawn, twin) and torch.equal(keys_out, twin_out)
    for b in range(B):
        key_out = torch.empty(3, dtype=torch.int32, device="cuda")
        one = fs.fused_regen(prevs[b], keys[b, 2:], rows, *bounds, k, 1000,
                             None if nz is None else nz[b], key=keys[b].contiguous(),
                             key_out=key_out)
        assert torch.equal(drawn[b], one) and torch.equal(keys_out[b], key_out), b
    costs = torch.rand(B, k, device="cuda") * 10
    samples = drawn.reshape(B, k, -1)
    launches = wu.weighted_update_partials.launches
    stats, numer = wu.weighted_update_partials_batch(costs, samples, lams)
    assert wu.weighted_update_partials.launches == launches + 1
    want = wu.weighted_update_partials_batch_plain(costs, samples, lams)
    for b in range(B):
        one = wu.weighted_update_partials(costs[b], samples[b], lams[b:b + 1])
        assert _equal((stats[b], numer[b]), one), b
        got = wu.combine_partials(costs[b], stats[b], numer[b], lams[b], T, m)
        ref = wu.combine_partials(costs[b], want[0][b], want[1][b], lams[b], T, m)
        torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=5e-3)


@pytest.mark.parametrize("lam", ["ESSPS", "LBPS"])
def test_epilogue_fleet_replays_are_the_standalone_fleet(card, lam):
    """The racing fleet at K=4,096 takes the batched epilogue; its episode replayed from one
    CUDA graph (twice) is the standalone fleet's bit for bit, λ of every tick included."""
    from chip_smoke import standalone_fleet

    task = make_racing_fused_task_from_env(card)
    batched = make_batched_fused_solver(_config(lam), task, card.dynamics, "cuda", B)
    path = card.racing_center_path

    def info_fn(cinds, xs):
        xrefs, new = calc_ref_trajectory_batch(xs, path, cinds, T)
        return {"reference_path": xrefs}, new

    x0s, *_ = _inputs(card, 4096)
    states = batched.init_batch(seed=5)
    c0 = torch.zeros(B, dtype=torch.int64, device="cuda")
    launches = fs.fused_costs_dump_lambda.launches["racing_costs_dump_lambda"]
    run = make_fleet_closed_loop(batched, card.dynamics, 6, info_fn=info_fn)
    first, second = run(states, x0s, c0), run(states, x0s, c0)
    assert fs.fused_costs_dump_lambda.launches["racing_costs_dump_lambda"] == launches + 1
    standalone = make_fleet_closed_loop(standalone_fleet(batched, task), card.dynamics, 6,
                                        info_fn=info_fn)(states, x0s, c0)
    assert _equal(first, second) and _equal(first, standalone)


@pytest.mark.parametrize("lam", [1.0, "ESSPS"])
def test_unfused_fleet_is_the_single_solves(card, lam):
    """The unfused racing fleet: one launch of row 6 and one of row 9 a tick, and each
    scenario bit for bit its single unfused solve, three ticks."""
    cost = make_mpcc_cost(card.obstacle_cost_map, card.lane_cost_map)
    config = dataclasses.replace(_config(lam, 1500), store_rollouts=True)
    batched = make_batched_solver(config, card.dynamics, cost, "cuda", B)
    states = batched.init_batch(seed=2)
    singles = [scenario(states, b) for b in range(B)]
    x0s, *_ = _inputs(card, 1500)
    cinds = torch.zeros(B, dtype=torch.int64, device="cuda")
    for tick in range(3):
        xrefs, cinds = calc_ref_trajectory_batch(x0s, card.racing_center_path, cinds, T)
        draws = fs.fused_regen.launches["fused_regen_m2"]
        weighs = wu.weighted_update_partials.launches
        out = batched.solve_batch(states, x0s, batched_info={"reference_path": xrefs})
        assert fs.fused_regen.launches["fused_regen_m2"] == draws + 1
        assert wu.weighted_update_partials.launches == weighs + 1
        for b in range(B):
            one = batched.solver.solve(singles[b], x0s[b], info={"reference_path": xrefs[b]})
            fields = ("costs", "weights", "lam", "ess", "state_seq_batch")
            assert _equal((one.action_seq, one.state_seq, *(getattr(one.aux, f) for f in fields)),
                          (out.action_seq[b], out.state_seq[b],
                           *(getattr(out.aux, f)[b] for f in fields))), (tick, b)
            assert _equal(one.state, scenario(out.state, b)), (tick, b)
            singles[b] = one.state
        states = out.state
        x0s = card.dynamics(x0s, out.action_seq[:, 0])
