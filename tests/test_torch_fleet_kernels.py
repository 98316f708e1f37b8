"""The fleet's batched launches and the fleet loop on the card (marker ``cuda``).

These need an NVIDIA GPU with ``nvcc``; they skip without a card, and import
no jax, so that the card's machine runs them::

    python -m pytest tests/test_torch_fleet_kernels.py -m cuda --noconftest -q

Each batched launch (rows 1, 2, 3, 5, 7 and 8 with the scenarios on
``blockIdx.y``) is bit for bit the single launch on each scenario's inputs,
seeded and in noise mode, at a full last block (K=4,096) and a ragged one
(K=1,500), with B=3 scenarios; and its twin (the single twin scenario by
scenario) at the single kernels' bars (``tests/test_torch_kernels.py``).  The
batched fused solver is bit for bit the single solves on every λ route, and
a fleet of replayed ticks bit for bit B independent closed loops.
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
    make_racing_fused_task_from_env,
)
from mppi_playground_tpu_torch.ops import fused_solve as fs
from mppi_playground_tpu_torch.ops import lambda_search as ls
from mppi_playground_tpu_torch.parallel import make_batched_fused_solver, scenario

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
