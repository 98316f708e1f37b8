"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These need an NVIDIA GPU with ``nvcc`` (Hopper, ``sm_90a``): they carry the
``cuda`` marker and skip without a card.  ``python3 chip_smoke.py`` runs the
same comparisons at the flagship's full size; on a card, run these with
``python -m pytest tests/test_torch_kernels.py -m cuda``.

The twins run on the card too, on the same tensors.  Costs are compared
with the JAX package's bar (rtol 1e-5) and, in noise mode, must be bitwise
equal: the kernels are built with ``-fmad=false`` and no fast math, so they
round each operation as the twin's separate tensor operations do.  The
partials are sums in another order: weights atol 1e-5, update atol 5e-3,
ESS rtol 1e-3.  The auto-lambda phases: phase 1's costs and dump, and phase
2 at lambda=1 against the fixed solve's partials, bitwise (the same device
functions).  The search kernels: ESSPS lambda rtol 1e-4, atol 1e-6; LBPS
lambda rtol 1e-3, atol 1e-4 and its objective at both lambdas rtol 1e-5
(the JAX package's bars); the twins sum in the kernels' order, so these
are expected to hold bit for bit where the card's exp equals torch's.
"""

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch.core.config import tick_seed
from mppi_playground_tpu_torch.ops import fused_solve, lambda_search
from mppi_playground_tpu_torch.ops.weighted_update import combine_partials

pytestmark = pytest.mark.cuda

SIGMAS = (0.5, 0.1)
U_MIN = (-2.0, -0.25)
U_MAX = (2.0, 0.25)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py runs these checks on the card")
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
    from mppi_playground_tpu_torch.models.racing_mpcc import make_racing_fused_task_from_env

    env = RacingEnv(device="cuda")
    return env, make_racing_fused_task_from_env(env)


def _inputs(env, horizon, num_samples, seed):
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory,
        extend_reference_path,
    )

    rng = np.random.default_rng(seed)
    dev = env.device
    x0 = env.reset() + torch.tensor([0.1, -0.1, 0.0, 5.0], device=dev)
    xref, _ = calc_ref_trajectory(x0, env.racing_center_path, torch.tensor(0, device=dev),
                                  horizon)
    prev = torch.tensor(rng.standard_normal((horizon, 2)) * SIGMAS, dtype=torch.float32,
                        device=dev)
    noise = torch.tensor(rng.standard_normal((num_samples, horizon, 2)) * SIGMAS,
                         dtype=torch.float32, device=dev)
    return x0, prev, extend_reference_path(xref).contiguous(), noise


@pytest.mark.parametrize("mode", ["noise", "seeded"])
@pytest.mark.parametrize("horizon,num_samples,exploration", [(50, 100_000, 0.0),
                                                             (8, 1500, 0.3)])
def test_fused_solve_kernel_matches_twin(card, mode, horizon, num_samples, exploration):
    env, task = card
    x0, prev, xref5, noise = _inputs(env, horizon, num_samples, seed=horizon)
    lam = torch.ones(1, device="cuda")
    threshold = int(num_samples * (1.0 - exploration))
    args = (x0, prev, lam, tick_seed(1, 2), xref5, task, SIGMAS, U_MIN, U_MAX,
            num_samples, threshold, noise if mode == "noise" else None)
    launches = fused_solve.fused_solve.launches["racing_fused_solve"]
    got = fused_solve.fused_solve(*args)
    assert fused_solve.fused_solve.launches["racing_fused_solve"] == launches + 1
    want = fused_solve.fused_solve_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    if mode == "noise":
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    g = combine_partials(*got, lam, horizon, 2)
    w = combine_partials(*want, lam, horizon, 2)
    torch.testing.assert_close(g[1], w[1], rtol=0, atol=1e-5)  # weights
    torch.testing.assert_close(g[0], w[0], rtol=0, atol=5e-3)  # update
    torch.testing.assert_close(g[2], w[2], rtol=1e-3, atol=0)  # ESS


def test_reroll_kernel_matches_twin(card):
    env, task = card
    rng = np.random.default_rng(3)
    for horizon in (1, 50, 300):
        x0 = torch.tensor([rng.uniform(-39, 39), rng.uniform(-39, 39), 1.0, 4.0],
                          dtype=torch.float32, device="cuda")
        seq = torch.tensor(np.stack([rng.uniform(-2.5, 2.5, horizon),
                                     rng.uniform(-0.3, 0.3, horizon)], axis=1),
                           dtype=torch.float32, device="cuda")
        got = fused_solve.fused_reroll(x0, seq, task)
        want = fused_solve.fused_reroll_plain(x0, seq, task)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_raises_on_what_the_kernel_does_not_take(card):
    env, task = card
    x0, prev, xref5, _ = _inputs(env, 8, 256, seed=1)
    lam = torch.ones(1, device="cuda")
    base = (x0, prev, lam, 0, xref5, task, SIGMAS, U_MIN, U_MAX, 256, 256)
    with pytest.raises(ValueError, match="dtype"):
        fused_solve.fused_solve(x0.double(), *base[1:])
    with pytest.raises(ValueError, match="contiguous"):
        fused_solve.fused_solve(x0, prev.t().contiguous().t(), *base[2:])
    with pytest.raises(ValueError, match="shape"):
        fused_solve.fused_solve(x0, prev, lam, 0, xref5[:-1].contiguous(), *base[5:])
    with pytest.raises(ValueError, match="horizon"):
        fused_solve.fused_solve(x0, torch.zeros(513, 2, device="cuda"), *base[2:])


@pytest.mark.parametrize("mode", ["noise", "seeded"])
@pytest.mark.parametrize("horizon,num_samples,exploration", [(50, 100_000, 0.0),
                                                             (8, 1500, 0.3)])
def test_auto_lambda_phases_match_twins(card, mode, horizon, num_samples, exploration):
    env, task = card
    x0, prev, xref5, noise = _inputs(env, horizon, num_samples, seed=horizon + 1)
    threshold = int(num_samples * (1.0 - exploration))
    args = (x0, prev, tick_seed(3, 4), xref5, task, SIGMAS, U_MIN, U_MAX,
            num_samples, threshold, noise if mode == "noise" else None)
    launches = fused_solve.fused_costs_dump.launches["racing_costs_dump"]
    costs, dump = fused_solve.fused_costs_dump(*args)
    assert fused_solve.fused_costs_dump.launches["racing_costs_dump"] == launches + 1
    want_costs, want_dump = fused_solve.fused_costs_dump_plain(*args)
    torch.cuda.synchronize()
    assert dump.shape == (2 * horizon, num_samples)
    torch.testing.assert_close(costs, want_costs, rtol=1e-5, atol=0)
    torch.testing.assert_close(dump, want_dump, rtol=0, atol=0)  # clamped draws: exact
    if mode == "noise":
        torch.testing.assert_close(costs, want_costs, rtol=0, atol=0)

    # phase 2 at lambda = 1 gives the fixed solve's partials, bit for bit
    lam = torch.ones(1, device="cuda")
    fixed = fused_solve.fused_solve(x0, prev, lam, *args[2:])
    stats, numer = fused_solve.fused_weighted(costs, dump, lam)
    torch.testing.assert_close(fixed[0], costs, rtol=0, atol=0)
    torch.testing.assert_close(stats, fixed[1], rtol=0, atol=0)
    torch.testing.assert_close(numer, fixed[2], rtol=0, atol=0)

    # phase 2 at another lambda against its twin: the fixed solve's bar
    lam = torch.full((1,), 37.5, device="cuda")
    got = fused_solve.fused_weighted(costs, dump, lam)
    want = fused_solve.fused_weighted_plain(costs, dump, lam)
    g = combine_partials(costs, *got, lam, horizon, 2)
    w = combine_partials(costs, *want, lam, horizon, 2)
    torch.testing.assert_close(g[1], w[1], rtol=0, atol=1e-5)  # weights
    torch.testing.assert_close(g[0], w[0], rtol=0, atol=5e-3)  # update
    torch.testing.assert_close(g[2], w[2], rtol=1e-3, atol=0)  # ESS


def _search_cases(num_samples):
    rng = np.random.default_rng(num_samples)
    yield "uniform", torch.tensor(rng.uniform(0.0, 20.0, num_samples), dtype=torch.float32)
    yield "to_min", torch.arange(num_samples, dtype=torch.float32) * 1e-9
    spike = torch.full((num_samples,), 1e6)
    spike[0] = 0.0
    yield "to_max", spike


# 2M: past the JAX package's 1M gate, each CTA reads part of its slice from L2
@pytest.mark.parametrize("num_samples", [5, 1500, 100_000, 1024 * 1024, 2 * 1024 * 1024])
def test_search_kernels_match_twins(card, num_samples):
    for name, costs in _search_cases(num_samples):
        costs = costs.cuda()
        target = num_samples / 10.0
        got = lambda_search.essps_lambda_fused(costs, target, 0.01, 10.0)
        want = lambda_search.essps_lambda_plain(costs, target, 0.01, 10.0)
        got_l = lambda_search.lbps_lambda_fused(costs, 0.01, 0.01, 10.0)
        want_l = lambda_search.lbps_lambda_plain(costs, 0.01, 0.01, 10.0)
        torch.cuda.synchronize()
        assert got.shape == () and got.device.type == "cuda", name
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6, msg=name)
        torch.testing.assert_close(got_l, want_l, rtol=1e-3, atol=1e-4, msg=name)
        pen = lambda_search.lbps_range_penalty(costs, 0.01)
        torch.testing.assert_close(lambda_search.lbps_objective_plain(costs, got_l, pen),
                                   lambda_search.lbps_objective_plain(costs, want_l, pen),
                                   rtol=1e-5, atol=0, msg=name)
        if name != "uniform" and num_samples > 5:
            bound = 0.01 if name == "to_min" else 10.0
            assert float(got) == np.float32(bound), name


def test_search_wrapper_raises_above_the_gate(card):
    too_many = torch.zeros(1, device="cuda").expand(lambda_search.MAX_SAMPLES + 1)
    with pytest.raises(ValueError, match="1 <= K"):
        lambda_search.essps_lambda_fused(too_many, 1.0, 0.01, 10.0)


def _assert_partials_bar(got, want, costs, samples, lam):
    """Block partials against another reduction of the same ``samples [K, D]``.

    Block maxima exact, sums of e and e^2 (each >= 1) within 1e-6 relative,
    each numerator within 1e-5 of its sum of ``|e * sample|``
    (``chip_smoke.PARTIALS_BAR``).
    """
    from mppi_playground_tpu_torch.ops import weighted_update as wu

    scale = wu.block_partials_plain(costs, samples.abs(), lam)[1]
    assert torch.equal(got[0][:, 0], want[0][:, 0])
    assert ((got[0][:, 1:] - want[0][:, 1:]).abs() / want[0][:, 1:]).max().item() <= 1e-6
    assert ((got[1] - want[1]).abs() / (scale + 1e-30)).max().item() <= 1e-5


# (K, D, offset): the unfused widths D=50 and 100, the JAX kernel's widest D=1,536 and
# beyond, D not a multiple of 4, and samples that start 4 bytes past a 16-byte boundary
# (the kernel's scalar loads)
@pytest.mark.parametrize("num_samples,slots,offset", [
    (100_000, 100, 0), (100_000, 1536, 0), (3000, 2000, 0), (7, 3, 0), (1500, 16, 0),
    (4000, 50, 0), (2000, 100, 1), (300, 1, 0),
])
@pytest.mark.parametrize("lam", [0.01, 1.0, 10.0])
def test_weighted_update_kernel_matches_twin(card, num_samples, slots, offset, lam):
    from mppi_playground_tpu_torch.ops import weighted_update as wu

    gen = torch.Generator(device="cuda").manual_seed(slots)
    costs = torch.rand(num_samples, generator=gen, device="cuda") * 100.0
    flat = torch.randn(offset + num_samples * slots, generator=gen, device="cuda")
    samples = flat[offset:].view(num_samples, slots)
    assert samples.is_contiguous()
    lam_t = torch.full((1,), lam, device="cuda")
    launches = wu.weighted_update_partials.launches
    got = wu.weighted_update_partials(costs, samples, lam_t)
    assert wu.weighted_update_partials.launches == launches + 1
    want = wu.block_partials_plain(costs, samples, lam_t)
    torch.cuda.synchronize()
    _assert_partials_bar(got, want, costs, samples, lam_t)
    g = wu.combine_partials(costs, *got, lam_t, slots, 1)
    w = wu.combine_partials(costs, *want, lam_t, slots, 1)
    torch.testing.assert_close(g[1], w[1], rtol=0, atol=1e-5)  # weights
    torch.testing.assert_close(g[0], w[0], rtol=0, atol=5e-3)  # update
    torch.testing.assert_close(g[2], w[2], rtol=1e-3, atol=0)  # ESS


def test_phase2_and_the_weighted_update_meet_the_partials_bar(card):
    """Phase 2 and the weighted update on the same perturbations.

    They share the statistics' code (bitwise equal block maxima and sums) and
    sum the numerator in different orders: the partials bar.
    """
    from mppi_playground_tpu_torch.ops import weighted_update as wu

    env, task = card
    x0, prev, xref5, _ = _inputs(env, 50, 20_000, seed=4)
    costs, dump = fused_solve.fused_costs_dump(x0, prev, tick_seed(5, 6), xref5, task,
                                                      SIGMAS, U_MIN, U_MAX, 20_000, 20_000)
    samples = dump.t().contiguous()
    for lam in (0.5, 10.0):
        lam_t = torch.full((1,), lam, device="cuda")
        p2 = fused_solve.fused_weighted(costs, dump, lam_t)
        r9 = wu.weighted_update_partials(costs, samples, lam_t)
        torch.testing.assert_close(p2[0], r9[0], rtol=0, atol=0)
        _assert_partials_bar(r9, p2, costs, samples, lam_t)


@pytest.mark.parametrize("mode", ["noise", "seeded"])
@pytest.mark.parametrize("horizon,num_samples,exploration", [(50, 100_000, 0.0),
                                                             (8, 1500, 0.3)])
def test_regen_kernel_equals_phase1_dump(card, mode, horizon, num_samples, exploration):
    from mppi_playground_tpu_torch.core.diagnostics import top_indices

    env, task = card
    x0, prev, xref5, noise = _inputs(env, horizon, num_samples, seed=horizon + 2)
    threshold = int(num_samples * (1.0 - exploration))
    nz = noise if mode == "noise" else None
    seed = tick_seed(7, 8)
    costs, dump = fused_solve.fused_costs_dump(x0, prev, seed, xref5, task, SIGMAS, U_MIN,
                                                      U_MAX, num_samples, threshold, nz)
    args = (SIGMAS, U_MIN, U_MAX, num_samples, threshold, nz)
    launches = fused_solve.fused_regen.launches["fused_regen_m2"]
    full = fused_solve.fused_regen(prev, seed, torch.arange(num_samples, device="cuda"), *args)
    assert fused_solve.fused_regen.launches["fused_regen_m2"] == launches + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(full, dump.t().reshape(num_samples, horizon, 2), rtol=0, atol=0)
    torch.testing.assert_close(
        full, fused_solve.fused_regen_plain(prev, seed, torch.arange(num_samples, device="cuda"),
                                             *args), rtol=0, atol=0)
    rows = top_indices(-costs, min(300, num_samples))[1]
    torch.testing.assert_close(fused_solve.fused_regen(prev, seed, rows, *args), full[rows],
                               rtol=0, atol=0)


def test_new_wrappers_raise_on_what_the_kernels_do_not_take(card):
    from mppi_playground_tpu_torch.ops import weighted_update as wu

    costs = torch.zeros(300, device="cuda")
    samples = torch.zeros(300, 10, device="cuda")
    one = torch.ones(1, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        wu.weighted_update_partials(costs.double(), samples, one)
    with pytest.raises(ValueError, match="contiguous"):
        wu.weighted_update_partials(costs, samples.t().contiguous().t(), one)
    with pytest.raises(ValueError, match="dtype"):
        fused_solve.fused_regen(torch.zeros(5, 2, device="cuda"), 0,
                                 torch.zeros(3, dtype=torch.int32, device="cuda"), SIGMAS, U_MIN,
                                 U_MAX, 16, 16)


def test_float64_controller_on_the_card_asks_for_the_plain_route(card):
    """A float64 unfused controller on the card raises unless it asks for ``"xla"``."""
    from mppi_playground_tpu_torch.envs import RacingController

    env, _ = card
    with pytest.raises(ValueError, match="kernel_backend='xla'"):
        RacingController(env, dtype=torch.float64)
    ctrl = RacingController(env, dtype=torch.float64, kernel_backend="xla")
    assert ctrl.solver_backend == "xla"


# --- every other model family, and the lambda epilogue -----------------------

NEW_MODELS = ("navigation", "danger_zone", "pendulum", "cartpole", "mountain_car", "integrator")
# models whose step calls libm sin/cos: the card's sinf/cosf against torch.sin/cos on
# the card are expected to agree bit for bit; held to the JAX package's fused-vs-XLA
# cost bar (tests/test_fused_models.py) if they do not
LIBM_MODELS = ("danger_zone", "pendulum", "cartpole", "mountain_car")


def _model_inputs(name, num_samples=None, seed=11):
    from mppi_playground_tpu_torch.workloads import build_model_workload

    w = build_model_workload(name, device="cuda", num_samples=num_samples)
    kw = w.mppi_kwargs
    horizon, m, k = kw["horizon"], kw["dim_control"], kw["num_samples"]
    rng = np.random.default_rng(seed)
    sig = np.asarray(kw["sigmas"])
    prev = torch.tensor(rng.standard_normal((horizon, m)) * sig, dtype=torch.float32,
                        device="cuda")
    noise = torch.tensor(rng.standard_normal((k, horizon, m)) * sig, dtype=torch.float32,
                         device="cuda")
    bounds = (tuple(kw["sigmas"]), tuple(float(v) for v in torch.as_tensor(kw["u_min"]).tolist()),
              tuple(float(v) for v in torch.as_tensor(kw["u_max"]).tolist()))
    return w, prev, noise, bounds


def _assert_costs(name, got, want):
    if name in LIBM_MODELS:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["noise", "seeded"])
@pytest.mark.parametrize("name", NEW_MODELS)
def test_model_kernels_match_twins(card, name, mode):
    w, prev, noise, (sig, lo, hi) = _model_inputs(name)
    k = w.mppi_kwargs["num_samples"]
    horizon, m = prev.shape
    nz = noise if mode == "noise" else None
    lam = torch.ones(1, device="cuda")
    threshold = int(0.8 * k)
    args = (w.x0, prev, lam, tick_seed(4, 2), None, w.task, sig, lo, hi, k, threshold, nz)
    got = fused_solve.fused_solve(*args)
    want = fused_solve.fused_solve_plain(*args)
    costs, dump = fused_solve.fused_costs_dump(w.x0, prev, *args[3:])
    want_dump = fused_solve.fused_costs_dump_plain(w.x0, prev, *args[3:])[1]
    stats, numer = fused_solve.fused_weighted(costs, dump, lam)
    rows = torch.arange(k, device="cuda")
    regen = fused_solve.fused_regen(prev, args[3], rows, sig, lo, hi, k, threshold, nz)
    torch.cuda.synchronize()
    _assert_costs(name, got[0], want[0])
    torch.testing.assert_close(dump, want_dump, rtol=0, atol=0)  # clamped draws: exact
    g = combine_partials(*got, lam, horizon, m)
    v = combine_partials(*want, lam, horizon, m)
    torch.testing.assert_close(g[1], v[1], rtol=0, atol=1e-5)  # weights
    torch.testing.assert_close(g[0], v[0], rtol=0, atol=5e-3)  # update
    # phase 1 and 2 at lambda = 1 give the fixed solve, bit for bit
    for a, b in ((costs, got[0]), (stats, got[1]), (numer, got[2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # regeneration replays phase 1's dump
    torch.testing.assert_close(regen, dump.t().reshape(k, horizon, m), rtol=0, atol=0)
    seq = g[0].contiguous()
    states = fused_solve.fused_reroll(w.x0, seq, w.task)
    want_states = fused_solve.fused_reroll_plain(w.x0, seq, w.task)
    torch.cuda.synchronize()
    _assert_costs(name, states, want_states)


# K=1, 257 and 2,049 launch grids of 1, 2 and 9 blocks: not whole clusters of 8
@pytest.mark.parametrize("mode", ["ESSPS", "LBPS"])
@pytest.mark.parametrize("name,num_samples", [
    ("navigation", 1), ("navigation", 257), ("navigation", 2049), ("navigation", 3000),
    ("navigation", 100_000), ("racing", 3000), ("racing", 100_000),
])
def test_lambda_epilogue_equals_the_standalone_route(card, name, num_samples, mode):
    """Costs, dump and lambda* bitwise the standalone route's; the ticket back at 0.

    After two launches in a row, and in a captured CUDA graph replayed twice;
    both noise modes.
    """
    from mppi_playground_tpu_torch.ops.lambda_search import LambdaSearch

    if name == "racing":
        env, task = card
        x0, prev, ref, noise = _inputs(env, 50, num_samples, seed=9)
        sig, lo, hi = SIGMAS, U_MIN, U_MAX
    else:
        w, prev, noise, (sig, lo, hi) = _model_inputs(name, num_samples)
        x0, ref, task = w.x0, None, w.task
    param = num_samples / 10.0 if mode == "ESSPS" else 0.01
    search = LambdaSearch(mode, 0.01, 10.0, param, 40 if mode == "ESSPS" else 32)
    ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
    kernel = f"{name}_costs_dump_lambda"
    for nz in (noise, None):
        args = (x0, prev, tick_seed(5, 1), ref, task, sig, lo, hi, num_samples, num_samples, nz)
        want_costs, want_dump = fused_solve.fused_costs_dump(*args)
        want_lam = search.run(want_costs)

        def check(costs, dump, lam, how):
            torch.cuda.synchronize()
            assert int(ticket.item()) == 0, how
            torch.testing.assert_close(costs, want_costs, rtol=0, atol=0, msg=how)
            torch.testing.assert_close(dump, want_dump, rtol=0, atol=0, msg=how)
            assert lam.item() == want_lam.item(), (how, lam.item(), want_lam.item())

        before = fused_solve.fused_costs_dump_lambda.launches[kernel]
        for i in range(2):  # the ticket resets between launches
            check(*fused_solve.fused_costs_dump_lambda(*args, search, ticket), f"launch {i}")
        assert fused_solve.fused_costs_dump_lambda.launches[kernel] == before + 2

        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):  # warm up off the default stream, as capture needs
            fused_solve.fused_costs_dump_lambda(*args, search, ticket)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fused_solve.fused_costs_dump_lambda(*args, search, ticket)
        for i in range(2):
            graph.replay()
            check(*out, f"graph replay {i}")
        bar = dict(rtol=1e-4, atol=1e-6) if mode == "ESSPS" else dict(rtol=1e-3, atol=1e-4)
        torch.testing.assert_close(out[2].reshape(()), search.plain(want_costs), **bar)


# --- row 6: the top rows regenerated and rolled out; row 1's bitwise bar ----------

ALL_MODELS = ("racing",) + NEW_MODELS


def _family(card, name, num_samples=None, seed=13):
    """``(x0, prev, ref, noise, task, (sigmas, u_min, u_max), K)`` of a model on the card."""
    if name == "racing":
        env, task = card
        k = num_samples or 4000
        x0, prev, ref, noise = _inputs(env, 50, k, seed=seed)
        return x0, prev, ref, noise, task, (SIGMAS, U_MIN, U_MAX), k
    w, prev, noise, bounds = _model_inputs(name, num_samples, seed=seed)
    return w.x0, prev, None, noise, w.task, bounds, w.mppi_kwargs["num_samples"]


@pytest.mark.parametrize("mode", ["noise", "seeded"])
@pytest.mark.parametrize("name", ALL_MODELS)
def test_top_rollouts_kernel_matches_twin(card, name, mode):
    """One launch: bitwise the twin (libm models: states atol 5e-3); rows past K all NaN.

    Each row is also the one-sequence re-roll kernel on its regenerated
    actions, bit for bit: both roll through the same device step.
    """
    x0, prev, _, noise, task, (sig, lo, hi), k = _family(card, name)
    nz = noise if mode == "noise" else None
    picked = torch.randperm(k, generator=torch.Generator().manual_seed(3))[:298]
    rows = torch.cat([picked, torch.tensor([k, -1])]).to("cuda")
    args = (x0, prev, tick_seed(6, 3), rows, task, sig, lo, hi, k, int(0.8 * k), nz)
    kernel = f"{task.model}_top_rollouts"
    before = fused_solve.fused_top_rollouts.launches[kernel]
    got = fused_solve.fused_top_rollouts(*args)
    assert fused_solve.fused_top_rollouts.launches[kernel] == before + 1
    want = fused_solve.fused_top_rollouts_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (rows.shape[0], prev.shape[0] + 1, task.dim_state)
    assert torch.isnan(got[-2:]).all() and torch.isfinite(got[:-2]).all()
    if name in LIBM_MODELS:
        torch.testing.assert_close(got[:-2], want[:-2], rtol=0, atol=5e-3)
    else:
        torch.testing.assert_close(got[:-2], want[:-2], rtol=0, atol=0)
    actions = fused_solve.fused_regen(prev, args[2], rows, sig, lo, hi, k, int(0.8 * k), nz)
    for i in (0, 1, rows.shape[0] - 3):
        torch.testing.assert_close(got[i], fused_solve.fused_reroll(x0, actions[i].contiguous(),
                                                                    task), rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["noise", "seeded"])
@pytest.mark.parametrize("num_samples", [1, 1500, 100_000])
@pytest.mark.parametrize("name", ALL_MODELS)
def test_fused_solve_is_bitwise_phase1_and_phase2_in_a_graph(card, name, num_samples, mode):
    """Row 1's bar: costs the twin's, statistics and numerators phase 1 + phase 2's at lambda=1.

    Bit for bit, eagerly and in a captured CUDA graph replayed twice (the
    numerator tile is sized at capture); the partials also within the
    partials bar of the twin, which sums in another order.
    """
    x0, prev, ref, noise, task, (sig, lo, hi), k = _family(card, name, num_samples)
    nz = noise if mode == "noise" else None
    lam = torch.ones(1, device="cuda")
    args = (x0, prev, lam, tick_seed(8, 1), ref, task, sig, lo, hi, k, int(0.8 * k), nz)
    got = fused_solve.fused_solve(*args)
    costs, dump = fused_solve.fused_costs_dump(x0, prev, *args[3:])
    stats, numer = fused_solve.fused_weighted(costs, dump, lam)
    want = fused_solve.fused_solve_plain(*args)
    torch.cuda.synchronize()
    for a, b in ((got[0], costs), (got[1], stats), (got[2], numer)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _assert_costs(name, got[0], want[0])
    _assert_partials_bar(got[1:], want[1:], want[0], dump.t(), lam)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm up off the default stream, as capture needs
        fused_solve.fused_solve(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_solve.fused_solve(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, got):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_angle_normalize_shortcut_is_fmodf_on_every_float(card):
    """The exact shortcut in ``device_math.cuh`` against fmodf, all 2^32 inputs, bit for bit."""
    differ, inside = _sweep("angle_normalize_sweep", 2)
    assert differ == 0
    assert inside > 2_000_000_000  # about 2.18e9 floats lie in (-4 pi, 4 pi)


# --- row 3 redesigned (fewer instructions a sample), row 2 as the tick's tail ------

@pytest.mark.parametrize("mode", ["noise", "seeded"])
@pytest.mark.parametrize("num_samples", [1, 1500, 100_000])
@pytest.mark.parametrize("name", ALL_MODELS)
def test_phase1_kernel_is_bitwise_its_twin(card, name, num_samples, mode):
    """Row 3: costs and dump bit for bit the twin's, the kernel's outputs before its redesign.

    The redesign computes the Box–Muller radius and the cell index in fewer
    instructions, each proven exact by an exhaustive sweep; every output bit
    stays.
    """
    x0, prev, ref, noise, task, (sig, lo, hi), k = _family(card, name, num_samples)
    nz = noise if mode == "noise" else None
    args = (x0, prev, tick_seed(9, 2), ref, task, sig, lo, hi, k, int(0.8 * k), nz)
    kernel = f"{task.model}_costs_dump"
    before = fused_solve.fused_costs_dump.launches[kernel]
    costs, dump = fused_solve.fused_costs_dump(*args)
    assert fused_solve.fused_costs_dump.launches[kernel] == before + 1
    want_costs, want_dump = fused_solve.fused_costs_dump_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(costs, want_costs, rtol=0, atol=0)
    torch.testing.assert_close(dump, want_dump, rtol=0, atol=0)


def _tail_routes(x0, prev, ref, task, bounds, k):
    """``{route: (costs, stats, numer, lam)}`` of the fixed, standalone and epilogue routes."""
    search = lambda_search.LambdaSearch("ESSPS", 0.01, 10.0, k / 10.0, 40)
    sampling = (tick_seed(4, 4), ref, task, *bounds, k, k, None)
    lam = torch.ones(1, device="cuda")
    out = {"fixed": fused_solve.fused_solve(x0, prev, lam, *sampling) + (lam,)}
    costs, dump = fused_solve.fused_costs_dump(x0, prev, *sampling)
    lam_s = search.run(costs).reshape(1)
    out["standalone"] = (costs, *fused_solve.fused_weighted(costs, dump, lam_s), lam_s)
    ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
    costs, dump, lam_e = fused_solve.fused_costs_dump_lambda(x0, prev, *sampling, search, ticket)
    out["epilogue"] = (costs, *fused_solve.fused_weighted(costs, dump, lam_e), lam_e)
    return out


@pytest.mark.parametrize("sg", [False, True])
@pytest.mark.parametrize("name", ALL_MODELS)
def test_tick_tail_kernel_is_bitwise_its_twin(card, name, sg):
    """Row 2's tail: the merged update, weights, ESS, filtered actions, history and states.

    On each fused route's partials, bit for bit the twin's (which sums in
    the kernel's order), eagerly and from a CUDA graph of the launch
    replayed twice; one launch a call.  The libm models' states: bitwise or
    atol 5e-3, the re-roll's bar.
    """
    from mppi_playground_tpu_torch.core.sg_filter import savitzky_golay_coeffs

    x0, prev, ref, _, task, bounds, k = _family(card, name, 2000 if name == "racing" else None)
    horizon, m = prev.shape
    history = torch.tensor(np.random.default_rng(5).standard_normal((horizon - 1, m)) * 0.1,
                           dtype=torch.float32, device="cuda")
    coeffs = (torch.tensor(savitzky_golay_coeffs(5, 3), dtype=torch.float32, device="cuda")
              if sg else None)
    kernel = f"{task.model}_tick_tail"
    for route, partials in _tail_routes(x0, prev, ref, task, bounds, k).items():
        args = (x0, *partials, task, history, coeffs)
        before = fused_solve.fused_tick_tail.launches[kernel]
        got = fused_solve.fused_tick_tail(*args)
        assert fused_solve.fused_tick_tail.launches[kernel] == before + 1
        want = fused_solve.fused_tick_tail_plain(*args)
        torch.cuda.synchronize()
        assert got[1].shape == (horizon + 1, task.dim_state) and torch.isfinite(got[1]).all()
        for i in (0, 2, 3, 4):  # actions, weights, ESS, history
            torch.testing.assert_close(got[i], want[i], rtol=0, atol=0, msg=route)
        if name in LIBM_MODELS:
            torch.testing.assert_close(got[1], want[1], rtol=0, atol=5e-3, msg=route)
        else:
            torch.testing.assert_close(got[1], want[1], rtol=0, atol=0, msg=route)

        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fused_solve.fused_tick_tail(*args)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fused_solve.fused_tick_tail(*args)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            for a, b in zip(out, got):
                torch.testing.assert_close(a, b, rtol=0, atol=0, msg=route)


def test_tick_tail_wrapper_raises_on_what_the_kernel_does_not_take(card):
    env, task = card
    x0, prev, xref5, _ = _inputs(env, 8, 512, seed=2)
    lam = torch.ones(1, device="cuda")
    costs, stats, numer = fused_solve.fused_solve(x0, prev, lam, 0, xref5, task, SIGMAS, U_MIN,
                                                  U_MAX, 512, 512)
    history = torch.zeros(7, 2, device="cuda")
    with pytest.raises(ValueError, match="sg_history"):
        fused_solve.fused_tick_tail(x0, costs, stats, numer, lam, task, history[:6].contiguous())
    with pytest.raises(ValueError, match="stats"):
        fused_solve.fused_tick_tail(x0, costs[:256].contiguous(), stats, numer, lam, task,
                                    history)
    with pytest.raises(ValueError, match="SG window"):
        fused_solve.fused_tick_tail(x0, costs, stats, numer, lam, task, history,
                                    torch.ones(4, device="cuda"))


def _sweep(symbol, counts, *args):
    """The ``counts`` counters of ``csrc/exact_checks.cu``'s sweep ``symbol``."""
    import ctypes

    from mppi_playground_tpu_torch.ops import cuda_build

    out = torch.zeros(counts, dtype=torch.int64, device="cuda")
    cuda_build.launch("exact_checks", symbol, [ctypes.c_void_p] * (len(args) + 1), out.device,
                      *args, out.data_ptr())
    return out.tolist()


def test_box_muller_radius_is_the_library_calls_on_every_input(card):
    """``sqrt_fast(-2 log_normal(u1))`` against ``sqrtf(-2.0f * logf(u1))``, all 2^24 u1."""
    radii, logs, checked = _sweep("radius_sweep", 3)
    assert (radii, logs, checked) == (0, 0, 1 << 24)


@pytest.mark.parametrize("model", ["racing", "navigation", 0.01, 0.3])
def test_cell_index_is_the_ieee_divisions_on_every_float(card, model):
    """One dimension of ``cell_index`` against the division form, all 2^32 positions.

    At the racing and Navigation2D maps' geometry, and at two other cell
    sizes on racing's: the same off-grid flag and cell everywhere, and the
    same quotient for every position of magnitude 2^-100 or more whose
    quotient lies below 2^100.
    """
    from mppi_playground_tpu_torch.ops.fused_solve import _floats, _ints

    env, task = card
    if model == "navigation":
        task = _model_inputs("navigation")[0].task
    floats = task.floats[:7] if isinstance(model, str) else task.floats[:6] + (model,)
    differ, quotients, on_grid = _sweep("cell_sweep", 3, _floats(floats), _ints(task.ints[:2]))
    assert (differ, quotients) == (0, 0)
    assert on_grid > 0
