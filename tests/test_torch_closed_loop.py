"""The port's closed loops, device key and replayed ticks, on the CPU (and on the card, marked).

* The device key: ``core/config.tick_seed_plain`` and ``advance_key_plain``
  (the device functions' twins) against the host ``tick_seed``, over ticks
  past 2^32 and seeds with the top bit set; the kernels' wrappers give the
  same outputs for a seed given as a host int and as a device word; a
  solver's key moves on by one tick a solve on every route.
* The unfused route draws the fused kernels' stream: its seeded solve is bit
  for bit the same solve on injected ``seeded_normals`` of the tick's seed.
* ``_freeze`` and ``RunnerCache`` as the JAX package's tests require them.
* ``make_closed_loop`` (racing fused and unfused, the pendulum,
  Navigation2D; with and without ``done_fn``) bit for bit the same number of
  eager solves; ``make_pipelined_closed_loop`` bit for bit
  ``PipelinedRunner``'s host loop at depth 0, 1 and 2; ``MPPI.run_episode``
  and ``RacingController.run_episode`` bit for bit ``forward``/``update``
  calls, with the JAX return shapes.
* Against the JAX package, on injected noise: a shim solver (defined here)
  takes each tick's noise from ``info``, fed by an ``info_fn`` carry over a
  seeded numpy table, through the port's and the JAX ``make_closed_loop``
  and ``make_pipelined_closed_loop``; the pendulum and the integrator for
  10 ticks and racing at T=8 for 3 ticks against the JAX XLA solver.  Each
  tick is held to the JAX package's bar (costs rtol 1e-5, weights atol
  1e-5, actions and states atol 5e-3).  The JAX references run in a
  subprocess with XLA's FMA contraction off (tests/test_torch_fused_solve.py).

The same on the card: ``tests/test_torch_graph_replay.py``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch import MPPI, PipelinedRunner
from mppi_playground_tpu_torch.core.closed_loop import (
    RunnerCache,
    _freeze,
    _tensors,
    make_closed_loop,
    make_pipelined_closed_loop,
)
from mppi_playground_tpu_torch.core.config import (
    MPPIConfig,
    advance_key_plain,
    make_key,
    tick_seed,
    tick_seed_plain,
)
from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
from mppi_playground_tpu_torch.core.solver import make_solver
from mppi_playground_tpu_torch.envs import RacingController, RacingEnv
from mppi_playground_tpu_torch.models import integrator, pendulum
from mppi_playground_tpu_torch.models.racing_mpcc import (
    calc_ref_trajectory,
    make_mpcc_cost,
    make_racing_fused_task_from_env,
)
from mppi_playground_tpu_torch.ops import fused_solve as fs
from mppi_playground_tpu_torch.ops.lambda_search import LambdaSearch
from tests.test_torch_fused_solve import run_jax_references

JAX_TICKS = 10
RACING_T, RACING_K, RACING_TICKS = 8, 256, 3
MODEL_T, MODEL_K = 10, 256
# model -> (dim_state, dim_control, sigmas, x0) of the small configs both packages run
MODELS = {
    "pendulum": (2, 1, (1.0,), (math.pi, 0.0)),
    "integrator": (2, 2, (0.5, 0.5), (1.0, -0.5)),
}


def _same(a, b) -> bool:
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(ta, tb))


# ---------------------------------------------------------------------------
# The device key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("span", ["low", "past_2_32", "top_bit_seeds", "edges"])
def test_device_key_twin_matches_tick_seed(span):
    rng = np.random.default_rng({"low": 1, "past_2_32": 2, "top_bit_seeds": 3, "edges": 4}[span])
    if span == "low":
        pairs = [(int(s), int(t)) for s, t in zip(rng.integers(0, 2**31, 500),
                                                  rng.integers(0, 10_000, 500))]
    elif span == "past_2_32":
        pairs = [(int(s), int(t)) for s, t in zip(rng.integers(0, 2**40, 500),
                                                  rng.integers(2**32, 2**44, 500))]
    elif span == "top_bit_seeds":
        pairs = [(int(s) | (1 << 63), int(t)) for s, t in zip(
            rng.integers(0, 2**63, 500, dtype=np.uint64), rng.integers(0, 2**36, 500))]
    else:
        pairs = [(0, 0), (2**64 - 1, 2**32 - 1), (2**63, 2**32), (2**32 - 1, 2**64 - 1),
                 (42, 0), (7, 2**32 + 5)]
    mask = 0xFFFFFFFF
    seeds = torch.tensor([s & mask for s, _ in pairs])
    ticks = torch.tensor([t & mask for _, t in pairs])
    assert tick_seed_plain(seeds, ticks).tolist() == [tick_seed(s, t) for s, t in pairs]
    for s, t in pairs[:50]:
        assert torch.equal(advance_key_plain(make_key(s, t, "cpu")), make_key(s, t + 1, "cpu"))


def _racing_inputs(env, horizon=RACING_T, num_samples=RACING_K, seed=0):
    from mppi_playground_tpu_torch.models.racing_mpcc import extend_reference_path

    rng = np.random.default_rng(seed)
    x0 = env.reset() + torch.tensor([0.1, -0.1, 0.0, 5.0])
    xref, _ = calc_ref_trajectory(x0, env.racing_center_path, torch.tensor(0), horizon)
    prev = torch.tensor(rng.standard_normal((horizon, 2)) * (0.5, 0.1), dtype=torch.float32)
    noise = torch.tensor(rng.standard_normal((num_samples, horizon, 2)) * (0.5, 0.1),
                         dtype=torch.float32)
    return x0, prev, extend_reference_path(xref).contiguous(), noise


@pytest.fixture(scope="module")
def env():
    return RacingEnv(device="cpu")


@pytest.mark.parametrize("wrapper", ["fused_solve", "costs_dump", "costs_dump_lambda ESSPS",
                                     "costs_dump_lambda LBPS", "regen", "top_rollouts"])
def test_wrappers_take_the_seed_as_int_or_device_word(env, wrapper):
    """A host int seed and the same word in a tensor give the same outputs, bit for bit."""
    task = make_racing_fused_task_from_env(env)
    x0, prev, ref, _ = _racing_inputs(env)
    word = tick_seed(42, 7)
    bounds = ((0.5, 0.1), (-2.0, -0.25), (2.0, 0.25))
    k, lam = RACING_K, torch.ones(1)
    rows = torch.tensor([0, 5, k - 1, 100])

    def call(seed):
        if wrapper == "fused_solve":
            return fs.fused_solve(x0, prev, lam, seed, ref, task, *bounds, k, k)
        if wrapper == "costs_dump":
            return fs.fused_costs_dump(x0, prev, seed, ref, task, *bounds, k, k)
        if wrapper.startswith("costs_dump_lambda"):
            search = LambdaSearch(wrapper.split()[1], 0.01, 10.0,
                                  k / 10.0 if "ESSPS" in wrapper else 0.01, 8)
            return fs.fused_costs_dump_lambda(x0, prev, seed, ref, task, *bounds, k, k, None,
                                              search, torch.zeros(1, dtype=torch.int32))
        if wrapper == "regen":
            return fs.fused_regen(prev, seed, rows, *bounds, k, k)
        return fs.fused_top_rollouts(x0, prev, seed, rows, task, *bounds, k, k)

    as_int = call(word)
    as_word = call(make_key(42, 7, "cpu")[2:])
    assert _same(as_int, as_word)


def _route_solver(env, route):
    task = make_racing_fused_task_from_env(env)
    lam = {"fixed": 1.0, "MPO": "MPO"}.get(route, route.split()[0])
    config = MPPIConfig(horizon=RACING_T, num_samples=RACING_K, dim_state=4, dim_control=2,
                        u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1), lambda_=lam,
                        store_rollouts=False)
    epilogue = {"epilogue": True, "standalone": False}.get(route.split()[-1])
    return make_fused_solver(config, task, env.dynamics, device="cpu", lambda_epilogue=epilogue)


FUSED_ROUTES = ["fixed", "MPO", "ESSPS standalone", "ESSPS epilogue", "LBPS epilogue"]


@pytest.mark.parametrize("route", FUSED_ROUTES)
def test_fused_solve_reads_the_device_key(env, route):
    """Every fused route: the key's seed word drives the tick, and the tail moves the key on.

    The solve from a state with its key equals the solve from the same state
    whose key is made from the host pair, bit for bit; ``aux.seed`` is the
    tick's word; the next state's key is the next tick's.
    """
    solver = _route_solver(env, route)
    x0, _, _, _ = _racing_inputs(env)
    xref, _ = calc_ref_trajectory(x0, env.racing_center_path, torch.tensor(0), RACING_T)
    info = {"reference_path": xref}
    state = dataclasses.replace(solver.init(seed=5), tick=2 ** 32 + 3,
                                key=make_key(5, 2 ** 32 + 3, "cpu"))
    with_key = solver.solve(state, x0, info=info)
    from_host = solver.solve(dataclasses.replace(state, key=None), x0, info=info)
    assert _same(with_key, from_host)
    assert with_key.aux.seed.tolist() == [tick_seed(5, 2 ** 32 + 3)]
    assert torch.equal(with_key.state.key, make_key(5, 2 ** 32 + 4, "cpu"))
    assert with_key.state.tick == 2 ** 32 + 4
    # the top rows replay from the aux's word
    states, _ = solver.top_samples(with_key.aux, 8)
    assert torch.isfinite(states).all()


# ---------------------------------------------------------------------------
# The unfused route draws the fused kernels' stream
# ---------------------------------------------------------------------------

def _unfused(name, dtype=torch.float32, kernel_backend="auto", threshold=1.0):
    n, m, sig, x0 = MODELS[name]
    model = {"pendulum": pendulum, "integrator": integrator}[name]
    config = MPPIConfig(horizon=MODEL_T, num_samples=MODEL_K, dim_state=n, dim_control=m,
                        u_min=model.U_MIN, u_max=model.U_MAX, sigmas=sig, lambda_=1.0,
                        exploration=1.0 - threshold, dtype=dtype, kernel_backend=kernel_backend)
    return make_solver(config, model.dynamics, model.cost, device="cpu"), torch.tensor(
        x0, dtype=dtype)


@pytest.mark.parametrize("case", ["pendulum m=1", "integrator m=2", "integrator exploration",
                                  "integrator float64"])
def test_unfused_draw_is_the_fused_stream(case):
    """The seeded unfused solve is bit for bit its solve on the kernels' noise of the tick."""
    name = case.split()[0]
    kw = {"integrator exploration": dict(threshold=0.6),
          "integrator float64": dict(dtype=torch.float64, kernel_backend="xla")}.get(case, {})
    solver, x0 = _unfused(name, **kw)
    config = solver.config
    state = solver.init(seed=11)
    for tick in range(3):
        seeded = solver.solve(state, x0)
        word = tick_seed(11, tick)
        normals = fs.seeded_normals(word, MODEL_K, MODEL_T, "cpu", config.dim_control)
        noise = normals.to(config.dtype) * torch.tensor(config.sigmas, dtype=config.dtype)
        injected = solver.solve(state, x0, noise=noise)
        assert _same(seeded, injected)
        assert torch.equal(seeded.state.key, make_key(11, tick + 1, "cpu"))
        state, x0 = seeded.state, seeded.state_seq[1]


def test_unfused_perturbations_equal_the_regeneration_twin(monkeypatch):
    """Racing's unfused draw is ``fused_regen_plain`` over rows 0..K-1, bit for bit."""
    from mppi_playground_tpu_torch.core import solver as solver_module

    drawn = []
    real = solver_module.fused_regen

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        drawn.append((args, out))
        return out

    monkeypatch.setattr(solver_module, "fused_regen", spy)
    env = RacingEnv(device="cpu")
    ctrl = RacingController(env, horizon=RACING_T, num_samples=RACING_K)
    x = env.reset()
    for tick in range(2):
        ctrl.update(x)
        args, out = drawn[-1]
        prev = args[0]
        want = fs.fused_regen_plain(prev, tick_seed(42, tick), torch.arange(RACING_K), (0.5, 0.1),
                                    (-2.0, -0.25), (2.0, 0.25), RACING_K, RACING_K)
        assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# _freeze and RunnerCache (JAX tests/test_solver.py)
# ---------------------------------------------------------------------------

def test_runner_cache_is_bounded_lru():
    built = []

    def builder(k):
        def build():
            built.append(k)
            return f"runner-{k}"
        return build

    cache = RunnerCache(capacity=2)
    assert cache.get_or_build("a", builder("a")) == "runner-a"
    assert cache.get_or_build("b", builder("b")) == "runner-b"
    assert cache.get_or_build("a", builder("a")) == "runner-a"
    cache.get_or_build("c", builder("c"))
    cache.get_or_build("a", builder("a"))
    assert built == ["a", "b", "c"]
    cache.get_or_build("b", builder("b"))
    assert built == ["a", "b", "c", "b"]


def test_runner_cache_failed_build_preserves_entries():
    cache = RunnerCache(capacity=1)
    assert cache.get_or_build("good", lambda: "runner-good") == "runner-good"

    def bad_build():
        raise RuntimeError("user callable exploded")

    with pytest.raises(RuntimeError, match="exploded"):
        cache.get_or_build("bad", bad_build)
    assert cache.get_or_build("good", lambda: "REBUILT") == "runner-good"
    with pytest.raises(ValueError, match="capacity"):
        RunnerCache(capacity=0)


@pytest.mark.parametrize("case", ["scalar done", "row-wise"])
def test_freeze_selects_the_old_tree_where_done(case):
    if case == "scalar done":
        done = torch.tensor(True)
        old = {"a": torch.zeros(3), "b": (torch.zeros(()), torch.zeros(2, 2))}
        new = {"a": torch.ones(3), "b": (torch.ones(()), torch.ones(2, 2))}
        assert _same(_freeze(done, old, new), old)
        assert _same(_freeze(torch.tensor(False), old, new), new)
    else:
        done = torch.tensor([True, False])
        old, new = torch.zeros(2, 3), torch.ones(2, 3)
        shared_old, shared_new = torch.zeros(5), torch.ones(5)  # not [B, ...]: passes through
        out = _freeze(done, (old, shared_old), (new, shared_new))
        assert out[0].tolist() == [[0, 0, 0], [1, 1, 1]] and torch.equal(out[1], shared_new)


# ---------------------------------------------------------------------------
# make_closed_loop against eager solves
# ---------------------------------------------------------------------------

def _loop_case(case):
    """(solver, plant, x0, info_fn, carry0, done_fn) of a closed-loop case, on the CPU."""
    name = case.split()[0]
    if name == "racing":
        env = RacingEnv(device="cpu")
        config = MPPIConfig(horizon=RACING_T, num_samples=RACING_K, dim_state=4, dim_control=2,
                            u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1),
                            lambda_=1.0, store_rollouts="unfused" in case)
        if "unfused" in case:
            solver = make_solver(config, env.dynamics,
                                 make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map),
                                 device="cpu")
        else:
            solver = make_fused_solver(config, make_racing_fused_task_from_env(env),
                                       env.dynamics, device="cpu")
        path = env.racing_center_path

        def info_fn(cind, x):
            xref, new_cind = calc_ref_trajectory(x, path, cind, RACING_T)
            return {"reference_path": xref}, new_cind

        x0 = env.reset()
        goal = x0[:2] + torch.tensor([2.0, 0.0])
        return (solver, lambda x, u: env.dynamics(x[None], u[None])[0], x0, info_fn,
                torch.tensor(0), lambda x: torch.linalg.norm(x[:2] - goal) < 1.5)
    if name == "navigation":
        from mppi_playground_tpu_torch.envs.navigation_2d import Navigation2DEnv

        nav = Navigation2DEnv(device="cpu")
        config = MPPIConfig(horizon=12, num_samples=512, dim_state=3, dim_control=2,
                            u_min=tuple(nav.u_min.tolist()), u_max=tuple(nav.u_max.tolist()),
                            sigmas=(0.5, 0.5), lambda_="ESSPS", store_rollouts=False)
        solver = make_fused_solver(config, nav.fused_task(), nav.dynamics, device="cpu")
        x0 = nav.reset()
        return (solver, lambda x, u: nav.dynamics(x[None], u[None])[0], x0, None, None,
                lambda x: x[0] > x0[0] + 0.15)
    config = MPPIConfig(horizon=MODEL_T, num_samples=MODEL_K, dim_state=2, dim_control=1,
                        u_min=(-2.0,), u_max=(2.0,), sigmas=(1.0,), lambda_="ESSPS",
                        store_rollouts=False)
    solver = make_fused_solver(config, pendulum.fused_task(), pendulum.dynamics, device="cpu")
    return (solver, lambda x, u: pendulum.dynamics(x[None], u[None])[0],
            torch.tensor([math.pi, 0.0]), None, None, lambda x: x[1] < -0.5)


LOOP_CASES = ["racing fused", "racing unfused", "pendulum fused ESSPS", "navigation fused ESSPS"]


@pytest.mark.parametrize("done", [False, True], ids=["no_done", "done_fn"])
@pytest.mark.parametrize("case", LOOP_CASES)
def test_closed_loop_is_the_eager_solves(case, done):
    solver, plant, x0, info_fn, carry0, done_fn = _loop_case(case)
    ticks = 6
    run = make_closed_loop(solver, plant, ticks, info_fn=info_fn,
                           done_fn=done_fn if done else None)
    out = run(solver.init(), x0, carry0)
    st, x, c = solver.init(), x0, carry0
    xs, us, fired = [], [], None
    for t in range(ticks):
        info, c_next = info_fn(c, x) if info_fn else (None, c)
        r = solver.solve(st, x, info=info)
        xs.append(x)
        us.append(r.action_seq[0])
        st, x, c = r.state, plant(x, r.action_seq[0]), c_next
        if done and bool(done_fn(x)):
            fired = t + 1
            break
    n = len(us)
    assert torch.equal(out[2][:n], torch.stack(xs)) and torch.equal(out[3][:n], torch.stack(us))
    assert out[2].shape == (ticks, x0.shape[0]) and out[3].shape == (ticks, solver.config.dim_control)
    if not done:
        assert _same((out[0], out[1], out[4]), (st, x, c))
        assert out[0].tick == ticks
        return
    episode = out[5]
    if fired is None:
        assert not bool(episode["done"]) and int(episode["ticks"]) == ticks
        assert _same((out[0], out[1]), (st, x))
        return
    # frozen after the fire: zero actions, the terminal state, the state of the last tick run
    assert bool(episode["done"]) and int(episode["ticks"]) == fired
    assert bool((out[3][fired:] == 0).all()) and bool((out[2][fired:] == x).all())
    assert torch.equal(out[1], x) and _same(out[0].key, st.key)
    assert torch.equal(out[0].previous_action_seq, st.previous_action_seq)


def test_closed_loop_done_fn_fires_in_the_budget():
    """The pendulum swinging down fires its done_fn within the budget: the freeze is exercised."""
    solver, plant, x0, info_fn, carry0, done_fn = _loop_case("pendulum fused ESSPS")
    run = make_closed_loop(solver, plant, 12, done_fn=done_fn)
    *_, episode = run(solver.init(), x0)
    assert bool(episode["done"]) and 1 <= int(episode["ticks"]) < 12


def test_solve_after_a_frozen_episode_draws_from_the_frozen_key():
    """After a done_fn fired the device key decides the next draw; the host tick counts."""
    solver, plant, x0, info_fn, carry0, done_fn = _loop_case("pendulum fused ESSPS")
    ticks = 12
    st, xf, *_, episode = make_closed_loop(solver, plant, ticks, done_fn=done_fn)(
        solver.init(), x0)
    fired = int(episode["ticks"])
    assert bool(episode["done"]) and fired < ticks
    assert st.tick == ticks and torch.equal(st.key, make_key(st.seed, fired, "cpu"))
    got = solver.solve(st, xf)
    assert torch.equal(got.aux.seed, make_key(st.seed, fired, "cpu")[2:])
    assert torch.equal(got.state.key, make_key(st.seed, fired + 1, "cpu"))
    assert got.state.tick == ticks + 1
    # the same warm start drawing from the host pair's key is another stream
    other = solver.solve(dataclasses.replace(st, key=None), xf)
    assert not torch.equal(other.aux.costs, got.aux.costs)
    assert torch.equal(got.aux.costs, solver.solve(
        dataclasses.replace(st, key=make_key(st.seed, fired, "cpu")), xf).aux.costs)


# ---------------------------------------------------------------------------
# make_pipelined_closed_loop against PipelinedRunner's host loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compensate", [True, False])
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_pipelined_loop_is_the_runner_host_loop(depth, compensate):
    solver, plant, x0, _, _, _ = _loop_case("pendulum fused ESSPS")
    ticks = 8
    x, host = x0, []
    if depth == 0:  # the strict loop: one solve, its row 0
        st = solver.init(seed=3)
        for _ in range(ticks):
            host.append(x)
            r = solver.solve(st, x)
            st, x = r.state, plant(x, r.action_seq[0])
    else:
        runner = PipelinedRunner(solver, depth=depth, compensate=compensate)
        runner.reset(seed=3)
        for _ in range(ticks):
            host.append(x)
            x = plant(x, torch.as_tensor(runner.step(x)))
        assert len(runner.flush()) == depth
    run = make_pipelined_closed_loop(solver, plant, ticks, depth, compensate=compensate)
    _, xf, xs, us, _ = run(solver.init(seed=3), x0)
    assert torch.equal(torch.stack(host), xs) and torch.equal(x, xf)


def test_pipelined_runner_schedule_and_validation():
    """Fill returns plan_t[0]; steady state plan_{t-depth}[depth]; depth >= 1."""
    n, m, sig, _ = MODELS["integrator"]
    solver, _ = _unfused("integrator")
    with pytest.raises(ValueError):
        PipelinedRunner(solver, depth=0)
    xs = [torch.tensor([0.1 * t, -0.05 * t]) for t in range(6)]
    st, plans = solver.init(), []
    for x in xs:
        r = solver.solve(st, x)
        plans.append(r.action_seq.numpy())
        st = r.state
    runner = PipelinedRunner(solver, depth=2)
    for t, x in enumerate(xs):
        a = runner.step(x)
        np.testing.assert_array_equal(a, plans[t][0] if t < 2 else plans[t - 2][2])
    leftover = runner.flush()
    assert len(leftover) == 2
    np.testing.assert_array_equal(leftover[-1], plans[-1])
    runner.reset()
    np.testing.assert_array_equal(runner.step(xs[0]), plans[0][0])
    uncompensated = PipelinedRunner(solver, depth=1, compensate=False)
    uncompensated.step(xs[0])
    np.testing.assert_array_equal(uncompensated.step(xs[1]), plans[0][0])


def test_pipelined_runner_is_exported_from_the_root():
    import mppi_playground_tpu_torch

    assert "PipelinedRunner" in mppi_playground_tpu_torch.__all__
    assert mppi_playground_tpu_torch.PipelinedRunner is PipelinedRunner


# ---------------------------------------------------------------------------
# The facades' run_episode
# ---------------------------------------------------------------------------

def _pendulum_mppi(fused):
    kw = dict(horizon=6, num_samples=128, dim_state=2, dim_control=1,
              dynamics=pendulum.dynamics, cost_func=pendulum.cost, u_min=[-2.0],
              u_max=[2.0], sigmas=[1.0], lambda_=1.0, device="cpu")
    if fused:
        kw.update(store_rollouts=False, fused_task=pendulum.fused_task())
    return MPPI(**kw)


def _plant(x, u):
    return pendulum.dynamics(x[None], u[None])[0]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_mppi_run_episode_is_forward_calls(fused):
    a, b = _pendulum_mppi(fused), _pendulum_mppi(fused)
    x0 = torch.tensor([math.pi, 0.0])
    xs, us = a.run_episode(_plant, x0, 4)
    assert xs.shape == (5, 2) and us.shape == (4, 1)
    x = x0
    for t in range(4):
        act, _ = b.forward(x)
        assert torch.equal(xs[t], x) and torch.equal(us[t], act[0])
        x = _plant(x, act[0])
    assert torch.equal(xs[-1], x)
    assert _same(a.solver_state, b.solver_state) and a.solver_state.tick == 4
    with pytest.raises(RuntimeError, match="prior forward"):
        a.get_top_samples(5)
    b.get_top_samples(5)


def test_mppi_run_episode_threads_the_carry_and_done():
    c = _pendulum_mppi(True)

    def info_fn(count, x):
        return {}, count + 1

    xs, us, carry = c.run_episode(_plant, torch.tensor([math.pi, 0.0]), 4, info_fn=info_fn,
                                  carry=torch.tensor(10, dtype=torch.int32))
    assert int(carry) == 14 and xs.shape == (5, 2)
    xs, us, episode = c.run_episode(_plant, torch.tensor([math.pi, 0.0]), 6,
                                    done_fn=lambda x: x[1] < -0.1)
    assert set(episode) == {"done", "ticks"} and episode["ticks"].dtype == torch.int32
    n = int(episode["ticks"])
    assert bool(episode["done"]) and bool((us[n:] == 0).all())


@pytest.mark.parametrize("store_rollouts", [True, False], ids=["unfused", "fused"])
def test_racing_controller_run_episode_is_update_calls(env, store_rollouts):
    a = RacingController(env, horizon=RACING_T, num_samples=RACING_K,
                         store_rollouts=store_rollouts)
    b = RacingController(env, horizon=RACING_T, num_samples=RACING_K,
                         store_rollouts=store_rollouts)
    x0 = env.reset()
    xs, us = a.run_episode(x0, 3)
    assert xs.shape == (4, 4) and us.shape == (3, 2)
    x = x0
    for t in range(3):
        act, _ = b.update(x)
        assert torch.equal(xs[t], x) and torch.equal(us[t], act[0])
        x = env.dynamics(x[None], act[:1])[0]
    assert torch.equal(xs[-1], x)
    assert _same(a.solver_state, b.solver_state)
    assert torch.equal(a.current_path_index, b.current_path_index)
    assert a.reference_path is None
    with pytest.raises(RuntimeError, match="update"):
        a.get_top_samples(5)
    goal = x0[:2]
    xs, us, episode = a.run_episode(xs[-1], 2, done_fn=lambda x: torch.linalg.norm(
        x[:2] - goal) > 0.0)
    assert bool(episode["done"]) and int(episode["ticks"]) == 1 and bool((us[1:] == 0).all())


# ---------------------------------------------------------------------------
# Against the JAX package on injected noise
# ---------------------------------------------------------------------------

class NoiseFromInfo:
    """A solver whose solve takes the tick's noise from ``info['noise']`` (the rest is ``info``)."""

    def __init__(self, solver):
        self.solver = solver
        self.config = solver.config
        self.device = getattr(solver, "device", None)

    def init(self, *args, **kwargs):
        return self.solver.init(*args, **kwargs)

    def solve(self, state, x, info=None):
        info = dict(info)
        noise = info.pop("noise")
        return self.solver.solve(state, x, info=info or None, noise=noise)


def _noise_table(name, ticks, horizon, num_samples, m, sigmas):
    rng = np.random.default_rng({"pendulum": 21, "integrator": 22, "racing": 23}[name])
    return (rng.standard_normal((ticks, num_samples, horizon, m)) * sigmas).astype(np.float32)


def _jax_model_config(name):
    from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
    from mppi_playground_tpu.models import integrator as jax_integrator
    from mppi_playground_tpu.models import pendulum as jax_pendulum

    n, m, sig, x0 = MODELS[name]
    model = {"pendulum": jax_pendulum, "integrator": jax_integrator}[name]
    config = JaxConfig(horizon=MODEL_T, num_samples=MODEL_K, dim_state=n, dim_control=m,
                       u_min=model.U_MIN, u_max=model.U_MAX, sigmas=sig, lambda_=1.0)
    return config, model


def jax_closed_loop_reference(out_path: str) -> None:
    """Subprocess body: the JAX closed loops on injected noise, and their eager ticks."""
    jax.config.update("jax_platforms", "cpu")
    from mppi_playground_tpu.core.closed_loop import (
        make_closed_loop as jax_closed_loop,
        make_pipelined_closed_loop as jax_pipelined,
    )
    from mppi_playground_tpu.core.solver import make_solver as jax_make_solver

    out = {}

    def record(prefix, solver, plant, x0, table, info_of, carry0):
        """The eager ticks' costs, weights, actions and states."""
        st, x, c = solver.init(), x0, carry0
        for t in range(table.shape[0]):
            info, c = info_of(c, x)
            r = solver.solve(st, x, info=info, noise=jnp.asarray(table[t]))
            for key, v in dict(costs=r.aux.costs, weights=r.aux.weights, action_seq=r.action_seq,
                               state_seq=r.state_seq).items():
                out[f"{prefix}_{t}_{key}"] = np.asarray(v)
            st, x = r.state, plant(x, r.action_seq[0])

    for name in MODELS:
        config, model = _jax_model_config(name)
        solver = jax_make_solver(config, model.dynamics, model.cost, jit=False)
        table = jnp.asarray(_noise_table(name, JAX_TICKS, MODEL_T, MODEL_K, *MODELS[name][1:3]))

        def plant(x, u, model=model):
            return model.dynamics(x[None], u[None])[0]

        def info_fn(t, x, table=table):
            return {"noise": table[t]}, t + 1

        shim = NoiseFromInfo(solver)
        x0 = jnp.asarray(MODELS[name][3], jnp.float32)
        st, xf, xs, us, _ = jax_closed_loop(shim, plant, JAX_TICKS, info_fn=info_fn)(
            solver.init(), x0, jnp.asarray(0, jnp.int32))
        out.update({f"{name}_xs": np.asarray(xs), f"{name}_us": np.asarray(us),
                    f"{name}_xf": np.asarray(xf), f"{name}_prev": np.asarray(
                        st.previous_action_seq)})
        record(name, solver, plant, x0, np.asarray(table), lambda c, x: (None, c), None)
        if name == "pendulum":
            for compensate in (True, False):
                _, xf, xs, us, _ = jax_pipelined(shim, plant, JAX_TICKS, 2, compensate=compensate,
                                                 info_fn=info_fn)(
                    solver.init(), x0, jnp.asarray(0, jnp.int32))
                out[f"pipelined_{compensate}_xs"] = np.asarray(xs)
                out[f"pipelined_{compensate}_us"] = np.asarray(us)

    from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
    from mppi_playground_tpu.envs.racing_env import RacingEnv as JaxRacingEnv
    from mppi_playground_tpu.models import racing_mpcc

    env = JaxRacingEnv()
    config = JaxConfig(horizon=RACING_T, num_samples=RACING_K, dim_state=4, dim_control=2,
                       u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1), lambda_=1.0)
    cost = racing_mpcc.make_mpcc_cost(env.obstacle_map.device_map, env.lane_map.device_map)
    solver = jax_make_solver(config, env.dynamics, cost, jit=False)
    table = jnp.asarray(_noise_table("racing", RACING_TICKS, RACING_T, RACING_K, 2, (0.5, 0.1)))
    path = env.racing_center_path

    def racing_info(carry, x):
        t, cind = carry
        xref, new_cind = racing_mpcc.calc_ref_trajectory(x, path, cind, RACING_T)
        return {"reference_path": xref, "noise": table[t]}, (t + 1, new_cind)

    def racing_plant(x, u):
        return env.dynamics(x[None], u[None])[0]

    x0 = jnp.asarray(env.reset())
    carry0 = (jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
    st, xf, xs, us, _ = jax_closed_loop(NoiseFromInfo(solver), racing_plant, RACING_TICKS,
                                        info_fn=racing_info)(solver.init(), x0, carry0)
    out.update(racing_xs=np.asarray(xs), racing_us=np.asarray(us), racing_xf=np.asarray(xf),
               racing_x0=np.asarray(x0))

    def eager_info(carry, x):
        info, carry = racing_info(carry, x)
        info.pop("noise")
        return info, carry

    record("racing", solver, racing_plant, x0, np.asarray(table), eager_info, carry0)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax_references("tests.test_torch_closed_loop", ["jax_closed_loop_reference"],
                              tmp_path_factory.mktemp("jax_closed_loop"))[
        "jax_closed_loop_reference"]


def _check_ticks(prefix, want, port_ticks):
    """Each tick at the JAX package's bar for the fused-vs-XLA comparison."""
    for t, r in enumerate(port_ticks):
        np.testing.assert_allclose(r.aux.costs.numpy(), want[f"{prefix}_{t}_costs"], rtol=1e-5)
        np.testing.assert_allclose(r.aux.weights.numpy(), want[f"{prefix}_{t}_weights"],
                                   atol=1e-5)
        np.testing.assert_allclose(r.action_seq.numpy(), want[f"{prefix}_{t}_action_seq"],
                                   atol=5e-3)
        np.testing.assert_allclose(r.state_seq.numpy(), want[f"{prefix}_{t}_state_seq"],
                                   atol=5e-3)


@pytest.mark.parametrize("name", list(MODELS))
def test_closed_loop_meets_jax_on_injected_noise(jax_ref, name):
    solver, _ = _unfused(name)
    model = {"pendulum": pendulum, "integrator": integrator}[name]
    table = torch.from_numpy(_noise_table(name, JAX_TICKS, MODEL_T, MODEL_K, *MODELS[name][1:3]))

    def plant(x, u):
        return model.dynamics(x[None], u[None])[0]

    def info_fn(t, x):
        return {"noise": table[t]}, t + 1

    x0 = torch.tensor(MODELS[name][3])
    run = make_closed_loop(NoiseFromInfo(solver), plant, JAX_TICKS, info_fn=info_fn)
    st, xf, xs, us, carry = run(solver.init(), x0, torch.tensor(0))
    assert int(carry) == JAX_TICKS
    np.testing.assert_allclose(us.numpy(), jax_ref[f"{name}_us"], atol=5e-3)
    np.testing.assert_allclose(xs.numpy(), jax_ref[f"{name}_xs"], atol=5e-3)
    np.testing.assert_allclose(xf.numpy(), jax_ref[f"{name}_xf"], atol=5e-3)
    np.testing.assert_allclose(st.previous_action_seq.numpy(), jax_ref[f"{name}_prev"],
                               atol=5e-3)
    # the eager ticks on the same noise, each at the bar, and the loop bit for bit them
    state, x, ticks = solver.init(), x0, []
    for t in range(JAX_TICKS):
        r = solver.solve(state, x, noise=table[t])
        ticks.append(r)
        assert torch.equal(us[t], r.action_seq[0]) and torch.equal(xs[t], x)
        state, x = r.state, plant(x, r.action_seq[0])
    _check_ticks(name, jax_ref, ticks)


@pytest.mark.parametrize("compensate", [True, False])
def test_pipelined_loop_meets_jax_on_injected_noise(jax_ref, compensate):
    solver, _ = _unfused("pendulum")
    table = torch.from_numpy(_noise_table("pendulum", JAX_TICKS, MODEL_T, MODEL_K,
                                          *MODELS["pendulum"][1:3]))
    run = make_pipelined_closed_loop(NoiseFromInfo(solver), _plant, JAX_TICKS, 2,
                                     compensate=compensate,
                                     info_fn=lambda t, x: ({"noise": table[t]}, t + 1))
    _, _, xs, us, _ = run(solver.init(), torch.tensor(MODELS["pendulum"][3]), torch.tensor(0))
    np.testing.assert_allclose(us.numpy(), jax_ref[f"pipelined_{compensate}_us"], atol=5e-3)
    np.testing.assert_allclose(xs.numpy(), jax_ref[f"pipelined_{compensate}_xs"], atol=5e-3)


def test_racing_closed_loop_meets_jax_on_injected_noise(jax_ref, env):
    config = MPPIConfig(horizon=RACING_T, num_samples=RACING_K, dim_state=4, dim_control=2,
                        u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1), lambda_=1.0)
    solver = make_solver(config, env.dynamics,
                         make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map), device="cpu")
    table = torch.from_numpy(_noise_table("racing", RACING_TICKS, RACING_T, RACING_K, 2,
                                          (0.5, 0.1)))
    path = env.racing_center_path

    def info_fn(carry, x):
        t, cind = carry
        xref, new_cind = calc_ref_trajectory(x, path, cind, RACING_T)
        return {"reference_path": xref, "noise": table[t]}, (t + 1, new_cind)

    def plant(x, u):
        return env.dynamics(x[None], u[None])[0]

    x0 = torch.from_numpy(jax_ref["racing_x0"])
    carry0 = (torch.tensor(0), torch.tensor(0))
    run = make_closed_loop(NoiseFromInfo(solver), plant, RACING_TICKS, info_fn=info_fn)
    st, xf, xs, us, _ = run(solver.init(), x0, carry0)
    np.testing.assert_allclose(us.numpy(), jax_ref["racing_us"], atol=5e-3)
    np.testing.assert_allclose(xs.numpy(), jax_ref["racing_xs"], atol=5e-3)
    np.testing.assert_allclose(xf.numpy(), jax_ref["racing_xf"], atol=5e-3)
    state, x, c, ticks = solver.init(), x0, carry0, []
    for t in range(RACING_TICKS):
        info, c = info_fn(c, x)
        r = solver.solve(state, x, info={"reference_path": info["reference_path"]},
                         noise=info["noise"])
        ticks.append(r)
        assert torch.equal(us[t], r.action_seq[0])
        state, x = r.state, plant(x, r.action_seq[0])
    _check_ticks("racing", jax_ref, ticks)
