"""The fused tick's tail (row 2 of PERF.md's table) against the JAX package, on the CPU.

The tail is one kernel launch after the fused solve or phase 2
(``ops/fused_solve.fused_tick_tail``): the block partials merged into the
update, weights and ESS, the SG filter, its history shifted, the nominal
re-roll.  On CPU tensors the wrapper runs its twin, which sums in the
kernel's order:

* The twin against the JAX package's ``combine_partials`` (the fused
  solver's merge), ``core/solver.smooth_predict_advance`` and
  ``make_fused_reroll`` in Pallas interpret mode, on the same partials of a
  solve on injected noise: racing, Navigation2D and the pendulum, the SG
  filter off and on.  The JAX package's bar for fused against XLA
  (tests/test_fused_solve.py): weights atol 1e-5, ESS rtol 1e-3, action and
  state sequences (and the shifted history) atol 5e-3.
* The twin's merge against the torch ``combine_partials`` it replaces,
  elementwise at rtol 1e-6 (the sums are taken in another order).
* The fused solver's ``solve`` goes through the tail on every fused route
  (fixed lambda, the standalone search, the lambda epilogue), and over two
  chained Navigation2D ticks with the SG filter on matches the JAX fused
  solver on each route (its Pallas kernels in interpret mode, in a
  subprocess with XLA's FMA contraction off): costs rtol 2e-5, atol 1e-5
  (tests/test_torch_fused_models.py; XLA's CPU sqrt is not correctly
  rounded), weights atol 1e-5, ESS rtol 1e-3, actions and states atol 5e-3,
  ESSPS lambda* rtol 1e-4, atol 1e-6.
* Racing's hoisted action terms (the clamped acceleration times dt and tan
  of the clamped steer, taken for a whole sequence at once, as the kernels'
  CTA takes them before the chain) give the plain step's states bit for bit.
"""

import types

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch.core import fused_solver as port_fused_solver
from mppi_playground_tpu_torch.core.config import MPPIConfig
from mppi_playground_tpu_torch.core.sg_filter import savitzky_golay_coeffs
from mppi_playground_tpu_torch.ops import fused_solve
from mppi_playground_tpu_torch.ops.weighted_update import combine_partials
from tests.test_torch_fused_solve import run_jax_references

HORIZON, K = 8, 1500  # a padded last block of 256
MODELS = ("racing", "navigation", "pendulum")
SG = (5, 3)
NAV_DIMS = dict(dim_state=3, dim_control=2, u_min=(0.0, -1.0), u_max=(2.0, 1.0),
                sigmas=(0.5, 0.5))
NAV_T, NAV_K, NAV_TICKS = 6, 1024, 2
ROUTES = {"fixed": (1.0, None), "standalone": ("ESSPS", False), "epilogue": ("ESSPS", True)}


def _port_model(name):
    """``(task, x0, sigmas, u_min, u_max, ref)`` of a model on the CPU."""
    if name == "racing":
        from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
        from mppi_playground_tpu_torch.models.racing_mpcc import (
            calc_ref_trajectory,
            extend_reference_path,
            make_racing_fused_task_from_env,
        )

        env = RacingEnv(device="cpu")
        x0 = env.reset() + torch.tensor([0.2, -0.1, 0.05, 6.0])
        xref, _ = calc_ref_trajectory(x0, env.racing_center_path, torch.tensor(0), HORIZON)
        return (make_racing_fused_task_from_env(env), x0, (0.5, 0.1), (-2.0, -0.25),
                (2.0, 0.25), extend_reference_path(xref).contiguous())
    if name == "navigation":
        from mppi_playground_tpu_torch.envs.navigation_2d import Navigation2DEnv

        env = Navigation2DEnv(device="cpu")
        return (env.fused_task(), env.reset(), NAV_DIMS["sigmas"], NAV_DIMS["u_min"],
                NAV_DIMS["u_max"], None)
    from mppi_playground_tpu_torch.models import pendulum

    return pendulum.fused_task(), torch.tensor([np.pi - 0.4, 0.3]), (1.0,), (-2.0,), (2.0,), None


def _partials(name):
    """A solve's block partials on injected noise, and what the tail takes besides."""
    task, x0, sig, lo, hi, ref = _port_model(name)
    m = task.dim_control
    rng = np.random.default_rng(len(name))
    prev = torch.tensor(rng.standard_normal((HORIZON, m)) * sig, dtype=torch.float32)
    noise = torch.tensor(rng.standard_normal((K, HORIZON, m)) * sig, dtype=torch.float32)
    lam = torch.tensor([0.7])
    costs, stats, numer = fused_solve.fused_solve_plain(x0, prev, lam, 0, ref, task, sig, lo,
                                                        hi, K, K, noise)
    history = torch.tensor(rng.standard_normal((HORIZON - 1, m)) * 0.2, dtype=torch.float32)
    return dict(task=task, x0=x0, costs=costs, stats=stats, numer=numer, lam=lam,
                history=history)


def jax_tail_reference(out_path: str) -> None:
    """Subprocess body: the JAX merge, SG filter and fused re-roll on the port's partials."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu.core import sg_filter as jax_sg
    from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
    from mppi_playground_tpu.core.solver import smooth_predict_advance
    from mppi_playground_tpu.envs.navigation_2d import Navigation2DEnv
    from mppi_playground_tpu.envs.racing_env import RacingEnv as JaxRacingEnv
    from mppi_playground_tpu.models import pendulum, racing_mpcc
    from mppi_playground_tpu.ops.fused_solve import make_fused_reroll, make_fused_solve

    tasks = {"racing": racing_mpcc.make_racing_fused_task_from_env(JaxRacingEnv()),
             "navigation": Navigation2DEnv().fused_task(), "pendulum": pendulum.fused_task()}
    out = {}
    for name in MODELS:
        p = {key: v.numpy() for key, v in _partials(name).items() if key not in ("task",)}
        task = tasks[name]
        m = p["history"].shape[1]
        for sg in (False, True):
            cfg = JaxConfig(horizon=HORIZON, num_samples=K, dim_state=p["x0"].shape[0],
                            dim_control=m, u_min=(-1.0,) * m, u_max=(1.0,) * m,
                            sigmas=(1.0,) * m, lambda_=1.0, store_rollouts=False,
                            use_sg_filter=sg, sg_window_size=SG[0], sg_poly_order=SG[1])
            core = make_fused_solve(cfg, task, interpret=True)
            reroll = make_fused_reroll(cfg, task, interpret=True)
            update, weights, ess = core.combine_partials(
                jnp.asarray(p["costs"]), jnp.asarray(p["stats"]), jnp.asarray(p["numer"]),
                jnp.asarray(p["lam"][0]))
            coeffs = jnp.asarray(jax_sg.savitzky_golay_coeffs(*SG), jnp.float32)
            state = types.SimpleNamespace(sg_history=jnp.asarray(p["history"]))
            actions, states, history = smooth_predict_advance(
                cfg, coeffs, lambda x0, seqs: reroll(x0, seqs[0])[None], state,
                jnp.asarray(p["x0"]), update)
            for key, value in dict(actions=actions, states=states, history=history,
                                   weights=weights, ess=ess).items():
                out[f"{name}_{sg}_{key}"] = np.asarray(value)
    np.savez(out_path, **out)


def _nav_config(mode):
    return dict(horizon=NAV_T, num_samples=NAV_K, lambda_=mode, store_rollouts=False,
                use_sg_filter=True, **NAV_DIMS)


def _nav_noise(tick):
    rng = np.random.default_rng(100 + tick)
    return (rng.standard_normal((NAV_K, NAV_T, 2)) * NAV_DIMS["sigmas"]).astype(np.float32)


def jax_routes_reference(out_path: str) -> None:
    """Subprocess body: the JAX fused solver on each route, chained Navigation2D ticks, SG on."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
    from mppi_playground_tpu.core.fused_solver import make_fused_solver as jax_fused
    from mppi_playground_tpu.envs.navigation_2d import Navigation2DEnv

    env = Navigation2DEnv()
    out = {}
    for route, (mode, epilogue) in ROUTES.items():
        kw = dict(jit=True, donate_state=False, interpret=True)
        if epilogue is not None:
            kw["lambda_epilogue"] = epilogue
        solver = jax_fused(JaxConfig(**_nav_config(mode)), env.fused_task(), env.dynamics, **kw)
        state, x = solver.init(), env.reset()
        for tick in range(NAV_TICKS):
            r = solver.solve(state, x, info={}, noise=jnp.asarray(_nav_noise(tick)))
            for key, value in dict(costs=r.aux.costs, weights=r.aux.weights, ess=r.aux.ess,
                                   lam=r.aux.lam, actions=r.action_seq, states=r.state_seq,
                                   x=x).items():
                out[f"{route}_{tick}_{key}"] = np.asarray(value)
            state, x = r.state, env.dynamics(x[None], r.action_seq[:1])[0]
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    refs = run_jax_references("tests.test_torch_tick_tail",
                              ["jax_tail_reference", "jax_routes_reference"],
                              tmp_path_factory.mktemp("jax_tick_tail"))
    return {**refs["jax_tail_reference"], **refs["jax_routes_reference"]}


@pytest.mark.parametrize("sg", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_tail_twin_matches_jax(jax_ref, name, sg):
    p = _partials(name)
    coeffs = torch.tensor(savitzky_golay_coeffs(*SG), dtype=torch.float32) if sg else None
    actions, states, weights, ess, history = fused_solve.fused_tick_tail(
        p["x0"], p["costs"], p["stats"], p["numer"], p["lam"], p["task"], p["history"], coeffs)
    key = f"{name}_{sg}"
    np.testing.assert_allclose(weights.numpy(), jax_ref[f"{key}_weights"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(ess), float(jax_ref[f"{key}_ess"]), rtol=1e-3)
    for got, want in ((actions, "actions"), (states, "states"), (history, "history")):
        assert got.shape == jax_ref[f"{key}_{want}"].shape
        np.testing.assert_allclose(got.numpy(), jax_ref[f"{key}_{want}"], rtol=0, atol=5e-3,
                                   err_msg=want)


@pytest.mark.parametrize("name", MODELS)
def test_tail_merge_matches_combine_partials(name):
    """The twin's merge (the kernel's summation order) against the torch merge it replaces."""
    p = _partials(name)
    update, weights, ess = fused_solve.tail_merge_plain(p["costs"], p["stats"], p["numer"],
                                                        p["lam"])
    want = combine_partials(p["costs"], p["stats"], p["numer"], p["lam"], HORIZON,
                            p["task"].dim_control)
    torch.testing.assert_close(update.reshape(want[0].shape), want[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(weights, want[1], rtol=1e-6, atol=0)
    torch.testing.assert_close(ess, want[2], rtol=1e-6, atol=0)


def test_tail_twin_without_filter_is_merge_then_reroll():
    """SG off: the twin's actions are the merged update, its states their re-roll, bit for bit."""
    p = _partials("racing")
    actions, states, weights, ess, history = fused_solve.fused_tick_tail_plain(
        p["x0"], p["costs"], p["stats"], p["numer"], p["lam"], p["task"], p["history"])
    update, want_w, want_ess = fused_solve.tail_merge_plain(p["costs"], p["stats"], p["numer"],
                                                            p["lam"])
    torch.testing.assert_close(actions, update.reshape(HORIZON, 2), rtol=0, atol=0)
    torch.testing.assert_close(states, fused_solve.fused_reroll_plain(p["x0"], actions,
                                                                      p["task"]), rtol=0, atol=0)
    torch.testing.assert_close(history, torch.cat([p["history"][1:], actions[:1]]), rtol=0,
                               atol=0)


@pytest.mark.parametrize("route", list(ROUTES))
def test_fused_solver_runs_the_tail_and_matches_jax(jax_ref, monkeypatch, route):
    from mppi_playground_tpu_torch.envs.navigation_2d import Navigation2DEnv

    calls = []
    # every route's tail, as the batch of one's
    def spy(*args, real=port_fused_solver.fused_tick_tail_batch, **kwargs):
        calls.append(args[7] is not None)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_fused_solver, "fused_tick_tail_batch", spy)
    mode, epilogue = ROUTES[route]
    env = Navigation2DEnv(device="cpu")
    solver = port_fused_solver.make_fused_solver(MPPIConfig(**_nav_config(mode)), env.fused_task(),
                                                 env.dynamics, device="cpu",
                                                 lambda_epilogue=epilogue)
    state = solver.init()
    for tick in range(NAV_TICKS):
        x = torch.from_numpy(jax_ref[f"{route}_{tick}_x"])
        r = solver.solve(state, x, noise=torch.from_numpy(_nav_noise(tick)))
        key = f"{route}_{tick}"
        np.testing.assert_allclose(r.aux.costs.numpy(), jax_ref[f"{key}_costs"], rtol=2e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r.aux.weights.numpy(), jax_ref[f"{key}_weights"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(float(r.aux.ess), float(jax_ref[f"{key}_ess"]), rtol=1e-3)
        np.testing.assert_allclose(float(r.aux.lam), float(jax_ref[f"{key}_lam"]), rtol=1e-4,
                                   atol=1e-6)
        for got, want in ((r.action_seq, "actions"), (r.state_seq, "states")):
            np.testing.assert_allclose(got.numpy(), jax_ref[f"{key}_{want}"], rtol=0, atol=5e-3)
        state = r.state
    assert calls == [True] * NAV_TICKS  # one tail a tick, with the filter's window


def test_racing_hoisted_terms_give_the_plain_step():
    """A sequence's action terms taken at once, then the chain: the plain step's states bitwise."""
    from mppi_playground_tpu_torch.models.bicycle import make_dynamics_soa
    from mppi_playground_tpu_torch.utils.angles import angle_normalize
    from mppi_playground_tpu_torch.utils.fastmath import sincos_npi

    x_lim, y_lim = (-40.0, 40.0), (-40.0, 40.0)
    dynamics = make_dynamics_soa(x_lim, y_lim)
    rng = np.random.default_rng(7)
    horizon, batch = 60, 256
    seq = torch.tensor(np.stack([rng.uniform(-3.0, 3.0, (horizon, batch)),
                                 rng.uniform(-0.4, 0.4, (horizon, batch))], axis=1),
                       dtype=torch.float32)  # [T, 2, B], past both clamps

    def plain(xs, us):  # the step as models/bicycle.py wrote it before the split
        x, y, theta, v = xs
        theta = angle_normalize(theta)
        accel = torch.clamp(us[0], -2.0, 2.0)
        steer = torch.clamp(us[1], -0.25, 0.25)
        s, c = sincos_npi(theta)
        x2 = steer * steer
        tan = steer * (1.0 + x2 * (1.0 / 3.0 + x2 * (2.0 / 15.0 + x2 * (17.0 / 315.0))))
        return (torch.clamp(x + v * c * 0.1, *x_lim), torch.clamp(y + v * s * 0.1, *y_lim),
                angle_normalize(theta + v * tan / 1.0 * 0.1), torch.clamp(v + accel * 0.1,
                                                                           -8.0, 8.0))

    x0 = tuple(torch.tensor(rng.uniform(lo, hi, batch), dtype=torch.float32)
               for lo, hi in ((-39, 39), (-39, 39), (-3.2, 3.2), (-8, 8)))
    terms = dynamics.action_terms((seq[:, 0], seq[:, 1]))  # every step at once
    hoisted, want = x0, x0
    for t in range(horizon):
        hoisted = dynamics.step_terms(hoisted, (terms[0][t], terms[1][t]))
        want = plain(want, (seq[t, 0], seq[t, 1]))
        for a, b in zip(hoisted, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(dynamics(x0, (seq[0, 0], seq[0, 1])), plain(x0, (seq[0, 0], seq[0, 1]))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
