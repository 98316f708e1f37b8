"""Row 6 of the port: the fused route's top samples regenerated and rolled out in one launch.

On the CPU ``ops/fused_solve.fused_top_rollouts`` runs its plain twin,
``fused_top_rollouts_plain``: the regeneration twin, then a batched re-roll
through the task's ``dynamics_soa``.  Held here, at T=8 and K=1,500 (a
padded last block), for racing, Navigation2D and the pendulum (m=1):

* against the JAX package's fused ``top_samples`` (its ``_top``: ``run_regen``
  in interpret mode, ``top_k``, the batched re-roll) on the same injected
  noise, through the port's fused solver and directly on the JAX top rows:
  weights atol 1e-5, states atol 5e-4, the JAX package's bar for its fused
  top samples.  The JAX side runs in subprocesses with XLA's FMA contraction
  off (see tests/test_torch_fused_solve.py).
* rows outside [0, K) give rows of NaN, as the kernel does, in both noise
  modes; every other row is the one-row re-roll twin of its regenerated
  actions; racing's seeded top samples are the regeneration rolled out by
  the AoS ``states_prediction``, bit for bit (the route before this kernel).
* the solver's error cases on every model.
"""

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch.core.config import MPPIConfig
from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
from mppi_playground_tpu_torch.core.solver import make_solver
from mppi_playground_tpu_torch.ops import fused_solve
from tests.test_torch_fused_models import DIMS, _jax_plug, _port_plug
from tests.test_torch_fused_solve import run_jax_references

HORIZON, K, TOP = 8, 1500, 300
MODELS = ("racing", "navigation", "pendulum")
RACING_DIMS = dict(dim_state=4, dim_control=2, u_min=(-2.0, -0.25), u_max=(2.0, 0.25),
                   sigmas=(0.5, 0.1))


def _config(name, **kw):
    dims = RACING_DIMS if name == "racing" else DIMS[name][0]
    return dict(dict(horizon=HORIZON, num_samples=K, lambda_=1.0, store_rollouts=False,
                     exploration=0.2, **dims), **kw)


def _noise(name):
    dims = RACING_DIMS if name == "racing" else DIMS[name][0]
    rng = np.random.default_rng(40 + len(name))
    return (rng.standard_normal((K, HORIZON, dims["dim_control"])) * dims["sigmas"]).astype(
        np.float32)


def _racing_start(env_reset):
    return (np.asarray(env_reset) + np.array([0.1, -0.1, 0.05, 5.0])).astype(np.float32)


def _jax_top(name, out_path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
    from mppi_playground_tpu.core.fused_solver import make_fused_solver as jax_fused

    if name == "racing":
        from mppi_playground_tpu.envs.racing_env import RacingEnv
        from mppi_playground_tpu.models import racing_mpcc

        env = RacingEnv()
        task, dyn = racing_mpcc.make_racing_fused_task_from_env(env), env.dynamics
        x0 = _racing_start(env.reset())
        xref, _ = racing_mpcc.calc_ref_trajectory(
            jnp.asarray(x0), env.racing_center_path, jnp.asarray(0, jnp.int32), HORIZON)
        info = {"reference_path": xref}
    else:
        from mppi_playground_tpu.envs.navigation_2d import Navigation2DEnv

        nav_env = Navigation2DEnv()
        task, dyn, _ = _jax_plug(name, nav_env)
        x0 = np.asarray(nav_env.reset() if name == "navigation" else DIMS[name][1], np.float32)
        info = {}
    solver = jax_fused(JaxConfig(**_config(name)), task, dyn, jit=True, donate_state=False,
                       interpret=True)
    noise = jnp.asarray(_noise(name))
    r = solver.solve(solver.init(), jnp.asarray(x0), info=info, noise=noise)
    states, weights = solver.top_samples(r.aux, TOP, noise=noise)
    np.savez(out_path, x0=x0, top_states=np.asarray(states), top_weights=np.asarray(weights),
             top_rows=np.asarray(jax.lax.top_k(r.aux.weights, TOP)[1]))


def jax_top_racing(out_path: str) -> None:
    """Subprocess body: the JAX fused solver's top samples, racing."""
    _jax_top("racing", out_path)


def jax_top_navigation(out_path: str) -> None:
    """Subprocess body: the JAX fused solver's top samples, Navigation2D."""
    _jax_top("navigation", out_path)


def jax_top_pendulum(out_path: str) -> None:
    """Subprocess body: the JAX fused solver's top samples, the pendulum."""
    _jax_top("pendulum", out_path)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    return run_jax_references("tests.test_torch_top_rollouts",
                              [f"jax_top_{name}" for name in MODELS],
                              tmp_path_factory.mktemp("jax_top_rollouts"))


@pytest.fixture(scope="module")
def nav_env():
    from mppi_playground_tpu_torch.envs.navigation_2d import Navigation2DEnv

    return Navigation2DEnv(device="cpu")


@pytest.fixture(scope="module")
def racing_env():
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv

    return RacingEnv(device="cpu")


def _port(name, nav_env, racing_env, **kw):
    """``(fused solver, unfused solver, task, x0, info)`` of ``name`` on the CPU."""
    if name == "racing":
        from mppi_playground_tpu_torch.models.racing_mpcc import (
            calc_ref_trajectory,
            make_mpcc_cost,
            make_racing_fused_task_from_env,
        )

        env = racing_env
        task, dyn = make_racing_fused_task_from_env(env), env.dynamics
        cost = make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map)
        x0 = torch.from_numpy(_racing_start(env.reset()))
        xref, _ = calc_ref_trajectory(x0, env.racing_center_path, torch.tensor(0), HORIZON)
        info = {"reference_path": xref}
    else:
        task, dyn, cost = _port_plug(name, nav_env)
        x0 = nav_env.reset() if name == "navigation" else torch.tensor(DIMS[name][1])
        info = {}
    fused = make_fused_solver(MPPIConfig(**_config(name, **kw)), task, dyn, device="cpu")
    unfused = make_solver(MPPIConfig(**_config(name, store_rollouts=True, **kw)), dyn, cost,
                          device="cpu")
    return fused, unfused, task, x0.to(torch.float32), info


def _sampling(solver):
    cfg = solver.config
    return (tuple(cfg.sigmas), tuple(cfg.u_min), tuple(cfg.u_max), cfg.num_samples,
            cfg.inherited_samples)


@pytest.mark.parametrize("name", MODELS)
def test_top_rollouts_twin_matches_jax_fused_top_samples(jax_refs, nav_env, racing_env, name):
    ref = jax_refs[f"jax_top_{name}"]
    fused, _, task, x0, info = _port(name, nav_env, racing_env)
    np.testing.assert_array_equal(x0.numpy(), ref["x0"])
    noise = torch.from_numpy(_noise(name))
    r = fused.solve(fused.init(), x0, info=info, noise=noise)
    states, weights = fused.top_samples(r.aux, TOP, noise=noise)
    assert states.shape == (TOP, HORIZON + 1, fused.config.dim_state)
    np.testing.assert_allclose(weights.numpy(), ref["top_weights"], atol=1e-5)
    np.testing.assert_allclose(states.numpy(), ref["top_states"], atol=5e-4)
    # the twin itself, on the rows the JAX solve chose
    rows = torch.from_numpy(ref["top_rows"].astype(np.int64))
    twin = fused_solve.fused_top_rollouts_plain(x0, r.aux.prev_action_seq, r.aux.seed, rows, task,
                                                *_sampling(fused), noise)
    np.testing.assert_allclose(twin.numpy(), ref["top_states"], atol=5e-4)


@pytest.mark.parametrize("mode", ["seeded", "noise"])
@pytest.mark.parametrize("name", MODELS)
def test_rows_outside_the_samples_are_nan(nav_env, racing_env, name, mode):
    fused, _, task, x0, _ = _port(name, nav_env, racing_env)
    m = fused.config.dim_control
    prev = torch.from_numpy((np.random.default_rng(3).standard_normal((HORIZON, m)) * 0.3)
                            .astype(np.float32))
    noise = torch.from_numpy(_noise(name)) if mode == "noise" else None
    rows = torch.tensor([K - 1, 0, K, -1, K + 7, 256, 255, 1199, 1200])
    args = (x0, prev, 1234, rows, task, *_sampling(fused), noise)
    states = fused_solve.fused_top_rollouts(*args)
    assert states.shape == (rows.shape[0], HORIZON + 1, fused.config.dim_state)
    bad, good = [2, 3, 4], [0, 1, 5, 6, 7, 8]
    assert torch.isnan(states[bad]).all() and torch.isfinite(states[good]).all()
    pert = fused_solve.fused_regen(prev, 1234, rows, *_sampling(fused), noise)
    assert torch.isnan(pert[bad]).all() and torch.isfinite(pert[good]).all()
    for i in good:  # each row is the one-sequence re-roll twin of its regenerated actions
        want = fused_solve.fused_reroll_plain(x0, pert[i], task)
        if name == "pendulum":  # torch's sin on one element and on a vector may differ by an ulp
            torch.testing.assert_close(states[i], want)
        else:
            torch.testing.assert_close(states[i], want, rtol=0, atol=0)
    assert fused_solve.fused_top_rollouts(x0, prev, 1234, rows[:0], task, *_sampling(fused),
                                          noise).shape == (0, HORIZON + 1, x0.shape[0])


def test_racing_seeded_top_samples_keep_their_values(nav_env, racing_env):
    """The racing AoS dynamics is the SoA step stacked: the AoS re-roll gives the same bits."""
    fused, _, _, x0, info = _port("racing", nav_env, racing_env)
    r = fused.solve(fused.init(), x0, info=info)
    states, weights = fused.top_samples(r.aux, TOP)
    rows = torch.sort(r.aux.weights, descending=True, stable=True).indices[:TOP]
    pert = fused_solve.fused_regen(r.aux.prev_action_seq, r.aux.seed, rows, *_sampling(fused))
    torch.testing.assert_close(states, fused.states_prediction(x0, pert), rtol=0, atol=0)
    assert bool((weights[:-1] >= weights[1:]).all())


@pytest.mark.parametrize("name", MODELS)
def test_top_samples_errors(nav_env, racing_env, name):
    fused, unfused, _, x0, info = _port(name, nav_env, racing_env)
    noise = torch.from_numpy(_noise(name))
    rf = fused.solve(fused.init(), x0, info=info, noise=noise)
    ru = unfused.solve(unfused.init(), x0, info=info, noise=noise)
    with pytest.raises(ValueError, match="injected noise"):
        fused.top_samples(rf.aux, 5)
    with pytest.raises(ValueError, match="requested top"):
        fused.top_samples(rf.aux, K + 1, noise=noise)
    with pytest.raises(ValueError, match="aux"):
        fused.top_samples(ru.aux, 5)
    seeded = fused.solve(fused.init(), x0, info=info)
    states, _ = fused.top_samples(seeded.aux, 10)
    assert states.shape == (10, HORIZON + 1, fused.config.dim_state)
    assert torch.isfinite(states).all()
