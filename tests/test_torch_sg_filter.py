"""The port's Savitzky–Golay filter against the JAX package, on the CPU.

* Coefficients: float64 on the host in both packages, the same numpy
  operations: equal bit for bit.
* The filter on random ``[T, m]`` sequences and histories, windows 1, 3, 5
  and 7: float32 contractions in two libraries, atol 1e-6 (the JAX
  package's own bar against its numpy re-derivation).
* An unfused solve with the filter on, injected noise, three chained ticks
  of the pendulum against the JAX ``make_solver``, at the JAX package's bar
  for fused against XLA (costs rtol 1e-5, weights atol 1e-5, actions and
  states atol 5e-3, ESS rtol 1e-3).  The torch pendulum is the twin in
  ``tests/test_oracle_parity.py``.
* The port's fused racing solver with the filter against its unfused
  solver, three chained ticks at T=8, K=1,500 (a padded last block), the
  same bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_playground_tpu.core import sg_filter as jax_sg
from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
from mppi_playground_tpu.core.solver import make_solver as jax_make_solver
from mppi_playground_tpu.models import pendulum
from mppi_playground_tpu_torch.core import sg_filter
from mppi_playground_tpu_torch.core.config import MPPIConfig
from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
from mppi_playground_tpu_torch.core.solver import make_solver
from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
from mppi_playground_tpu_torch.models.racing_mpcc import (
    calc_ref_trajectory,
    make_mpcc_cost,
    make_racing_fused_task_from_env,
)
from tests.test_oracle_parity import torch_pendulum_cost, torch_pendulum_dynamics

WINDOWS = [(1, 0), (3, 1), (5, 3), (7, 3), (7, 2)]


@pytest.mark.parametrize("window,poly", WINDOWS + [(9, 5), (11, 2)])
def test_coeffs_equal_jax(window, poly):
    got = sg_filter.savitzky_golay_coeffs(window, poly)
    want = jax_sg.savitzky_golay_coeffs(window, poly)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_coeffs_reject_like_jax():
    for window, poly in ((4, 3), (3, 3)):
        with pytest.raises(ValueError):
            jax_sg.savitzky_golay_coeffs(window, poly)
        with pytest.raises(ValueError):
            sg_filter.savitzky_golay_coeffs(window, poly)


@pytest.mark.parametrize("window,poly", WINDOWS)
@pytest.mark.parametrize("horizon,m", [(12, 2), (5, 1), (30, 3)])
def test_filter_matches_jax(window, poly, horizon, m):
    rng = np.random.default_rng(window * 100 + horizon)
    seq = rng.normal(size=(horizon, m)).astype(np.float32)
    hist = rng.normal(size=(horizon - 1, m)).astype(np.float32)
    coeffs = sg_filter.savitzky_golay_coeffs(window, poly)
    got = sg_filter.apply_sg_filter(torch.from_numpy(seq), torch.from_numpy(hist),
                                    torch.tensor(coeffs, dtype=torch.float32))
    want = jax_sg.apply_sg_filter(jnp.asarray(seq), jnp.asarray(hist),
                                  jnp.asarray(coeffs, jnp.float32))
    assert got.shape == (horizon, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    if window == 1:
        torch.testing.assert_close(got, torch.from_numpy(seq), rtol=0, atol=0)


def test_config_coeffs_only_when_enabled():
    base = dict(horizon=8, num_samples=16, dim_state=2, dim_control=1, u_min=(-2.0,),
                u_max=(2.0,), sigmas=(1.0,), lambda_=1.0)
    assert sg_filter.config_sg_coeffs(MPPIConfig(**base), torch.float32, "cpu") is None
    coeffs = sg_filter.config_sg_coeffs(MPPIConfig(**base, use_sg_filter=True), torch.float32,
                                        "cpu")
    np.testing.assert_allclose(coeffs.numpy(), jax_sg.savitzky_golay_coeffs(5, 3), rtol=1e-7)


def _bar(name, got, want):
    np.testing.assert_allclose(got.aux.costs.numpy(), want["costs"], rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(got.aux.weights.numpy(), want["weights"], atol=1e-5,
                               err_msg=name)
    np.testing.assert_allclose(float(got.aux.ess), float(want["ess"]), rtol=1e-3, err_msg=name)
    np.testing.assert_allclose(got.action_seq.numpy(), want["action_seq"], atol=5e-3,
                               err_msg=name)
    np.testing.assert_allclose(got.state_seq.numpy(), want["state_seq"], atol=5e-3,
                               err_msg=name)


def _as_dict(result):
    return {"costs": np.asarray(result.aux.costs), "weights": np.asarray(result.aux.weights),
            "ess": np.asarray(result.aux.ess), "action_seq": np.asarray(result.action_seq),
            "state_seq": np.asarray(result.state_seq)}


@pytest.mark.parametrize("window,poly", [(5, 3), (7, 2)])
def test_unfused_solve_with_filter_matches_jax(window, poly):
    horizon, k = 12, 400
    cfg = dict(horizon=horizon, num_samples=k, dim_state=2, dim_control=1, u_min=(-2.0,),
               u_max=(2.0,), sigmas=(1.0,), lambda_=1.0, use_sg_filter=True,
               sg_window_size=window, sg_poly_order=poly)
    jax_solver = jax_make_solver(JaxConfig(**cfg), pendulum.dynamics, pendulum.cost,
                                 donate_state=False)
    solver = make_solver(MPPIConfig(**cfg), torch_pendulum_dynamics, torch_pendulum_cost,
                         device="cpu")
    rng = np.random.default_rng(window)
    jst, st = jax_solver.init(), solver.init()
    x = np.array([np.pi - 0.3, 0.2], np.float32)
    for tick in range(3):
        noise = (rng.normal(size=(k, horizon, 1)) * 1.0).astype(np.float32)
        want = jax_solver.solve(jst, jnp.asarray(x), noise=jnp.asarray(noise))
        got = solver.solve(st, torch.tensor(x), noise=torch.from_numpy(noise))
        _bar(f"tick {tick}", got, _as_dict(want))
        np.testing.assert_allclose(got.state.sg_history.numpy(),
                                   np.asarray(want.state.sg_history), atol=5e-3)
        jst, st = want.state, got.state
        x = np.array(want.state_seq[1])
    assert jax.default_backend() == "cpu"


def test_fused_solver_with_filter_matches_unfused():
    env = RacingEnv(device="cpu")
    horizon, k = 8, 1500
    cfg = MPPIConfig(horizon=horizon, num_samples=k, dim_state=4, dim_control=2,
                     u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1), lambda_=1.0,
                     store_rollouts=False, use_sg_filter=True, sg_window_size=7,
                     sg_poly_order=3)
    fused = make_fused_solver(cfg, make_racing_fused_task_from_env(env), env.dynamics,
                              device="cpu")
    unfused = make_solver(cfg, env.dynamics,
                          make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map), device="cpu")
    rng = np.random.default_rng(11)
    st_f, st_u = fused.init(), unfused.init()
    x = env.reset() + torch.tensor([0.0, 0.0, 0.0, 4.0])
    cind = torch.tensor(0)
    for tick in range(3):
        noise = torch.from_numpy((rng.normal(size=(k, horizon, 2)) * (0.5, 0.1)).astype(np.float32))
        xref, cind = calc_ref_trajectory(x, env.racing_center_path, cind, horizon)
        rf = fused.solve(st_f, x, info={"reference_path": xref}, noise=noise)
        ru = unfused.solve(st_u, x, info={"reference_path": xref}, noise=noise)
        _bar(f"tick {tick}", rf, {k_: v.numpy() for k_, v in _as_dict_t(ru).items()})
        torch.testing.assert_close(rf.state.sg_history, ru.state.sg_history, rtol=0, atol=5e-3)
        st_f, st_u = rf.state, ru.state
        x = ru.state_seq[1]


def _as_dict_t(result):
    return {"costs": result.aux.costs, "weights": result.aux.weights, "ess": result.aux.ess,
            "action_seq": result.action_seq, "state_seq": result.state_seq}
