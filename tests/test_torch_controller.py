"""The port's controller facades against the JAX package's, on the CPU.

* ``MPPI``: three chained ``forward(state, info, noise)`` calls on the
  pendulum (the torch twin of ``tests/test_oracle_parity.py``) and on the
  racing dynamics with the MPCC cost through ``info``, at a fixed lambda
  and under ESSPS; ``reset`` keeps the adapted lambda, and the tick after
  it matches the JAX tick after its reset.
* ``RacingController`` at T=25, K=512 against the JAX
  ``RacingController(solver_backend="xla")``: three chained ``update``
  calls on injected noise, through the port's unfused route (its default)
  and its fused route (``store_rollouts=False``).
* The map-mutation rebuild, the two env attributes the controller reads
  (``ObstacleMap.version``, ``RacingEnv.V_MAX``), and what the facades
  refuse.

The racing references run in a subprocess with XLA's FMA contraction off
(see tests/test_torch_fused_solve.py), so that their costs round as the
port's do.  Bars: the JAX package's for fused against XLA (costs rtol 1e-5,
weights atol 1e-5, actions and states atol 5e-3, ESS rtol 1e-3), and under
ESSPS its bar for fused auto-lambda against XLA (costs rtol 1e-3, lambda
rtol 1e-2, actions atol 5e-3); reference rows and path indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_playground_tpu import MPPI as JaxMPPI
from mppi_playground_tpu.envs.racing_env import RacingEnv as JaxRacingEnv
from mppi_playground_tpu.maps.obstacle_map import ObstacleMap as JaxObstacleMap
from mppi_playground_tpu.models import pendulum
from mppi_playground_tpu_torch import MPPI
from mppi_playground_tpu_torch.envs import RacingController, RacingEnv
from mppi_playground_tpu_torch.maps.obstacle_map import ObstacleMap
from mppi_playground_tpu_torch.models.racing_mpcc import (
    calc_ref_trajectory,
    make_mpcc_cost,
    make_racing_fused_task_from_env,
)
from tests.test_oracle_parity import torch_pendulum_cost, torch_pendulum_dynamics
from tests.test_torch_fused_solve import run_jax_references

TICKS = 3
RC_T, RC_K = 25, 512
MPPI_T, MPPI_K = 8, 1000
SIGMAS = (0.5, 0.1)
MODES = (1.0, "ESSPS")


def _racing_mppi_kwargs(mode):
    return dict(horizon=MPPI_T, num_samples=MPPI_K, dim_state=4, dim_control=2,
                u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=SIGMAS, lambda_=mode)


def jax_racing_reference(out_path: str) -> None:
    """Subprocess body: JAX ``RacingController`` and racing ``MPPI`` ticks."""
    jax.config.update("jax_platforms", "cpu")
    from mppi_playground_tpu.envs.racing_controller import RacingController as JaxController
    from mppi_playground_tpu.models import racing_mpcc

    env = JaxRacingEnv()
    out = {}
    ctrl = JaxController(env, horizon=RC_T, num_samples=RC_K, solver_backend="xla")
    rng = np.random.default_rng(31)
    x = np.asarray(env.reset())
    for i in range(TICKS):
        noise = (rng.standard_normal((RC_K, RC_T, 2)) * SIGMAS).astype(np.float32)
        a, s = ctrl.update(jnp.asarray(x), noise=jnp.asarray(noise))
        for name, v in dict(x=x, noise=noise, action_seq=a, state_seq=s,
                            reference_path=ctrl.reference_path,
                            cind=ctrl.current_path_index).items():
            out[f"rc{i}_{name}"] = np.asarray(v)
        x = np.asarray(s[1])

    cost = racing_mpcc.make_mpcc_cost(env.obstacle_map.device_map, env.lane_map.device_map)
    for m, mode in enumerate(MODES):
        c = JaxMPPI(dynamics=env.dynamics, cost_func=cost, **_racing_mppi_kwargs(mode))
        rng = np.random.default_rng(40 + m)
        x = np.asarray(env.reset())
        cind = jnp.asarray(0, jnp.int32)
        for i in range(TICKS + 1):
            if i == TICKS:  # one more tick after a reset
                out[f"m{m}_lam_before_reset"] = np.asarray(c.lambda_)
                c.reset()
            noise = (rng.standard_normal((MPPI_K, MPPI_T, 2)) * SIGMAS).astype(np.float32)
            xref, cind = racing_mpcc.calc_ref_trajectory(jnp.asarray(x), env.racing_center_path,
                                                         cind, MPPI_T)
            a, s = c.forward(jnp.asarray(x), info={"reference_path": xref},
                             noise=jnp.asarray(noise))
            aux = c._last_aux
            for name, v in dict(x=x, noise=noise, xref=xref, action_seq=a, state_seq=s,
                                costs=aux.costs, weights=aux.weights, ess=aux.ess, lam=aux.lam,
                                next_lam=c.solver_state.lam).items():
                out[f"m{m}_{i}_{name}"] = np.asarray(v)
            x = np.asarray(s[1])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax_references("tests.test_torch_controller", ["jax_racing_reference"],
                              tmp_path_factory.mktemp("jax_controller"))["jax_racing_reference"]


@pytest.fixture(scope="module")
def env():
    return RacingEnv(device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _tick_bar(name, mode, c, action_seq, state_seq, want):
    aux = c._last_aux
    if mode == "ESSPS":
        np.testing.assert_allclose(aux.costs.numpy(), want["costs"], rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(float(aux.lam), float(want["lam"]), rtol=1e-2, err_msg=name)
        np.testing.assert_allclose(float(c.solver_state.lam), float(want["next_lam"]), rtol=1e-2,
                                   err_msg=name)
    else:
        np.testing.assert_allclose(aux.costs.numpy(), want["costs"], rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(aux.weights.numpy(), want["weights"], atol=1e-5, err_msg=name)
        np.testing.assert_allclose(float(aux.ess), float(want["ess"]), rtol=1e-3, err_msg=name)
    np.testing.assert_allclose(action_seq.numpy(), want["action_seq"], atol=5e-3, err_msg=name)
    np.testing.assert_allclose(state_seq.numpy(), want["state_seq"], atol=5e-3, err_msg=name)


@pytest.mark.parametrize("m", [0, 1], ids=["fixed", "ESSPS"])
def test_mppi_racing_forward_matches_jax(jax_ref, env, m):
    mode = MODES[m]
    c = MPPI(dynamics=env.dynamics,
             cost_func=make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map),
             device="cpu", **_racing_mppi_kwargs(mode))
    assert c.solver_backend == "xla"
    for i in range(TICKS + 1):
        want = {k.split("_", 2)[2]: v for k, v in jax_ref.items() if k.startswith(f"m{m}_{i}_")}
        if i == TICKS:
            lam = c.lambda_
            np.testing.assert_allclose(lam, float(jax_ref[f"m{m}_lam_before_reset"]), rtol=1e-2)
            c.reset()
            assert c.lambda_ == lam  # the adapted temperature persists
            assert float(c.solver_state.previous_action_seq.abs().sum()) == 0.0
        x = _t(want["x"])
        a, s = c.forward(x, info={"reference_path": _t(want["xref"])}, noise=_t(want["noise"]))
        _tick_bar(f"{mode} tick {i}", mode, c, a, s, want)


def _pendulum_kwargs(mode):
    return dict(horizon=10, num_samples=300, dim_state=2, dim_control=1, u_min=(-2.0,),
                u_max=(2.0,), sigmas=(1.0,), lambda_=mode)


@pytest.mark.parametrize("mode", [1.0, "ESSPS", "MPO"])
def test_mppi_pendulum_forward_and_reset_match_jax(mode):
    want_c = JaxMPPI(dynamics=pendulum.dynamics, cost_func=pendulum.cost,
                     **_pendulum_kwargs(mode))
    got_c = MPPI(dynamics=torch_pendulum_dynamics, cost_func=torch_pendulum_cost, device="cpu",
                 **_pendulum_kwargs(mode))
    rng = np.random.default_rng(12)
    x = np.array([np.pi - 0.2, 0.1], np.float32)
    for i in range(TICKS + 1):
        if i == TICKS:
            lam = got_c.lambda_
            log_t = float(got_c.solver_state.mpo_log_temperature)
            want_c.reset()
            got_c.reset()
            assert got_c.lambda_ == lam
            assert float(got_c.solver_state.mpo_log_temperature) == log_t
            assert float(got_c.solver_state.previous_action_seq.abs().sum()) == 0.0
            np.testing.assert_allclose(lam, want_c.lambda_, rtol=1e-2)
        noise = (rng.standard_normal((300, 10, 1))).astype(np.float32)
        wa, ws = want_c.forward(jnp.asarray(x), noise=jnp.asarray(noise))
        ga, gs = got_c.forward(torch.tensor(x), noise=torch.from_numpy(noise))
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), atol=5e-3, err_msg=f"tick {i}")
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=5e-3, err_msg=f"tick {i}")
        np.testing.assert_allclose(got_c.lambda_, want_c.lambda_, rtol=1e-2, err_msg=f"tick {i}")
        x = np.array(ws[1])
    if mode != "MPO":
        assert got_c.lambda_ > 0
    else:
        assert got_c.lambda_ != 1.0  # MPO adapted it


def test_mppi_rejects_like_jax():
    kw = dict(_pendulum_kwargs(1.0), dynamics=torch_pendulum_dynamics,
              cost_func=torch_pendulum_cost, device="cpu")
    with pytest.raises(ValueError):
        JaxMPPI(dynamics=pendulum.dynamics, cost_func=pendulum.cost, **_pendulum_kwargs("NOPE"))
    with pytest.raises(ValueError):
        MPPI(**dict(kw, lambda_="NOPE"))
    c = MPPI(**kw)
    with pytest.raises(ValueError, match="dim_state"):
        c.forward(torch.zeros(1, 2))
    with pytest.raises(ValueError, match="posterior samples"):
        c.get_samples_from_posterior(torch.zeros(10, 1), torch.zeros(2), num_samples=10**9)


def test_mppi_fused_route(env):
    task = make_racing_fused_task_from_env(env)
    kw = dict(_racing_mppi_kwargs(1.0), dynamics=env.dynamics,
              cost_func=make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map), device="cpu")
    with pytest.raises(ValueError, match="store_rollouts=False"):
        MPPI(fused_task=task, **kw)
    with pytest.raises(TypeError, match="RacingFusedTask"):
        MPPI(fused_task=object(), store_rollouts=False, **kw)
    # outside the fused envelope (T*m > 1024): the unfused route, chosen from the config
    wide = MPPI(fused_task=task, store_rollouts=False, **dict(kw, horizon=600))
    assert wide.solver_backend == "xla"
    fused = MPPI(fused_task=task, store_rollouts=False, **kw)
    unfused = MPPI(**kw)
    assert (fused.solver_backend, unfused.solver_backend) == ("fused", "xla")
    rng = np.random.default_rng(8)
    x = env.reset() + torch.tensor([0.0, 0.0, 0.0, 3.0])
    xref, _ = calc_ref_trajectory(x, env.racing_center_path, torch.tensor(0), MPPI_T)
    for _ in range(2):
        noise = torch.from_numpy((rng.standard_normal((MPPI_K, MPPI_T, 2)) * SIGMAS)
                                 .astype(np.float32))
        fa, fs = fused.forward(x, info={"reference_path": xref}, noise=noise)
        ua, us = unfused.forward(x, info={"reference_path": xref}, noise=noise)
        np.testing.assert_allclose(fa.numpy(), ua.numpy(), atol=5e-3)
        np.testing.assert_allclose(fs.numpy(), us.numpy(), atol=5e-3)
    seqs_f, w_f = fused.get_top_samples(50)
    seqs_u, w_u = unfused.get_top_samples(50)
    np.testing.assert_allclose(w_f.numpy(), w_u.numpy(), atol=1e-5)
    np.testing.assert_allclose(seqs_f.numpy(), seqs_u.numpy(), atol=5e-4)


@pytest.mark.parametrize("store_rollouts", [True, False], ids=["unfused", "fused"])
def test_racing_controller_matches_jax(jax_ref, env, store_rollouts):
    ctrl = RacingController(env, horizon=RC_T, num_samples=RC_K, store_rollouts=store_rollouts)
    assert ctrl.solver_backend == ("xla" if store_rollouts else "fused")
    assert ctrl.config.lambda_ == 1.0 and ctrl.config.sigmas == SIGMAS
    for i in range(TICKS):
        want = {k.split("_", 1)[1]: v for k, v in jax_ref.items() if k.startswith(f"rc{i}_")}
        a, s = ctrl.update(_t(want["x"]), noise=_t(want["noise"]))
        name = f"{ctrl.solver_backend} tick {i}"
        np.testing.assert_array_equal(ctrl.reference_path.numpy(), want["reference_path"],
                                      err_msg=name)
        assert int(ctrl.current_path_index) == int(want["cind"]), name
        np.testing.assert_allclose(a.numpy(), want["action_seq"], atol=5e-3, err_msg=name)
        np.testing.assert_allclose(s.numpy(), want["state_seq"], atol=5e-3, err_msg=name)
        seqs, w = ctrl.get_top_samples(300)
        assert seqs.shape == (300, RC_T + 1, 4) and bool((w[:-1] >= w[1:]).all())
    ctrl.reset()
    assert int(ctrl.current_path_index) == 0 and ctrl.reference_path is None
    with pytest.raises(RuntimeError, match="prior update"):
        ctrl.get_top_samples()


def test_racing_controller_defaults_and_routes(env):
    ctrl = RacingController(env)
    cfg = ctrl.config
    assert (cfg.horizon, cfg.num_samples, cfg.sigmas, cfg.lambda_) == (25, 4000, SIGMAS, 1.0)
    assert cfg.store_rollouts and ctrl.solver_backend == "xla"
    assert RacingController(env, store_rollouts=False).solver_backend == "fused"
    assert RacingController(env, store_rollouts=False, dtype=torch.float64).solver_backend == "xla"
    with pytest.raises(ValueError, match="store rollouts"):
        RacingController(env, solver_backend="fused")
    with pytest.raises(ValueError, match="solver_backend"):
        RacingController(env, solver_backend="pallas")


@pytest.mark.parametrize("kernel_backend", ["auto", "pallas"])
def test_float64_on_the_card_needs_the_plain_route(monkeypatch, kernel_backend):
    """The weighted-update kernel takes float32: a float64 unfused solver on the card raises.

    The raise comes before any tensor is made, so a card that is only
    reported present is enough to reach it.
    """
    from mppi_playground_tpu_torch.core.config import MPPIConfig
    from mppi_playground_tpu_torch.core.solver import make_solver

    cfg = MPPIConfig(horizon=4, num_samples=8, dim_state=2, dim_control=1, u_min=(-2.0,),
                     u_max=(2.0,), sigmas=(1.0,), lambda_=1.0, dtype=torch.float64,
                     kernel_backend=kernel_backend)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="kernel_backend='xla'"):
        make_solver(cfg, torch_pendulum_dynamics, torch_pendulum_cost, device="cuda")


@pytest.mark.parametrize("store_rollouts", [True, False], ids=["unfused", "fused"])
def test_racing_controller_rebuilds_on_map_mutation(store_rollouts):
    """Same state and noise, only the map changed: the costs see the new obstacle."""
    env = RacingEnv(device="cpu")  # fresh: this test mutates its map
    ctrl = RacingController(env, horizon=6, num_samples=128, store_rollouts=store_rollouts)
    x0 = env.reset()
    st0 = ctrl.solver_state
    noise = torch.from_numpy(np.random.default_rng(3).normal(size=(128, 6, 2))
                             .astype(np.float32)) * torch.tensor([0.5, 0.1])
    ctrl.update(x0, noise=noise)
    c1 = ctrl._last_aux.costs.clone()
    solver_before = ctrl._solver
    v0 = env.obstacle_map.version
    env.obstacle_map.add_circle_obstacle(x0[:2].numpy().astype(float), 1.0)
    assert env.obstacle_map.version == v0 + 1
    ctrl.solver_state = st0
    ctrl.current_path_index = torch.tensor(0)
    ctrl.update(x0, noise=noise)
    assert ctrl._solver is not solver_before
    assert bool((ctrl._last_aux.costs > c1 + 1e3).all())


def test_obstacle_map_version_counts_like_jax():
    ours = ObstacleMap(map_size=(20, 20), cell_size=0.1, device="cpu")
    theirs = JaxObstacleMap(map_size=(20, 20), cell_size=0.1)
    assert ours.version == theirs.version == 0
    for m in (ours, theirs):
        m.add_circle_obstacle(np.array([1.0, 2.0]), 0.5)
        m.add_rectangle_obstacle(np.array([-3.0, 1.0]), 1.0, 2.0)
        m.add_circle_obstacle(np.array([4.0, -2.0]), 0.7)
    assert ours.version == theirs.version == 3
    np.testing.assert_array_equal(ours.grid, theirs.device_map.grid)
    with pytest.raises(ValueError):
        ours.add_circle_obstacle(np.array([0.0, 0.0]), -1.0)
    assert ours.version == 3  # a refused obstacle is no mutation


def test_racing_env_v_max_like_jax(env):
    assert env.V_MAX == JaxRacingEnv().V_MAX == 8.0


def test_mppi_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MPPI(dynamics=torch_pendulum_dynamics, cost_func=torch_pendulum_cost,
             **_pendulum_kwargs(1.0))
