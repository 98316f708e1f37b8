"""The flagship racing tick of the port against the JAX package, on the CPU.

Full width of the flagship's model (T=50, n=4, m=2, racing MPCC with both
maps), K cut to 4,096.  Three chained, warm-started ticks with injected
noise go through three solvers on the same inputs:

* the port's fused solver (on the CPU it runs the kernels' plain twins),
* the port's unfused ``make_solver`` with ``make_mpcc_cost``,
* the JAX package's XLA ``make_solver`` with ``make_mpcc_cost`` and
  ``calc_ref_trajectory`` (in a subprocess with XLA's FMA contraction off,
  see tests/test_torch_fused_solve.py).

The bar is the JAX package's own: costs rtol 1e-5, weights atol 1e-5,
actions and states atol 5e-3, ESS rtol 1e-3.  At lambda=1 the racing ESS is
about 1, so the weights test the argmin.  A cost that differs by a map-cell
flip (a jump of Qo = 1e4) fails the cost bar and is named in the message.

Auto-lambda, at K=1500 (a padded last block) and the same width: three
chained ticks per mode of the port's fused solver (CPU twins) and its
unfused solver, and one tick from the JAX state carried over by
``utils/convert``, against the JAX package's fused solver in interpret mode
on its standalone two-phase route (``lambda_epilogue=False``) for ESSPS
and LBPS.  MPO is held against the JAX XLA solver: MPO weighs in the
single-pass kernel, which at T=50 takes the JAX package over eight minutes
to compile in interpret mode on a CPU (that kernel is held against the JAX
fused kernel at T=8 in tests/test_torch_fused_solve.py).  The bar is the
JAX package's for its fused auto-lambda against XLA
(tests/test_fused_solve.py): costs rtol 1e-3, lambda rtol 1e-2, actions
atol 5e-3, the next state's lambda rtol 1e-2.
"""

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch.core.config import MPPIConfig
from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
from mppi_playground_tpu_torch.core.solver import make_solver
from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
from mppi_playground_tpu_torch.models.racing_mpcc import (
    calc_ref_trajectory,
    make_mpcc_cost,
    make_racing_fused_task_from_env,
)
from mppi_playground_tpu_torch.utils import convert
from mppi_playground_tpu_torch.workloads import build_flagship
from tests.test_torch_fused_solve import run_jax_references

HORIZON = 50
K = 4096
TICKS = 3
AUTO_K = 1500
AUTO_MODES = ("ESSPS", "LBPS", "MPO")
CONFIG = dict(horizon=HORIZON, num_samples=K, dim_state=4, dim_control=2,
              u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1), lambda_=1.0,
              store_rollouts=False)


def jax_flagship_reference(out_path: str) -> None:
    """Subprocess body: three chained JAX XLA ticks and their inputs."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
    from mppi_playground_tpu.core.solver import make_solver as jax_make_solver
    from mppi_playground_tpu.envs.racing_env import RacingEnv as JaxRacingEnv
    from mppi_playground_tpu.models import racing_mpcc

    assert jax.default_backend() == "cpu"
    env = JaxRacingEnv()
    cost = racing_mpcc.make_mpcc_cost(env.obstacle_map.device_map, env.lane_map.device_map)
    solver = jax_make_solver(JaxConfig(**CONFIG), env.dynamics, cost, jit=True,
                             donate_state=False)
    rng = np.random.default_rng(2024)
    state = solver.init()
    x = np.asarray(env.reset())
    cind = jnp.asarray(0, jnp.int32)
    out = {}
    for i in range(TICKS):
        noise = (rng.standard_normal((K, HORIZON, 2)) * CONFIG["sigmas"]).astype(np.float32)
        xref, cind = racing_mpcc.calc_ref_trajectory(
            jnp.asarray(x), env.racing_center_path, cind, HORIZON
        )
        r = solver.solve(state, jnp.asarray(x), info={"reference_path": xref},
                         noise=jnp.asarray(noise))
        for name, value in dict(x=x, noise=noise, xref=xref, cind=cind, costs=r.aux.costs,
                                weights=r.aux.weights, ess=r.aux.ess, action_seq=r.action_seq,
                                state_seq=r.state_seq, prev=state.previous_action_seq,
                                sg_history=state.sg_history, lam=state.lam).items():
            out[f"{i}_{name}"] = np.asarray(value)
        state = r.state
        x = np.asarray(r.state_seq[1])
    np.savez(out_path, **out)


def _jax_auto_reference(mode: str, out_path: str) -> None:
    """Subprocess body: three chained JAX ticks under one auto-lambda mode."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
    from mppi_playground_tpu.core.fused_solver import make_fused_solver as jax_make_fused
    from mppi_playground_tpu.core.solver import make_solver as jax_make_solver
    from mppi_playground_tpu.envs.racing_env import RacingEnv as JaxRacingEnv
    from mppi_playground_tpu.models import racing_mpcc

    env = JaxRacingEnv()
    cfg = JaxConfig(**dict(CONFIG, num_samples=AUTO_K, lambda_=mode))
    if mode == "MPO":
        cost = racing_mpcc.make_mpcc_cost(env.obstacle_map.device_map, env.lane_map.device_map)
        solver = jax_make_solver(cfg, env.dynamics, cost, jit=True, donate_state=False)
    else:
        solver = jax_make_fused(cfg, racing_mpcc.make_racing_fused_task_from_env(env),
                                env.dynamics, jit=True, donate_state=False, interpret=True,
                                lambda_epilogue=False)
    rng = np.random.default_rng(77)
    state = solver.init()
    x = np.asarray(env.reset())
    cind = jnp.asarray(0, jnp.int32)
    out = {}
    for i in range(TICKS):
        noise = (rng.standard_normal((AUTO_K, HORIZON, 2)) * CONFIG["sigmas"]).astype(np.float32)
        xref, cind = racing_mpcc.calc_ref_trajectory(
            jnp.asarray(x), env.racing_center_path, cind, HORIZON
        )
        r = solver.solve(state, jnp.asarray(x), info={"reference_path": xref},
                         noise=jnp.asarray(noise))
        values = dict(x=x, noise=noise, xref=xref, cind=cind, costs=r.aux.costs, lam=r.aux.lam,
                      next_lam=r.state.lam, action_seq=r.action_seq,
                      prev=state.previous_action_seq,
                      sg_history=state.sg_history, state_lam=state.lam,
                      log_t=state.mpo_log_temperature)
        if mode == "MPO":
            adam = state.mpo_opt_state[0]
            values.update(count=adam.count, mu=adam.mu, nu=adam.nu)
        for name, value in values.items():
            out[f"{i}_{name}"] = np.asarray(value)
        state = r.state
        x = np.asarray(r.state_seq[1])
    np.savez(out_path, **out)


def jax_essps_reference(out_path: str) -> None:
    _jax_auto_reference("ESSPS", out_path)


def jax_lbps_reference(out_path: str) -> None:
    _jax_auto_reference("LBPS", out_path)


def jax_mpo_reference(out_path: str) -> None:
    _jax_auto_reference("MPO", out_path)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """Every JAX reference of this file, computed at once in parallel subprocesses."""
    return run_jax_references(
        "tests.test_torch_flagship",
        ["jax_flagship_reference"] + [f"jax_{m.lower()}_reference" for m in AUTO_MODES],
        tmp_path_factory.mktemp("jax_flagship"),
    )


@pytest.fixture(scope="module")
def jax_ref(jax_refs):
    return jax_refs["jax_flagship_reference"]


@pytest.fixture(scope="module")
def env():
    return RacingEnv(device="cpu")


def _compare(name, got, want):
    """The bar; a map-cell flip shows as a cost jump of about 1e4."""
    gc, wc = got.aux.costs.numpy(), want["costs"]
    rel = np.abs(gc - wc) / np.abs(wc)
    bad = np.flatnonzero(rel > 1e-5)
    assert bad.size == 0, (
        f"{name}: {bad.size} costs off the bar, jumps {np.abs(gc - wc)[bad][:5]} "
        f"(1e4 = one map cell flipped)"
    )
    np.testing.assert_allclose(gc, wc, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(got.aux.weights.numpy(), want["weights"], atol=1e-5,
                               err_msg=name)
    np.testing.assert_allclose(float(got.aux.ess), float(want["ess"]), rtol=1e-3, err_msg=name)
    np.testing.assert_allclose(got.action_seq.numpy(), want["action_seq"], atol=5e-3,
                               err_msg=name)
    np.testing.assert_allclose(got.state_seq.numpy(), want["state_seq"], atol=5e-3,
                               err_msg=name)


def test_flagship_ticks_match_jax_xla(jax_ref, env):
    cfg = MPPIConfig(**CONFIG)
    fused = make_fused_solver(cfg, make_racing_fused_task_from_env(env), env.dynamics,
                              device="cpu")
    unfused = make_solver(cfg, env.dynamics,
                          make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map),
                          device="cpu")
    st_f, st_u = fused.init(), unfused.init()
    cind = torch.tensor(0)
    for i in range(TICKS):
        ref = {k.split("_", 1)[1]: v for k, v in jax_ref.items() if k.startswith(f"{i}_")}
        x = torch.from_numpy(np.array(ref["x"]))
        xref, cind = calc_ref_trajectory(x, env.racing_center_path, cind, HORIZON)
        np.testing.assert_array_equal(xref.numpy(), ref["xref"])  # tolerance 0
        assert int(cind) == int(ref["cind"])
        noise = torch.from_numpy(np.array(ref["noise"]))
        rf = fused.solve(st_f, x, info={"reference_path": xref}, noise=noise)
        ru = unfused.solve(st_u, x, info={"reference_path": xref}, noise=noise)
        _compare(f"tick {i}: fused vs JAX", rf, ref)
        _compare(f"tick {i}: unfused vs JAX", ru, ref)
        _compare(f"tick {i}: fused vs unfused", rf, {
            "costs": ru.aux.costs.numpy(), "weights": ru.aux.weights.numpy(),
            "ess": ru.aux.ess.numpy(), "action_seq": ru.action_seq.numpy(),
            "state_seq": ru.state_seq.numpy(),
        })
        assert rf.state.tick == ru.state.tick == i + 1
        # the same tick from the JAX solver's own warm start, carried over
        jax_state = convert.mppi_state(ref["prev"], ref["sg_history"], ref["lam"], tick=i,
                                       device="cpu")
        _compare(f"tick {i}: fused from the JAX state vs JAX",
                 fused.solve(jax_state, x, info={"reference_path": xref}, noise=noise), ref)
        st_f, st_u = rf.state, ru.state


def test_build_flagship_closed_loop_on_cpu(env):
    """The seeded path end to end through the public entry point, cut to K=1024."""
    env, solver, tick = build_flagship(num_samples=1024, env=env, device="cpu")
    assert solver.config.horizon == 50 and solver.device == torch.device("cpu")
    state = solver.init()
    x = env.reset()
    cind = torch.tensor(0)
    seen = []
    for _ in range(4):
        action_seq, state_seq, state, new_cind = tick(state, cind, x)
        assert action_seq.shape == (50, 2) and state_seq.shape == (51, 4)
        assert torch.isfinite(action_seq).all() and torch.isfinite(state_seq).all()
        # a weighted mean of clamped samples, rounded in float32: a few ulp over
        assert (action_seq >= env.u_min - 1e-5).all() and (action_seq <= env.u_max + 1e-5).all()
        assert int(new_cind) >= int(cind)
        cind = new_cind
        x, _ = env.step(action_seq[0])
        seen.append(action_seq[0].clone())
    assert state.tick == 4
    assert not torch.equal(seen[0], seen[1])  # a fresh noise stream each tick
    # the same seed replays the same ticks
    _, _, first, _ = tick(solver.init(), torch.tensor(0), env.reset())
    _, _, again, _ = tick(solver.init(), torch.tensor(0), env.reset())
    torch.testing.assert_close(first.previous_action_seq, again.previous_action_seq,
                               rtol=0, atol=0)


def _auto_compare(name, got, want):
    """The JAX package's bar for fused auto-lambda against XLA."""
    np.testing.assert_allclose(got.aux.costs.numpy(), want["costs"], rtol=1e-3, err_msg=name)
    np.testing.assert_allclose(float(got.aux.lam), float(want["lam"]), rtol=1e-2, err_msg=name)
    np.testing.assert_allclose(got.action_seq.numpy(), want["action_seq"], atol=5e-3,
                               err_msg=name)
    np.testing.assert_allclose(float(got.state.lam), float(want["next_lam"]), rtol=1e-2,
                               err_msg=name)


@pytest.mark.parametrize("mode", AUTO_MODES)
def test_auto_lambda_ticks_match_jax(jax_refs, env, mode):
    refs = jax_refs[f"jax_{mode.lower()}_reference"]
    cfg = MPPIConfig(**dict(CONFIG, num_samples=AUTO_K, lambda_=mode))
    fused = make_fused_solver(cfg, make_racing_fused_task_from_env(env), env.dynamics,
                              device="cpu")
    unfused = make_solver(cfg, env.dynamics,
                          make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map), device="cpu")
    st_f, st_u = fused.init(), unfused.init()
    assert float(st_f.mpo_log_temperature) == float(refs["0_log_t"]) == 0.0
    cind = torch.tensor(0)
    for i in range(TICKS):
        ref = {k.split("_", 1)[1]: v for k, v in refs.items() if k.startswith(f"{i}_")}
        x = torch.from_numpy(np.array(ref["x"]))
        xref, cind = calc_ref_trajectory(x, env.racing_center_path, cind, HORIZON)
        np.testing.assert_array_equal(xref.numpy(), ref["xref"])  # tolerance 0
        noise = torch.from_numpy(np.array(ref["noise"]))
        info = {"reference_path": xref}
        rf = fused.solve(st_f, x, info=info, noise=noise)
        ru = unfused.solve(st_u, x, info=info, noise=noise)
        _auto_compare(f"{mode} tick {i}: fused vs JAX", rf, ref)
        _auto_compare(f"{mode} tick {i}: unfused vs JAX", ru, ref)
        if i == 1:  # the same tick from the JAX solver's own state, carried over
            adam = (ref["count"], ref["mu"], ref["nu"]) if mode == "MPO" else None
            jax_state = convert.mppi_state(ref["prev"], ref["sg_history"], ref["state_lam"],
                                           tick=i, device="cpu", mpo_log_temperature=ref["log_t"],
                                           mpo_opt_state=adam)
            _auto_compare(f"{mode} tick {i}: fused from the JAX state vs JAX",
                          fused.solve(jax_state, x, info=info, noise=noise), ref)
        if mode != "MPO":
            assert cfg.lambda_min <= float(rf.aux.lam) <= cfg.lambda_max
            assert float(rf.state.lam) == float(rf.aux.lam)
        st_f, st_u = rf.state, ru.state


@pytest.mark.parametrize("change,error", [
    ({"lambda_": "MPO"}, None),
    ({"lambda_": "LBPS"}, None),
    ({"lambda_": "ESSPS"}, None),
    ({"use_sg_filter": True}, None),
    ({"store_rollouts": True}, ValueError),
    ({"horizon": 513}, ValueError),
    ({"dim_state": 3}, ValueError),
    ({"dtype": torch.float64}, ValueError),
    ({"lambda_": "ESSPS", "lambda_epilogue": True}, None),
])
def test_fused_solver_envelope(env, change, error):
    """What the fused solver builds and runs, and what it refuses (``error``)."""
    change = dict(change)
    kwargs = {"lambda_epilogue": change.pop("lambda_epilogue", None)}
    cfg = MPPIConfig(**dict(CONFIG, **change))
    task = make_racing_fused_task_from_env(env)
    if error is not None:
        with pytest.raises(error):
            make_fused_solver(cfg, task, env.dynamics, device="cpu", **kwargs)
        return
    solver = make_fused_solver(cfg, task, env.dynamics, device="cpu", **kwargs)
    x = env.reset()
    xref, _ = calc_ref_trajectory(x, env.racing_center_path, torch.tensor(0), HORIZON)
    result = solver.solve(solver.init(), x, info={"reference_path": xref})
    lam = float(result.state.lam)
    assert result.action_seq.shape == (HORIZON, 2) and torch.isfinite(result.action_seq).all()
    assert np.isfinite(lam) and lam > 0.0
    if cfg.lambda_ != "MPO":
        assert cfg.lambda_min <= lam <= cfg.lambda_max
