"""The port's fleet on the CPU: scenario-batched solvers and the fleet loop.

* Against the JAX package, on injected noise made with numpy from a seed,
  the JAX references run in subprocesses with XLA's FMA contraction off
  (``tests/test_torch_fused_solve.run_jax_references``), at T=8:
  - ``make_batched_fused_solver`` (racing, fixed λ, per-scenario reference
    paths, K=1,500) against the JAX ``make_batched_fused_solver`` at mesh
    (1, 1): costs at the single solver's bar (rtol 2e-5, atol 1e-5: each
    side extends the reference rows with its own sin and cos), and bitwise
    from the JAX rows; weights atol 1e-5, actions and states atol 5e-3;
  - the same under ESSPS (the batched λ epilogue), λ* and the next λ at the
    JAX package's fused auto-λ bar (rtol 1e-2);
  - ``make_batched_solver`` with ``batched_info`` (each scenario's goal)
    against the JAX per-scenario base solve on the same noise, at the bar
    (costs rtol 1e-5, weights atol 1e-5, actions and states atol 5e-3);
  - ``make_fleet_closed_loop`` against the JAX fleet loop, each tick's noise
    fed through a shim solver, the references from the batched
    ``calc_ref_trajectory`` against ``jax.vmap(calc_ref_trajectory)``.
* Against the port itself, bit for bit: ``solve_batch`` against B single
  solves (fixed λ, MPO, ESSPS, LBPS; seeded and in noise mode; a full and a
  ragged last block); the λ route a fleet takes (the batched epilogue up to
  K=10,000, the standalone route above, as its single solver); the batched
  twins of rows 4, 6 and 9 against their single wrappers (m = 1 and 2, both
  noise modes); the unfused fleet's one call of rows 6 and 9 a tick, any B;
  ``init_batch`` against ``init(scenario_seed(seed, b))``,
  the fleet loop against B ``make_closed_loop`` episodes, ``done_fn``
  freezing episodes one by one (their keys too) and the ``carry_freeze``
  spec, as ``tests/test_sharding.py`` holds the JAX fleet.

B is 3 or 4: a key write that only scenario 0 made would pass at B=1.
Scenario b's bits equal the single solve's for B below the CPU's vector
width (torch's CPU softplus and sigmoid take another code path on vectors);
on the card for any B (``tests/test_torch_fleet_kernels.py``).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch.core.closed_loop import (
    _freeze,
    _tensors,
    make_closed_loop,
    make_fleet_closed_loop,
)
from mppi_playground_tpu_torch.core.config import (
    MPPIConfig,
    make_batch_key,
    make_key,
    scenario_seed,
    tick_seed,
)
from mppi_playground_tpu_torch.core import fused_solver
from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
from mppi_playground_tpu_torch.models import integrator, pendulum
from mppi_playground_tpu_torch.models.racing_mpcc import (
    calc_ref_trajectory,
    calc_ref_trajectory_batch,
    make_racing_fused_task_from_env,
)
from mppi_playground_tpu_torch.parallel import (
    make_batched_fused_solver,
    make_batched_solver,
    scenario,
)
from mppi_playground_tpu_torch.ops import fused_solve as fs
from tests.test_torch_fused_solve import run_jax_references

T = 8
B = 3
SIGMAS = (0.5, 0.1)
U_MIN, U_MAX = (-2.0, -0.25), (2.0, 0.25)
JAX_K = 1500
FLEET_K, FLEET_TICKS = 256, 3
GOAL_K, GOAL_B = 256, 4
GOALS = ((5.0, 5.0), (-5.0, -5.0), (5.0, -5.0), (-5.0, 5.0))
ESSPS_LAMBDA_MAX = 100.0  # the ESSPS fleet's bracket against JAX: each λ* inside it
STARTS = (0, 400, 900)  # rows of the racing path the scenarios start on


def _same(a, b) -> bool:
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(ta, tb))


def _racing_config(lam=1.0, k=JAX_K, exploration=0.0):
    return MPPIConfig(horizon=T, num_samples=k, dim_state=4, dim_control=2, u_min=U_MIN,
                      u_max=U_MAX, sigmas=SIGMAS, lambda_=lam, store_rollouts=False,
                      exploration=exploration)


def _racing_starts(x0, path):
    """``[B, 4]`` starts: the env's start moved onto path rows ``STARTS``."""
    x0s = x0.repeat(B, 1)
    x0s[:, :3] = path[torch.tensor(STARTS)]
    return x0s.contiguous()


def _noise(name, shape):
    rng = np.random.default_rng({"fused": 31, "fleet": 32, "goal": 33}[name])
    sig = (0.5, 0.5) if name == "goal" else SIGMAS
    return (rng.standard_normal(shape) * sig).astype(np.float32)


def _cost_with_goal_torch(state, action, info):
    return torch.sum((state - info["goal"]) ** 2, dim=1)


@pytest.fixture(scope="module")
def env():
    return RacingEnv(device="cpu")


# ---------------------------------------------------------------------------
# The JAX references (subprocess bodies)
# ---------------------------------------------------------------------------

def _jax_racing():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
    from mppi_playground_tpu.envs.racing_env import RacingEnv as JaxRacingEnv
    from mppi_playground_tpu.models.racing_mpcc import (
        calc_ref_trajectory as jax_ref,
        make_racing_fused_task_from_env as jax_task,
    )
    from mppi_playground_tpu.parallel import make_mesh

    env = JaxRacingEnv()
    mesh = make_mesh(mesh_shape=(1, 1), devices=jax.devices()[:1])
    return jax, JaxConfig, env, jax_ref, jax_task(env), mesh


def jax_fused_batch_reference(out_path: str, lam=1.0, lambda_max=10.0) -> None:
    """The JAX batched fused solve on injected noise, one tick, B scenarios."""
    jax, JaxConfig, env, jax_ref, task, mesh = _jax_racing()
    import jax.numpy as jnp

    from mppi_playground_tpu.models.racing_mpcc import extend_reference_path as jax_extend
    from mppi_playground_tpu.parallel.sharded import make_batched_fused_solver as jax_batched

    config = JaxConfig(horizon=T, num_samples=JAX_K, dim_state=4, dim_control=2, u_min=U_MIN,
                       u_max=U_MAX, sigmas=SIGMAS, lambda_=lam, lambda_max=lambda_max,
                       store_rollouts=False)
    solver = jax_batched(config, task, env.dynamics, mesh, batch_size=B, donate_state=False,
                         interpret=True)
    path = env.racing_center_path
    x0s = jnp.asarray(env.reset())[None].repeat(B, 0)
    x0s = x0s.at[:, :3].set(jnp.asarray(path)[jnp.asarray(STARTS)])
    xrefs, cinds = jax.vmap(lambda x, c: jax_ref(x, path, c, T))(
        x0s, jnp.zeros(B, jnp.int32))
    noise = jnp.asarray(_noise("fused", (B, JAX_K, T, 2)))
    r = solver.solve_batch(solver.init_batch(seed=0), x0s, noise=noise,
                           batched_info={"reference_path": xrefs})
    np.savez(out_path, x0s=np.asarray(x0s), xrefs=np.asarray(xrefs), cinds=np.asarray(cinds),
             xref5s=np.asarray(jax.vmap(jax_extend)(xrefs)),
             costs=np.asarray(r.aux.costs), weights=np.asarray(r.aux.weights),
             action_seq=np.asarray(r.action_seq), state_seq=np.asarray(r.state_seq),
             lam=np.asarray(r.aux.lam), next_lam=np.asarray(r.state.lam))


def jax_fused_batch_essps_reference(out_path: str) -> None:
    """The JAX batched fused solve under ESSPS: each scenario's single solver takes its λ
    epilogue (the ``lambda_mode`` kernel, interpreted) under ``vmap``.  The bracket reaches
    λ=100, so that every scenario's λ* lies inside it (15-20 here), not at a clamp."""
    jax_fused_batch_reference(out_path, lam="ESSPS", lambda_max=ESSPS_LAMBDA_MAX)


class JaxNoiseFromInfo:
    """A batched solver whose ``solve_batch`` takes the tick's noise from ``batched_info``."""

    def __init__(self, solver):
        self.solver = solver
        self.config = solver.config
        self.device = getattr(solver, "device", None)

    def init_batch(self, *args, **kwargs):
        return self.solver.init_batch(*args, **kwargs)

    def solve_batch(self, states, xs, batched_info=None):
        info = dict(batched_info)
        noise = info.pop("noise")
        return self.solver.solve_batch(states, xs, noise=noise, batched_info=info or None)


def jax_fleet_reference(out_path: str) -> None:
    """The JAX fleet loop on injected noise through the shim, and its reference rows."""
    jax, JaxConfig, env, jax_ref, task, mesh = _jax_racing()
    import jax.numpy as jnp

    from mppi_playground_tpu.core.closed_loop import make_fleet_closed_loop as jax_fleet
    from mppi_playground_tpu.parallel.sharded import make_batched_fused_solver as jax_batched

    config = JaxConfig(horizon=T, num_samples=FLEET_K, dim_state=4, dim_control=2,
                       u_min=U_MIN, u_max=U_MAX, sigmas=SIGMAS, lambda_=1.0,
                       store_rollouts=False)
    solver = jax_batched(config, task, env.dynamics, mesh, batch_size=B, jit=False,
                         donate_state=False, interpret=True)
    path = env.racing_center_path
    table = jnp.asarray(_noise("fleet", (FLEET_TICKS, B, FLEET_K, T, 2)))

    def info_fn(carry, xs):
        t, cinds = carry
        xrefs, new = jax.vmap(lambda x, c: jax_ref(x, path, c, T))(xs, cinds)
        return {"reference_path": xrefs, "noise": table[t]}, (t + 1, new)

    x0s = jnp.asarray(env.reset())[None].repeat(B, 0)
    x0s = x0s.at[:, :3].set(jnp.asarray(path)[jnp.asarray(STARTS)])
    run = jax_fleet(JaxNoiseFromInfo(solver), env.dynamics, FLEET_TICKS, info_fn=info_fn)
    carry0 = (jnp.asarray(0, jnp.int32), jnp.zeros(B, jnp.int32))
    st, xf, xs, us, (_, cinds) = run(solver.init_batch(seed=0), x0s, carry0)
    np.savez(out_path, xs=np.asarray(xs), us=np.asarray(us), xf=np.asarray(xf),
             cinds=np.asarray(cinds), prev=np.asarray(st.previous_action_seq))


def jax_goal_reference(out_path: str) -> None:
    """The JAX base solve scenario by scenario, each its goal and its noise (integrator)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
    from mppi_playground_tpu.core.solver import make_solver as jax_make_solver
    from mppi_playground_tpu.models import integrator as jax_integrator

    def cost_with_goal(state, action, info):
        return jnp.sum((state - info["goal"]) ** 2, axis=1)

    config = JaxConfig(horizon=T, num_samples=GOAL_K, dim_state=2, dim_control=2,
                       u_min=jax_integrator.U_MIN, u_max=jax_integrator.U_MAX,
                       sigmas=(0.5, 0.5), lambda_=1.0)
    solver = jax_make_solver(config, jax_integrator.dynamics, cost_with_goal, jit=False)
    noise = _noise("goal", (GOAL_B, GOAL_K, T, 2))
    out = {}
    for b in range(GOAL_B):
        r = solver.solve(solver.init(), jnp.zeros(2), info={"goal": jnp.asarray(GOALS[b])},
                         noise=jnp.asarray(noise[b]))
        for key, v in dict(costs=r.aux.costs, weights=r.aux.weights, action_seq=r.action_seq,
                           state_seq=r.state_seq).items():
            out[f"{key}_{b}"] = np.asarray(v)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax_references(
        "tests.test_torch_fleet",
        ["jax_fused_batch_reference", "jax_fused_batch_essps_reference", "jax_fleet_reference",
         "jax_goal_reference"],
        tmp_path_factory.mktemp("jax_fleet"))


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def test_batched_fused_solve_meets_jax(jax_ref, env):
    want = jax_ref["jax_fused_batch_reference"]
    batched = make_batched_fused_solver(_racing_config(), make_racing_fused_task_from_env(env),
                                        env.dynamics, "cpu", B)
    x0s = torch.from_numpy(want["x0s"])
    xrefs, cinds = calc_ref_trajectory_batch(x0s, env.racing_center_path,
                                             torch.zeros(B, dtype=torch.int64), T)
    np.testing.assert_allclose(xrefs.numpy(), want["xrefs"], rtol=0, atol=1e-6)
    assert cinds.tolist() == want["cinds"].tolist()
    noise = torch.from_numpy(_noise("fused", (B, JAX_K, T, 2)))
    r = batched.solve_batch(batched.init_batch(seed=0), x0s, noise=noise,
                            batched_info={"reference_path": torch.from_numpy(want["xrefs"])})
    # the solver extends the reference rows with torch's sin and cos, the JAX
    # solver with XLA's: the single solver's parity bar (tests/test_torch_tick_tail.py)
    np.testing.assert_allclose(r.aux.costs.numpy(), want["costs"], rtol=2e-5, atol=1e-5)
    # on the JAX rows themselves the batched rollout's costs are bitwise
    costs, _, _ = fs.fused_solve_batch(
        x0s, torch.zeros(B, T, 2), torch.ones(B), [0] * B, torch.from_numpy(want["xref5s"]),
        make_racing_fused_task_from_env(env), SIGMAS, U_MIN, U_MAX, JAX_K, JAX_K, noise)
    np.testing.assert_array_equal(costs.numpy(), want["costs"])
    np.testing.assert_allclose(r.aux.weights.numpy(), want["weights"], atol=1e-5)
    np.testing.assert_allclose(r.action_seq.numpy(), want["action_seq"], atol=5e-3)
    np.testing.assert_allclose(r.state_seq.numpy(), want["state_seq"], atol=5e-3)


def test_batched_fused_essps_solve_meets_jax(jax_ref, env):
    """The ESSPS fleet (the batched λ epilogue at K=1,500) against the JAX fleet: costs and
    the update at the fixed-λ test's bars, λ* and the next state's λ at the JAX package's bar
    for fused auto-λ (rtol 1e-2, ``tests/test_fused_solve.py``)."""
    want = jax_ref["jax_fused_batch_essps_reference"]
    config = dataclasses.replace(_racing_config("ESSPS"), lambda_max=ESSPS_LAMBDA_MAX)
    batched = make_batched_fused_solver(config, make_racing_fused_task_from_env(env),
                                        env.dynamics, "cpu", B)
    assert fused_solver.takes_lambda_epilogue(batched.config)
    noise = torch.from_numpy(_noise("fused", (B, JAX_K, T, 2)))
    r = batched.solve_batch(batched.init_batch(seed=0), torch.from_numpy(want["x0s"]),
                            noise=noise,
                            batched_info={"reference_path": torch.from_numpy(want["xrefs"])})
    np.testing.assert_allclose(r.aux.costs.numpy(), want["costs"], rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(r.aux.lam.numpy(), want["lam"], rtol=1e-2)
    np.testing.assert_allclose(r.state.lam.numpy(), want["next_lam"], rtol=1e-2)
    np.testing.assert_allclose(r.aux.weights.numpy(), want["weights"], atol=1e-5)
    np.testing.assert_allclose(r.action_seq.numpy(), want["action_seq"], atol=5e-3)
    np.testing.assert_allclose(r.state_seq.numpy(), want["state_seq"], atol=5e-3)
    lam = r.aux.lam
    assert lam.shape == (B,) and len(set(lam.tolist())) == B
    assert bool(((lam > 1.0) & (lam < ESSPS_LAMBDA_MAX / 2)).all()), lam  # not at a clamp


def test_batched_unfused_solve_meets_jax_per_scenario(jax_ref):
    want = jax_ref["jax_goal_reference"]
    config = MPPIConfig(horizon=T, num_samples=GOAL_K, dim_state=2, dim_control=2,
                        u_min=integrator.U_MIN, u_max=integrator.U_MAX, sigmas=(0.5, 0.5),
                        lambda_=1.0)
    batched = make_batched_solver(config, integrator.dynamics, _cost_with_goal_torch, "cpu",
                                  GOAL_B)
    r = batched.solve_batch(batched.init_batch(seed=3), torch.zeros(GOAL_B, 2),
                            noise=torch.from_numpy(_noise("goal", (GOAL_B, GOAL_K, T, 2))),
                            batched_info={"goal": torch.tensor(GOALS)})
    for b in range(GOAL_B):
        np.testing.assert_allclose(r.aux.costs[b].numpy(), want[f"costs_{b}"], rtol=1e-5)
        np.testing.assert_allclose(r.aux.weights[b].numpy(), want[f"weights_{b}"], atol=1e-5)
        np.testing.assert_allclose(r.action_seq[b].numpy(), want[f"action_seq_{b}"], atol=5e-3)
        np.testing.assert_allclose(r.state_seq[b].numpy(), want[f"state_seq_{b}"], atol=5e-3)
        # each scenario's first move points toward its own goal
        goal = np.asarray(GOALS[b])
        assert float(r.action_seq[b, 0].numpy() @ (goal / np.linalg.norm(goal))) > 0.1


class NoiseFromInfo:
    """The port's batched shim: ``solve_batch`` takes the tick's noise from ``batched_info``."""

    def __init__(self, solver):
        self.solver = solver
        self.config = solver.config
        self.device = solver.device

    def solve_batch(self, states, xs, batched_info=None):
        info = dict(batched_info)
        noise = info.pop("noise")
        return self.solver.solve_batch(states, xs, noise=noise, batched_info=info or None)


def test_fleet_loop_meets_jax_on_injected_noise(jax_ref, env):
    want = jax_ref["jax_fleet_reference"]
    batched = make_batched_fused_solver(_racing_config(k=FLEET_K),
                                        make_racing_fused_task_from_env(env), env.dynamics,
                                        "cpu", B)
    path = env.racing_center_path
    table = torch.from_numpy(_noise("fleet", (FLEET_TICKS, B, FLEET_K, T, 2)))

    def info_fn(carry, xs):
        t, cinds = carry
        xrefs, new = calc_ref_trajectory_batch(xs, path, cinds, T)
        return {"reference_path": xrefs, "noise": table[t]}, (t + 1, new)

    run = make_fleet_closed_loop(NoiseFromInfo(batched), env.dynamics, FLEET_TICKS,
                                 info_fn=info_fn)
    x0s = _racing_starts(env.reset(), path)
    st, xf, xs, us, (t, cinds) = run(batched.init_batch(seed=0), x0s,
                                     (torch.tensor(0), torch.zeros(B, dtype=torch.int64)))
    assert int(t) == FLEET_TICKS and cinds.tolist() == want["cinds"].tolist()
    np.testing.assert_allclose(us.numpy(), want["us"], atol=5e-3)
    np.testing.assert_allclose(xs.numpy(), want["xs"], atol=5e-3)
    np.testing.assert_allclose(xf.numpy(), want["xf"], atol=5e-3)
    np.testing.assert_allclose(st.previous_action_seq.numpy(), want["prev"], atol=5e-3)


# ---------------------------------------------------------------------------
# Batched solves against single solves, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2048, 1500])
@pytest.mark.parametrize("mode", ["seeded", "noise"])
@pytest.mark.parametrize("lam", [1.0, "MPO", "ESSPS", "LBPS"])
def test_batched_fused_solves_are_the_single_solves(env, lam, mode, k):
    batched = make_batched_fused_solver(_racing_config(lam, k, exploration=0.3),
                                        make_racing_fused_task_from_env(env), env.dynamics,
                                        "cpu", B)
    path = env.racing_center_path
    states = batched.init_batch(seed=5)
    singles = [scenario(states, b) for b in range(B)]
    xs = _racing_starts(env.reset(), path)
    cinds = torch.zeros(B, dtype=torch.int64)
    rng = np.random.default_rng(7)
    for _ in range(3):
        xrefs, cinds = calc_ref_trajectory_batch(xs, path, cinds, T)
        noise = None
        if mode == "noise":
            noise = torch.from_numpy((rng.standard_normal((B, k, T, 2)) * SIGMAS)
                                     .astype(np.float32))
        out = batched.solve_batch(states, xs, noise=noise,
                                  batched_info={"reference_path": xrefs})
        for b in range(B):
            one = batched.solver.solve(singles[b], xs[b], info={"reference_path": xrefs[b]},
                                       noise=None if noise is None else noise[b])
            assert _same((one.action_seq, one.state_seq, one.aux.costs, one.aux.weights,
                          one.aux.lam, one.aux.ess),
                         (out.action_seq[b], out.state_seq[b], out.aux.costs[b],
                          out.aux.weights[b], out.aux.lam[b], out.aux.ess[b])), b
            assert _same(one.state, scenario(out.state, b)), b
            singles[b] = one.state
        assert out.state.tick == singles[0].tick and out.state.seed == 5
        states = out.state
        xs = env.dynamics(xs, out.action_seq[:, 0])
    # every scenario's key moved on: a key written by scenario 0 alone would not
    assert torch.equal(states.key, make_batch_key(5, 3, B, "cpu"))


@pytest.mark.parametrize("lam", [1.0, "ESSPS"])
def test_batched_unfused_solves_are_the_single_solves(lam):
    config = MPPIConfig(horizon=T, num_samples=300, dim_state=2, dim_control=1,
                        u_min=pendulum.U_MIN, u_max=pendulum.U_MAX, sigmas=(1.0,), lambda_=lam)
    batched = make_batched_solver(config, pendulum.dynamics, pendulum.cost, "cpu", B)
    states = batched.init_batch(seed=9)
    singles = [scenario(states, b) for b in range(B)]
    xs = torch.tensor([[math.pi, 0.0], [2.0, 0.5], [-1.0, 0.0]])
    for _ in range(3):
        out = batched.solve_batch(states, xs)
        for b in range(B):
            one = batched.solver.solve(singles[b], xs[b])
            assert _same((one.action_seq, one.state_seq, one.aux.costs, one.aux.weights),
                         (out.action_seq[b], out.state_seq[b], out.aux.costs[b],
                          out.aux.weights[b])), b
            assert _same(one.state, scenario(out.state, b)), b
            singles[b] = one.state
        states = out.state
        xs = pendulum.dynamics(xs, out.action_seq[:, 0])
    assert torch.equal(states.key, make_batch_key(9, 3, B, "cpu"))


def test_init_batch_is_init_of_the_scenario_seeds(env):
    batched = make_batched_fused_solver(_racing_config("MPO"),
                                        make_racing_fused_task_from_env(env), env.dynamics,
                                        "cpu", B)
    states = batched.init_batch(seed=2**40 + 17)
    assert states.seed == 2**40 + 17 and states.tick == 0
    assert states.key.shape == (B, 3) and states.mpo_opt_state.count.shape == (B,)
    for b in range(B):
        one = batched.solver.init(scenario_seed(2**40 + 17, b))
        assert _same(one, scenario(states, b)) and scenario(states, b).seed == one.seed
    # the default seed is the config's; distinct scenarios draw distinct streams
    assert _same(batched.init_batch(), batched.init_batch(seed=42))
    seeds = [scenario_seed(42, b) for b in range(4096)]
    assert len(set(seeds)) == 4096 and seeds[0] == 42
    assert len({tick_seed(s, 0) for s in seeds}) == 4096


# K on each side of the single solver's measured crossover (K=10,000), ragged last blocks
ROUTE_KS = (1500, fused_solver.EPILOGUE_DEFAULT_MAX_SAMPLES + 241)


@pytest.mark.parametrize("batch", [1, B])
def test_a_fleet_searches_on_the_standalone_route(env, batch, monkeypatch):
    """A fleet takes its single solver's λ route and no option for it: the batched epilogue
    (a ticket a scenario) up to K=10,000, the standalone route above; on either route, under
    ESSPS and LBPS, scenario b is its single solve bit for bit, and its λ* the single solver's
    on the other route too."""
    task = make_racing_fused_task_from_env(env)
    with pytest.raises(TypeError, match="lambda_epilogue"):
        make_batched_fused_solver(_racing_config("ESSPS"), task, env.dynamics, "cpu", batch,
                                  lambda_epilogue=True)
    calls = {}
    for name in ("fused_costs_dump_lambda_batch", "fused_costs_dump_batch"):
        def spy(*args, wrapped=getattr(fused_solver, name), name=name, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return wrapped(*args, **kwargs)

        monkeypatch.setattr(fused_solver, name, spy)
    xs = _racing_starts(env.reset(), env.racing_center_path)[:batch]
    xrefs, _ = calc_ref_trajectory_batch(xs, env.racing_center_path,
                                         torch.zeros(batch, dtype=torch.int64), T)
    for mode in ("ESSPS", "LBPS"):
        for k in ROUTE_KS:
            config = _racing_config(mode, k)
            fleet = make_batched_fused_solver(config, task, env.dynamics, "cpu", batch)
            other = make_fused_solver(config, task, env.dynamics, device="cpu",
                                      lambda_epilogue=k > ROUTE_KS[0])
            states = fleet.init_batch(seed=1)
            calls.clear()
            out = fleet.solve_batch(states, xs, batched_info={"reference_path": xrefs})
            epilogue = k <= fused_solver.EPILOGUE_DEFAULT_MAX_SAMPLES
            assert calls == {"fused_costs_dump_lambda_batch" if epilogue
                             else "fused_costs_dump_batch": 1}, (mode, k)
            for b in range(batch):
                info = {"reference_path": xrefs[b]}
                want = fleet.solver.solve(scenario(states, b), xs[b], info=info)
                assert _same((out.action_seq[b], out.aux.costs[b], out.aux.weights[b],
                              out.aux.lam[b], out.state.key[b]),
                             (want.action_seq, want.aux.costs, want.aux.weights, want.aux.lam,
                              want.state.key)), (mode, k, b)
                assert _same(scenario(out.state, b), want.state), (mode, k, b)
                assert _same(other.solve(scenario(states, b), xs[b], info=info).aux.lam,
                             out.aux.lam[b]), (mode, k, b)


def _row_inputs(m, k, noise_mode, seed=0):
    """``(task, x0s, prevs, noise, bounds)`` of B scenarios at width m for the batched twins."""
    rng = np.random.default_rng(seed)
    module = pendulum if m == 1 else integrator
    sig = (0.5,) * m
    bounds = (sig, tuple(module.U_MIN), tuple(module.U_MAX))
    x0s = torch.from_numpy(rng.standard_normal((B, module.DIM_STATE)).astype(np.float32))
    prevs = torch.from_numpy((rng.standard_normal((B, T, m)) * 0.5).astype(np.float32))
    noise = None
    if noise_mode == "noise":
        noise = torch.from_numpy((rng.standard_normal((B, k, T, m)) * 0.5).astype(np.float32))
    return module.fused_task(), x0s, prevs, noise, bounds


@pytest.mark.parametrize("mode", ["seeded", "noise"])
@pytest.mark.parametrize("m", [1, 2])
def test_batched_twins_of_rows_4_6_and_9_are_the_single_twins(m, mode):
    """Rows 4 (the λ epilogue), 6 (the draw) and 9 (the weighted update) over B scenarios:
    each scenario's outputs are its single wrapper's bit for bit, and each scenario's key
    moves on alone, at a K with a ragged last block."""
    from mppi_playground_tpu_torch.ops import lambda_search as ls
    from mppi_playground_tpu_torch.ops import weighted_update as wu

    k = 300
    task, x0s, prevs, noise, bounds = _row_inputs(m, k, mode)
    keys = make_batch_key(7, 2, B, "cpu")
    seeds, threshold = keys[:, 2], 200
    one_noise = (lambda b: None) if noise is None else (lambda b: noise[b])
    for search in (ls.LambdaSearch("ESSPS", 0.01, 10.0, k / 10.0, 40),
                   ls.LambdaSearch("LBPS", 0.01, 10.0, 0.01, 32)):
        tickets = torch.zeros(B, dtype=torch.int32)
        got = fs.fused_costs_dump_lambda_batch(x0s, prevs, seeds, None, task, *bounds, k,
                                               threshold, noise, search, tickets)
        assert got[0].shape == (B, k) and got[1].shape == (B, T * m, k) and got[2].shape == (B,)
        for b in range(B):
            one = fs.fused_costs_dump_lambda(x0s[b], prevs[b], keys[b, 2:], None, task, *bounds,
                                             k, threshold, one_noise(b), search,
                                             torch.zeros(1, dtype=torch.int32))
            assert _same((got[0][b], got[1][b], got[2][b:b + 1]), one), (search.mode, b)
            phase1 = fs.fused_costs_dump(x0s[b], prevs[b], keys[b, 2:], None, task, *bounds, k,
                                         threshold, one_noise(b))
            assert _same((got[0][b], got[1][b]), phase1)
            assert _same(got[2][b], search.plain(phase1[0]))
    rows = torch.arange(k)
    keys_out = torch.empty_like(keys)
    drawn = fs.fused_regen_batch(prevs, seeds, rows, *bounds, k, threshold, noise, keys=keys,
                                 keys_out=keys_out)
    assert drawn.shape == (B, k, T, m)
    for b in range(B):
        key_out = torch.empty(3, dtype=torch.int32)
        one = fs.fused_regen(prevs[b], keys[b, 2:], rows, *bounds, k, threshold, one_noise(b),
                             key=keys[b], key_out=key_out)
        assert _same(drawn[b], one) and _same(keys_out[b], key_out), b
        assert _same(keys_out[b], make_key(scenario_seed(7, 0), 3, "cpu")) or b > 0
    assert len({tuple(keys_out[b].tolist()) for b in range(B)}) == B
    costs = torch.from_numpy(np.random.default_rng(1).random((B, k)).astype(np.float32) * 10)
    lams = torch.tensor([1.0, 0.5, 2.0])
    samples = drawn.reshape(B, k, T * m)
    stats, numer = wu.weighted_update_partials_batch(costs, samples, lams)
    for b in range(B):
        one = wu.weighted_update_partials(costs[b], samples[b].contiguous(), lams[b:b + 1])
        assert _same((stats[b], numer[b]), one), b
    update, weights, ess = wu.weighted_update_batch(costs, drawn, lams)
    for b in range(B):
        assert _same((update[b], weights[b], ess[b]),
                     wu.weighted_update(costs[b], drawn[b], lams[b])), b


@pytest.mark.parametrize("batch", [1, B, 5])
def test_an_unfused_fleet_tick_draws_and_weighs_in_one_call_each(monkeypatch, batch):
    """Whatever B is, a tick of the unfused fleet calls row 6's batched draw once and row 9's
    batched weighted update once, and never their single wrappers."""
    from mppi_playground_tpu_torch.core import solver as solver_module
    from mppi_playground_tpu_torch.ops import weighted_update as wu

    calls = {"row 6": 0, "row 9": 0}

    def counting(row, wrapped):
        def spy(*args, **kwargs):
            calls[row] += 1
            return wrapped(*args, **kwargs)
        return spy

    def single(*args, **kwargs):
        raise AssertionError("the fleet called a single scenario's kernel wrapper")

    monkeypatch.setattr(solver_module, "fused_regen_batch",
                        counting("row 6", solver_module.fused_regen_batch))
    monkeypatch.setattr(wu, "weighted_update_partials_batch",
                        counting("row 9", wu.weighted_update_partials_batch))
    monkeypatch.setattr(solver_module, "fused_regen", single)
    monkeypatch.setattr(wu, "weighted_update_partials", single)
    config = MPPIConfig(horizon=T, num_samples=300, dim_state=2, dim_control=1,
                        u_min=pendulum.U_MIN, u_max=pendulum.U_MAX, sigmas=(1.0,),
                        lambda_="ESSPS")
    batched = make_batched_solver(config, pendulum.dynamics, pendulum.cost, "cpu", batch)
    states = batched.init_batch(seed=4)
    xs = torch.tensor([[math.pi, 0.0], [2.0, 0.5], [-1.0, 0.0], [0.5, 0.1], [1.0, -1.0]])[:batch]
    for tick in range(3):
        out = batched.solve_batch(states, xs)
        assert calls == {"row 6": tick + 1, "row 9": tick + 1}, (batch, tick)
        states = out.state
        xs = pendulum.dynamics(xs, out.action_seq[:, 0])
    assert torch.equal(states.key, make_batch_key(4, 3, batch, "cpu"))


def test_calc_ref_trajectory_batch_rows_are_the_single_calls(env):
    path = env.racing_center_path
    n = path.shape[0]
    xs = env.reset().repeat(5, 1)
    xs[:, :3] = path[torch.tensor([0, 100, 700, n - 40, n - 3])]
    xs[:, 0] += torch.linspace(-0.3, 0.3, 5)
    cinds = torch.tensor([0, 90, 720, n - 60, 0])
    xrefs, new = calc_ref_trajectory_batch(xs, path, cinds, 25)
    for b in range(5):
        xref, ind = calc_ref_trajectory(xs[b], path, cinds[b], 25)
        assert torch.equal(xrefs[b], xref) and int(new[b]) == int(ind)
    # an overrun of the path end zeroes that row's velocity column only
    assert float(xrefs[0, 0, 3]) > 0 and bool((xrefs[4, :, 3] == 0).all())


# ---------------------------------------------------------------------------
# The fleet loop against independent episodes, done_fn and carry_freeze
# ---------------------------------------------------------------------------

def _fleet_case(name):
    """(batched, single plant, batched plant, x0s, info_fn pair, carry0) of a fleet case."""
    if name == "racing fused":
        env = RacingEnv(device="cpu")
        batched = make_batched_fused_solver(_racing_config(k=FLEET_K),
                                            make_racing_fused_task_from_env(env), env.dynamics,
                                            "cpu", B)
        path = env.racing_center_path

        def info_batch(cinds, xs):
            xrefs, new = calc_ref_trajectory_batch(xs, path, cinds, T)
            return {"reference_path": xrefs}, new

        def info_one(cind, x):
            xref, new = calc_ref_trajectory(x, path, cind, T)
            return {"reference_path": xref}, new

        return (batched, lambda x, u: env.dynamics(x[None], u[None])[0], env.dynamics,
                _racing_starts(env.reset(), path), (info_batch, info_one),
                torch.zeros(B, dtype=torch.int64))
    config = MPPIConfig(horizon=T, num_samples=256, dim_state=2, dim_control=1,
                        u_min=pendulum.U_MIN, u_max=pendulum.U_MAX, sigmas=(1.0,),
                        lambda_="ESSPS")
    batched = make_batched_solver(config, pendulum.dynamics, pendulum.cost, "cpu", B)
    return (batched, lambda x, u: pendulum.dynamics(x[None], u[None])[0], pendulum.dynamics,
            torch.tensor([[math.pi, 0.0], [2.0, 0.5], [-1.0, 0.0]]), (None, None), None)


@pytest.mark.parametrize("name", ["racing fused", "pendulum unfused"])
def test_fleet_loop_is_the_independent_episodes(name):
    batched, plant_one, plant, x0s, (info_batch, info_one), carry0 = _fleet_case(name)
    ticks = 4
    fleet = make_fleet_closed_loop(batched, plant, ticks, info_fn=info_batch)
    states = batched.init_batch(seed=11)
    st, xf, xs, us, c = fleet(states, x0s, carry0)
    assert xs.shape == (ticks, B, x0s.shape[1]) and us.shape == (ticks, B, 1 + (
        name == "racing fused"))
    assert st.tick == ticks and st.seed == 11
    loop = make_closed_loop(batched.solver, plant_one, ticks, info_fn=info_one)
    for b in range(B):
        st_b, xf_b, xs_b, us_b, c_b = loop(scenario(states, b), x0s[b],
                                           None if carry0 is None else carry0[b])
        assert torch.equal(xs[:, b], xs_b) and torch.equal(us[:, b], us_b), b
        assert torch.equal(xf[b], xf_b) and _same(scenario(st, b), st_b), b
        if c is not None:
            assert int(c[b]) == int(c_b)


def _ramp(state, action):
    new_v = 0.9 * state[:, 1] + 0.1 * torch.clamp(action[:, 0], -1.0, 1.0)
    return torch.stack([state[:, 0] + 0.1 * new_v, new_v], dim=1)


def _ramp_cost(state, action, info):
    return (state[:, 0] - 2.0) ** 2 + 0.1 * state[:, 1] ** 2


def _ramp_fleet(batch=2):
    config = MPPIConfig(horizon=10, num_samples=256, dim_state=2, dim_control=1,
                        u_min=(-1.0,), u_max=(1.0,), sigmas=(0.7,), lambda_=1.0)
    return make_batched_solver(config, _ramp, _ramp_cost, "cpu", batch)


# episode 0 starts at 0.9 with velocity 1.0 and crosses 1.1 within 4 ticks under
# any admissible action; episode 1 starts at -5.0 and cannot reach it in 8
RAMP_X0S = ((0.9, 1.0), (-5.0, 0.0))


def _done(xs):
    return xs[:, 0] > 1.1


def test_fleet_done_fn_freezes_episodes_independently():
    batched = _ramp_fleet()
    ticks = 8
    x0s = torch.tensor(RAMP_X0S)
    _, _, xs_b, us_b, _ = make_fleet_closed_loop(batched, _ramp, ticks)(
        batched.init_batch(seed=5), x0s)
    st, xf, xs, us, _, ep = make_fleet_closed_loop(batched, _ramp, ticks, done_fn=_done)(
        batched.init_batch(seed=5), x0s)
    done, nt = ep["done"], ep["ticks"]
    assert bool(done[0]) and not bool(done[1]) and nt.dtype == torch.int32
    t0 = int(nt[0])
    assert 1 <= t0 < ticks and int(nt[1]) == ticks
    # episode 0: the same prefix bit for bit, then its state frozen and zero actions
    assert torch.equal(us[:t0, 0], us_b[:t0, 0]) and bool((us[t0:, 0] == 0).all())
    assert bool((xs[t0:, 0] == xf[0]).all())
    # its key froze at the tick it fired; episode 1 ran every tick
    assert torch.equal(st.key[0], make_key(scenario_seed(5, 0), t0, "cpu"))
    assert torch.equal(st.key[1], make_key(scenario_seed(5, 1), ticks, "cpu"))
    assert st.tick == ticks
    # episode 1 is untouched by episode 0's termination
    assert torch.equal(xs[:, 1], xs_b[:, 1]) and torch.equal(us[:, 1], us_b[:, 1])


def test_fleet_done_fn_carry_freeze_is_per_leading_axis():
    batched = _ramp_fleet()
    ticks = 6

    def info_fn(carry, xs):
        return {}, {"per_ep": carry["per_ep"] + 1.0, "shared": carry["shared"] + 1.0}

    carry0 = {"per_ep": torch.zeros(2), "shared": torch.zeros(3)}
    fleet = make_fleet_closed_loop(batched, _ramp, ticks, info_fn=info_fn, done_fn=_done)
    *_, carry, ep = fleet(batched.init_batch(seed=5), torch.tensor(RAMP_X0S), carry0)
    t0 = int(ep["ticks"][0])
    assert bool(ep["done"][0]) and t0 < ticks
    assert carry["per_ep"].tolist() == [float(t0), float(ticks)]
    assert carry["shared"].tolist() == [float(ticks)] * 3


def test_fleet_carry_freeze_spec_overrides_shape_heuristic():
    batched = _ramp_fleet()
    ticks = 6
    x0s = torch.tensor(RAMP_X0S)

    def info_fn(carry, xs):
        return {}, {"per_ep": carry["per_ep"] + 1.0, "shared_b": carry["shared_b"] + 1.0}

    carry0 = {"per_ep": torch.zeros(2), "shared_b": torch.zeros(2)}
    fleet = make_fleet_closed_loop(batched, _ramp, ticks, info_fn=info_fn, done_fn=_done,
                                   carry_freeze={"per_ep": True, "shared_b": False})
    *_, carry, ep = fleet(batched.init_batch(seed=5), x0s, carry0)
    t0 = int(ep["ticks"][0])
    assert bool(ep["done"][0]) and t0 < ticks
    assert carry["per_ep"].tolist() == [float(t0), float(ticks)]
    assert carry["shared_b"].tolist() == [float(ticks)] * 2
    # a spec marking a non-[B] leaf per-episode fails loudly, not silently
    bad = make_fleet_closed_loop(batched, _ramp, ticks,
                                 info_fn=lambda c, xs: ({}, {"w": c["w"] + 1.0}),
                                 done_fn=_done, carry_freeze={"w": True})
    with pytest.raises(ValueError, match="carry_freeze"):
        bad(batched.init_batch(seed=5), x0s, {"w": torch.zeros(3)})
    # a prefix spec (a bool root for a dict carry) is a structure mismatch
    prefix = make_fleet_closed_loop(batched, _ramp, ticks, info_fn=info_fn, done_fn=_done,
                                    carry_freeze=True)
    with pytest.raises(ValueError, match="carry_freeze"):
        prefix(batched.init_batch(seed=5), x0s, carry0)
    # a spec without the pieces it describes is a mis-wiring, not a no-op
    with pytest.raises(ValueError, match="done_fn"):
        make_fleet_closed_loop(batched, _ramp, ticks, info_fn=info_fn,
                               carry_freeze={"per_ep": True, "shared_b": False})
    with pytest.raises(ValueError, match="info_fn"):
        make_fleet_closed_loop(batched, _ramp, ticks, done_fn=_done, carry_freeze=True)
    # the trailing parameters are keyword-only
    with pytest.raises(TypeError):
        make_fleet_closed_loop(batched, _ramp, ticks, info_fn, _done, True)


def test_freeze_spec_selects_by_the_spec():
    done = torch.tensor([True, False, True])
    old = {"a": torch.zeros(3, 2), "b": (torch.zeros(3), torch.zeros(5))}
    new = {"a": torch.ones(3, 2), "b": (torch.ones(3), torch.ones(5))}
    out = _freeze(done, old, new, spec={"a": True, "b": (False, False)})
    assert out["a"][:, 0].tolist() == [0.0, 1.0, 0.0]
    assert torch.equal(out["b"][0], new["b"][0]) and torch.equal(out["b"][1], new["b"][1])
    with pytest.raises(ValueError, match="carry_freeze"):
        _freeze(done, old, new, spec={"a": True, "b": False})
    with pytest.raises(ValueError, match="leading shape"):
        _freeze(done, old, new, spec={"a": True, "b": (True, True)})


def test_fleet_states_keep_a_made_key():
    """A batched state without a key draws from its host pair's keys, as a single one does."""
    batched = _ramp_fleet(B)
    states = dataclasses.replace(batched.init_batch(seed=8), key=None, tick=4)
    run = make_fleet_closed_loop(batched, _ramp, 2)
    st, *_ = run(states, torch.tensor([[0.0, 0.0]] * B))
    assert torch.equal(st.key, make_batch_key(8, 6, B, "cpu")) and st.tick == 6
