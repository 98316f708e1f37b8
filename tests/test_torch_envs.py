"""The port's Navigation2DEnv and GoalInDangerZoneEnv against the JAX package's.

The JAX side runs in a subprocess with XLA's FMA contraction off (see
tests/test_torch_fused_solve.py); inputs are made with numpy.

* Navigation2DEnv: the obstacle grid byte for byte (the same seeded
  obstacle draws), the reset state, 20 ``step`` calls on seeded actions,
  ``collision_check`` on seeded trajectories (all bitwise: no sqrt or libm
  reaches them but the goal test's norm), and three warm-started ``MPPI``
  ticks (T=8, K=1,024, ESSPS, injected noise) on each of the port's routes
  (unfused; fused on its default lambda route, and forced onto the lambda
  epilogue and onto the standalone search) against the JAX
  ``MPPI`` on its XLA route: actions and states atol 5e-3, lambda rtol
  1e-4, and the port's fused top samples against the JAX stored rollouts.
* GoalInDangerZoneEnv: ``reset(seed=42)`` draws the JAX env's start,
  heading and goal (its gymnasium ``np_random`` is the generator
  ``np.random.default_rng(42)`` builds), and 30 host ``step`` calls give its
  observations, rewards and costs bit for bit.
"""

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch import MPPI
from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver, takes_lambda_epilogue
from mppi_playground_tpu_torch.envs import GoalInDangerZoneEnv, Navigation2DEnv
from mppi_playground_tpu_torch.utils import convert
from tests.test_torch_fused_solve import run_jax_reference

STEPS = 20
TICKS = 3
T, K = 8, 1024
DZ_STEPS = 30


def _actions():
    rng = np.random.default_rng(20)
    return np.stack([rng.uniform(-0.5, 2.5, STEPS), rng.uniform(-1.5, 1.5, STEPS)], 1).astype(
        np.float32)


def _trajectories():
    rng = np.random.default_rng(21)
    xy = rng.uniform(-11.0, 11.0, (16, T + 1, 2))
    return np.concatenate([xy, rng.uniform(-3, 3, (16, T + 1, 1))], 2).astype(np.float32)


def _noise(tick):
    rng = np.random.default_rng(300 + tick)
    return (rng.standard_normal((K, T, 2)) * 0.5).astype(np.float32)


def _dz_actions():
    return np.random.default_rng(22).uniform(-1.2, 1.2, (DZ_STEPS, 2)).astype(np.float32)


def jax_envs_reference(out_path: str) -> None:
    """Subprocess body: the JAX package's two envs and its MPPI on Navigation2D."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu import MPPI as JaxMPPI
    from mppi_playground_tpu.envs import GoalInDangerZoneEnv as JaxDZ
    from mppi_playground_tpu.envs import Navigation2DEnv as JaxNav

    env = JaxNav()
    out = {"grid": np.asarray(env.obstacle_map.device_map.grid),
           "origin": np.asarray(env.obstacle_map.device_map.origin),
           "reset": np.asarray(env.reset()), "goal": np.asarray(env.goal_pos),
           "x_lim": np.asarray(env.obstacle_map.x_lim), "y_lim": np.asarray(env.obstacle_map.y_lim)}
    states, goals = [], []
    for u in _actions():
        x, reached = env.step(jnp.asarray(u))
        states.append(np.asarray(x))
        goals.append(reached)
    out["steps"], out["goals"] = np.stack(states), np.asarray(goals)
    out["collisions"] = np.asarray(env.collision_check(jnp.asarray(_trajectories())))

    solver = JaxMPPI(horizon=T, num_samples=K, dim_state=3, dim_control=2,
                     dynamics=env.dynamics, cost_func=env.cost_function, u_min=env.u_min,
                     u_max=env.u_max, sigmas=jnp.asarray([0.5, 0.5]), lambda_="ESSPS")
    x = env.reset()
    for tick in range(TICKS):
        action_seq, state_seq = solver.forward(x, noise=jnp.asarray(_noise(tick)))
        out[f"tick{tick}_actions"] = np.asarray(action_seq)
        out[f"tick{tick}_states"] = np.asarray(state_seq)
        out[f"tick{tick}_lam"] = np.asarray(solver.solver_state.lam)
        x = env.dynamics(x[None], action_seq[:1])[0]
    seqs, weights = solver.get_top_samples(50)
    out["top_seqs"], out["top_weights"] = np.asarray(seqs), np.asarray(weights)

    dz = JaxDZ(render_mode=None, seed=42)
    obs, _ = dz.reset(seed=42)
    out["dz_reset"] = obs
    rows = []
    for a in _dz_actions():
        obs, reward, _, truncated, info = dz.step(a)
        rows.append(np.concatenate([obs.astype(np.float64), [reward, info["cost"], truncated]]))
    out["dz_steps"] = np.stack(rows)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax_reference("tests.test_torch_envs", "jax_envs_reference",
                             tmp_path_factory.mktemp("jax_envs"))


@pytest.fixture(scope="module")
def env():
    return Navigation2DEnv(device="cpu")


def test_navigation_map_and_reset_match_jax(jax_ref, env):
    grid = env.obstacle_map.grid
    assert grid.shape == jax_ref["grid"].shape
    assert (grid.astype(np.float32).tobytes() == jax_ref["grid"].astype(np.float32).tobytes())
    np.testing.assert_array_equal(env.obstacle_map.origin, jax_ref["origin"])
    np.testing.assert_array_equal(env.reset().numpy(), jax_ref["reset"])
    task = env.fused_task()
    assert task.model == "navigation" and task.grids[0].dtype == torch.uint8
    np.testing.assert_array_equal(task.grids[0].numpy(), (jax_ref["grid"] != 0).astype(np.uint8))
    # the same task, carried over from the JAX env's map, goal and bounds
    carried = convert.navigation_task(jax_ref["grid"], jax_ref["origin"], 0.1, jax_ref["goal"],
                                      jax_ref["x_lim"], jax_ref["y_lim"], device="cpu")
    assert (carried.floats, carried.ints) == (task.floats, task.ints)
    assert torch.equal(carried.grids[0], task.grids[0])


def test_navigation_steps_and_collisions_match_jax(jax_ref, env):
    env.reset()
    for i, u in enumerate(_actions()):
        x, reached = env.step(torch.from_numpy(u))
        np.testing.assert_array_equal(x.numpy(), jax_ref["steps"][i], err_msg=f"step {i}")
        assert reached == bool(jax_ref["goals"][i])
    got = env.collision_check(torch.from_numpy(_trajectories()))
    np.testing.assert_array_equal(got.numpy(), jax_ref["collisions"])
    assert got.sum() > 0  # the seeded trajectories do cross obstacles


class _ForcedRoute:
    """``MPPI``'s ticks over ``make_fused_solver`` with a forced lambda route.

    ``MPPI`` takes no lambda-route option (as the JAX facade); the route is
    forced below it, on the fused solver.
    """

    def __init__(self, solver):
        self.solver, self.state = solver, solver.init()

    def forward(self, x, noise):
        result = self.solver.solve(self.state, x, noise=noise)
        self.state, self.aux, self.noise = result.state, result.aux, noise
        return result.action_seq, result.state_seq

    def get_top_samples(self, n):
        return self.solver.top_samples(self.aux, n, noise=self.noise)

    @property
    def lambda_(self):
        return float(self.state.lam)


# epilogue: None, the facade and its default route; True / False, the route forced
@pytest.mark.parametrize("route,epilogue", [("xla", None), ("fused", None), ("fused", True),
                                            ("fused", False)])
def test_navigation_mppi_ticks_match_jax(jax_ref, env, route, epilogue):
    extra = dict(store_rollouts=False, fused_task=env.fused_task()) if route == "fused" else {}
    solver = MPPI(horizon=T, num_samples=K, dim_state=3, dim_control=2, dynamics=env.dynamics,
                  cost_func=env.cost_function, u_min=env.u_min, u_max=env.u_max,
                  sigmas=(0.5, 0.5), lambda_="ESSPS", device="cpu", **extra)
    assert solver.solver_backend == route
    if epilogue is not None:
        assert takes_lambda_epilogue(solver.config, epilogue) is epilogue
        solver = _ForcedRoute(make_fused_solver(solver.config, env.fused_task(), env.dynamics,
                                                device="cpu", lambda_epilogue=epilogue))
    x = env.reset()
    for tick in range(TICKS):
        action_seq, state_seq = solver.forward(x, noise=torch.from_numpy(_noise(tick)))
        np.testing.assert_allclose(action_seq.numpy(), jax_ref[f"tick{tick}_actions"], atol=5e-3)
        np.testing.assert_allclose(state_seq.numpy(), jax_ref[f"tick{tick}_states"], atol=5e-3)
        np.testing.assert_allclose(solver.lambda_, float(jax_ref[f"tick{tick}_lam"]), rtol=1e-4,
                                   atol=1e-6)
        x = env.dynamics(x[None], action_seq[:1])[0]
    seqs, weights = solver.get_top_samples(50)
    np.testing.assert_allclose(weights.numpy(), jax_ref["top_weights"], atol=1e-5)
    np.testing.assert_allclose(seqs.numpy(), jax_ref["top_seqs"], atol=5e-3)


def test_danger_zone_reset_and_steps_match_jax(jax_ref):
    env = GoalInDangerZoneEnv(seed=42)
    obs, info = env.reset(seed=42)
    assert info == {"cost": 0.0} and obs.dtype == np.float32
    np.testing.assert_array_equal(obs, jax_ref["dz_reset"])
    for i, a in enumerate(_dz_actions()):
        obs, reward, terminated, truncated, info = env.step(a)
        want = jax_ref["dz_steps"][i]
        np.testing.assert_array_equal(obs, want[:7].astype(np.float32), err_msg=f"step {i}")
        assert (reward, info["cost"], truncated) == (want[7], want[8], bool(want[9]))
        assert terminated is False
    # reset without a seed continues the stream; with the seed it starts over
    env.reset()
    again, _ = env.reset(seed=42)
    np.testing.assert_array_equal(again, jax_ref["dz_reset"])


def test_danger_zone_solver_callables_match_the_model():
    """parallel_step / parallel_cost / fused_task are the danger-zone model's, radius 10."""
    from mppi_playground_tpu_torch.models import danger_zone

    env = GoalInDangerZoneEnv(seed=42)
    obs, _ = env.reset(seed=42)
    x = torch.from_numpy(obs)[None].expand(5, -1)
    u = torch.linspace(-1, 1, 10).reshape(5, 2)
    torch.testing.assert_close(env.parallel_step(x, u), danger_zone.make_dynamics()(x, u),
                               rtol=0, atol=0)
    torch.testing.assert_close(env.parallel_cost(x, u, {}), danger_zone.make_cost(10.0)(x, u, {}),
                               rtol=0, atol=0)
    task = env.fused_task()
    assert task.model == "danger_zone" and task.floats[5] == 10.0
    assert env.danger_zone.is_inside(np.zeros(2)) and not env.danger_zone.is_inside(obs[:2])


def test_danger_zone_env_is_a_gym_env_with_the_jax_spaces():
    """With gymnasium, a ``gym.Env`` whose spaces equal the JAX env's; the same seeded reset."""
    import gymnasium as gym

    from mppi_playground_tpu.envs import GoalInDangerZoneEnv as JaxDZ

    env, jax_env = GoalInDangerZoneEnv(seed=42), JaxDZ(seed=42)
    assert isinstance(env, gym.Env)
    for name in ("action_space", "observation_space"):
        got, want = getattr(env, name), getattr(jax_env, name)
        assert isinstance(got, gym.spaces.Box) and got.dtype == want.dtype == np.float32
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.low, want.low)
        np.testing.assert_array_equal(got.high, want.high)
    obs, _ = env.reset(seed=42)
    np.testing.assert_array_equal(obs, jax_env.reset(seed=42)[0])
    assert env.observation_space.contains(obs)
    assert env.action_space.contains(np.array([0.5, -0.5], np.float32))


def test_danger_zone_env_without_gymnasium_is_a_plain_class(monkeypatch):
    """Where gymnasium does not import: a plain class, no spaces, the same seeded reset."""
    import importlib
    import sys

    from mppi_playground_tpu_torch.envs import goal_in_danger_zone as module

    want, _ = GoalInDangerZoneEnv(seed=42).reset(seed=42)
    monkeypatch.setitem(sys.modules, "gymnasium", None)  # import gymnasium raises ImportError
    try:
        plain = importlib.reload(module).GoalInDangerZoneEnv(seed=42)
        assert type(plain).__mro__[1:] == (object,)
        assert not hasattr(plain, "action_space") and not hasattr(plain, "observation_space")
        obs, info = plain.reset(seed=42)
        np.testing.assert_array_equal(obs, want)
        assert info == {"cost": 0.0}
    finally:
        monkeypatch.undo()
        importlib.reload(module)
