"""Every model family on the port's fused route against the JAX package, and the lambda epilogue.

A port of tests/test_fused_models.py.  For each of the six model families
besides racing (pendulum, cartpole, mountain car, integrator, danger zone,
Navigation2D), with the same injected noise on both sides (T=6, K=1,024),
four solves: the port's fused solver (the kernels' plain twins on the CPU),
the port's unfused solver, and the JAX package's fused solver (its Pallas
kernel in interpret mode) and XLA solver.  The JAX side runs in
subprocesses with XLA's FMA contraction off (see
tests/test_torch_fused_solve.py).  The bar is the JAX package's own for
fused against XLA: costs rtol 2e-5, atol 1e-5; actions atol 5e-3.  The
integrator matches the JAX fused kernel bit for bit; Navigation2D's and the
danger zone's costs take XLA's CPU sqrt, which is not correctly rounded
(tests/test_torch_models.py), and the libm models sin/cos; those are held
to the bar.

The lambda epilogue (row 4 of PERF.md's table): on the port, the epilogue
route (``lambda_epilogue=True``) and the standalone route give the same
lambda*, costs and update bit for bit; against the JAX package's
``make_fused_solver(lambda_epilogue=True)`` in interpret mode over three
warm-started Navigation2D ticks, costs and actions within the bar above and
lambda* within the bars of tests/test_torch_autolambda.py: ESSPS rtol 1e-4,
atol 1e-6; LBPS by its objective, rtol 1e-5 at the two lambdas on the same
costs.  LBPS's lambda itself is held to the chained-tick bar of
tests/test_torch_flagship.py, rtol 1e-2: the objective is flat near its
minimum, and the few costs that XLA's sqrt rounds 1 ulp apart move golden
section by about 0.4% (objective 9e-8 apart).
"""

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch.core.config import MPPIConfig
from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
from mppi_playground_tpu_torch.core.solver import make_solver
from mppi_playground_tpu_torch.utils import convert
from tests.test_torch_fused_solve import run_jax_references

K = 1024
HORIZON = 6
MODELS = ("pendulum", "cartpole", "mountain_car", "integrator", "danger_zone", "navigation")
EXACT = ("integrator",)  # bitwise against the JAX fused kernel
EPILOGUE_TICKS = 3

# name -> (MPPIConfig dims, x0): the JAX package's tests/test_fused_models.py cases
DIMS = {
    "pendulum": (dict(dim_state=2, dim_control=1, u_min=(-2.0,), u_max=(2.0,), sigmas=(1.0,)),
                 [np.pi, 0.0]),
    "cartpole": (dict(dim_state=4, dim_control=1, u_min=(-1.0,), u_max=(1.0,), sigmas=(1.0,)),
                 [0.0, 0.0, 0.1, 0.0]),
    "mountain_car": (dict(dim_state=2, dim_control=1, u_min=(-1.0,), u_max=(1.0,),
                          sigmas=(1.0,)), [-0.5, 0.0]),
    "integrator": (dict(dim_state=2, dim_control=2, u_min=(-1.0, -1.0), u_max=(1.0, 1.0),
                        sigmas=(0.5, 0.5)), [0.0, 0.0]),
    "danger_zone": (dict(dim_state=7, dim_control=2, u_min=(-1.0, -1.0), u_max=(1.0, 1.0),
                         sigmas=(0.5, 0.5)), [0.0, 0.0, 0.3, 3.0, 2.0, 1.5, 1.0]),
    "navigation": (dict(dim_state=3, dim_control=2, u_min=(0.0, -1.0), u_max=(2.0, 1.0),
                        sigmas=(0.5, 0.5)), None),
}
DZ_RADIUS = 1.5


def _noise(name, tick=0):
    dims = DIMS[name][0]
    rng = np.random.default_rng(1000 * tick + len(name))
    return (rng.standard_normal((K, HORIZON, dims["dim_control"])) * dims["sigmas"]).astype(
        np.float32)


def _jax_plug(name, nav_env):
    from mppi_playground_tpu.models import cartpole, danger_zone, integrator, mountain_car, pendulum

    if name == "navigation":
        return nav_env.fused_task(), nav_env.dynamics, nav_env.cost_function
    if name == "danger_zone":
        return (danger_zone.make_fused_task(radius=DZ_RADIUS), danger_zone.make_dynamics(),
                danger_zone.make_cost(radius=DZ_RADIUS))
    module = {"pendulum": pendulum, "cartpole": cartpole, "mountain_car": mountain_car,
              "integrator": integrator}[name]
    return module.fused_task(), module.dynamics, module.cost


def jax_models_reference(out_path: str) -> None:
    """Subprocess body: the JAX fused (interpret) and XLA solvers on each model, one tick."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
    from mppi_playground_tpu.core.fused_solver import make_fused_solver as jax_fused
    from mppi_playground_tpu.core.solver import make_solver as jax_solver
    from mppi_playground_tpu.envs.navigation_2d import Navigation2DEnv

    nav_env = Navigation2DEnv()
    out = {}
    for name in MODELS:
        task, dyn, cost = _jax_plug(name, nav_env)
        dims, x0 = DIMS[name]
        x0 = np.asarray(nav_env.reset() if x0 is None else x0, np.float32)
        cfg = JaxConfig(horizon=HORIZON, num_samples=K, lambda_=1.0, store_rollouts=False,
                        **dims)
        fused = jax_fused(cfg, task, dyn, jit=True, donate_state=False, interpret=True)
        xla = jax_solver(cfg, dyn, cost, jit=True, donate_state=False)
        noise = jnp.asarray(_noise(name))
        for route, solver in (("fused", fused), ("xla", xla)):
            r = solver.solve(solver.init(), jnp.asarray(x0), info={}, noise=noise)
            out[f"{name}_{route}_costs"] = np.asarray(r.aux.costs)
            out[f"{name}_{route}_actions"] = np.asarray(r.action_seq)
            out[f"{name}_{route}_states"] = np.asarray(r.state_seq)
        out[f"{name}_x0"] = x0
    np.savez(out_path, **out)


def jax_epilogue_reference(out_path: str) -> None:
    """Subprocess body: the JAX fused solver with the lambda epilogue, three Navigation2D ticks."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
    from mppi_playground_tpu.core.fused_solver import make_fused_solver as jax_fused
    from mppi_playground_tpu.envs.navigation_2d import Navigation2DEnv

    env = Navigation2DEnv()
    out = {}
    for mode in ("ESSPS", "LBPS"):
        cfg = JaxConfig(horizon=HORIZON, num_samples=K, lambda_=mode, store_rollouts=False,
                        **DIMS["navigation"][0])
        solver = jax_fused(cfg, env.fused_task(), env.dynamics, jit=True, donate_state=False,
                           interpret=True, lambda_epilogue=True)
        state, x = solver.init(), env.reset()
        for tick in range(EPILOGUE_TICKS):
            r = solver.solve(state, x, info={}, noise=jnp.asarray(_noise("navigation", tick)))
            for key, value in dict(lam=r.aux.lam, costs=r.aux.costs, actions=r.action_seq,
                                   x=x).items():
                out[f"{mode}_{tick}_{key}"] = np.asarray(value)
            state, x = r.state, env.dynamics(x[None], r.action_seq[:1])[0]
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    refs = run_jax_references("tests.test_torch_fused_models",
                              ["jax_models_reference", "jax_epilogue_reference"],
                              tmp_path_factory.mktemp("jax_fused_models"))
    return {**refs["jax_models_reference"], **refs["jax_epilogue_reference"]}


@pytest.fixture(scope="module")
def nav_env():
    from mppi_playground_tpu_torch.envs.navigation_2d import Navigation2DEnv

    return Navigation2DEnv(device="cpu")


def _port_plug(name, nav_env):
    from mppi_playground_tpu_torch.models import (
        cartpole,
        danger_zone,
        integrator,
        mountain_car,
        pendulum,
    )

    if name == "navigation":
        return nav_env.fused_task(), nav_env.dynamics, nav_env.cost_function
    if name == "danger_zone":
        return (danger_zone.make_fused_task(radius=DZ_RADIUS), danger_zone.make_dynamics(),
                danger_zone.make_cost(radius=DZ_RADIUS))
    module = {"pendulum": pendulum, "cartpole": cartpole, "mountain_car": mountain_car,
              "integrator": integrator}[name]
    return module.fused_task(), module.dynamics, module.cost


def _costs_close(got, want, exact=False, msg=""):
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=msg)  # tolerance 0
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5, err_msg=msg)


@pytest.mark.parametrize("name", MODELS)
def test_fused_model_matches_jax(jax_ref, nav_env, name):
    task, dyn, cost = _port_plug(name, nav_env)
    cfg = MPPIConfig(horizon=HORIZON, num_samples=K, lambda_=1.0, store_rollouts=False,
                     **DIMS[name][0])
    fused = make_fused_solver(cfg, task, dyn, device="cpu")
    unfused = make_solver(cfg, dyn, cost, device="cpu")
    x0 = convert.observation(jax_ref[f"{name}_x0"], device="cpu")
    noise = torch.from_numpy(_noise(name))
    rf = fused.solve(fused.init(), x0, noise=noise)
    ru = unfused.solve(unfused.init(), x0, noise=noise)
    # the port's two routes
    np.testing.assert_allclose(rf.aux.costs.numpy(), ru.aux.costs.numpy(), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(rf.action_seq.numpy(), ru.action_seq.numpy(), atol=5e-3)
    # against the JAX package's fused kernel and XLA solver
    for route, result in (("fused", rf), ("xla", ru)):
        _costs_close(result.aux.costs.numpy(), jax_ref[f"{name}_{route}_costs"],
                     exact=name in EXACT and route == "fused", msg=f"{name} {route}")
        for want in ("fused", "xla"):
            np.testing.assert_allclose(result.action_seq.numpy(),
                                       jax_ref[f"{name}_{want}_actions"], atol=5e-3)
            np.testing.assert_allclose(result.state_seq.numpy(),
                                       jax_ref[f"{name}_{want}_states"], atol=5e-3)


@pytest.mark.parametrize("name", MODELS)
def test_fused_top_samples_match_unfused(nav_env, name):
    """Regenerated top samples (m=1 and m=2 streams) equal the unfused route's stored rollouts."""
    task, dyn, cost = _port_plug(name, nav_env)
    cfg = dict(horizon=HORIZON, num_samples=K, lambda_=1.0, **DIMS[name][0])
    fused = make_fused_solver(MPPIConfig(store_rollouts=False, **cfg), task, dyn, device="cpu")
    unfused = make_solver(MPPIConfig(**cfg), dyn, cost, device="cpu")
    x0 = nav_env.reset() if name == "navigation" else torch.tensor(DIMS[name][1])
    noise = torch.from_numpy(_noise(name, tick=5))
    rf = fused.solve(fused.init(), x0, noise=noise)
    ru = unfused.solve(unfused.init(), x0, noise=noise)
    seqs, weights = fused.top_samples(rf.aux, 40, noise=noise)
    order = torch.argsort(ru.aux.weights, descending=True, stable=True)[:40]
    np.testing.assert_allclose(weights.numpy(), ru.aux.weights[order].numpy(), atol=1e-5)
    np.testing.assert_allclose(seqs.numpy(), ru.aux.state_seq_batch[order].numpy(), atol=5e-4)
    assert seqs.shape == (40, HORIZON + 1, cfg["dim_state"])


@pytest.mark.parametrize("mode", ["ESSPS", "LBPS"])
@pytest.mark.parametrize("name", ["navigation", "pendulum", "danger_zone"])
def test_lambda_epilogue_equals_standalone_route(nav_env, name, mode):
    task, dyn, _ = _port_plug(name, nav_env)
    cfg = MPPIConfig(horizon=HORIZON, num_samples=K, lambda_=mode, store_rollouts=False,
                     **DIMS[name][0])
    epilogue = make_fused_solver(cfg, task, dyn, device="cpu", lambda_epilogue=True)
    standalone = make_fused_solver(cfg, task, dyn, device="cpu", lambda_epilogue=False)
    x0 = nav_env.reset() if name == "navigation" else torch.tensor(DIMS[name][1])
    se, ss = epilogue.init(), standalone.init()
    for tick in range(2):
        noise = torch.from_numpy(_noise(name, tick))
        re = epilogue.solve(se, x0, noise=noise)
        rs = standalone.solve(ss, x0, noise=noise)
        for a, b in ((re.aux.lam, rs.aux.lam), (re.aux.costs, rs.aux.costs),
                     (re.action_seq, rs.action_seq), (re.aux.weights, rs.aux.weights)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert re.aux.lam.shape == () and cfg.lambda_min <= float(re.aux.lam) <= cfg.lambda_max
        se, ss = re.state, rs.state


@pytest.mark.parametrize("mode", ["ESSPS", "LBPS"])
def test_lambda_epilogue_matches_jax(jax_ref, nav_env, mode):
    task, dyn, _ = _port_plug("navigation", nav_env)
    cfg = MPPIConfig(horizon=HORIZON, num_samples=K, lambda_=mode, store_rollouts=False,
                     **DIMS["navigation"][0])
    solver = make_fused_solver(cfg, task, dyn, device="cpu", lambda_epilogue=True)
    from mppi_playground_tpu_torch.ops.lambda_search import (
        lbps_objective_plain,
        lbps_range_penalty,
    )

    bar = dict(rtol=1e-4, atol=1e-6) if mode == "ESSPS" else dict(rtol=1e-2, atol=0)
    state = solver.init()
    for tick in range(EPILOGUE_TICKS):
        ref = {key: jax_ref[f"{mode}_{tick}_{key}"] for key in ("lam", "costs", "actions", "x")}
        x = torch.from_numpy(ref["x"])  # the JAX trajectory's state, carried over
        r = solver.solve(state, x, noise=torch.from_numpy(_noise("navigation", tick)))
        np.testing.assert_allclose(float(r.aux.lam), float(ref["lam"]), **bar)
        if mode == "LBPS":
            pen = lbps_range_penalty(r.aux.costs, cfg.lbps_delta)
            objective = [lbps_objective_plain(r.aux.costs, torch.tensor(float(lam)), pen).item()
                         for lam in (r.aux.lam, ref["lam"])]
            np.testing.assert_allclose(*objective, rtol=1e-5)
        _costs_close(r.aux.costs.numpy(), ref["costs"], msg=f"{mode} tick {tick}")
        np.testing.assert_allclose(r.action_seq.numpy(), ref["actions"], atol=5e-3)
        state = r.state
