"""The JAX fused config sweep on a user's own model: the fused solver with a ``ModelPlug``.

``tests/test_fused_config_sweep.py`` drives the JAX package's
dimension-generic linear task through five configurations (horizon, state
and control widths, K with a padded tile, each lambda mode, exploration, the
SG filter) over two chained ticks.  Here the same task is a user's model
plug (``chip_smoke.linear_plug``: the CUDA source of its plug struct and its
torch twins), so the port's fused solver runs it on the CPU through the
twins, as the card runs the plug's kernels.  Each case, with the same noise
(numpy, from the case's seed) on both sides, is held against the JAX
``make_solver`` (XLA, in a subprocess with FMA contraction off) and against
the port's unfused solver, at the JAX sweep's own bars: costs rtol 2e-5 on
tick 0 and 1e-3 on tick 1 (tick 1 inherits tick 0's float32 drift in the
warm start), lambda and ESS rtol 1e-2, actions and states atol 5e-3.  Two
cases take m=3, whose steps straddle the kernels' Philox blocks.
"""

import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from mppi_playground_tpu_torch.core.config import MPPIConfig
from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
from mppi_playground_tpu_torch.core.solver import make_solver
from tests.test_torch_fused_solve import run_jax_references

CASES = [
    # (name, T, n, m, K, lambda_, exploration, use_sg): tests/test_fused_config_sweep.py's
    ("fixed", 6, 3, 2, 1024, 1.0, 0.0, False),
    ("essps-exploration", 8, 2, 1, 2048, "ESSPS", 0.25, False),
    ("lbps-sg-odd-dims", 5, 4, 3, 1024, "LBPS", 0.0, True),
    ("mpo-padded-k", 10, 2, 2, 1536, "MPO", 0.5, False),
    ("essps-multi-vreg", 50, 3, 3, 1024, "ESSPS", 0.0, True),
]
BY_NAME = {case[0]: case for case in CASES}
TICKS = 2


def _sigmas(m):
    return tuple(0.5 + 0.1 * j for j in range(m))


def _noise(name, tick):
    """The case's injected noise ``[K, T, m]`` of one tick, already scaled by sigma."""
    _, horizon, _, m, k, _, _, _ = BY_NAME[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()) + tick)
    return (rng.standard_normal((k, horizon, m)) * np.asarray(_sigmas(m))).astype(np.float32)


def _jax_case(name: str, out_path: str) -> None:
    """Subprocess body: the JAX XLA solver on the JAX sweep's linear task, two chained ticks."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu import MPPIConfig as JaxConfig
    from mppi_playground_tpu import make_solver as jax_make_solver
    from tests.test_fused_config_sweep import _make_linear_model

    _, horizon, n, m, k, lambda_, exploration, use_sg = BY_NAME[name]
    dynamics, cost, _ = _make_linear_model(n, m)
    config = JaxConfig(horizon=horizon, num_samples=k, dim_state=n, dim_control=m,
                       u_min=(-1.0,) * m, u_max=(1.0,) * m, sigmas=_sigmas(m), lambda_=lambda_,
                       exploration=exploration, use_sg_filter=use_sg, store_rollouts=False)
    xla = jax_make_solver(config, dynamics, cost, jit=True, donate_state=False)
    x0 = jnp.linspace(-0.5, 0.5, n).astype(jnp.float32)
    state, out = xla.init(), {"x0": np.asarray(x0)}
    for tick in range(TICKS):
        r = xla.solve(state, x0, noise=jnp.asarray(_noise(name, tick)))
        state = r.state
        for key, value in dict(costs=r.aux.costs, lam=r.aux.lam, action_seq=r.action_seq,
                               state_seq=r.state_seq, ess=r.aux.ess).items():
            out[f"{tick}_{key}"] = np.asarray(value)
    np.savez(out_path, **out)


def jax_fixed(out_path: str) -> None:
    _jax_case("fixed", out_path)


def jax_essps_exploration(out_path: str) -> None:
    _jax_case("essps-exploration", out_path)


def jax_lbps_sg_odd_dims(out_path: str) -> None:
    _jax_case("lbps-sg-odd-dims", out_path)


def jax_mpo_padded_k(out_path: str) -> None:
    _jax_case("mpo-padded-k", out_path)


def jax_essps_multi_vreg(out_path: str) -> None:
    _jax_case("essps-multi-vreg", out_path)


def _reference_name(name):
    return "jax_" + name.replace("-", "_")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax_references("tests.test_torch_fused_config_sweep",
                              [_reference_name(case[0]) for case in CASES],
                              tmp_path_factory.mktemp("jax_sweep"))


def _port_ticks(name, x0, fused: bool):
    """The port's fused solver on the linear plug (or its unfused solver), two chained ticks."""
    _, horizon, n, m, k, lambda_, exploration, use_sg = BY_NAME[name]
    plug = chip_smoke.linear_plug(n, m)
    config = MPPIConfig(horizon=horizon, num_samples=k, dim_state=n, dim_control=m,
                        u_min=plug.u_min, u_max=plug.u_max, sigmas=plug.sigmas,
                        lambda_=lambda_, exploration=exploration, use_sg_filter=use_sg,
                        store_rollouts=False)
    if fused:
        solver = make_fused_solver(config, plug.task, plug.dynamics, device="cpu")
    else:
        solver = make_solver(config, plug.dynamics, plug.cost, device="cpu")
    state, results = solver.init(), []
    for tick in range(TICKS):
        r = solver.solve(state, x0, noise=torch.from_numpy(_noise(name, tick)))
        state = r.state
        results.append(dict(costs=r.aux.costs.numpy(), lam=float(r.aux.lam),
                            action_seq=r.action_seq.numpy(), state_seq=r.state_seq.numpy(),
                            ess=float(r.aux.ess)))
    return results


def _assert_sweep_bars(got, want, label):
    """The JAX sweep's bars, tick by tick: ``want`` is ``{tick: {key: array}}``-shaped."""
    for tick in range(TICKS):
        g, w = got[tick], want[tick]
        np.testing.assert_allclose(g["costs"], w["costs"], rtol=2e-5 if tick == 0 else 1e-3,
                                   err_msg=f"{label} tick {tick}: costs")
        np.testing.assert_allclose(g["lam"], w["lam"], rtol=1e-2,
                                   err_msg=f"{label} tick {tick}: lambda")
        np.testing.assert_allclose(g["action_seq"], w["action_seq"], atol=5e-3,
                                   err_msg=f"{label} tick {tick}: action_seq")
        np.testing.assert_allclose(g["state_seq"], w["state_seq"], atol=5e-3,
                                   err_msg=f"{label} tick {tick}: state_seq")
        np.testing.assert_allclose(g["ess"], w["ess"], rtol=1e-2,
                                   err_msg=f"{label} tick {tick}: ess")


@pytest.mark.parametrize("name", [case[0] for case in CASES])
def test_plug_fused_matches_jax_across_configs(jax_ref, name):
    ref = jax_ref[_reference_name(name)]
    got = _port_ticks(name, torch.from_numpy(ref["x0"]), fused=True)
    want = [{key: ref[f"{tick}_{key}"] for key in got[0]} for tick in range(TICKS)]
    _assert_sweep_bars(got, want, f"{name} fused plug vs JAX")


@pytest.mark.parametrize("name", [case[0] for case in CASES])
def test_plug_fused_matches_unfused_across_configs(name):
    n = BY_NAME[name][2]
    x0 = torch.linspace(-0.5, 0.5, n)
    _assert_sweep_bars(_port_ticks(name, x0, fused=True), _port_ticks(name, x0, fused=False),
                       f"{name} fused plug vs unfused")
