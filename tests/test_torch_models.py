"""The port's model families against the JAX package's, and the seeded stream for any m.

* Each model's SoA and AoS dynamics and cost (pendulum, cartpole, mountain
  car, integrator, unicycle navigation, danger zone) against the JAX module
  on the same random states and actions, made with numpy.  The JAX side
  runs in a subprocess with XLA's FMA contraction off (see
  tests/test_torch_fused_solve.py), so models without libm calls (the
  integrator, the unicycle with its polynomial sin/cos) must step bit for
  bit, and the integrator's cost too.  Pendulum, cartpole, mountain car and
  danger zone call sin/cos, which XLA and PyTorch evaluate with different
  polynomials on the CPU, and XLA's float32 sqrt on the CPU is not correctly
  rounded (1 ulp off on about 1 value in 250; PyTorch's and the card's
  sqrtf are), which the navigation and danger-zone costs take: states are
  held to rtol 1e-5, atol 1e-6 and costs to the JAX package's fused-vs-XLA
  bar (tests/test_fused_models.py), rtol 2e-5, atol 1e-5.
  Threshold costs are kept away from their thresholds, where one ulp flips
  them: cartpole's ``u >= 0`` (|u| > 1e-3), the danger zone's ``distance <
  radius`` (|distance - radius| > 1e-3).
* The seeded Philox stream: for m=2 the generic slot mapping gives the
  racing stream of earlier releases bit for bit (pairs (x, y) on even steps,
  (z, w) on odd ones), and the stream of m=1 is the same slot sequence.
"""

import math

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch.core.config import tick_seed
from mppi_playground_tpu_torch.maps.grid_cost import GridMapData
from mppi_playground_tpu_torch.models import (
    cartpole,
    danger_zone,
    integrator,
    mountain_car,
    pendulum,
    unicycle,
)
from mppi_playground_tpu_torch.ops import fused_solve
from tests.test_torch_fused_solve import run_jax_reference

BATCH = 512
LIBM = ("pendulum", "cartpole", "mountain_car", "danger_zone")
SQRT_COST = ("navigation", "danger_zone")
NAV_LIM = (-10.0, 10.0)
NAV_GOAL = (9.0, 9.0)
DZ_RADIUS = 1.5


def _inputs(name):
    """Random states ``[B, n]`` and actions ``[B, m]`` for model ``name``, float32."""
    rng = np.random.default_rng(sum(map(ord, name)))
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape)  # noqa: E731
    if name == "pendulum":
        x, a = np.stack([u(-7, 7, BATCH), u(-9, 9, BATCH)], 1), u(-3, 3, BATCH, 1)
    elif name == "cartpole":
        x = np.stack([u(-3, 3, BATCH), u(-2, 2, BATCH), u(-0.5, 0.5, BATCH), u(-3, 3, BATCH)], 1)
        a = u(-3, 3, BATCH, 1)
        a = np.where(np.abs(a) < 1e-3, 0.5, a)  # away from the bang-bang switch
    elif name == "mountain_car":
        x, a = np.stack([u(-1.3, 0.7, BATCH), u(-0.08, 0.08, BATCH)], 1), u(-1.5, 1.5, BATCH, 1)
    elif name == "integrator":
        x, a = u(-3, 3, BATCH, 2), u(-1, 1, BATCH, 2)
    elif name == "navigation":
        x = np.stack([u(-11, 11, BATCH), u(-11, 11, BATCH), u(-7, 7, BATCH)], 1)
        a = np.stack([u(-0.5, 2.5, BATCH), u(-1.5, 1.5, BATCH)], 1)
    else:  # danger zone: goal and centre as offsets from the position
        pos = u(-4, 4, BATCH, 2)
        goal, center = u(-4, 4, BATCH, 2), u(-4, 4, BATCH, 2)
        dist = np.linalg.norm(center - pos, axis=1)
        center = np.where((np.abs(dist - DZ_RADIUS) < 1e-3)[:, None], pos + 3.0, center)
        x = np.concatenate([pos, u(-4, 4, BATCH, 1), goal - pos, center - pos], 1)
        a = u(-1.5, 1.5, BATCH, 2)
    return x.astype(np.float32), a.astype(np.float32)


MODELS = ("pendulum", "cartpole", "mountain_car", "integrator", "navigation", "danger_zone")


def jax_models_reference(out_path: str) -> None:
    """Subprocess body: every model's SoA and AoS dynamics and cost in the JAX package."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu.maps.grid_cost import GridMapData
    from mppi_playground_tpu.models import cartpole as jc
    from mppi_playground_tpu.models import danger_zone as jd
    from mppi_playground_tpu.models import integrator as ji
    from mppi_playground_tpu.models import mountain_car as jm
    from mppi_playground_tpu.models import pendulum as jp
    from mppi_playground_tpu.models import unicycle as ju
    from mppi_playground_tpu.ops.row_intervals import build_row_interval_table

    grid, origin = _nav_grid()
    table = build_row_interval_table(grid, origin, 0.1)
    gmap = GridMapData(grid=jnp.asarray(grid, jnp.float32), origin=jnp.asarray(origin, jnp.float32),
                       cell_size=0.1)
    plugs = {
        "pendulum": (jp.dynamics_soa, jp.cost_soa, jp.dynamics, jp.cost, {}),
        "cartpole": (jc.dynamics_soa, jc.cost_soa, jc.dynamics, jc.cost, {}),
        "mountain_car": (jm.dynamics_soa, jm.cost_soa, jm.dynamics, jm.cost, {}),
        "integrator": (ji.dynamics_soa, ji.cost_soa, ji.dynamics, ji.cost, {}),
        "navigation": (ju.make_dynamics_soa(NAV_LIM, NAV_LIM),
                       ju.make_navigation_cost_soa(NAV_GOAL), ju.make_dynamics(NAV_LIM, NAV_LIM),
                       ju.make_navigation_cost(jnp.asarray(NAV_GOAL, jnp.float32), gmap),
                       {"vmem": {"obstacle_table": table}}),
        "danger_zone": (jd.make_dynamics_soa(), jd.make_cost_soa(DZ_RADIUS), jd.make_dynamics(),
                        jd.make_cost(DZ_RADIUS), {}),
    }
    out = {}
    for name, (dyn_soa, cost_soa, dyn, cost, ctx) in plugs.items():
        x, a = (jnp.asarray(v) for v in _inputs(name))
        xs = tuple(x[:, c] for c in range(x.shape[1]))
        us = tuple(a[:, j] for j in range(a.shape[1]))
        out[f"{name}_soa_next"] = np.stack(
            [np.asarray(v) for v in jax.jit(dyn_soa)(xs, us)], 1)
        out[f"{name}_soa_cost"] = np.asarray(jax.jit(lambda xs, us: cost_soa(xs, us, ctx))(xs, us))
        out[f"{name}_next"] = np.asarray(jax.jit(dyn)(x, a))
        out[f"{name}_cost"] = np.asarray(jax.jit(lambda x, a: cost(x, a, {}))(x, a))
    np.savez(out_path, **out)


def _nav_grid():
    """A 20x20 m map at 0.1 m cells with a few blocked boxes, and its origin."""
    grid = np.zeros((200, 200), np.float32)
    grid[40:70, 50:90] = 1.0
    grid[120:125, 10:190] = 1.0
    grid[150:180, 140:160] = 1.0
    return grid, np.array([100.0, 100.0], np.float32)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax_reference("tests.test_torch_models", "jax_models_reference",
                             tmp_path_factory.mktemp("jax_models"))


def _port_plug(name):
    if name == "navigation":
        grid, origin = _nav_grid()
        g = torch.from_numpy(grid != 0).to(torch.uint8)
        gmap = GridMapData(grid=torch.from_numpy(grid), origin=torch.from_numpy(origin),
                           cell_size=0.1)
        return (unicycle.make_dynamics_soa(NAV_LIM, NAV_LIM),
                unicycle.make_navigation_cost_soa(NAV_GOAL, g, tuple(origin.tolist()), 0.1),
                unicycle.make_dynamics(NAV_LIM, NAV_LIM),
                unicycle.make_navigation_cost(torch.tensor(NAV_GOAL), gmap))
    if name == "danger_zone":
        return (danger_zone.make_dynamics_soa(), danger_zone.make_cost_soa(DZ_RADIUS),
                danger_zone.make_dynamics(), danger_zone.make_cost(DZ_RADIUS))
    module = {"pendulum": pendulum, "cartpole": cartpole, "mountain_car": mountain_car,
              "integrator": integrator}[name]
    return module.dynamics_soa, module.cost_soa, module.dynamics, module.cost


@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax(jax_ref, name):
    dyn_soa, cost_soa, dyn, cost = _port_plug(name)
    x, a = (torch.from_numpy(v) for v in _inputs(name))
    xs = tuple(x[:, c] for c in range(x.shape[1]))
    us = tuple(a[:, j] for j in range(a.shape[1]))
    got = {
        "soa_next": torch.stack(dyn_soa(xs, us), 1).numpy(),
        "soa_cost": cost_soa(xs, us, {}).numpy(),
        "next": dyn(x, a).numpy(),
        "cost": cost(x, a, {}).numpy(),
    }
    for key, value in got.items():
        want = jax_ref[f"{name}_{key}"]
        assert value.shape == want.shape, key
        exact = name not in LIBM and not (name in SQRT_COST and key.endswith("cost"))
        if exact:
            np.testing.assert_array_equal(value, want, err_msg=f"{name} {key}")  # tolerance 0
        elif key.endswith("next"):
            np.testing.assert_allclose(value, want, rtol=1e-5, atol=1e-6, err_msg=f"{name} {key}")
        else:
            np.testing.assert_allclose(value, want, rtol=2e-5, atol=1e-5, err_msg=f"{name} {key}")
    # the AoS forms are the SoA forms on columns (navigation's AoS cost reads the
    # float grid through grid_cost, its SoA cost the uint8 raster: the same cells)
    np.testing.assert_array_equal(got["soa_next"], got["next"])
    np.testing.assert_array_equal(got["soa_cost"], got["cost"])


@pytest.mark.parametrize("name", MODELS)
def test_fused_task_matches_model(name):
    """Each model's FusedTask names its kernels and carries its own twins."""
    from mppi_playground_tpu_torch.workloads import build_model_workload

    w = build_model_workload(name, device="cpu", num_samples=8)
    task = w.task
    assert task.model == name
    assert (task.dim_state, task.dim_control) == (w.mppi_kwargs["dim_state"],
                                                  w.mppi_kwargs["dim_control"])
    assert task.reference_width == 0
    x = w.x0[None].expand(4, -1)
    u = torch.zeros(4, task.dim_control)
    soa = torch.stack(task.dynamics_soa(tuple(x[:, c] for c in range(task.dim_state)),
                                        tuple(u[:, j] for j in range(task.dim_control))), 1)
    torch.testing.assert_close(soa, w.mppi_kwargs["dynamics"](x, u), rtol=0, atol=0)


def _pr3_normals(seed, num_samples, horizon):
    """The racing stream of earlier releases: one Philox block per pair of steps."""
    quads = (horizon + 1) // 2
    k = torch.arange(num_samples, dtype=torch.int64)[:, None]
    q = torch.arange(quads, dtype=torch.int64)[None, :].expand(num_samples, quads)
    zero = torch.zeros_like(q)
    w0, w1, w2, w3 = fused_solve.philox4x32_10((q, zero, zero, zero), int(seed) & 0xFFFFFFFF, k)
    a0, a1 = fused_solve.normal_pair_from_bits(w0, w1)
    b0, b1 = fused_solve.normal_pair_from_bits(w2, w3)
    z = torch.stack([a0, a1, b0, b1], dim=-1).reshape(num_samples, 4 * quads)
    return z[:, : 2 * horizon].reshape(num_samples, horizon, 2)


@pytest.mark.parametrize("seed,horizon", [(tick_seed(42, 0), 50), (tick_seed(7, 3), 7),
                                          (0, 1), (2**31 - 1, 30)])
def test_seeded_stream_of_two_actions_is_unchanged(seed, horizon):
    got = fused_solve.seeded_normals(seed, 300, horizon, "cpu", dim_control=2)
    torch.testing.assert_close(got, _pr3_normals(seed, 300, horizon), rtol=0, atol=0)
    # the default is the racing model's two actions
    torch.testing.assert_close(fused_solve.seeded_normals(seed, 300, horizon, "cpu"), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("horizon", [1, 15, 100])
def test_seeded_stream_is_one_slot_sequence_for_any_m(horizon):
    """Slot f = t*m + j takes normal f mod 4 of counter f div 4, whatever m is."""
    seed = tick_seed(3, 9)
    one = fused_solve.seeded_normals(seed, 200, 2 * horizon, "cpu", dim_control=1)
    two = fused_solve.seeded_normals(seed, 200, horizon, "cpu", dim_control=2)
    torch.testing.assert_close(one.reshape(200, horizon, 2), two, rtol=0, atol=0)
    z = one.double().numpy().ravel()
    assert abs(z.mean()) < 5 / math.sqrt(z.size) and abs(z.var() - 1.0) < 5 * math.sqrt(2 / z.size)
