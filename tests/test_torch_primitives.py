"""The port's racing primitives against the JAX package, on the CPU.

Inputs are made from seeds with numpy and handed to both packages.  JAX runs
eagerly here: each of its operations is compiled on its own, so no
multiply-add is contracted into an FMA and the port, which repeats the JAX
arithmetic operation for operation, must give the same bits (tolerance 0)
wherever both sides use only +, -, *, /, comparisons, ``%`` and rounding.
Where a library transcendental (sin, cos) enters, the two libraries may
differ by an ulp: tolerance stated at the assertion.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_playground_tpu.envs.racing_env import RacingEnv as JaxRacingEnv
from mppi_playground_tpu.models import bicycle as jax_bicycle
from mppi_playground_tpu.models import racing_mpcc as jax_mpcc
from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
from mppi_playground_tpu.utils.angles import angle_normalize as jax_angle_normalize
from mppi_playground_tpu.utils.fastmath import sincos_2pi as jax_sincos_2pi
from mppi_playground_tpu.utils.fastmath import sincos_npi as jax_sincos_npi
from mppi_playground_tpu_torch.core.config import MPPIConfig, tick_seed
from mppi_playground_tpu_torch.models import bicycle
from mppi_playground_tpu_torch.models import racing_mpcc
from mppi_playground_tpu_torch.ops.fused_solve import philox4x32_10
from mppi_playground_tpu_torch.utils import convert
from mppi_playground_tpu_torch.utils.angles import angle_normalize
from mppi_playground_tpu_torch.utils.fastmath import sincos_2pi, sincos_npi

X_LIM = (-40.0, 40.0)
Y_LIM = (-40.0, 40.0)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(a):
    return np.asarray(a)


@pytest.fixture(scope="module")
def jax_env():
    return JaxRacingEnv()


def test_angle_normalize_matches_jax_bitwise():
    rng = np.random.default_rng(0)
    pi = np.float32(np.pi)
    ties = np.array(
        [pi, -pi, 3 * pi, -3 * pi, np.nextafter(pi, 0), np.nextafter(-pi, 0),
         0.0, -0.0, 2 * pi, -2 * pi, 1e-30, -1e-30], np.float32
    )
    x = np.concatenate([(rng.standard_normal(100_000) * 20).astype(np.float32), ties])
    got = angle_normalize(_t(x)).numpy()
    want = _np(jax_angle_normalize(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)  # tolerance 0
    assert np.all(got >= -pi) and np.all(got <= pi)


def test_sincos_match_jax_bitwise():
    rng = np.random.default_rng(1)
    x = rng.uniform(-np.pi, np.pi, 100_000).astype(np.float32)
    for got, want in zip(sincos_npi(_t(x)), jax_sincos_npi(jnp.asarray(x))):
        np.testing.assert_array_equal(got.numpy(), _np(want))  # tolerance 0
    u = rng.uniform(0.0, 2 * np.pi, 100_000).astype(np.float32)
    for got, want in zip(sincos_2pi(_t(u)), jax_sincos_2pi(jnp.asarray(u))):
        np.testing.assert_array_equal(got.numpy(), _np(want))  # tolerance 0


def test_tan_small_matches_jax_bitwise():
    x = np.linspace(-0.25, 0.25, 20_001, dtype=np.float32)
    np.testing.assert_array_equal(
        bicycle._tan_small(_t(x)).numpy(), _np(jax_bicycle._tan_small(jnp.asarray(x)))
    )


def _random_states_actions(n, seed):
    rng = np.random.default_rng(seed)
    states = np.stack(
        [rng.uniform(-42, 42, n), rng.uniform(-42, 42, n),
         rng.uniform(-10, 10, n), rng.uniform(-9, 9, n)], axis=1
    ).astype(np.float32)
    actions = np.stack([rng.uniform(-3, 3, n), rng.uniform(-0.4, 0.4, n)], axis=1)
    return states, actions.astype(np.float32)


def test_bicycle_soa_and_aos_match_jax_bitwise():
    states, actions = _random_states_actions(50_000, 2)
    soa = bicycle.make_dynamics_soa(X_LIM, Y_LIM)
    jsoa = jax_bicycle.make_dynamics_soa(X_LIM, Y_LIM)
    got = soa(tuple(_t(states[:, c]) for c in range(4)), (_t(actions[:, 0]), _t(actions[:, 1])))
    want = jsoa(tuple(jnp.asarray(states[:, c]) for c in range(4)),
                (jnp.asarray(actions[:, 0]), jnp.asarray(actions[:, 1])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))  # tolerance 0
    aos = bicycle.make_dynamics(X_LIM, Y_LIM)(_t(states), _t(actions))
    jaos = jax_bicycle.make_dynamics(X_LIM, Y_LIM)(jnp.asarray(states), jnp.asarray(actions))
    np.testing.assert_array_equal(aos.numpy(), _np(jaos))  # tolerance 0


def test_bicycle_wide_steering_keeps_true_tan():
    dyn = bicycle.make_dynamics((-100.0, 100.0), (-100.0, 100.0), u_min=(-2.0, -1.2),
                                u_max=(2.0, 1.2))
    out = dyn(_t([[0.0, 0.0, 0.0, 4.0]]), _t([[0.0, 1.2]]))
    np.testing.assert_allclose(float(out[0, 2]), 4.0 * np.tan(1.2) * 0.1, rtol=1e-6)


def test_mpcc_costs_match_jax(jax_env):
    """AoS cost against JAX's AoS cost; SoA cost (the kernel's order) against JAX's SoA cost."""
    env = jax_env
    states, actions = _random_states_actions(20_000, 3)
    prev = np.random.default_rng(4).uniform(-2, 2, actions.shape).astype(np.float32)
    xref, _ = jax_mpcc.calc_ref_trajectory(
        jnp.asarray(states[0]), env.racing_center_path, jnp.asarray(0, jnp.int32), 10
    )
    om = env.obstacle_map.device_map
    lm = env.lane_map.device_map
    t_om = convert.grid_map(_np(om.grid), _np(om.origin), om.cell_size, device="cpu")
    t_lm = convert.grid_map(_np(lm.grid), _np(lm.origin), lm.cell_size, device="cpu")
    for t in (0, 4, 10):
        info = {"reference_path": xref, "t": t, "prev_action": jnp.asarray(prev)}
        want = _np(jax_mpcc.make_mpcc_cost(om, lm)(jnp.asarray(states), jnp.asarray(actions), info))
        tinfo = {"reference_path": _t(xref), "t": t, "prev_action": _t(prev)}
        got = racing_mpcc.make_mpcc_cost(t_om, t_lm)(_t(states), _t(actions), tinfo).numpy()
        # sin/cos of the reference yaw come from two libraries: rtol 1e-6
        np.testing.assert_allclose(got, want, rtol=1e-6)

        xref5 = jax_mpcc.extend_reference_path(xref)
        ctx = dict(t=t, prev_us=(jnp.asarray(prev[:, 0]), jnp.asarray(prev[:, 1])),
                   smem={"xref": xref5},
                   vmem={"obstacle_table": env.obstacle_map.row_interval_table,
                         "lane_table": env.lane_map.row_interval_table})
        xs = tuple(jnp.asarray(states[:, c]) for c in range(4))
        us = (jnp.asarray(actions[:, 0]), jnp.asarray(actions[:, 1]))
        want_soa = _np(jax_mpcc.make_mpcc_cost_soa()(xs, us, ctx))
        grids = tuple(torch.from_numpy((_np(m.grid) != 0).astype(np.uint8)) for m in (om, lm))
        tctx = dict(t=t, prev_us=(_t(prev[:, 0]), _t(prev[:, 1])), xref=_t(xref5),
                    maps=(grids[0], grids[1], tuple(_np(om.origin).tolist()), om.cell_size))
        got_soa = racing_mpcc.make_mpcc_cost_soa()(
            tuple(_t(states[:, c]) for c in range(4)), (_t(actions[:, 0]), _t(actions[:, 1])), tctx
        ).numpy()
        np.testing.assert_array_equal(got_soa, want_soa)  # same reference rows: tolerance 0


def test_extend_reference_path_matches_jax():
    rng = np.random.default_rng(5)
    xref = np.stack([rng.uniform(-40, 40, 51), rng.uniform(-40, 40, 51),
                     rng.uniform(-np.pi, np.pi, 51), np.full(51, 8.0)], axis=1).astype(np.float32)
    got = racing_mpcc.extend_reference_path(_t(xref)).numpy()
    want = _np(jax_mpcc.extend_reference_path(jnp.asarray(xref)))
    np.testing.assert_array_equal(got[:, [0, 1, 4]], want[:, [0, 1, 4]])
    # torch and XLA sin/cos: within 2 ulp of values <= 1
    np.testing.assert_allclose(got[:, 2:4], want[:, 2:4], rtol=0, atol=2.4e-7)


@pytest.mark.parametrize("where", ["start", "middle", "near_end", "overrun", "held_back"])
def test_calc_ref_trajectory_matches_jax(jax_env, where):
    path = _np(jax_env.racing_center_path)
    n = path.shape[0]
    idx, cind = {
        "start": (0, 0), "middle": (n // 2, 0), "near_end": (n - 60, 0),
        "overrun": (n - 3, 0), "held_back": (n // 3, n // 2),
    }[where]
    state = np.array([path[idx, 0] + 0.03, path[idx, 1] - 0.02, 0.1, 3.0], np.float32)
    for horizon in (10, 50):
        want, wind = jax_mpcc.calc_ref_trajectory(
            jnp.asarray(state), jnp.asarray(path), jnp.asarray(cind, jnp.int32), horizon
        )
        got, gind = racing_mpcc.calc_ref_trajectory(
            _t(state), convert.center_path(path, device="cpu"), torch.tensor(cind), horizon
        )
        np.testing.assert_array_equal(got.numpy(), _np(want))  # tolerance 0
        assert int(gind) == int(wind)
    if where == "overrun":
        assert np.all(got.numpy()[:, 3] == 0.0)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import mppi_playground_tpu_torch\n"
        "import mppi_playground_tpu_torch.workloads, mppi_playground_tpu_torch.utils.convert\n"
        "from mppi_playground_tpu_torch.workloads import build_flagship\n"
        "import mppi_playground_tpu_torch.core.fused_solver, mppi_playground_tpu_torch.envs\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'mppi_playground_tpu' or m.startswith('mppi_playground_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
    from mppi_playground_tpu_torch.core.solver import make_solver
    from mppi_playground_tpu_torch.workloads import build_flagship

    with pytest.raises(RuntimeError, match="device='cpu'"):
        RacingEnv()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_flagship(num_samples=256)
    cfg = MPPIConfig(horizon=4, num_samples=8, dim_state=4, dim_control=2,
                     u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1), lambda_=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_solver(cfg, lambda x, u: x, lambda x, u, i: x[:, 0])
    from mppi_playground_tpu_torch.maps.lane_map import LaneMap
    from mppi_playground_tpu_torch.maps.obstacle_map import ObstacleMap

    lane = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    for build in (
        lambda: ObstacleMap(map_size=(2, 2), cell_size=0.1),
        lambda: LaneMap(lane, lane_width=1.0, map_size=(2, 2), cell_size=0.1),
        lambda: convert.mppi_state(np.zeros((4, 2)), np.zeros((3, 2)), 1.0),
        lambda: convert.grid_map(np.zeros((4, 4)), np.array([2, 2]), 0.1),
        lambda: convert.center_path(lane),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    # asked for the CPU, each of them builds
    cpu_map = ObstacleMap(map_size=(2, 2), cell_size=0.1, device="cpu")
    assert cpu_map.device_map.grid.device.type == "cpu"
    assert convert.center_path(lane, device="cpu").device.type == "cpu"


_BASE = dict(horizon=10, num_samples=64, dim_state=4, dim_control=2,
             u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1), lambda_=1.0)


@pytest.mark.parametrize("change", [
    {}, {"horizon": 0}, {"num_samples": 0}, {"sigmas": (0.5,)}, {"lambda_": "FOO"},
    {"lambda_": "ESSPS"}, {"lambda_": None}, {"exploration": 1.5}, {"exploration": 0.3},
    {"use_sg_filter": True, "sg_window_size": 4}, {"use_sg_filter": True},
    {"kernel_backend": "cuda"},
])
def test_config_accepts_and_rejects_like_jax(change):
    kw = dict(_BASE, **change)
    try:
        want = JaxConfig(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            MPPIConfig(**kw)
        return
    got = MPPIConfig(**kw)
    for prop in ("auto_lambda", "initial_lambda", "target_ess", "inherited_samples"):
        assert getattr(got, prop) == getattr(want, prop)


def test_tick_seed_is_deterministic_and_spreads():
    seeds = {tick_seed(42, t) for t in range(10_000)}
    assert len(seeds) == 10_000
    assert tick_seed(42, 7) == tick_seed(42, 7) != tick_seed(43, 7)
    assert all(0 <= s < 2**31 for s in seeds)


def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors of the Random123 reference."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        out = philox4x32_10([torch.tensor([c]) for c in ctr], key[0], torch.tensor([key[1]]))
        assert tuple(int(o) for o in out) == want
