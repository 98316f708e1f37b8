"""The port's racing maps against the JAX package: byte-identical, exact queries.

Maps are built on the host with numpy in both packages from the same seeds,
so paths, grids and packed tables must be equal byte for byte.  A map query
is exact arithmetic (division, add, round half to even, compare), so the
port's ``grid_cost``, ``grid_cost_pair`` and ``interval_query_pair`` must
equal the JAX ``grid_cost`` with tolerance 0 on random points, on cell
boundaries and out of bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_playground_tpu.envs.racing_env import RacingEnv as JaxRacingEnv
from mppi_playground_tpu.maps import circuit as jax_circuit
from mppi_playground_tpu.maps.grid_cost import grid_cost as jax_grid_cost
from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
from mppi_playground_tpu_torch.maps import circuit
from mppi_playground_tpu_torch.maps.grid_cost import grid_cost, grid_cost_pair
from mppi_playground_tpu_torch.maps.obstacle_map import ObstacleMap, generate_random_obstacles
from mppi_playground_tpu_torch.ops.row_intervals import interval_query, interval_query_pair


@pytest.fixture(scope="module")
def envs():
    return JaxRacingEnv(), RacingEnv(device="cpu")


def _query_points(seed=0):
    """Random points, exact cell boundaries (+-half a cell) and out-of-bounds points."""
    rng = np.random.default_rng(seed)
    rand = rng.uniform(-41.0, 41.0, (20_000, 2))
    k = rng.integers(-400, 400, (4000, 2))
    bound = (k + 0.5) * 0.1
    near = np.concatenate([bound, np.nextafter(bound.astype(np.float32), 0),
                           np.nextafter(bound.astype(np.float32), 100)])
    oob = np.array([[40.05, 0.0], [-40.05, 0.0], [0.0, 39.95], [0.0, -40.06],
                    [1e3, 1e3], [-1e3, 5.0], [39.94, 39.94], [-39.95, -39.95]])
    return np.concatenate([rand, near, oob]).astype(np.float32)


@pytest.mark.parametrize("seed", [7, 3])
def test_circuit_paths_are_byte_identical(seed):
    for got, want in zip(circuit.default_circuit_paths(seed=seed),
                         jax_circuit.default_circuit_paths(seed=seed)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert circuit.generate_circuit(seed=seed)[0].tobytes() == \
        jax_circuit.generate_circuit(seed=seed)[0].tobytes()


def test_racing_grids_and_path_are_byte_identical(envs):
    jenv, env = envs
    assert env.obstacle_map.grid.tobytes() == jenv.obstacle_map._map.tobytes()
    assert env.lane_map.grid.tobytes() == jenv.lane_map._map.tobytes()
    np.testing.assert_array_equal(env.obstacle_map.origin, jenv.obstacle_map._cell_map_origin)
    np.testing.assert_array_equal(env.lane_map.origin, jenv.lane_map._cell_map_origin)
    assert env.obstacle_map.x_lim == jenv.obstacle_map.x_lim
    assert env.lane_map.y_lim == jenv.lane_map.y_lim
    assert env.racing_center_path.numpy().tobytes() == \
        np.asarray(jenv.racing_center_path).tobytes()
    for name in ("grid", "origin"):
        for pm, jm in ((env.obstacle_map, jenv.obstacle_map), (env.lane_map, jenv.lane_map)):
            assert getattr(pm.device_map, name).numpy().tobytes() == \
                np.asarray(getattr(jm.device_map, name)).tobytes()


@pytest.mark.parametrize("seed", [0, 11])
def test_random_obstacles_with_rectangles_are_byte_identical(seed):
    from mppi_playground_tpu.maps.obstacle_map import ObstacleMap as JaxObstacleMap
    from mppi_playground_tpu.maps.obstacle_map import (
        generate_random_obstacles as jax_generate,
    )

    kw = dict(random_x_range=(-8, 8), random_y_range=(-8, 8), num_circle_obs=6,
              radius_range=(0.3, 0.8), num_rectangle_obs=4, width_range=(0.5, 1.5),
              height_range=(0.5, 1.5), max_iteration=1000, seed=seed)
    m = ObstacleMap(map_size=(20, 20), cell_size=0.1, device="cpu")
    jm = JaxObstacleMap(map_size=(20, 20), cell_size=0.1)
    generate_random_obstacles(m, **kw)
    jax_generate(jm, **kw)
    assert m.grid.tobytes() == jm._map.tobytes()


def test_row_interval_tables_are_byte_identical(envs):
    jenv, env = envs
    for pm, jm in ((env.obstacle_map, jenv.obstacle_map), (env.lane_map, jenv.lane_map)):
        got, want = pm.row_interval_table(), jm.row_interval_table
        assert got.packed.tobytes() == np.asarray(want.packed).tobytes()
        assert got.slot_plan == want.slot_plan
        assert (got.origin, got.cell_size, got.width, got.height) == \
            (want.origin, want.cell_size, want.width, want.height)


def test_grid_queries_equal_jax_grid_cost(envs):
    jenv, env = envs
    pts = _query_points()
    jo = np.asarray(jax_grid_cost(jenv.obstacle_map.device_map, jnp.asarray(pts)))
    jl = np.asarray(jax_grid_cost(jenv.lane_map.device_map, jnp.asarray(pts)))
    tp = torch.from_numpy(pts)
    np.testing.assert_array_equal(grid_cost(env.obstacle_map.device_map, tp).numpy(), jo)
    np.testing.assert_array_equal(grid_cost(env.lane_map.device_map, tp).numpy(), jl)

    om, lm = env.obstacle_map, env.lane_map
    grids = [torch.from_numpy((m.grid != 0).astype(np.uint8)) for m in (om, lm)]
    pair = grid_cost_pair(grids[0], grids[1], tuple(float(v) for v in om.origin),
                          om.cell_size, tp[:, 0], tp[:, 1])
    np.testing.assert_array_equal(pair.numpy(), jo + jl)

    ot, lt = om.row_interval_table(), lm.row_interval_table()
    np.testing.assert_array_equal(interval_query(ot, tp[:, 0], tp[:, 1]).numpy(), jo)
    np.testing.assert_array_equal(
        interval_query_pair(ot, lt, tp[:, 0], tp[:, 1]).numpy(), jo + jl
    )
    # the points do exercise both sides of blocked cells and the border
    assert 0 < jo.mean() < 1 and 0 < jl.mean() < 1


def test_env_collision_check_and_step_match_jax(envs):
    jenv, env = envs
    rng = np.random.default_rng(3)
    traj = np.concatenate([rng.uniform(-40, 40, (4, 9, 2)), np.zeros((4, 9, 2))], axis=2)
    traj = traj.astype(np.float32)
    np.testing.assert_array_equal(
        env.collision_check(torch.from_numpy(traj)).numpy(),
        np.asarray(jenv.collision_check(jnp.asarray(traj))),
    )
    x0 = env.reset()
    jx0 = jenv.reset()
    # atan2 of the start heading comes from two libraries: 1 ulp
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=0, atol=2.4e-7)
    u = np.array([1.5, -0.3], np.float32)  # steer beyond its bound: clamped
    got, done = env.step(torch.from_numpy(u))
    jenv._robot_state = jnp.asarray(x0.numpy())
    want, jdone = jenv.step(jnp.asarray(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert done == jdone is False
