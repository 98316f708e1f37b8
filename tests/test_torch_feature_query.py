"""The port's analytic feature-map query on the CPU: bit for bit the grid, and JAX's features.

Mirrors ``tests/test_feature_query.py`` on the port's maps: the obstacle
map of the navigation example verifies analytically (7 discs, 7
rectangles), its feature query equals ``grid_cost`` bit for bit on random
points, cell centers and boundaries; the racing-style lane corridor prunes
its discs and is exact; ``map_query`` dispatches both forms; a grid no
feature explains gives ``None``.  Against the JAX package (a subprocess with
XLA's FMA contraction off): the built ``FeatureMapData`` arrays equal JAX's,
and JAX's features carried over by ``utils/convert.feature_map`` query bit
for bit the port's grid and JAX's own query.  The unfused racing and
navigation costs give the same values through either map form.
"""

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch.maps import (
    LaneMap,
    ObstacleMap,
    build_feature_map,
    feature_cost,
    generate_random_obstacles,
    grid_cost,
    map_query,
)
from mppi_playground_tpu_torch.utils import convert

ARRAYS = ("disc_x", "disc_y", "disc_r2", "rect_x0", "rect_x1", "rect_y0", "rect_y1", "origin")
STATIC = ("cell_size", "width", "height", "inside_is_blocked")
SPAN = 12.0


def _points(span=SPAN, n=50_000, seed=0):
    """Random points, and a 101 x 101 lattice of cell centers and boundaries."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-span, span, (n, 2)).astype(np.float32)
    lin = np.linspace(-span, span, 101, dtype=np.float32)
    lattice = np.stack(np.meshgrid(lin, lin), axis=-1).reshape(-1, 2)
    return np.concatenate([pts, lattice])


def _nav_obstacles(m):
    generate_random_obstacles(obstacle_map=m, random_x_range=(-7.5, 7.5),
                              random_y_range=(-7.5, 7.5), num_circle_obs=7, radius_range=(1, 1),
                              num_rectangle_obs=7, width_range=(2, 2), height_range=(2, 2),
                              max_iteration=1000, seed=42)
    return m


def _lane():
    theta = np.linspace(0, 2 * np.pi, 700, endpoint=False)
    return np.stack([6.0 * np.cos(theta), 4.0 * np.sin(theta), np.zeros_like(theta)], axis=1)


@pytest.fixture(scope="module")
def nav_map():
    return _nav_obstacles(ObstacleMap(map_size=(20, 20), cell_size=0.1, device="cpu"))


@pytest.fixture(scope="module")
def lane_map():
    return LaneMap(lane=_lane(), lane_width=2.4, map_size=(20, 20), cell_size=0.1, device="cpu")


def _assert_exact(device_map, fm):
    pts = torch.from_numpy(_points())
    assert torch.equal(grid_cost(device_map, pts), feature_cost(fm, pts))


def test_obstacle_feature_map_verifies(nav_map):
    fm = nav_map.feature_map
    assert fm is not None, "a reference-style obstacle map must verify analytically"
    assert fm.disc_x.shape[0] == 7
    assert fm.rect_x0.shape[0] == 7
    assert nav_map.cost_map is fm


def test_obstacle_feature_query_exact(nav_map):
    _assert_exact(nav_map.device_map, nav_map.feature_map)


def test_lane_feature_map_pruned_and_exact(lane_map):
    fm = lane_map.feature_map
    assert fm is not None and not fm.inside_is_blocked
    # pruning must shrink the feature set substantially
    assert fm.disc_x.shape[0] < len(lane_map._centerline_cells) * 0.7
    _assert_exact(lane_map.device_map, fm)


def test_map_query_dispatch(nav_map):
    pts = torch.tensor([[0.0, 0.0], [100.0, 100.0]])
    via_grid = map_query(nav_map.device_map, pts)
    via_features = map_query(nav_map.feature_map, pts)
    assert torch.equal(via_grid, via_features)
    assert float(via_grid[1]) == 1.0  # out of bounds costs 1.0 on both paths


def test_build_returns_none_on_mismatch():
    grid = np.zeros((64, 64))
    grid[10, 10] = 1  # a cell no feature explains
    fm = build_feature_map(grid, origin=np.array([32, 32]), cell_size=0.1,
                           disc_centers=np.zeros((0, 2)), disc_r2=np.zeros((0,)), device="cpu")
    assert fm is None


def test_an_added_obstacle_rebuilds_the_features():
    m = _nav_obstacles(ObstacleMap(map_size=(20, 20), cell_size=0.1, device="cpu"))
    before = m.feature_map
    m.add_circle_obstacle(np.array([9.0, 9.0]), 0.5)
    assert m.feature_map is not before and m.feature_map.disc_x.shape[0] == 8
    _assert_exact(m.device_map, m.feature_map)


def test_unfused_costs_read_either_map_form(nav_map, lane_map):
    from mppi_playground_tpu_torch.models.racing_mpcc import make_mpcc_cost
    from mppi_playground_tpu_torch.models.unicycle import make_navigation_cost

    rng = np.random.default_rng(5)
    states = torch.from_numpy(rng.uniform(-10, 10, (4096, 4)).astype(np.float32))
    actions = torch.from_numpy(rng.uniform(-1, 1, (4096, 2)).astype(np.float32))
    ref = torch.from_numpy(rng.uniform(-1, 1, (5, 4)).astype(np.float32))
    info = {"reference_path": ref, "t": 2, "prev_action": actions.flip(0)}
    grids = make_mpcc_cost(nav_map.device_map, lane_map.device_map)(states, actions, info)
    features = make_mpcc_cost(nav_map.feature_map, lane_map.feature_map)(states, actions, info)
    assert torch.equal(grids, features)
    goal = torch.tensor([5.0, 5.0])
    nav_grid = make_navigation_cost(goal, nav_map.device_map)(states[:, :3], actions, {})
    nav_features = make_navigation_cost(goal, nav_map.cost_map)(states[:, :3], actions, {})
    assert torch.equal(nav_grid, nav_features)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def jax_features_reference(out_path: str) -> None:
    """Subprocess body: the JAX maps' feature arrays and their queries."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu.maps.feature_query import feature_cost as jax_feature_cost
    from mppi_playground_tpu.maps.lane_map import LaneMap as JaxLaneMap
    from mppi_playground_tpu.maps.obstacle_map import ObstacleMap as JaxObstacleMap
    from mppi_playground_tpu.maps.obstacle_map import (
        generate_random_obstacles as jax_obstacles,
    )

    nav = JaxObstacleMap(map_size=(20, 20), cell_size=0.1)
    jax_obstacles(obstacle_map=nav, random_x_range=(-7.5, 7.5), random_y_range=(-7.5, 7.5),
                  num_circle_obs=7, radius_range=(1, 1), num_rectangle_obs=7,
                  width_range=(2, 2), height_range=(2, 2), max_iteration=1000, seed=42)
    lane = JaxLaneMap(lane=_lane(), lane_width=2.4, map_size=(20, 20), cell_size=0.1)
    pts = jnp.asarray(_points())
    out = {}
    for name, fm in (("nav", nav.feature_map), ("lane", lane.feature_map)):
        for field in ARRAYS:
            out[f"{name}_{field}"] = np.asarray(getattr(fm, field))
        for field in STATIC:
            out[f"{name}_{field}"] = np.asarray(getattr(fm, field))
        out[f"{name}_query"] = np.asarray(jax.jit(lambda p, fm=fm: jax_feature_cost(fm, p))(pts))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    from tests.test_torch_fused_solve import run_jax_reference

    return run_jax_reference("tests.test_torch_feature_query", "jax_features_reference",
                             tmp_path_factory.mktemp("jax_features"))


@pytest.mark.parametrize("name", ["nav", "lane"])
def test_built_features_are_jaxs(jax_ref, nav_map, lane_map, name):
    fm = {"nav": nav_map, "lane": lane_map}[name].feature_map
    for field in ARRAYS:
        np.testing.assert_array_equal(getattr(fm, field).numpy(), jax_ref[f"{name}_{field}"],
                                      err_msg=field)
    for field in STATIC:
        assert getattr(fm, field) == jax_ref[f"{name}_{field}"].item(), field


@pytest.mark.parametrize("name", ["nav", "lane"])
def test_jax_features_query_the_ports_grid(jax_ref, nav_map, lane_map, name):
    fm = convert.feature_map({f: jax_ref[f"{name}_{f}"] for f in ARRAYS},
                             *(jax_ref[f"{name}_{f}"].item() for f in STATIC), device="cpu")
    pts = torch.from_numpy(_points())
    got = feature_cost(fm, pts)
    assert torch.equal(got, grid_cost({"nav": nav_map, "lane": lane_map}[name].device_map, pts))
    np.testing.assert_array_equal(got.numpy(), jax_ref[f"{name}_query"])
