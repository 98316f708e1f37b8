"""Occupancy-grid obstacle map with seeded random obstacle generation.

Counterpart of ``mppi_playground_tpu/maps/obstacle_map.py``: a centered grid
of ``map_size / cell_size`` cells, circles rasterized around rounded centers,
rectangles around ceil'd centers, and the seeded rejection-sampling
generator with the same ``np.random.default_rng`` draw order, so a seed gives
byte-identical grids in both packages.  Construction is host-side numpy;
queries run on a device through :func:`maps.grid_cost.grid_cost`, or through
the analytic feature form (:attr:`ObstacleMap.feature_map`,
``maps/feature_query.py``), which gives the same values; the fused CUDA
kernels read the grid itself.
"""

from __future__ import annotations

import dataclasses
from math import ceil
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from mppi_playground_tpu_torch.maps.feature_query import FeatureMapData, build_feature_map
from mppi_playground_tpu_torch.maps.grid_cost import GridMapData, grid_cost
from mppi_playground_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class CircleObstacle:
    center: np.ndarray
    radius: float


@dataclasses.dataclass
class RectangleObstacle:
    """Axis-aligned rectangle."""

    center: np.ndarray
    width: float
    height: float


class ObstacleMap:
    """Centered occupancy grid."""

    def __init__(
        self,
        map_size: Tuple[int, int] = (20, 20),
        cell_size: float = 0.01,
        dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        """``device``: where :attr:`device_map` lives; ``None`` means ``cuda``."""
        if len(map_size) != 2:
            raise ValueError("map_size must be (width, height) in meters")
        if cell_size <= 0:
            raise ValueError("cell_size must be positive (meters per cell)")
        if map_size[0] % 2 != 0 or map_size[1] % 2 != 0:
            raise ValueError(
                f"map_size extents must be even (centered grid), got {map_size}"
            )

        cell_map_dim = (ceil(map_size[0] / cell_size), ceil(map_size[1] / cell_size))
        self._map = np.zeros(cell_map_dim)
        self._cell_size = cell_size
        self._cell_map_origin = np.array(
            [cell_map_dim[0] / 2, cell_map_dim[1] / 2]
        ).astype(int)
        self._dtype = dtype
        self._device = resolve_device(device)

        x_range = cell_size * cell_map_dim[0]
        y_range = cell_size * cell_map_dim[1]
        self.x_lim = [-x_range / 2, x_range / 2]
        self.y_lim = [-y_range / 2, y_range / 2]

        self.circle_obs_list: List[CircleObstacle] = []
        self.rectangle_obs_list: List[RectangleObstacle] = []
        self._device_map: Optional[GridMapData] = None
        self._feature_map: Optional[FeatureMapData] = None
        self._feature_map_built = False
        self._version = 0

    def add_circle_obstacle(self, center: np.ndarray, radius: float) -> None:
        """Rasterize a disk around its rounded center."""
        if len(center) != 2 or radius <= 0:
            raise ValueError(
                f"need a 2D center and positive radius, got center={center!r} "
                f"radius={radius!r}"
            )
        center_occ = np.round(center / self._cell_size + self._cell_map_origin).astype(int)
        radius_occ = ceil(radius / self._cell_size)

        offsets = np.arange(-radius_occ, radius_occ + 1)
        ii, jj = np.meshgrid(offsets, offsets, indexing="ij")
        inside = ii**2 + jj**2 <= radius_occ**2
        xs = np.clip(center_occ[0] + ii[inside], 0, self._map.shape[0] - 1)
        ys = np.clip(center_occ[1] + jj[inside], 0, self._map.shape[1] - 1)
        self._map[xs, ys] = 1

        self.circle_obs_list.append(CircleObstacle(np.asarray(center, float), radius))
        self._device_map = None
        self._feature_map_built = False
        self._version += 1

    def add_rectangle_obstacle(
        self, center: np.ndarray, width: float, height: float
    ) -> None:
        """Rasterize a rectangle around its ceil'd center."""
        if len(center) != 2 or width <= 0 or height <= 0:
            raise ValueError(
                f"need a 2D center and positive width/height, got "
                f"center={center!r} width={width!r} height={height!r}"
            )
        center_occ = np.ceil(center / self._cell_size + self._cell_map_origin).astype(int)
        width_occ = ceil(width / self._cell_size)
        height_occ = ceil(height / self._cell_size)

        x_init = np.clip(center_occ[0] - ceil(width_occ / 2), 0, self._map.shape[0] - 1)
        x_end = np.clip(center_occ[0] + ceil(width_occ / 2), 0, self._map.shape[0] - 1)
        y_init = np.clip(center_occ[1] - ceil(height_occ / 2), 0, self._map.shape[1] - 1)
        y_end = np.clip(center_occ[1] + ceil(height_occ / 2), 0, self._map.shape[1] - 1)
        self._map[x_init:x_end, y_init:y_end] = 1

        self.rectangle_obs_list.append(
            RectangleObstacle(np.asarray(center, float), width, height)
        )
        self._device_map = None
        self._feature_map_built = False
        self._version += 1

    @property
    def version(self) -> int:
        """Mutation counter, bumped by every ``add_*_obstacle`` call.

        Consumers that build on the map's device data once (the
        ``RacingController``'s solver) compare it to see that the map moved
        and rebuild.
        """
        return self._version

    @property
    def grid(self) -> np.ndarray:
        """The host grid ``[W, H]`` (1 = blocked)."""
        return self._map

    @property
    def origin(self) -> np.ndarray:
        """Cell coordinates of the world origin."""
        return self._cell_map_origin

    @property
    def cell_size(self) -> float:
        return self._cell_size

    @property
    def device_map(self) -> GridMapData:
        """The grid uploaded once to the map's device."""
        if self._device_map is None:
            self._device_map = GridMapData(
                grid=torch.as_tensor(self._map, dtype=self._dtype, device=self._device),
                origin=torch.as_tensor(
                    self._cell_map_origin, dtype=self._dtype, device=self._device
                ),
                cell_size=float(self._cell_size),
            )
        return self._device_map

    @property
    def feature_map(self) -> Optional[FeatureMapData]:
        """The gather-free analytic query data (``maps/feature_query.py``), on the map's device.

        Built from the obstacle list with the rasterizer's cell arithmetic and
        verified cell for cell against the stored grid; ``None`` when the grid
        cannot be reproduced analytically (e.g. a disk clipped at the map's
        edge), where callers keep the grid.
        """
        if not self._feature_map_built:
            discs = np.array(
                [np.round(c.center / self._cell_size + self._cell_map_origin)
                 for c in self.circle_obs_list], np.int64).reshape(-1, 2)
            r2 = np.array([ceil(c.radius / self._cell_size) ** 2 for c in self.circle_obs_list],
                          np.float64)
            rects = []
            for r in self.rectangle_obs_list:
                center_occ = np.ceil(r.center / self._cell_size + self._cell_map_origin).astype(int)
                w_occ = ceil(ceil(r.width / self._cell_size) / 2)
                h_occ = ceil(ceil(r.height / self._cell_size) / 2)
                rects.append([np.clip(center_occ[0] - w_occ, 0, self._map.shape[0] - 1),
                              np.clip(center_occ[0] + w_occ, 0, self._map.shape[0] - 1),
                              np.clip(center_occ[1] - h_occ, 0, self._map.shape[1] - 1),
                              np.clip(center_occ[1] + h_occ, 0, self._map.shape[1] - 1)])
            self._feature_map = build_feature_map(
                self._map, self._cell_map_origin, self._cell_size, discs, r2,
                rects=np.asarray(rects, np.int64).reshape(-1, 4), inside_is_blocked=True,
                prune=False, dtype=self._dtype, device=self._device)
            self._feature_map_built = True
        return self._feature_map

    @property
    def cost_map(self):
        """The feature map where it reproduces the grid exactly, else the grid.

        The JAX package's fastest exact form on the TPU; on the card a gather
        is cheap, and the port's envs and kernels read :attr:`device_map`.
        """
        fm = self.feature_map
        return fm if fm is not None else self.device_map

    def row_interval_table(self):
        """Per-row interval encoding of the grid (``ops/row_intervals``)."""
        from mppi_playground_tpu_torch.ops.row_intervals import build_row_interval_table

        return build_row_interval_table(self._map, self._cell_map_origin, self._cell_size)

    def compute_cost(self, x: torch.Tensor) -> torch.Tensor:
        """Batched occupancy cost."""
        return grid_cost(self.device_map, x)

    # ------------------------------------------------------------------
    def render_occupancy(self, ax, cmap: str = "binary") -> None:
        """The grid as an image on a matplotlib axes."""
        ax.imshow(self._map, cmap=cmap)

    def render(self, ax, zorder: int = 0) -> None:
        """The obstacles in world coordinates on a matplotlib axes."""
        from matplotlib import pyplot as plt

        ax.set_xlim(self.x_lim)
        ax.set_ylim(self.y_lim)
        ax.set_aspect("equal")
        for circle in self.circle_obs_list:
            ax.add_patch(plt.Circle(circle.center, circle.radius, color="gray", zorder=zorder))
        for rect in self.rectangle_obs_list:
            ax.add_patch(plt.Rectangle(rect.center - np.array([rect.width / 2, rect.height / 2]),
                                       rect.width, rect.height, color="gray", zorder=zorder))


def generate_random_obstacles(
    obstacle_map: ObstacleMap,
    random_x_range: Tuple[float, float],
    random_y_range: Tuple[float, float],
    num_circle_obs: int,
    radius_range: Tuple[float, float],
    num_rectangle_obs: int,
    width_range: Tuple[float, float],
    height_range: Tuple[float, float],
    max_iteration: int,
    seed: int,
) -> None:
    """Seeded rejection sampling of non-overlapping obstacles.

    Same ``np.random.default_rng`` draw order and overlap predicates as the
    JAX package, so the same seed yields the same obstacle field.
    """
    rng = np.random.default_rng(seed)

    x_lo = max(random_x_range[0], obstacle_map.x_lim[0])
    x_hi = min(random_x_range[1], obstacle_map.x_lim[1])
    y_lo = max(random_y_range[0], obstacle_map.y_lim[0])
    y_hi = min(random_y_range[1], obstacle_map.y_lim[1])

    for _ in range(num_circle_obs):
        num_trial = 0
        while num_trial < max_iteration:
            center = np.array(
                [rng.uniform(x_lo, x_hi), rng.uniform(y_lo, y_hi)]
            )
            radius = rng.uniform(radius_range[0], radius_range[1])

            is_overlap = False
            for circle in obstacle_map.circle_obs_list:
                if np.linalg.norm(circle.center - center) <= circle.radius + radius:
                    is_overlap = True
            for rect in obstacle_map.rectangle_obs_list:
                dist = np.linalg.norm(rect.center - center)
                if dist <= rect.width / 2 + radius and dist <= rect.height / 2 + radius:
                    is_overlap = True

            if not is_overlap:
                break
            num_trial += 1
            if num_trial == max_iteration:
                raise RuntimeError(
                    "random obstacle placement failed: no non-overlapping spot "
                    f"found within {max_iteration} tries"
                )
        obstacle_map.add_circle_obstacle(center, radius)

    for _ in range(num_rectangle_obs):
        num_trial = 0
        while num_trial < max_iteration:
            center = np.array(
                [rng.uniform(x_lo, x_hi), rng.uniform(y_lo, y_hi)]
            )
            width = rng.uniform(width_range[0], width_range[1])
            height = rng.uniform(height_range[0], height_range[1])

            is_overlap = False
            for circle in obstacle_map.circle_obs_list:
                dist = np.linalg.norm(circle.center - center)
                if (
                    dist <= circle.radius + width / 2
                    and dist <= circle.radius + height / 2
                ):
                    is_overlap = True
            for rect in obstacle_map.rectangle_obs_list:
                dist = np.linalg.norm(rect.center - center)
                if (
                    dist <= rect.width / 2 + width / 2
                    and dist <= rect.height / 2 + height / 2
                ):
                    is_overlap = True

            if not is_overlap:
                break
            num_trial += 1
            if num_trial == max_iteration:
                raise RuntimeError(
                    "random obstacle placement failed: no non-overlapping spot "
                    f"found within {max_iteration} tries"
                )
        obstacle_map.add_rectangle_obstacle(center, width, height)
