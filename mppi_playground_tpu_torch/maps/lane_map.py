"""Drivable-corridor lane map via a Euclidean distance transform.

Counterpart of ``mppi_playground_tpu/maps/lane_map.py``: rasterize the lane
centerline into a ones-grid, apply ``scipy.ndimage.distance_transform_edt``
and threshold at half the lane width -> 0 (drivable) / 1 (off-lane).  Queries
read the grid (:func:`maps.grid_cost.grid_cost`) or its analytic feature
form (:attr:`LaneMap.feature_map`), which gives the same values.
"""

from __future__ import annotations

from math import ceil
from typing import Optional, Tuple, Union

import numpy as np
import torch
from scipy.ndimage import distance_transform_edt

from mppi_playground_tpu_torch.maps.feature_query import FeatureMapData, build_feature_map
from mppi_playground_tpu_torch.maps.grid_cost import GridMapData, grid_cost
from mppi_playground_tpu_torch.utils.device import resolve_device


class LaneMap:
    """Lane-corridor occupancy grid."""

    def __init__(
        self,
        lane: np.ndarray,
        lane_width: float,
        map_size: Tuple[int, int] = (20, 20),
        cell_size: float = 0.01,
        dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        """
        Args:
            lane: centerline ``[[x, y, angle], ...]``.
            lane_width: drivable width in meters.
            map_size: (width, height) in meters, origin at the center.
            cell_size: meters per cell.
            device: where :attr:`device_map` lives; ``None`` means ``cuda``.
        """
        if lane_width <= 0:
            raise ValueError(f"lane_width must be positive, got {lane_width}")
        if lane.ndim != 2 or lane.shape[1] != 3:
            raise ValueError(f"lane must be [N, 3] (x, y, angle), got {lane.shape}")

        cell_map_dim = (ceil(map_size[0] / cell_size), ceil(map_size[1] / cell_size))
        self._cell_size = cell_size
        self._cell_map_origin = np.array(
            [cell_map_dim[0] // 2, cell_map_dim[1] // 2]
        )
        self._dtype = dtype
        self._device = resolve_device(device)
        self.x_lim = [-map_size[0] / 2, map_size[0] / 2]
        self.y_lim = [-map_size[1] / 2, map_size[1] / 2]

        grid = np.ones(cell_map_dim)
        cells = (
            np.round(lane[:, :2] / cell_size).astype(int) + self._cell_map_origin
        )
        in_bounds = (
            (cells[:, 0] >= 0)
            & (cells[:, 0] < cell_map_dim[0])
            & (cells[:, 1] >= 0)
            & (cells[:, 1] < cell_map_dim[1])
        )
        cells = cells[in_bounds]
        grid[cells[:, 0], cells[:, 1]] = 0

        distance_map = distance_transform_edt(grid)
        max_distance = (lane_width / 2) / cell_size
        self._map = np.where(distance_map <= max_distance, 0, 1)
        self._centerline_cells = np.unique(cells, axis=0)
        self._max_distance = max_distance
        self._device_map: Optional[GridMapData] = None
        self._feature_map: Optional[FeatureMapData] = None
        self._feature_map_built = False

    @property
    def grid(self) -> np.ndarray:
        """The host grid ``[W, H]`` (1 = off-lane)."""
        return self._map

    @property
    def origin(self) -> np.ndarray:
        return self._cell_map_origin

    @property
    def cell_size(self) -> float:
        return self._cell_size

    @property
    def device_map(self) -> GridMapData:
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
        """The gather-free analytic corridor query (``maps/feature_query.py``).

        The EDT-threshold corridor is the union of radius-``w`` disks on the
        rasterized centerline cells; redundant cells are pruned and the
        result verified against the stored grid when it is built.
        """
        if not self._feature_map_built:
            self._feature_map = build_feature_map(
                self._map, self._cell_map_origin, self._cell_size, self._centerline_cells,
                np.full(len(self._centerline_cells), self._max_distance ** 2),
                inside_is_blocked=False, prune=True, dtype=self._dtype, device=self._device)
            self._feature_map_built = True
        return self._feature_map

    @property
    def cost_map(self):
        """The feature map where it reproduces the grid exactly, else the grid."""
        fm = self.feature_map
        return fm if fm is not None else self.device_map

    def row_interval_table(self):
        """Per-row interval encoding of the grid (``ops/row_intervals``)."""
        from mppi_playground_tpu_torch.ops.row_intervals import build_row_interval_table

        return build_row_interval_table(self._map, self._cell_map_origin, self._cell_size)

    def compute_cost(self, x: torch.Tensor) -> torch.Tensor:
        """Batched off-lane cost."""
        return grid_cost(self.device_map, x)

    def render_occupancy(self, ax, cmap: str = "binary") -> None:
        """The grid as an image in world coordinates on a matplotlib axes."""
        extent = [self.x_lim[0], self.x_lim[1], self.y_lim[0], self.y_lim[1]]
        ax.imshow(self._map.T, cmap=cmap, origin="lower", extent=extent)
