"""The racing scene, worked out again on the host: the circuit, the lane grid, the obstacles.

Plain numpy (and scipy's Euclidean distance transform), independent of the
program: the circuit is the procedural closed loop the port's racing env
draws by default (Fourier-perturbed radius, seed 7, resampled at 0.1 m), the
lane corridor is the cells within ``0.8 * 6.5 / 2`` m of the rasterized
center line, and the obstacles are 50 disks of radius 0.9-1.2 m placed by
rejection sampling inside +-35 m from ``numpy.random.default_rng(seed)``,
rasterized around their rounded centers.  Grids are ``[W, H]`` with 1 for a
blocked cell; the world origin sits at cell ``(W // 2, H // 2)``.
"""

from __future__ import annotations

import dataclasses
from math import ceil

import numpy as np
from scipy.ndimage import distance_transform_edt


@dataclasses.dataclass(frozen=True)
class Scene:
    """A racing deployment's host data: ``path [N, 3]`` (x, y, yaw), the two grids, their
    origin cell and cell size, and the position clamp ``x_lim``/``y_lim``."""

    path: np.ndarray
    obstacle_grid: np.ndarray
    lane_grid: np.ndarray
    origin: tuple
    cell_size: float
    x_lim: tuple
    y_lim: tuple


def _circuit_columns(seed: int, num_points: int = 360, base_radius: float = 26.0,
                     track_width: float = 3.7, gap_points: int = 6):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 2.0 * np.pi, num_points + gap_points, endpoint=False)[:num_points]
    radius = np.full_like(t, base_radius)
    for k in (2, 3, 5):
        amplitude = rng.uniform(1.0, 3.0) / k
        phase = rng.uniform(0.0, 2.0 * np.pi)
        radius += amplitude * k * np.cos(k * t + phase) / 2.0
    radius = np.clip(radius, 14.0, 33.0)
    return radius * np.cos(t), radius * np.sin(t)


def _resample(points: np.ndarray, spacing: float) -> np.ndarray:
    """Arc-length resampling at about ``spacing``, headings attached ``[N, 3]``."""
    chords = np.sqrt(np.sum(np.diff(points, axis=0) ** 2, axis=1))
    along = np.concatenate(([0], np.cumsum(chords)))
    count = int(along[-1] // spacing) + 1
    at = np.linspace(0, along[-1], count)
    path = np.column_stack((np.interp(at, along, points[:, 0]),
                            np.interp(at, along, points[:, 1])))
    first = path[0] - path[-1]
    norm = np.linalg.norm(first)
    first = first / norm if norm != 0 else np.array([1.0, 0.0])
    steps = path[1:] - path[:-1]
    yaw = np.concatenate(([np.arctan2(first[1], first[0])], np.arctan2(steps[:, 1], steps[:, 0])))
    return np.concatenate((path, yaw[:, None]), axis=1)


def circuit(seed: int, spacing: float) -> np.ndarray:
    """The center path ``[N, 3]`` of the procedural circuit of ``seed``."""
    xs, ys = _circuit_columns(seed)
    center = np.column_stack((xs - xs.mean(), ys - ys.mean()))
    return _resample(center, spacing)


def lane_grid(path: np.ndarray, lane_width: float, cells: tuple, origin: np.ndarray,
              cell_size: float) -> np.ndarray:
    """1 off the corridor of ``lane_width`` around the rasterized path, else 0."""
    grid = np.ones(cells)
    at = np.round(path[:, :2] / cell_size).astype(int) + origin
    inside = (at[:, 0] >= 0) & (at[:, 0] < cells[0]) & (at[:, 1] >= 0) & (at[:, 1] < cells[1])
    at = at[inside]
    grid[at[:, 0], at[:, 1]] = 0
    distance = distance_transform_edt(grid)
    return np.where(distance <= (lane_width / 2) / cell_size, 0, 1)


def obstacle_grid(seed: int, count: int, radius_range: tuple, spread: tuple, cells: tuple,
                  origin: np.ndarray, cell_size: float, x_lim: tuple, y_lim: tuple,
                  max_tries: int = 1000) -> np.ndarray:
    """``count`` disks that do not overlap, drawn in turn (center x, center y, radius) from
    ``default_rng(seed)`` inside ``spread`` and the map, each redrawn where it overlaps."""
    rng = np.random.default_rng(seed)
    x_lo, x_hi = max(spread[0], x_lim[0]), min(spread[1], x_lim[1])
    y_lo, y_hi = max(spread[0], y_lim[0]), min(spread[1], y_lim[1])
    grid = np.zeros(cells)
    placed = []
    for _ in range(count):
        for _ in range(max_tries):
            center = np.array([rng.uniform(x_lo, x_hi), rng.uniform(y_lo, y_hi)])
            radius = rng.uniform(*radius_range)
            if all(np.linalg.norm(c - center) > r + radius for c, r in placed):
                break
        else:
            raise RuntimeError(f"no free spot for an obstacle in {max_tries} tries")
        placed.append((center, radius))
        at = np.round(center / cell_size + origin).astype(int)
        reach = ceil(radius / cell_size)
        offsets = np.arange(-reach, reach + 1)
        ii, jj = np.meshgrid(offsets, offsets, indexing="ij")
        disk = ii**2 + jj**2 <= reach**2
        grid[np.clip(at[0] + ii[disk], 0, cells[0] - 1),
             np.clip(at[1] + jj[disk], 0, cells[1] - 1)] = 1
    return grid


def scene(config: dict, obstacle_seed: int) -> Scene:
    """The scene of a racing configuration (``portbench/configs/<name>.json``'s ``scene``)."""
    s = config["scene"]
    cell_size = float(s["cell_size"])
    size = s["map_size"]
    cells = (ceil(size[0] / cell_size), ceil(size[1] / cell_size))
    origin = np.array([cells[0] // 2, cells[1] // 2])
    x_lim = (-cell_size * cells[0] / 2, cell_size * cells[0] / 2)
    y_lim = (-cell_size * cells[1] / 2, cell_size * cells[1] / 2)
    path = circuit(int(s["circuit_seed"]), float(s["path_spacing"]))
    lane = lane_grid(path, float(s["lane_width"]) * float(s["lane_share"]), cells, origin,
                     cell_size)
    obstacles = obstacle_grid(obstacle_seed, int(s["obstacles"]), tuple(s["obstacle_radius"]),
                              tuple(s["obstacle_spread"]), cells, origin, cell_size, x_lim, y_lim)
    return Scene(path, obstacles, lane, (float(origin[0]), float(origin[1])), cell_size,
                 x_lim, y_lim)
