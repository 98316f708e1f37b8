"""Gather-free analytic occupancy queries: the maps' feature form.

Counterpart of ``mppi_playground_tpu/maps/feature_query.py``.  Both map
families are geometric: obstacle maps are unions of rasterized disks and
rectangles, lane maps the union of radius-w disks on the rasterized
centerline cells.  So the grid lookup can be replaced by integer geometry on
cell coordinates, a broadcast distance test against a small feature set,
bit for bit the rasterized grid's answer:

* every quantity is a small integer held in float32 (cells below 2^11,
  squared distances below 2^21, under the 2^24 exact-integer limit);
* the cell projection is :func:`~mppi_playground_tpu_torch.maps.grid_cost.grid_cost`'s
  own (IEEE division by the cell size, round half to even);
* :func:`build_feature_map` prunes redundant corridor features on the host
  and verifies, when it builds, that the features reproduce the stored grid
  cell for cell, returning ``None`` where they cannot (the caller keeps the
  grid).

On the TPU this form stands in for a slow gather.  The port's fused CUDA
kernels read the grid (a cached gather is cheap on the card); the feature
form is here so that the maps' API is whole, and the unfused costs accept
either form through ``maps/grid_cost.map_query``.  The host-side construction is a
numpy copy of the JAX package's; the query runs in torch.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Union

import numpy as np
import torch

from mppi_playground_tpu_torch.maps.grid_cost import cell_divisor
from mppi_playground_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FeatureMapData:
    """The analytic equivalent of one occupancy grid, on a device.

    ``inside_is_blocked=True`` models obstacle maps (occupied inside the
    features' union); ``False`` models corridor maps (occupied outside the
    union of centerline disks).  Every coordinate is in cell space, float32.
    """

    disc_x: torch.Tensor  # [Nd] disc center cell x
    disc_y: torch.Tensor  # [Nd] disc center cell y
    disc_r2: torch.Tensor  # [Nd] squared cell radius (inclusive test)
    rect_x0: torch.Tensor  # [Nr] inclusive cell bounds
    rect_x1: torch.Tensor  # [Nr] exclusive
    rect_y0: torch.Tensor  # [Nr]
    rect_y1: torch.Tensor  # [Nr]
    origin: torch.Tensor  # [2] cell coordinates of the world origin
    cell_size: float
    width: int
    height: int
    inside_is_blocked: bool


def feature_cost(fm: FeatureMapData, x: torch.Tensor) -> torch.Tensor:
    """Occupancy cost of positions ``x [..., 2]`` -> ``[...]``.

    The values ``grid_cost`` gives on the grid this feature map was built
    from: out of bounds 1.0, else the cell's occupancy, by geometry instead
    of a gather.
    """
    cell = torch.round(x / cell_divisor(fm.cell_size, x) + fm.origin)
    ix, iy = cell[..., 0], cell[..., 1]
    out_of_bounds = (ix < 0) | (ix >= fm.width) | (iy < 0) | (iy >= fm.height)
    # an out-of-bounds query costs 1.0 either way: the clamp only keeps the
    # arithmetic in the exact-integer range
    ix = torch.clamp(ix, 0.0, fm.width - 1.0)
    iy = torch.clamp(iy, 0.0, fm.height - 1.0)

    inside = torch.zeros(ix.shape, dtype=torch.bool, device=x.device)
    if fm.disc_x.shape[0]:
        dx = ix[..., None] - fm.disc_x
        dy = iy[..., None] - fm.disc_y
        inside = torch.any(dx * dx + dy * dy <= fm.disc_r2, dim=-1)
    if fm.rect_x0.shape[0]:
        in_rect = ((ix[..., None] >= fm.rect_x0) & (ix[..., None] < fm.rect_x1)
                   & (iy[..., None] >= fm.rect_y0) & (iy[..., None] < fm.rect_y1))
        inside = inside | torch.any(in_rect, dim=-1)

    blocked = inside if fm.inside_is_blocked else ~inside
    return (out_of_bounds | blocked).to(x.dtype)


# ----------------------------------------------------------------------
# Host-side construction (numpy)
# ----------------------------------------------------------------------


def _prune_disc_features(centers: np.ndarray, r2: float, shape: tuple) -> np.ndarray:
    """A subset of the discs with the same lattice coverage.

    Lazy greedy max-cover: take the disc covering the most cells not covered
    yet until the union is the whole region.  The query's cost is linear in
    the feature count, so a corridor map (discs about a cell apart, of radius
    about 26 cells) shrinks about tenfold.
    """
    r = int(np.floor(np.sqrt(r2)))
    offs = np.arange(-r, r + 1)
    ii, jj = np.meshgrid(offs, offs, indexing="ij")
    disc_mask = (ii * ii + jj * jj) <= r2
    di, dj = ii[disc_mask], jj[disc_mask]

    flat_lists = []
    covered = np.zeros(shape[0] * shape[1], bool)
    for cx, cy in centers:
        xs = cx + di
        ys = cy + dj
        keep = (xs >= 0) & (xs < shape[0]) & (ys >= 0) & (ys < shape[1])
        flat = xs[keep] * shape[1] + ys[keep]
        flat_lists.append(flat)
        covered[flat] = True
    remaining = int(covered.sum())
    covered[:] = False

    heap = [(-len(f), idx) for idx, f in enumerate(flat_lists)]
    heapq.heapify(heap)
    selected = []
    while remaining > 0 and heap:
        _, idx = heapq.heappop(heap)
        gain = int((~covered[flat_lists[idx]]).sum())
        if gain == 0:
            continue
        if heap and gain < -heap[0][0]:  # a stale score: back in the heap
            heapq.heappush(heap, (-gain, idx))
            continue
        selected.append(idx)
        covered[flat_lists[idx]] = True
        remaining -= gain
    return centers[np.sort(selected)]


def _region_from_features(disc_centers: np.ndarray, disc_r2: np.ndarray, rects: np.ndarray,
                          shape: tuple) -> np.ndarray:
    """The lattice region a feature set covers (the build's verification)."""
    region = np.zeros(shape, bool)
    for (cx, cy), r2 in zip(disc_centers, disc_r2):
        r = int(np.floor(np.sqrt(r2)))
        offs = np.arange(-r, r + 1)
        ii, jj = np.meshgrid(offs, offs, indexing="ij")
        mask = (ii * ii + jj * jj) <= r2
        xs = cx + ii[mask]
        ys = cy + jj[mask]
        keep = (xs >= 0) & (xs < shape[0]) & (ys >= 0) & (ys < shape[1])
        region[xs[keep], ys[keep]] = True
    for x0, x1, y0, y1 in rects.astype(int):
        region[max(x0, 0):max(x1, 0), max(y0, 0):max(y1, 0)] = True
    return region


def build_feature_map(
    grid: np.ndarray,
    origin: np.ndarray,
    cell_size: float,
    disc_centers: np.ndarray,
    disc_r2: np.ndarray,
    rects: Optional[np.ndarray] = None,
    inside_is_blocked: bool = True,
    prune: bool = True,
    dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
) -> Optional[FeatureMapData]:
    """Build and verify a :class:`FeatureMapData` from a grid's metadata.

    Args:
        grid: the stored occupancy grid ``[W, H]`` (the ground truth).
        disc_centers: ``[Nd, 2]`` integer cell centers.
        disc_r2: ``[Nd]`` squared cell radii (inclusive membership test).
        rects: ``[Nr, 4]`` cell-space ``(x0, x1, y0, y1)``, end-exclusive.
        inside_is_blocked: True for obstacle maps, False for corridors.
        device: where the features go; ``None`` means ``cuda`` (the maps
            pass their own).

    Returns:
        The verified feature map, or ``None`` if the features do not
        reproduce ``grid`` exactly (the caller keeps the grid).
    """
    disc_centers = np.asarray(disc_centers, np.int64).reshape(-1, 2)
    # squared distances between cells are integers, so flooring r^2 changes
    # no membership, and a floored r^2 below 2^24 is exact in float32: the
    # device's compare is this float64 verification's
    disc_r2 = np.floor(np.asarray(disc_r2, np.float64).reshape(-1))
    rects = (np.zeros((0, 4), np.int64) if rects is None
             else np.asarray(rects, np.int64).reshape(-1, 4))

    if prune and len(disc_centers) and rects.shape[0] == 0 and (disc_r2 == disc_r2[0]).all():
        disc_centers = _prune_disc_features(disc_centers, float(disc_r2[0]), grid.shape)
        disc_r2 = np.full(len(disc_centers), disc_r2[0])

    region = _region_from_features(disc_centers, disc_r2, rects, grid.shape)
    blocked = region if inside_is_blocked else ~region
    if not (blocked == (np.asarray(grid) != 0)).all():
        return None

    device = resolve_device(device)

    def tensor(values):
        return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)

    return FeatureMapData(
        disc_x=tensor(disc_centers[:, 0]), disc_y=tensor(disc_centers[:, 1]),
        disc_r2=tensor(disc_r2),
        rect_x0=tensor(rects[:, 0]), rect_x1=tensor(rects[:, 1]),
        rect_y0=tensor(rects[:, 2]), rect_y1=tensor(rects[:, 3]),
        origin=tensor(origin), cell_size=float(cell_size), width=int(grid.shape[0]),
        height=int(grid.shape[1]), inside_is_blocked=inside_is_blocked,
    )
