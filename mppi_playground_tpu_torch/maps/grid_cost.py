"""Occupancy-grid cost query on tensors.

Counterpart of ``mppi_playground_tpu/maps/grid_cost.py``: project positions
to cells with round-half-to-even (``torch.round``), dividing by
``cell_size`` (never multiplying by its reciprocal: the float32 results
differ at cell boundaries); out-of-bounds points cost 1.0, in-bounds
points read the grid.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GridMapData:
    """Occupancy grid on a device.

    Attributes:
        grid: ``[W, H]`` occupancy values (1.0 = blocked).
        origin: ``[2]`` cell coordinates of the world origin.
        cell_size: meters per cell.
    """

    grid: torch.Tensor
    origin: torch.Tensor
    cell_size: float


def cell_divisor(cell_size: float, like: torch.Tensor) -> torch.Tensor:
    """``cell_size`` as a 0-dim tensor on ``like``'s device.

    PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
    which rounds differently at cell boundaries; a tensor divisor keeps the
    IEEE division of the kernels and of the CPU.
    """
    return torch.full((), cell_size, dtype=like.dtype, device=like.device)


def map_query(map_data, x: torch.Tensor) -> torch.Tensor:
    """Occupancy cost through either map form: :class:`GridMapData` or a feature map.

    A :class:`GridMapData` is read by :func:`grid_cost`; a
    ``maps/feature_query.FeatureMapData`` by its analytic query.  Both give
    the same values.
    """
    if isinstance(map_data, GridMapData):
        return grid_cost(map_data, x)
    from mppi_playground_tpu_torch.maps.feature_query import feature_cost

    return feature_cost(map_data, x)


def grid_cost(map_data: GridMapData, x: torch.Tensor) -> torch.Tensor:
    """Occupancy cost of positions ``x [..., 2]`` -> ``[...]``."""
    grid = map_data.grid
    occ = torch.round(x / cell_divisor(map_data.cell_size, x) + map_data.origin).to(torch.int64)
    ix, iy = occ[..., 0], occ[..., 1]
    out_of_bounds = (
        (ix < 0) | (ix >= grid.shape[0]) | (iy < 0) | (iy >= grid.shape[1])
    )
    ix = torch.clamp(ix, 0, grid.shape[0] - 1)
    iy = torch.clamp(iy, 0, grid.shape[1] - 1)
    values = grid[ix, iy]
    return torch.where(out_of_bounds, torch.ones_like(values), values)


def _cell(i: torch.Tensor, size: int) -> torch.Tensor:
    """A rounded cell coordinate as an index into ``[0, size)``: clamped, and 0 for NaN.

    The kernels' ``__float2int_rn`` converts NaN to 0 and their bounds test
    then finds it on the grid, so a NaN position reads cell 0 there; here too,
    where the NaN would otherwise become an index far out of range.
    """
    return torch.nan_to_num(torch.clamp(i, 0.0, float(size - 1)), nan=0.0).to(torch.int64)


def grid_occupancy(
    grid: torch.Tensor,
    origin: tuple,
    cell_size: float,
    px: torch.Tensor,
    py: torch.Tensor,
) -> torch.Tensor:
    """:func:`grid_cost` of one ``[W, H]`` grid (nonzero = blocked) at ``(px, py)``.

    The fused CUDA kernel's single-grid read, the plain twin of
    ``map_occupancy`` in ``csrc/device_math.cuh``: the cell index of
    :func:`grid_cost_pair`, out of bounds 1.0.  ``origin`` is a pair of
    floats.
    """
    w, h = grid.shape
    cell = cell_divisor(cell_size, px)
    ix = torch.round(px / cell + origin[0])
    iy = torch.round(py / cell + origin[1])
    oob = (ix < 0) | (ix >= w) | (iy < 0) | (iy >= h)
    ixi, iyi = _cell(ix, w), _cell(iy, h)
    return (oob | (grid[ixi, iyi] != 0)).to(px.dtype)


def grid_cost_pair(
    grid_a: torch.Tensor,
    grid_b: torch.Tensor,
    origin: tuple,
    cell_size: float,
    px: torch.Tensor,
    py: torch.Tensor,
) -> torch.Tensor:
    """``grid_cost(a) + grid_cost(b)`` for two grids on one raster.

    One shared cell index per point, as the fused CUDA kernel computes it:
    ``round(p / cell_size + origin)`` with half to even, out of bounds 1.0.
    ``grid_a``/``grid_b`` are ``[W, H]`` (nonzero = blocked); ``origin`` is
    a pair of floats.  This is the kernel's plain twin of its map read.
    """
    w, h = grid_a.shape
    cell = cell_divisor(cell_size, px)
    ix = torch.round(px / cell + origin[0])
    iy = torch.round(py / cell + origin[1])
    oob = (ix < 0) | (ix >= w) | (iy < 0) | (iy >= h)
    ixi, iyi = _cell(ix, w), _cell(iy, h)
    cost_a = (oob | (grid_a[ixi, iyi] != 0)).to(px.dtype)
    cost_b = (oob | (grid_b[ixi, iyi] != 0)).to(px.dtype)
    return cost_a + cost_b
