"""Per-row interval encoding of occupancy grids, with a plain tensor query.

Counterpart of ``mppi_playground_tpu/ops/row_intervals.py``.  The JAX
package encodes each grid row as blocked column intervals so that a TPU
kernel can query the map with lane gathers.  The CUDA kernel of this port
reads the grid itself (two 640 KB ``uint8`` grids stay in the H100's L2), so
nothing on the port's main path uses these tables.  They are kept, with a
plain PyTorch :func:`interval_query` / :func:`interval_query_pair`, so that
the tests can hold the encoding byte for byte against the JAX package's and
show that it answers like :func:`maps.grid_cost.grid_cost`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mppi_playground_tpu_torch.maps.grid_cost import cell_divisor

LANES = 128

PLAN_SKIP = 0
PLAN_UNIFORM = 1
PLAN_GATHER = 2


@dataclasses.dataclass(frozen=True)
class RowIntervalTable:
    """Blocked-interval tables for one occupancy grid.

    ``packed`` is ``[M, G, 128]`` float32 with ``G = ceil(width / 128)``:
    slot ``k`` holds the k-th blocked interval ``[lo, hi)`` of grid row
    ``ix`` at group ``ix >> 7``, lane ``ix & 127``, packed as
    ``lo * 2048 + hi``.  Unused slots are ``lo = hi = height``; rows past
    the grid are fully blocked, like out-of-bounds queries.
    """

    packed: np.ndarray
    origin: tuple
    cell_size: float
    width: int
    height: int
    slot_plan: tuple

    @property
    def max_intervals(self) -> int:
        return self.packed.shape[0]


def build_row_interval_table(
    grid: np.ndarray, origin: np.ndarray, cell_size: float
) -> RowIntervalTable:
    """Encode ``grid [W, H]`` (nonzero = blocked) as per-row intervals."""
    g = np.asarray(grid) != 0
    w, h = g.shape
    rows = []
    max_m = 1
    for r in range(w):
        padded = np.concatenate([[0], g[r].astype(np.int8), [0]])
        d = np.diff(padded)
        starts = np.flatnonzero(d == 1)
        ends = np.flatnonzero(d == -1)
        rows.append((starts, ends))
        max_m = max(max_m, len(starts))

    if not (h < 2048 and w < 8192):
        raise ValueError("packed interval encoding needs height < 2048, width < 8192")
    n_table_rows = -(-w // LANES) * LANES
    lo = np.full((max_m, n_table_rows), float(h))
    hi = np.full((max_m, n_table_rows), float(h))
    for r, (starts, ends) in enumerate(rows):
        lo[: len(starts), r] = starts
        hi[: len(ends), r] = ends
    lo[0, w:] = 0.0
    hi[0, w:] = float(h)

    packed = lo * 2048.0 + hi
    shape = (max_m, n_table_rows // LANES, LANES)
    packed = packed.reshape(shape)
    empty = float(h) * 2048.0 + float(h)
    plan = []
    for k in range(max_m):
        row_plan = []
        for grp in range(shape[1]):
            cell = packed[k, grp]
            if np.all(cell == empty):
                row_plan.append(PLAN_SKIP)
            elif np.all(cell == cell[0]):
                row_plan.append(PLAN_UNIFORM)
            else:
                row_plan.append(PLAN_GATHER)
        plan.append(tuple(row_plan))
    return RowIntervalTable(
        packed=packed.astype(np.float32),
        origin=(float(origin[0]), float(origin[1])),
        cell_size=float(cell_size),
        width=int(w),
        height=int(h),
        slot_plan=tuple(plan),
    )


def _query_indices(table: RowIntervalTable, px: torch.Tensor, py: torch.Tensor):
    """(oob mask, iy as float, row index) per point."""
    cell = cell_divisor(table.cell_size, px)
    ix = torch.round(px / cell + table.origin[0])
    iy = torch.round(py / cell + table.origin[1])
    oob = (ix < 0) | (ix >= table.width) | (iy < 0) | (iy >= table.height)
    ix = torch.clamp(ix, 0.0, float(table.width - 1))
    iy = torch.clamp(iy, 0.0, float(table.height - 1))
    return oob, iy, ix.to(torch.int64)


def _blocked(table: RowIntervalTable, iy: torch.Tensor, row: torch.Tensor):
    flat = torch.as_tensor(
        table.packed.reshape(table.max_intervals, -1), device=iy.device
    )
    blocked = torch.zeros(iy.shape, dtype=torch.bool, device=iy.device)
    for k in range(table.max_intervals):
        p = flat[k][row]
        lo_k = torch.floor(p * (1.0 / 2048.0))
        hi_k = p - lo_k * 2048.0
        blocked = blocked | ((iy >= lo_k) & (iy < hi_k))
    return blocked


def interval_query(
    table: RowIntervalTable, px: torch.Tensor, py: torch.Tensor
) -> torch.Tensor:
    """Occupancy cost at world positions ``(px, py)``: equals ``grid_cost``."""
    oob, iy, row = _query_indices(table, px, py)
    blocked = _blocked(table, iy, row)
    return (oob | blocked).to(px.dtype)


def same_geometry(a: RowIntervalTable, b: RowIntervalTable) -> bool:
    """Whether two tables share origin, cell size and extent."""
    return (
        a.origin == b.origin
        and a.cell_size == b.cell_size
        and a.width == b.width
        and a.height == b.height
    )


def interval_query_pair(
    table_a: RowIntervalTable,
    table_b: RowIntervalTable,
    px: torch.Tensor,
    py: torch.Tensor,
) -> torch.Tensor:
    """``interval_query(a, ...) + interval_query(b, ...)`` with shared indices."""
    if not same_geometry(table_a, table_b):
        raise ValueError("interval_query_pair requires same-geometry tables")
    oob, iy, row = _query_indices(table_a, px, py)
    cost_a = (oob | _blocked(table_a, iy, row)).to(px.dtype)
    cost_b = (oob | _blocked(table_b, iy, row)).to(px.dtype)
    return cost_a + cost_b
