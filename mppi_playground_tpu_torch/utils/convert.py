"""Carry state and maps from the JAX package, as numpy arrays, into the port.

The tests hand the same inputs to both packages through these functions:
the solver state's warm start, SG history and temperature; an occupancy
grid with its origin and cell size; the circuit's center path.  Nothing
here imports the JAX package: callers pass ``np.asarray(...)`` of its
arrays.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from mppi_playground_tpu_torch.core.config import MPPIState
from mppi_playground_tpu_torch.maps.grid_cost import GridMapData

Device = Optional[Union[str, torch.device]]


def mppi_state(
    previous_action_seq: np.ndarray,
    sg_history: np.ndarray,
    lam,
    seed: int = 0,
    tick: int = 0,
    device: Device = "cpu",
    dtype: torch.dtype = torch.float32,
) -> MPPIState:
    """An :class:`MPPIState` from the JAX state's arrays (its key is not carried)."""
    return MPPIState(
        previous_action_seq=torch.as_tensor(
            np.array(previous_action_seq), dtype=dtype, device=device
        ).contiguous(),
        sg_history=torch.as_tensor(np.array(sg_history), dtype=dtype, device=device),
        lam=torch.as_tensor(np.array(lam), dtype=dtype, device=device).reshape(()),
        seed=int(seed),
        tick=int(tick),
    )


def grid_map(
    grid: np.ndarray,
    origin: np.ndarray,
    cell_size: float,
    device: Device = "cpu",
    dtype: torch.dtype = torch.float32,
) -> GridMapData:
    """A :class:`GridMapData` from an occupancy grid ``[W, H]``, origin and cell size."""
    return GridMapData(
        grid=torch.as_tensor(np.array(grid), dtype=dtype, device=device),
        origin=torch.as_tensor(np.array(origin), dtype=dtype, device=device),
        cell_size=float(cell_size),
    )


def center_path(
    path: np.ndarray, device: Device = "cpu", dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """The circuit's center path ``[N, 3]`` (x, y, heading) as a tensor."""
    return torch.as_tensor(np.array(path), dtype=dtype, device=device).contiguous()
