"""Carry state and maps from the JAX package, as numpy arrays, into the port.

The tests hand the same inputs to both packages through these functions:
the solver state's warm start, SG history, temperature and MPO state; an
occupancy grid with its origin and cell size, as a map or as the fused
kernels' uint8 raster with the navigation task built on it; a map's analytic
feature form; the circuit's
center path; an environment's observation (the danger zone's 7 floats).
Nothing here imports the JAX package: callers pass ``np.asarray(...)`` of
its arrays.  ``device=None`` means ``cuda``, as everywhere in the port.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from mppi_playground_tpu_torch.core.config import AdamState, MPPIState, make_key
from mppi_playground_tpu_torch.maps.feature_query import FeatureMapData
from mppi_playground_tpu_torch.maps.grid_cost import GridMapData
from mppi_playground_tpu_torch.ops.fused_solve import FusedTask
from mppi_playground_tpu_torch.utils.device import resolve_device

Device = Optional[Union[str, torch.device]]


def mppi_state(
    previous_action_seq: np.ndarray,
    sg_history: np.ndarray,
    lam,
    seed: int = 0,
    tick: int = 0,
    device: Device = None,
    dtype: torch.dtype = torch.float32,
    mpo_log_temperature=0.0,
    mpo_opt_state: Optional[Sequence[np.ndarray]] = None,
) -> MPPIState:
    """An :class:`MPPIState` from the JAX state's arrays (its key is not carried).

    ``mpo_opt_state`` is ``(count, mu, nu)`` of the JAX state's Adam state
    (``state.mpo_opt_state[0]``), or ``None`` outside MPO mode.  ``seed``
    and ``tick`` name the port's noise stream; its device key is made from
    them.
    """
    device = resolve_device(device)

    def tensor(a, dt=dtype):
        return torch.as_tensor(np.array(a), dtype=dt, device=device)

    opt_state = None
    if mpo_opt_state is not None:
        count, mu, nu = mpo_opt_state
        opt_state = AdamState(count=tensor(count, torch.int32).reshape(()),
                              mu=tensor(mu).reshape(()), nu=tensor(nu).reshape(()))
    return MPPIState(
        previous_action_seq=tensor(previous_action_seq).contiguous(),
        sg_history=tensor(sg_history),
        lam=tensor(lam).reshape(()),
        seed=int(seed),
        tick=int(tick),
        mpo_log_temperature=tensor(mpo_log_temperature).reshape(()),
        mpo_opt_state=opt_state,
        key=make_key(seed, tick, device),
    )


def grid_map(
    grid: np.ndarray,
    origin: np.ndarray,
    cell_size: float,
    device: Device = None,
    dtype: torch.dtype = torch.float32,
) -> GridMapData:
    """A :class:`GridMapData` from an occupancy grid ``[W, H]``, origin and cell size."""
    device = resolve_device(device)
    return GridMapData(
        grid=torch.as_tensor(np.array(grid), dtype=dtype, device=device),
        origin=torch.as_tensor(np.array(origin), dtype=dtype, device=device),
        cell_size=float(cell_size),
    )


def feature_map(
    arrays: dict,
    cell_size: float,
    width: int,
    height: int,
    inside_is_blocked: bool,
    device: Device = None,
    dtype: torch.dtype = torch.float32,
) -> FeatureMapData:
    """A :class:`FeatureMapData` from a JAX ``FeatureMapData``'s arrays and its static fields.

    ``arrays`` maps the array fields (``disc_x``, ``disc_y``, ``disc_r2``,
    ``rect_x0``, ``rect_x1``, ``rect_y0``, ``rect_y1``, ``origin``) to numpy
    arrays.
    """
    device = resolve_device(device)
    fields = ("disc_x", "disc_y", "disc_r2", "rect_x0", "rect_x1", "rect_y0", "rect_y1", "origin")
    return FeatureMapData(
        **{f: torch.as_tensor(np.array(arrays[f]), dtype=dtype, device=device) for f in fields},
        cell_size=float(cell_size), width=int(width), height=int(height),
        inside_is_blocked=bool(inside_is_blocked),
    )


def center_path(
    path: np.ndarray, device: Device = None, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """The circuit's center path ``[N, 3]`` (x, y, heading) as a tensor."""
    device = resolve_device(device)
    return torch.as_tensor(np.array(path), dtype=dtype, device=device).contiguous()


def occupancy(grid: np.ndarray, device: Device = None) -> torch.Tensor:
    """The fused kernels' ``[W, H]`` uint8 raster (1 = blocked) of an occupancy grid."""
    device = resolve_device(device)
    return torch.as_tensor(np.array(grid) != 0, dtype=torch.uint8, device=device).contiguous()


def navigation_task(
    grid: np.ndarray,
    origin: np.ndarray,
    cell_size: float,
    goal: np.ndarray,
    x_lim: Sequence[float],
    y_lim: Sequence[float],
    device: Device = None,
) -> FusedTask:
    """The navigation model's :class:`FusedTask` from a JAX ``Navigation2DEnv``'s map and goal."""
    from mppi_playground_tpu_torch.models.unicycle import make_navigation_fused_task

    return make_navigation_fused_task(
        occupancy(grid, device),
        origin=tuple(float(v) for v in np.asarray(origin)),
        cell_size=float(cell_size),
        goal=tuple(float(v) for v in np.asarray(goal)),
        x_lim=(float(x_lim[0]), float(x_lim[1])),
        y_lim=(float(y_lim[0]), float(y_lim[1])),
    )


def observation(
    obs: np.ndarray, device: Device = None, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """An environment's observation (e.g. the danger zone's ``[7]``) as a tensor."""
    device = resolve_device(device)
    return torch.as_tensor(np.array(obs), dtype=dtype, device=device).contiguous()
