"""MPCC racing cost and on-device reference-trajectory generation.

Counterpart of ``mppi_playground_tpu/models/racing_mpcc.py``:

* :func:`make_mpcc_cost` — contouring/lag error against the per-step
  reference pose, velocity tracking, the obstacle and lane map penalty,
  input and delta-input costs (Qc=2, Ql=3, Qv=2, Qo=1e4, Qin=0.01,
  Qdin=0.5), on ``[K, 4]`` states for the unfused solver.  States on a
  CUDA device with two grid maps take one launch of ``ops/mpcc_cost``
  (``csrc/mpcc_cost.cu``), which raises on what it does not take; elsewhere
  the torch ops of :func:`make_mpcc_cost_plain`.
* :func:`make_mpcc_cost_soa` — the same cost on component tensors, in the
  operation order of the fused CUDA kernel (``csrc/racing_model.cuh``); the
  kernel's plain twin traces it.
* :func:`calc_ref_trajectory` — nearest path index by an on-device argmin
  with monotone progress ``max(cind, ind)``, a lookahead of 3 m at 0.85 m
  intervals accumulated in float64 on the host, and a target velocity that
  zeroes for the whole horizon once the lookahead overruns the path end.
  A path on a CUDA device takes one launch of ``ops/reference_rows``
  (``csrc/reference_rows.cu``), which raises on what it does not take; a
  path on the CPU takes the torch ops of :func:`calc_ref_trajectory_plain`.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from mppi_playground_tpu_torch.maps.grid_cost import (
    GridMapData,
    grid_cost_pair,
    map_query,
)
from mppi_playground_tpu_torch.models.bicycle import V_MAX
from mppi_playground_tpu_torch.ops.mpcc_cost import stage_cost
from mppi_playground_tpu_torch.ops.reference_rows import reference_rows
from mppi_playground_tpu_torch.utils import timing

_REFERENCE_ROWS = timing.Span("solver.reference_rows")

QC = 2.0
QL = 3.0
QV = 2.0
QO = 10000.0
QIN = 0.01
QDIN = 0.5


def make_mpcc_cost(
    obstacle_map: GridMapData,
    lane_map: GridMapData,
    qc: float = QC,
    ql: float = QL,
    qv: float = QV,
    qo: float = QO,
    qin: float = QIN,
    qdin: float = QDIN,
) -> Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]:
    """Contouring-control stage cost on ``state [K, 4]``, ``action [K, 2]``.

    Expects ``info['reference_path']`` ``[horizon+1, 4]`` (x, y, yaw,
    v_target) and the solver's ``info['t']`` / ``info['prev_action']``.  The
    maps are either form, :class:`GridMapData` or a feature map
    (``maps/grid_cost.map_query``).  With two :class:`GridMapData` maps the
    cost takes ``ops/mpcc_cost.stage_cost``: one launch of
    ``csrc/mpcc_cost.cu`` for states on a CUDA device (float32; anything else
    there raises), the torch ops of :func:`make_mpcc_cost_plain` elsewhere.
    A feature map takes the torch ops on any device.
    """
    weights = (qc, ql, qv, qo, qin, qdin)
    plain = make_mpcc_cost_plain(obstacle_map, lane_map, *weights)
    grids = isinstance(obstacle_map, GridMapData) and isinstance(lane_map, GridMapData)

    def cost(state: torch.Tensor, action: torch.Tensor, info: dict) -> torch.Tensor:
        ref = info["reference_path"][info["t"]]
        prev_action = info["prev_action"]
        if grids:
            return stage_cost(state, action, prev_action, ref, plain, obstacle_map, lane_map,
                              weights)
        return plain(state, action, prev_action, ref)

    return cost


def make_mpcc_cost_plain(
    obstacle_map: GridMapData,
    lane_map: GridMapData,
    qc: float = QC,
    ql: float = QL,
    qv: float = QV,
    qo: float = QO,
    qin: float = QIN,
    qdin: float = QDIN,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """:func:`make_mpcc_cost` in torch ops, on any device and dtype: ``plain(state [K, 4],
    action [K, 2], prev_action [K, 2], ref [4])``, ``ref`` the tick's reference row (x, y,
    yaw, v_target).  The CPU's route, and what the kernel is held against on the card."""

    def plain(state, action, prev_action, ref):
        dx = state[:, 0] - ref[0]
        dy = state[:, 1] - ref[1]
        sin_yaw = torch.sin(ref[2])
        cos_yaw = torch.cos(ref[2])
        ec = sin_yaw * dx - cos_yaw * dy
        el = -cos_yaw * dx - sin_yaw * dy
        path_cost = qc * ec**2 + ql * el**2

        velocity_cost = qv * (state[:, 3] - ref[3]) ** 2

        pos = state[:, :2]
        map_cost = map_query(obstacle_map, pos) + map_query(lane_map, pos)
        obstacle_cost = qo * map_cost

        input_cost = qin * torch.sum(action**2, dim=1)
        input_cost = input_cost + qdin * torch.sum((action - prev_action) ** 2, dim=1)

        return path_cost + velocity_cost + obstacle_cost + input_cost

    return plain


def make_mpcc_cost_soa(
    qc: float = QC,
    ql: float = QL,
    qv: float = QV,
    qo: float = QO,
    qin: float = QIN,
    qdin: float = QDIN,
) -> Callable:
    """Structure-of-arrays MPCC stage cost, the fused kernel's arithmetic.

    ``ctx`` carries ``t`` (int), ``prev_us`` (tuple), ``xref`` ``[T+1, 5]``
    rows ``(x, y, sin_yaw, cos_yaw, v_target)`` and ``maps``, a tuple
    ``(obstacle_grid, lane_grid, origin, cell_size)``.
    """

    def cost_soa(xs, us, ctx):
        x, y, _theta, v = xs
        xref = ctx["xref"][ctx["t"]]
        rx, ry, sin_yaw, cos_yaw, rv = xref[0], xref[1], xref[2], xref[3], xref[4]

        dx = x - rx
        dy = y - ry
        ec = sin_yaw * dx - cos_yaw * dy
        el = -cos_yaw * dx - sin_yaw * dy
        path_cost = qc * ec * ec + ql * el * el

        dv = v - rv
        velocity_cost = qv * (dv * dv)

        grid_a, grid_b, origin, cell_size = ctx["maps"]
        obstacle_cost = qo * grid_cost_pair(grid_a, grid_b, origin, cell_size, x, y)

        u0, u1 = us
        p0, p1 = ctx["prev_us"]
        input_cost = qin * u0 * u0 + qin * u1 * u1
        d0 = u0 - p0
        d1 = u1 - p1
        input_cost = input_cost + (qdin * (d0 * d0) + qdin * (d1 * d1))
        return path_cost + velocity_cost + obstacle_cost + input_cost

    return cost_soa


def make_racing_fused_task(
    obstacle_map: GridMapData,
    lane_map: GridMapData,
    x_lim: Tuple[float, float],
    y_lim: Tuple[float, float],
):
    """The racing model's data for the fused kernel, from two grids on one raster.

    Reads the origins back to the host once, at build time.
    """
    from mppi_playground_tpu_torch.ops.fused_solve import RacingFusedTask

    origin = tuple(float(v) for v in obstacle_map.origin.tolist())
    lane_origin = tuple(float(v) for v in lane_map.origin.tolist())
    if (
        origin != lane_origin
        or obstacle_map.cell_size != lane_map.cell_size
        or obstacle_map.grid.shape != lane_map.grid.shape
    ):
        raise ValueError("the fused kernel needs the obstacle and lane grids on one raster")
    return RacingFusedTask(
        obstacle_grid=(obstacle_map.grid != 0).to(torch.uint8).contiguous(),
        lane_grid=(lane_map.grid != 0).to(torch.uint8).contiguous(),
        origin=origin,
        cell_size=float(obstacle_map.cell_size),
        x_lim=(float(x_lim[0]), float(x_lim[1])),
        y_lim=(float(y_lim[0]), float(y_lim[1])),
    )


def make_racing_fused_task_from_env(env):
    """``make_racing_fused_task`` wired from a ``RacingEnv``'s maps and bounds."""
    return make_racing_fused_task(
        env.obstacle_map.device_map,
        env.lane_map.device_map,
        x_lim=tuple(env.obstacle_map.x_lim),
        y_lim=tuple(env.obstacle_map.y_lim),
    )


def extend_reference_path(xref: torch.Tensor) -> torch.Tensor:
    """``[..., T+1, 4]`` (x, y, yaw, v) -> ``[..., T+1, 5]`` (x, y, sin, cos, v)."""
    return torch.stack(
        [
            xref[..., 0],
            xref[..., 1],
            torch.sin(xref[..., 2]),
            torch.cos(xref[..., 2]),
            xref[..., 3],
        ],
        dim=-1,
    )


def racing_reference(info) -> torch.Tensor:
    """The racing task's reference builder: ``info['reference_path']`` ``[..., T+1, 4]`` ->
    the kernels' rows ``[..., T+1, 5]`` (:func:`extend_reference_path`)."""
    return extend_reference_path(info["reference_path"])


@functools.lru_cache(maxsize=16)
def _lookahead_offsets(
    horizon: int,
    DL: float,
    lookahead_distance: float,
    reference_path_interval: float,
    device: torch.device,
) -> torch.Tensor:
    """Row offsets of the reference, accumulated in float64 on the host.

    ``travel += interval`` each row and ``round(travel / DL)``: a closed
    form in float32 rounds about one row in five differently.  Cached per
    device so that a tick copies nothing from the host.  Read-only.
    """
    travel = float(lookahead_distance)
    dind_list = []
    for _ in range(horizon + 1):
        travel += float(reference_path_interval)
        dind_list.append(int(round(travel / DL)))
    return torch.tensor(dind_list, dtype=torch.int64, device=device)


def _kernel_rows(states, path, cinds, horizon, DL, lookahead_distance, reference_path_interval,
                 v_max):
    """``ops/reference_rows`` on ``states [B, 4]`` and ``cinds [B]``, with the cached float64
    lookahead table."""
    dinds = _lookahead_offsets(
        int(horizon), float(DL), float(lookahead_distance),
        float(reference_path_interval), path.device,
    )
    cinds = torch.as_tensor(cinds, dtype=torch.int64, device=path.device)
    return reference_rows(states.contiguous(), path.contiguous(), cinds.contiguous(), dinds,
                          v_max)


def calc_ref_trajectory(
    state: torch.Tensor,
    path: torch.Tensor,
    cind: torch.Tensor,
    horizon: int,
    DL: float = 0.1,
    lookahead_distance: float = 3.0,
    reference_path_interval: float = 0.85,
    v_max: float = V_MAX,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference trajectory for the current tick, all on the path's device.

    A path on a CUDA device: the kernel at a batch of one; on the CPU
    :func:`calc_ref_trajectory_plain`.  The same rows and index either way.

    Args:
        state: ``[4]`` current vehicle state.
        path: ``[N, 3]`` resampled center path (x, y, yaw).
        cind: 0-dim int64 tensor, the monotone progress index.
        horizon: prediction horizon T.

    Returns:
        (xref ``[horizon+1, 4]``, new_cind 0-dim int64 tensor).
    """
    with _REFERENCE_ROWS:
        if path.is_cuda:
            cinds = torch.as_tensor(cind, dtype=torch.int64, device=path.device).reshape(1)
            xrefs, inds = _kernel_rows(state[None], path, cinds, horizon, DL,
                                       lookahead_distance, reference_path_interval, v_max)
            return xrefs[0], inds[0]
        return calc_ref_trajectory_plain(state, path, cind, horizon, DL, lookahead_distance,
                                         reference_path_interval, v_max)


def calc_ref_trajectory_plain(
    state: torch.Tensor,
    path: torch.Tensor,
    cind: torch.Tensor,
    horizon: int,
    DL: float = 0.1,
    lookahead_distance: float = 3.0,
    reference_path_interval: float = 0.85,
    v_max: float = V_MAX,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`calc_ref_trajectory` in torch ops, on any device and dtype: the CPU's route, and
    what the kernel is held against on the card."""
    ncourse = path.shape[0]
    dx = path[:, 0] - state[0]
    dy = path[:, 1] - state[1]
    d = torch.sqrt(dx * dx + dy * dy)
    nearest = torch.argmin(d)  # first minimum
    ind = torch.maximum(torch.as_tensor(cind, dtype=torch.int64, device=path.device), nearest)

    dinds = _lookahead_offsets(
        int(horizon), float(DL), float(lookahead_distance),
        float(reference_path_interval), path.device,
    )
    rows = ind + dinds
    valid = rows < ncourse
    rows = torch.clamp(rows, max=ncourse - 1)
    xref_pose = path[rows]

    v_column = torch.where(
        torch.all(valid),
        torch.full((horizon + 1,), v_max, dtype=path.dtype, device=path.device),
        torch.zeros((horizon + 1,), dtype=path.dtype, device=path.device),
    )
    xref = torch.cat([xref_pose, v_column[:, None]], dim=1)
    return xref.to(state.dtype), ind


def calc_ref_trajectory_batch(
    states: torch.Tensor,
    path: torch.Tensor,
    cinds: torch.Tensor,
    horizon: int,
    DL: float = 0.1,
    lookahead_distance: float = 3.0,
    reference_path_interval: float = 0.85,
    v_max: float = V_MAX,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`calc_ref_trajectory` for a fleet: row b is the single call on ``states[b]``, bit for bit.

    A path on a CUDA device: one launch of the kernel for the B states; on
    the CPU :func:`calc_ref_trajectory_batch_plain`.

    Args:
        states: ``[B, 4]`` vehicle states.
        path: ``[N, 3]`` resampled center path.
        cinds: ``[B]`` int64 monotone progress indices.

    Returns:
        (xrefs ``[B, horizon+1, 4]``, new_cinds ``[B]`` int64).
    """
    with _REFERENCE_ROWS:
        if path.is_cuda:
            return _kernel_rows(states, path, cinds, horizon, DL, lookahead_distance,
                                reference_path_interval, v_max)
        return calc_ref_trajectory_batch_plain(states, path, cinds, horizon, DL,
                                               lookahead_distance, reference_path_interval, v_max)


def calc_ref_trajectory_batch_plain(
    states: torch.Tensor,
    path: torch.Tensor,
    cinds: torch.Tensor,
    horizon: int,
    DL: float = 0.1,
    lookahead_distance: float = 3.0,
    reference_path_interval: float = 0.85,
    v_max: float = V_MAX,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`calc_ref_trajectory_batch` in torch ops, on any device and dtype.

    The JAX fleet's ``jax.vmap(calc_ref_trajectory)``, written out over the
    leading axis: the same operations elementwise (the nearest path point by
    the first minimum, the float64 lookahead table, the zeroed velocity
    column of a row whose lookahead overruns the path end).
    """
    ncourse = path.shape[0]
    dx = path[:, 0] - states[:, 0:1]
    dy = path[:, 1] - states[:, 1:2]
    d = torch.sqrt(dx * dx + dy * dy)
    nearest = torch.argmin(d, dim=1)  # first minimum
    ind = torch.maximum(torch.as_tensor(cinds, dtype=torch.int64, device=path.device), nearest)

    dinds = _lookahead_offsets(
        int(horizon), float(DL), float(lookahead_distance),
        float(reference_path_interval), path.device,
    )
    rows = ind[:, None] + dinds
    valid = rows < ncourse
    rows = torch.clamp(rows, max=ncourse - 1)
    xref_pose = path[rows]

    v_column = torch.where(
        torch.all(valid, dim=1, keepdim=True),
        torch.full((1, horizon + 1), v_max, dtype=path.dtype, device=path.device),
        torch.zeros((1, horizon + 1), dtype=path.dtype, device=path.device),
    )
    xrefs = torch.cat([xref_pose, v_column[..., None]], dim=-1)
    return xrefs.to(states.dtype), ind
