"""The unfused route's MPCC stage cost as one CUDA kernel launch (``csrc/mpcc_cost.cu``).

:func:`mpcc_cost` costs R rows of states and actions at once, as
``models/racing_mpcc.make_mpcc_cost``'s torch ops cost them (~64 kernels a
call): bit for bit on the card, NaN where they give NaN
(``tests/test_torch_mpcc_cost.py``).  It reads a state or an action where it
lies, by its row stride (an expanded state, a column of a sequence of
actions), and takes the rows as B groups of K, each group against its own
reference row, so that a vmapped call reads each group where it lies too.
The two maps' origins are read on the card: the launch reads nothing from
the host, so a CUDA graph captures it.  Its ``launches`` reads the eager
launches in ``utils/timing``'s registry.

:func:`stage_cost` is the route ``make_mpcc_cost`` takes for two
:class:`~mppi_playground_tpu_torch.maps.grid_cost.GridMapData` maps: by the
states' device alone, the kernel on a card (which raises on what it does not
take) and the torch ops elsewhere; under ``torch.func.vmap`` the vmapped
dimension is folded into the groups, so the kernel runs there too.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from mppi_playground_tpu_torch.maps.grid_cost import GridMapData
from mppi_playground_tpu_torch.ops import cuda_build
from mppi_playground_tpu_torch.ops.racing_plant import _batch_first, _groups
from mppi_playground_tpu_torch.utils import timing

_TENSOR = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
# grid, its two strides, width, height, origin, its stride, cell size
_MAP = [ctypes.c_void_p] + [ctypes.c_int64] * 4 + [ctypes.c_void_p, ctypes.c_int64,
                                                    ctypes.c_float]
# states, actions, previous actions (each with batch and row strides), reference and its
# batch stride, the two maps, the six weights, K, R, out
_ARGTYPES = (_TENSOR * 3 + [ctypes.c_void_p, ctypes.c_int64] + _MAP * 2 + [ctypes.c_float] * 6
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])

# (qc, ql, qv, qo, qin, qdin)
Weights = Tuple[float, float, float, float, float, float]


def _check_map(name: str, m: GridMapData) -> None:
    for part, t in (("grid", m.grid), ("origin", m.origin)):
        if t.dtype != torch.float32:
            raise ValueError(f"the {name} map's {part} must be torch.float32, got {t.dtype}")
    if m.grid.dim() != 2 or m.grid.numel() == 0:
        raise ValueError(f"the {name} map's grid must be a non-empty [W, H], got "
                         f"{tuple(m.grid.shape)}")
    if tuple(m.origin.shape) != (2,):
        raise ValueError(f"the {name} map's origin must be [2], got {tuple(m.origin.shape)}")


def _map_args(m: GridMapData) -> list:
    return [m.grid.data_ptr(), *m.grid.stride(), *m.grid.shape, m.origin.data_ptr(),
            m.origin.stride(0), float(m.cell_size)]


@timing.counted_launches("mpcc_cost")
def mpcc_cost(states: torch.Tensor, actions: torch.Tensor, prev_actions: torch.Tensor,
              reference: torch.Tensor, obstacle_map: GridMapData, lane_map: GridMapData,
              weights: Weights) -> torch.Tensor:
    """The stage costs ``[R]`` of ``states [R, 4]`` under ``actions [R, 2]`` after
    ``prev_actions [R, 2]``, against the reference row ``reference [4]`` (x, y, yaw, v).

    Also ``[B, K, 4]``, ``[B, K, 2]``, ``[B, K, 2]`` and ``[B, 4]`` (a vmapped call's groups,
    each against its own reference row) -> ``[B, K]``.  float32 on one CUDA device, any
    strides with contiguous columns; ``1 <= R < 2**31`` rows in all; each map's grid
    ``[W, H]`` (any strides) and origin ``[2]`` float32 on the same device.  ``weights`` are
    ``(qc, ql, qv, qo, qin, qdin)``.  Raises on anything else.
    """
    lead = tuple(states.shape[:-1])
    if states.dim() not in (2, 3) or states.shape[-1] != 4:
        raise ValueError(f"states must be [R, 4] or [B, K, 4], got {tuple(states.shape)}")
    for name, t in (("actions", actions), ("prev_actions", prev_actions)):
        if tuple(t.shape) != lead + (2,):
            raise ValueError(f"{name} must be {list(lead + (2,))}, one a state, got "
                             f"{tuple(t.shape)}")
    if tuple(reference.shape) != lead[:-1] + (4,):
        raise ValueError(f"reference must be {list(lead[:-1] + (4,))}, one row a group, got "
                         f"{tuple(reference.shape)}")
    rows = states.shape[0] * states.shape[1] if states.dim() == 3 else states.shape[0]
    if not 1 <= rows < 2**31:
        raise ValueError(f"the rows must number 1 to 2**31 - 1, got {rows}")
    dev = states.device
    tensors = (("states", states), ("actions", actions), ("prev_actions", prev_actions),
               ("reference", reference))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have contiguous columns (inner stride 1), got "
                             f"strides {t.stride()}")
    maps = (("obstacle", obstacle_map), ("lane", lane_map))
    for name, m in maps:
        _check_map(name, m)
    tensors += tuple((f"the {name} map's {part}", t) for name, m in maps
                     for part, t in (("grid", m.grid), ("origin", m.origin)))
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be on the states' CUDA device, got {t.device} and "
                             f"{dev}")
    if states.dim() == 3:
        per_batch = states.shape[1]
        strides = [t.stride()[:2] for t in (states, actions, prev_actions)]
        ref_stride = reference.stride(0)
    else:
        per_batch = rows
        strides = [(0, t.stride(0)) for t in (states, actions, prev_actions)]
        ref_stride = 0
    out = torch.empty(lead, dtype=torch.float32, device=dev)
    (xb, xr), (ub, ur), (pb, pr) = strides
    cuda_build.launch("mpcc_cost", "mpcc_cost", _ARGTYPES, dev,
                      states.data_ptr(), xb, xr, actions.data_ptr(), ub, ur,
                      prev_actions.data_ptr(), pb, pr, reference.data_ptr(), ref_stride,
                      *_map_args(obstacle_map), *_map_args(lane_map),
                      *(float(q) for q in weights), per_batch, rows, out.data_ptr())
    return out


class _StageCost(torch.autograd.Function):
    """The route: the kernel for states on a card, the torch ops ``plain`` elsewhere; under
    vmap, the vmapped dimension folded into the groups (the cost works row by row, each group
    against its own reference row)."""

    generate_vmap_rule = False

    @staticmethod
    def forward(states, actions, prev_actions, reference, plain, obstacle_map, lane_map,
                weights):
        if states.is_cuda:
            return mpcc_cost(states, actions, prev_actions, reference, obstacle_map, lane_map,
                             weights)
        if states.dim() == 3:  # groups folded by the vmap rule: the torch ops group by group
            return torch.stack([plain(*(t[g] for t in (states, actions, prev_actions,
                                                        reference)))
                                for g in range(states.shape[0])])
        return plain(states, actions, prev_actions, reference)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, states, actions, prev_actions, reference, plain, obstacle_map,
             lane_map, weights):
        xs, us, ps, ref = (_batch_first(t, d, info.batch_size) for t, d in zip(
            (states, actions, prev_actions, reference), in_dims))
        out = _StageCost.apply(_groups(xs), _groups(us), _groups(ps), _groups(ref, 1), plain,
                               obstacle_map, lane_map, weights)
        return out.reshape(xs.shape[:-1]), 0


def stage_cost(states: torch.Tensor, actions: torch.Tensor, prev_actions: torch.Tensor,
               reference: torch.Tensor,
               plain: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                               torch.Tensor],
               obstacle_map: GridMapData, lane_map: GridMapData,
               weights: Weights) -> torch.Tensor:
    """The MPCC stage cost of ``states [R, 4]`` under ``actions [R, 2]`` after
    ``prev_actions [R, 2]`` against ``reference [4]``: one launch of :func:`mpcc_cost` for
    states on a CUDA device, ``plain(states, actions, prev_actions, reference)`` (the torch ops
    of ``make_mpcc_cost`` on the same maps and weights) elsewhere."""
    return _StageCost.apply(states, actions, prev_actions, reference, plain, obstacle_map,
                            lane_map, weights)
