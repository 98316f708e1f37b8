"""The racing plant's kinematic-bicycle step as one CUDA kernel launch (``csrc/racing_plant.cu``).

:func:`racing_plant` steps R rows of states at once, as
``models/bicycle.make_dynamics``'s torch ops step them (~67 kernels a call):
bit for bit on the card, NaN where they give NaN
(``tests/test_torch_racing_plant.py``).  It reads a state or an action where it
lies, by its row stride (an expanded state, a column of a sequence of actions),
and takes the rows as B groups of K, so that a vmapped call reads each group
where it lies too.  The launch reads nothing from the host, so a CUDA graph
captures it.  Its ``launches`` reads the eager launches in ``utils/timing``'s
registry.

:func:`bicycle_step` is the route ``envs/racing_env.RacingEnv.dynamics``
takes: by the states' device alone, the kernel on a card (which raises on what
it does not take) and the torch ops elsewhere; under ``torch.func.vmap`` the
vmapped dimension is folded into the rows, so the kernel runs there too.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from mppi_playground_tpu_torch.ops import cuda_build
from mppi_playground_tpu_torch.utils import timing

# states, batch stride, row stride, actions, batch stride, row stride, K, R,
# x_lo, x_hi, y_lo, y_hi, out
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int64] * 2) * 2 + [ctypes.c_int] * 2 + [
    ctypes.c_float] * 4 + [ctypes.c_void_p]

Limits = Tuple[float, float]


@timing.counted_launches("racing_plant")
def racing_plant(states: torch.Tensor, actions: torch.Tensor, x_lim: Limits,
                 y_lim: Limits) -> torch.Tensor:
    """The next states ``[R, 4]`` of ``states [R, 4]`` under ``actions [R, 2]``.

    Also ``[B, K, 4]`` and ``[B, K, 2]`` (a vmapped call's groups) ->
    ``[B, K, 4]``, row b of the output group b.  float32 on one CUDA device,
    any strides with contiguous columns; ``1 <= R < 2**31`` rows in all.  The
    position is clamped to ``x_lim`` and ``y_lim``.  Raises on anything else.
    """
    lead = tuple(states.shape[:-1])
    if states.dim() not in (2, 3) or states.shape[-1] != 4:
        raise ValueError(f"states must be [R, 4] or [B, K, 4], got {tuple(states.shape)}")
    if tuple(actions.shape) != lead + (2,):
        raise ValueError(f"actions must be {list(lead + (2,))}, one a state, got "
                         f"{tuple(actions.shape)}")
    rows = states.shape[0] * states.shape[1] if states.dim() == 3 else states.shape[0]
    if not 1 <= rows < 2**31:
        raise ValueError(f"the rows must number 1 to 2**31 - 1, got {rows}")
    dev = states.device
    tensors = (("states", states), ("actions", actions))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have contiguous columns (inner stride 1), got "
                             f"strides {t.stride()}")
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be on the states' CUDA device, got {t.device} and "
                             f"{dev}")
    if states.dim() == 3:
        per_batch = states.shape[1]
        x_strides, u_strides = states.stride()[:2], actions.stride()[:2]
    else:
        per_batch = rows
        x_strides, u_strides = (0, states.stride(0)), (0, actions.stride(0))
    out = torch.empty(lead + (4,), dtype=torch.float32, device=dev)
    cuda_build.launch("racing_plant", "racing_plant", _ARGTYPES, dev,
                      states.data_ptr(), *x_strides, actions.data_ptr(), *u_strides, per_batch,
                      rows, float(x_lim[0]), float(x_lim[1]), float(y_lim[0]), float(y_lim[1]),
                      out.data_ptr())
    return out


def _batch_first(t: torch.Tensor, dim, batch: int) -> torch.Tensor:
    """``t`` with its vmapped dimension ``dim`` first (``None``: broadcast, batch stride 0)."""
    return t.expand(batch, *t.shape) if dim is None else t.movedim(dim, 0)


def _groups(t: torch.Tensor, dims: int = 2) -> torch.Tensor:
    """``t [B, ..., *shape]``, ``shape`` its own ``dims`` dimensions (``[K, n]`` by default),
    as ``[B', *shape]``: the batch dimensions of nested vmaps folded."""
    return t.flatten(0, -dims - 1) if t.dim() > dims + 1 else t


class _BicycleStep(torch.autograd.Function):
    """The route: the kernel for states on a card, the torch ops ``plain`` elsewhere; under
    vmap, the vmapped dimension folded into the rows (the step works row by row)."""

    generate_vmap_rule = False

    @staticmethod
    def forward(states, actions, plain, x_lim, y_lim):
        if states.is_cuda:
            return racing_plant(states, actions, x_lim, y_lim)
        return plain(states, actions)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, states, actions, plain, x_lim, y_lim):
        xs = _batch_first(states, in_dims[0], info.batch_size)
        us = _batch_first(actions, in_dims[1], info.batch_size)
        out = _BicycleStep.apply(_groups(xs), _groups(us), plain, x_lim, y_lim)
        return out.reshape(xs.shape), 0


def bicycle_step(states: torch.Tensor, actions: torch.Tensor,
                 plain: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], x_lim: Limits,
                 y_lim: Limits) -> torch.Tensor:
    """The racing plant's step of ``states [R, 4]`` under ``actions [R, 2]``: one launch of
    :func:`racing_plant` for states on a CUDA device, ``plain(states, actions)`` (the torch
    ops of ``models/bicycle.make_dynamics`` at the same limits) elsewhere."""
    return _BicycleStep.apply(states, actions, plain, x_lim, y_lim)
