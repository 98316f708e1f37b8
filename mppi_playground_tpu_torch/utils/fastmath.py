"""Polynomial sin/cos for normalized angles.

Counterpart of ``mppi_playground_tpu/utils/fastmath.py`` with the same
branch-free quadrant and octant reduction, the same Horner order and the
same constants (Python doubles rounded to float32 where they meet a float32
tensor), so both packages and the CUDA kernels (``csrc/device_math.cuh``)
compute the same bits on the same inputs.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_PI = math.pi
_HALF_PI = math.pi / 2
_QUARTER_PI = math.pi / 4


def sincos_npi(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sin x, cos x)`` for ``x`` in ``[-pi, pi]``; no range reduction."""
    ax = torch.abs(x)
    flip = ax > _HALF_PI
    r = torch.where(flip, _PI - ax, ax)
    swap = r > _QUARTER_PI
    t = torch.where(swap, _HALF_PI - r, r)
    t2 = t * t
    sp = t * (
        1.0
        + t2
        * (
            -1.0 / 6.0
            + t2 * (1.0 / 120.0 + t2 * (-1.0 / 5040.0 + t2 * (1.0 / 362880.0)))
        )
    )
    cp = 1.0 + t2 * (
        -0.5 + t2 * (1.0 / 24.0 + t2 * (-1.0 / 720.0 + t2 * (1.0 / 40320.0)))
    )
    s_r = torch.where(swap, cp, sp)
    c_r = torch.where(swap, sp, cp)
    sin = torch.where(x < 0, -s_r, s_r)
    cos = torch.where(flip, -c_r, c_r)
    return sin, cos


def sincos_2pi(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sin x, cos x)`` for ``x`` in ``[0, 2*pi)`` (Box–Muller angles)."""
    s, c = sincos_npi(x - _PI)
    return -s, -c
