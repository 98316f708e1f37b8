"""Angle helpers shared by models and environments.

Counterpart of ``mppi_playground_tpu/utils/angles.py``: wrap an angle into
``[-pi, pi)`` with a floored remainder.  ``torch.remainder`` is
``fmod`` plus a sign fix, the same bits as JAX's ``%``; the CUDA kernels
use ``fmodf`` with the same fix (``csrc/device_math.cuh``).
"""

from __future__ import annotations

import math

import torch


def angle_normalize(x: torch.Tensor) -> torch.Tensor:
    """Wrap angles into ``[-pi, pi)``."""
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi
