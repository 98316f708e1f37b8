"""The racing reference rows as one CUDA kernel launch (``csrc/reference_rows.cu``).

:func:`reference_rows` computes, for B vehicle states at once, what
``models/racing_mpcc.calc_ref_trajectory_plain`` computes with torch ops: the
nearest path point by the first minimum of the distances, the monotone
progress index ``max(cind, nearest)``, the lookahead rows gathered from the
path with their clamp at its end, and the velocity column (``v_max``, or 0
for the whole horizon once a row overruns the path).  One block a scenario;
the rows and indices are bit for bit the torch ops' on the card
(``tests/test_torch_reference_rows.py``).  The launch reads nothing from the
host, so a CUDA graph captures it.  Its ``launches`` reads the eager
launches in ``utils/timing``'s registry.

``models/racing_mpcc.calc_ref_trajectory`` and ``calc_ref_trajectory_batch``
take it for a path on a CUDA device (the single call as a batch of one); a
path on the CPU takes the torch ops.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from mppi_playground_tpu_torch.ops import cuda_build
from mppi_playground_tpu_torch.utils import timing

# states, path, cinds, dinds, v_max, N, R, B, xrefs, inds
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


@timing.counted_launches("reference_rows")
def reference_rows(states: torch.Tensor, path: torch.Tensor, cinds: torch.Tensor,
                   dinds: torch.Tensor, v_max: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(xrefs [B, R, 4], inds [B])`` of ``states [B, 4]`` on ``path [N, 3]``.

    ``states`` and ``path`` float32, ``cinds [B]`` (the progress indices) and
    ``dinds [R]`` (the lookahead offsets, ``R = T+1``) int64, all contiguous on
    one CUDA device.  Raises on anything else.
    """
    if states.dim() != 2 or states.shape[1] != 4 or states.shape[0] < 1:
        raise ValueError(f"states must be [B, 4] with B >= 1, got {tuple(states.shape)}")
    if path.dim() != 2 or path.shape[1] != 3 or not 1 <= path.shape[0] < 2**31 // 3:
        raise ValueError(f"path must be [N, 3] with 1 <= N < 2**31 / 3, got {tuple(path.shape)}")
    batch = states.shape[0]
    if tuple(cinds.shape) != (batch,):
        raise ValueError(f"cinds must be [{batch}], one a state, got {tuple(cinds.shape)}")
    if dinds.dim() != 1 or dinds.shape[0] < 1:
        raise ValueError(f"dinds must be [R] with R >= 1, got {tuple(dinds.shape)}")
    dev = path.device
    tensors = (("states", states, torch.float32), ("path", path, torch.float32),
               ("cinds", cinds, torch.int64), ("dinds", dinds, torch.int64))
    for name, t, dtype in tensors:
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t, _ in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be on the path's CUDA device, got {t.device} and {dev}")
    rows = dinds.shape[0]
    xrefs = torch.empty(batch, rows, 4, dtype=torch.float32, device=dev)
    inds = torch.empty(batch, dtype=torch.int64, device=dev)
    cuda_build.launch("reference_rows", "reference_rows", _ARGTYPES, dev,
                      states.data_ptr(), path.data_ptr(), cinds.data_ptr(), dinds.data_ptr(),
                      float(v_max), path.shape[0], rows, batch, xrefs.data_ptr(), inds.data_ptr())
    return xrefs, inds
