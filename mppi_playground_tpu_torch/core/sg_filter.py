"""Savitzky–Golay smoothing of the solved action sequence.

Counterpart of ``mppi_playground_tpu/core/sg_filter.py``: the coefficients
are the first row of the pseudo-inverse of the window's Vandermonde matrix,
computed once on the host in float64 (a config constant); the filter
prepends the last ``horizon - 1`` applied actions, mirror-pads both ends and
cross-correlates each control dimension with the coefficients, keeping the
last ``horizon`` rows.  On tensors the filter is one ``[L, m, w] x [w]``
contraction over a window view, with no loop over the control dimensions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def savitzky_golay_coeffs(window_size: int, poly_order: int) -> np.ndarray:
    """Smoothing coefficients ``[window_size]``, float64: first row of pinv(Vandermonde)."""
    if window_size % 2 == 0 or window_size <= poly_order:
        raise ValueError("SG coefficients need an odd window_size larger than poly_order")
    half_window = (window_size - 1) // 2
    indices = np.arange(-half_window, half_window + 1, dtype=np.float64)
    vander = np.vander(indices, N=poly_order + 1, increasing=True)
    return np.linalg.pinv(vander)[0]


def apply_sg_filter(
    action_seq: torch.Tensor, history: torch.Tensor, coeffs: torch.Tensor
) -> torch.Tensor:
    """Filter ``action_seq [T, m]`` with ``history [T-1, m]`` prepended -> ``[T, m]``."""
    horizon = action_seq.shape[0]
    prolonged = torch.cat([history, action_seq], dim=0)  # [L, m]
    length = prolonged.shape[0]
    pad = coeffs.shape[0] // 2
    # slice the right pad by length: prolonged[-0:] (window 1) would mirror
    # the whole signal instead of nothing
    padded = torch.cat(
        [prolonged[:pad].flip(0), prolonged, prolonged[length - pad:].flip(0)], dim=0
    )  # [L + 2 pad, m]
    windows = padded.unfold(0, coeffs.shape[0], 1)  # [L, m, w]: out[i] uses padded[i + j]
    filtered = torch.einsum("lmw,w->lm", windows, coeffs.to(padded.dtype))
    return filtered[-horizon:].contiguous()  # the fused kernels take it as their warm start


def config_sg_coeffs(config, dtype: torch.dtype, device) -> Optional[torch.Tensor]:
    """The config's SG coefficients on ``device``, or ``None`` when the filter is off."""
    if not config.use_sg_filter:
        return None
    return torch.tensor(
        savitzky_golay_coeffs(config.sg_window_size, config.sg_poly_order),
        dtype=dtype, device=device,
    )
