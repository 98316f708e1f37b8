"""Softmin weighting and weighted-average update of the unfused solver.

Counterpart of ``_xla_weighted_update`` in
``mppi_playground_tpu/ops/weighted_update.py``:
``weights = softmax(-costs / lambda)``, ``update = sum_k weights[k] *
samples[k]`` and the effective sample size ``1 / sum(w^2)``.  The streaming
Pallas kernel of that module serves the JAX package's unfused path on a
TPU only; its port is queued.
"""

from __future__ import annotations

from typing import Tuple

import torch


def weighted_update(
    costs: torch.Tensor, samples: torch.Tensor, lam: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(update [T, m], weights [K], ess)`` from costs ``[K]`` and samples ``[K, T, m]``."""
    weights = torch.softmax(-costs / lam, dim=0)
    update = torch.einsum("k,ktm->tm", weights, samples)
    ess = 1.0 / torch.sum(weights * weights)
    return update, weights, ess
