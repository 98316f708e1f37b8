"""Solver diagnostics: top-weighted samples and posterior sampling.

Counterpart of ``mppi_playground_tpu/core/diagnostics.py``.

Top-k order.  ``jax.lax.top_k`` returns weights in descending order and,
among equal weights, the lower index first.  ``torch.topk`` orders ties
otherwise (and its CPU and CUDA versions need not agree), which matters
here: at racing costs of about 1e5 with lambda=1 nearly every weight
underflows to exactly 0, so the top 300 of thousands of samples are mostly
ties.  :func:`top_indices` therefore takes a stable descending sort.

Spans (``utils/timing``): a ``get_top_samples`` call is ``solver.top_samples``
on either route (here around the stored rollouts' read, in
``core/fused_solver`` around the fused route's regeneration), with the
selection ``solver.top_indices`` inside it; the counter
``solver.top_samples`` counts the calls.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mppi_playground_tpu_torch.utils import timing

TOP_SAMPLES = timing.Span("solver.top_samples")
TOP_INDICES = timing.Span("solver.top_indices")


def top_indices(weights: torch.Tensor, num_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(top weights [n], their indices [n])`` in ``jax.lax.top_k``'s order."""
    with TOP_INDICES:
        order = torch.sort(weights, descending=True, stable=True)
        return order.values[:num_samples], order.indices[:num_samples]


def top_samples(
    state_seq_batch: torch.Tensor, weights: torch.Tensor, num_samples: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``num_samples`` stored rollouts ``[n, T+1, n_x]`` and their weights, descending."""
    if num_samples > weights.shape[0]:
        raise ValueError(
            f"requested top {num_samples} samples, but the solve drew {weights.shape[0]}"
        )
    top_w, rows = top_indices(weights, num_samples)
    return state_seq_batch[rows], top_w


def top_samples_from_last(solver, aux, num_samples, noise=None, what="forward()"):
    """``get_top_samples`` of the controller facades.

    Stored rollouts are read; on the fused route the winning perturbations
    are regenerated through ``solver.top_samples``; otherwise the config
    cannot serve diagnostics.
    """
    if aux is None:
        raise RuntimeError(f"get_top_samples requires a prior {what}.")
    if aux.state_seq_batch is not None:
        with TOP_SAMPLES:
            timing.count("solver.top_samples")
            return top_samples(aux.state_seq_batch, aux.weights, num_samples)
    if solver.top_samples is not None:
        return solver.top_samples(aux, num_samples, noise=noise)
    raise RuntimeError(
        "get_top_samples requires store_rollouts=True or the fused "
        "solver (which regenerates rollouts from seeds)."
    )


def posterior_samples(
    generator: torch.Generator,
    optimal_solution: torch.Tensor,
    sigmas: torch.Tensor,
    num_samples: int,
) -> torch.Tensor:
    """``[N, T, m]`` action sequences from the MPPI posterior.

    A Gaussian around the optimal sequence with the diagonal noise
    covariance, drawn from ``generator`` (on the solution's device).  Roll
    them through ``MPPISolver.states_prediction`` for predictive states.
    """
    horizon, dim_control = optimal_solution.shape
    noise = torch.randn(
        num_samples, horizon, dim_control, generator=generator,
        dtype=optimal_solution.dtype, device=optimal_solution.device,
    )
    return optimal_solution[None] + noise * sigmas
