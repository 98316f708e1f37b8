"""Numerical guards: actionable errors instead of silent NaN propagation.

Counterpart of ``mppi_playground_tpu/utils/guards.py``, which wraps a solve
in ``jax.experimental.checkify``.  Torch has no checkify: :func:`checked_solve`
reduces the solve's costs and action sequence to two finiteness flags on the
device and reads them once.  That read waits for the device (a host sync),
so a checked solve cannot be captured in a CUDA graph and costs a round
trip a tick: a development tool for bringing up new dynamics and cost
models, not the serving hot path.
"""

from __future__ import annotations

import torch


class NonFiniteSolveError(RuntimeError):
    """A solve produced non-finite costs or actions."""


def checked_solve(solver):
    """Wrap ``solver.solve`` with non-finite checks.

    Returns ``checked(state, x0, info=None, noise=None) -> SolveResult``;
    raises :class:`NonFiniteSolveError` on non-finite costs or actions.
    """

    def solve(state, x0, info=None, noise=None):
        # only forward noise= when given: some solve surfaces take no noise parameter
        kwargs = {} if noise is None else {"noise": noise}
        result = solver.solve(state, x0, info=info, **kwargs)
        finite = torch.stack([torch.isfinite(result.aux.costs).all(),
                              torch.isfinite(result.action_seq).all()])
        costs_ok, actions_ok = finite.tolist()  # the one read: waits for the device
        if not costs_ok:
            raise NonFiniteSolveError("non-finite trajectory costs (dynamics or cost overflow)")
        if not actions_ok:
            raise NonFiniteSolveError(
                "non-finite optimal action sequence (softmin weights collapsed)")
        return result

    return solve
