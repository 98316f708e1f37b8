"""The port's pipelined (stale-action) serving: the control-quality bounds.

Counterpart of the quality cases of ``tests/test_pipelined_quality.py``,
with the JAX package's bounds unchanged, on the port's own seeded draws:
the pendulum swing-up (T=15, K=512, λ=1, seed 3, from hanging down) through
``core/closed_loop.make_pipelined_closed_loop``, whose action schedule is
:class:`PipelinedRunner`'s bit for bit (``tests/test_torch_closed_loop.py``).

Measured on the CPU (300 ticks unless said): strict sync (depth 0) episode
cost 404.5, final |θ| 0.023 after 150 ticks; depth 2 compensated 566.3
(1.40x strict, final |θ| 0.103), uncompensated 558.1 (1.38x, final |θ|
0.037); depth 4 compensated 1341.1 (3.31x, max |ω| 6.11, not stabilized by
tick 300).  The JAX package measured 1.05x, 1.41x and 3.4x on its draws.
"""

import math

import pytest
import torch

from mppi_playground_tpu_torch import MPPIConfig, make_solver
from mppi_playground_tpu_torch.core.closed_loop import make_pipelined_closed_loop
from mppi_playground_tpu_torch.models import pendulum
from mppi_playground_tpu_torch.utils.angles import angle_normalize

HORIZON = 15
K = 512
TICKS = 150


def _config():
    return MPPIConfig(horizon=HORIZON, num_samples=K, dim_state=2, dim_control=1,
                      u_min=pendulum.U_MIN, u_max=pendulum.U_MAX, sigmas=(1.0,), lambda_=1.0,
                      store_rollouts=False)


def _plant(x, u):
    return pendulum.dynamics(x[None], u[None])[0]


def _episode_cost(xs) -> float:
    return float(torch.sum(angle_normalize(xs[:, 0]) ** 2 + 0.1 * xs[:, 1] ** 2))


def _run(depth, compensate, ticks=TICKS):
    """``(x_final, xs)`` of the pipelined swing-up at ``depth``."""
    solver = make_solver(_config(), pendulum.dynamics, pendulum.cost, device="cpu")
    run = make_pipelined_closed_loop(solver, _plant, ticks, depth, compensate=compensate)
    _, xf, xs, _, _ = run(solver.init(seed=3), torch.tensor([math.pi, 0.0]))
    return xf, xs


@pytest.fixture(scope="module")
def strict_cost():
    return _episode_cost(_run(0, True, ticks=300)[1])


def test_depth0_is_strict_sync():
    xf, _ = _run(0, True)
    assert abs(float(angle_normalize(xf[0]))) < 0.15


@pytest.mark.parametrize("compensate", [True, False])
def test_depth2_quality_bounded(compensate, strict_cost):
    """Depth 2 swings up, its cost within 1.6x strict (2.5x without compensation)."""
    xf, xs = _run(2, compensate, ticks=300)
    assert abs(float(angle_normalize(xf[0]))) < 0.25, (
        f"depth-2 (compensate={compensate}) failed to swing up")
    cost = _episode_cost(xs)
    bound = 1.6 if compensate else 2.5
    assert cost < bound * strict_cost, (
        f"depth-2 compensate={compensate} episode cost {cost:.1f} vs strict {strict_cost:.1f}")


def test_depth4_degradation_bounded(strict_cost):
    """Depth 4 degrades (3.31x measured) but stays bounded: under 6x strict, |ω| <= 8."""
    _, xs = _run(4, True, ticks=300)
    cost = _episode_cost(xs)
    assert cost < 6.0 * strict_cost, (
        f"depth-4 degradation blew past the measured ~3.3x envelope: {cost:.1f} vs strict "
        f"{strict_cost:.1f}")
    assert float(xs[:, 1].abs().max()) <= 8.0
