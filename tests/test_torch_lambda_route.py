"""Which lambda route the port's fused solver takes under LBPS/ESSPS, on the CPU twins.

``make_fused_solver(..., lambda_epilogue=None)`` picks by K alone
(``core/fused_solver.takes_lambda_epilogue``): the epilogue (phase 1 and the
search in one launch) up to ``EPILOGUE_DEFAULT_MAX_SAMPLES``, the crossover
measured on the H100 (``PERF.md``), the standalone search above it, and
never above ``EPILOGUE_MAX_SAMPLES`` (524,288, the JAX package's gate).
``True`` and ``False`` force a route up to that gate.  The wrappers run
their plain twins on CPU tensors and count no launch there, so each solve's
route is read from counting spies around the two phase-1 wrappers the
solver calls.  ``MPPI`` takes no ``lambda_epilogue`` (the JAX facade has
none).
"""

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch import MPPI
from mppi_playground_tpu_torch.core import fused_solver
from mppi_playground_tpu_torch.core.config import MPPIConfig
from mppi_playground_tpu_torch.models import integrator

CROSSOVER = fused_solver.EPILOGUE_DEFAULT_MAX_SAMPLES
GATE = fused_solver.EPILOGUE_MAX_SAMPLES


def _config(num_samples, lam="ESSPS"):
    return MPPIConfig(horizon=1, num_samples=num_samples, dim_state=2, dim_control=2,
                      u_min=integrator.U_MIN, u_max=integrator.U_MAX, sigmas=(0.5, 0.5),
                      lambda_=lam, store_rollouts=False)


def _route_of_one_solve(monkeypatch, config, lambda_epilogue):
    """``"epilogue"`` or ``"standalone"``: the phase-1 wrapper one solve called (either
    route is the batch of one's)."""
    calls = {"epilogue": 0, "standalone": 0}
    for name, route in (("fused_costs_dump_lambda_batch", "epilogue"),
                        ("fused_costs_dump_batch", "standalone")):
        wrapped = getattr(fused_solver, name)

        def spy(*args, wrapped=wrapped, route=route, **kwargs):
            calls[route] += 1
            return wrapped(*args, **kwargs)

        monkeypatch.setattr(fused_solver, name, spy)
    solver = fused_solver.make_fused_solver(config, integrator.fused_task(), integrator.dynamics,
                                            device="cpu", lambda_epilogue=lambda_epilogue)
    result = solver.solve(solver.init(), torch.zeros(2))
    lam = result.aux.lam.item()  # float32 bounds
    assert np.float32(config.lambda_min) <= lam <= np.float32(config.lambda_max)
    assert sum(calls.values()) == 1, calls
    return max(calls, key=calls.get)


# each side of the measured crossover and of the gate, by default and forced
CASES = sorted({(k, forced) for k in (1, CROSSOVER, CROSSOVER + 1, GATE, GATE + 1) if k >= 1
                for forced in (None, True, False)},
               key=lambda case: (case[0], str(case[1])))


@pytest.mark.parametrize("num_samples,lambda_epilogue", CASES)
def test_default_route_follows_the_measured_crossover(monkeypatch, num_samples,
                                                      lambda_epilogue):
    config = _config(num_samples)
    want_epilogue = num_samples <= GATE and (
        num_samples <= CROSSOVER if lambda_epilogue is None else lambda_epilogue)
    assert fused_solver.takes_lambda_epilogue(config, lambda_epilogue) is want_epilogue
    want = "epilogue" if want_epilogue else "standalone"
    assert _route_of_one_solve(monkeypatch, config, lambda_epilogue) == want


@pytest.mark.parametrize("lam", ["LBPS", "MPO", 1.0])
def test_route_by_lambda_mode(monkeypatch, lam):
    """LBPS takes the same routes as ESSPS; MPO and a fixed lambda have no search."""
    config = _config(1000, lam)
    want = lam == "LBPS" and 1000 <= CROSSOVER
    assert fused_solver.takes_lambda_epilogue(config) is want
    assert fused_solver.takes_lambda_epilogue(config, True) is (lam == "LBPS")
    if lam == "LBPS":
        assert _route_of_one_solve(monkeypatch, config, None) == (
            "epilogue" if want else "standalone")


def test_mppi_takes_no_lambda_epilogue():
    """As the JAX ``MPPI`` facade: the option lives on ``make_fused_solver`` only."""
    kw = dict(horizon=4, num_samples=64, dim_state=2, dim_control=2,
              dynamics=integrator.dynamics, cost_func=integrator.cost, u_min=integrator.U_MIN,
              u_max=integrator.U_MAX, sigmas=(0.5, 0.5), lambda_="ESSPS", device="cpu",
              store_rollouts=False, fused_task=integrator.fused_task())
    assert MPPI(**kw).solver_backend == "fused"
    with pytest.raises(TypeError, match="lambda_epilogue"):
        MPPI(**kw, lambda_epilogue=True)
