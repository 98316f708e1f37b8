"""Shared-noise parity: the port's unfused solver against the float64 torch oracle.

The counterpart of ``tests/test_oracle_parity.py`` for the port:
``make_solver(..., device="cpu")`` in float32 and ``TorchOracleMPPI`` in
float64 get the same noise, so rollout, costs, softmin weighting (the
weighted-update kernel's twin), auto-lambda, the SG filter and the warm
start must agree to float32 accuracy over closed-loop ticks.  The cases and
bars are that file's; its torch integrator and pendulum drive both sides.
"""

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch.core.config import MPPIConfig
from mppi_playground_tpu_torch.core.solver import make_solver
from tests.reference_oracle import TorchOracleMPPI
from tests.test_oracle_parity import (
    torch_integrator_cost,
    torch_integrator_dynamics,
    torch_pendulum_cost,
    torch_pendulum_dynamics,
)


def _integrator_cost(state, action, info):
    """The oracle's integrator cost in the state's own dtype (its goal is float64)."""
    return torch_integrator_cost(state, action, info).to(state.dtype)


CASES = {
    "integrator": dict(dim_state=2, dim_control=2, u_min=(-1.0, -1.0), u_max=(1.0, 1.0),
                       sigmas=(0.5, 0.5), port_model=(torch_integrator_dynamics, _integrator_cost),
                       oracle_model=(torch_integrator_dynamics, torch_integrator_cost),
                       x0=np.array([0.0, 0.0])),
    "pendulum": dict(dim_state=2, dim_control=1, u_min=(-2.0,), u_max=(2.0,), sigmas=(1.0,),
                     port_model=(torch_pendulum_dynamics, torch_pendulum_cost),
                     oracle_model=(torch_pendulum_dynamics, torch_pendulum_cost),
                     x0=np.array([np.pi, 0.0])),
}


def _run_parity(case_name, lambda_, horizon=8, num_samples=200, ticks=5, exploration=0.0,
                use_sg_filter=False, atol=2e-5):
    case = CASES[case_name]
    shared = dict(horizon=horizon, num_samples=num_samples, dim_state=case["dim_state"],
                  dim_control=case["dim_control"], u_min=case["u_min"], u_max=case["u_max"],
                  sigmas=case["sigmas"], lambda_=lambda_, exploration=exploration,
                  use_sg_filter=use_sg_filter)
    solver = make_solver(MPPIConfig(**shared), *case["port_model"], device="cpu")
    state = solver.init()
    od, oc = case["oracle_model"]
    oracle = TorchOracleMPPI(dynamics=od, cost_func=oc, **shared)

    rng = np.random.default_rng(7)
    x = case["x0"].astype(np.float64)
    for _ in range(ticks):
        noise = rng.normal(size=(num_samples, horizon, case["dim_control"])) * np.asarray(
            case["sigmas"])
        noise32 = noise.astype(np.float32)
        result = solver.solve(state, torch.tensor(x, dtype=torch.float32),
                              noise=torch.from_numpy(noise32))
        state = result.state
        actions, states = result.action_seq.double().numpy(), result.state_seq.double().numpy()
        actions_oracle, states_oracle, _, _ = oracle.solve(x, noise32.astype(np.float64))
        np.testing.assert_allclose(actions, actions_oracle, atol=atol)
        np.testing.assert_allclose(states, states_oracle, atol=atol * 20)
        # drive both with the oracle's first action (closed loop)
        x = oracle.dynamics(torch.as_tensor(x).unsqueeze(0),
                            torch.as_tensor(actions_oracle[0]).unsqueeze(0))[0].numpy()


@pytest.mark.parametrize("case", ["integrator", "pendulum"])
def test_parity_fixed_lambda(case):
    _run_parity(case, lambda_=1.0)


@pytest.mark.parametrize("case", ["integrator", "pendulum"])
def test_parity_low_lambda(case):
    # low temperature exponentiates float32 cost differences into the weights
    _run_parity(case, lambda_=0.05, atol=3e-4)


def test_parity_exploration():
    _run_parity("integrator", lambda_=1.0, exploration=0.3)


def test_parity_sg_filter():
    _run_parity("integrator", lambda_=1.0, use_sg_filter=True, atol=5e-5)


def test_parity_essps():
    # float32 bisection against float64 brentq: the root agrees to ~1e-3 relative
    _run_parity("pendulum", lambda_="ESSPS", atol=5e-3)


def test_parity_lbps():
    _run_parity("pendulum", lambda_="LBPS", atol=5e-3)


def test_parity_mpo():
    _run_parity("pendulum", lambda_="MPO", atol=1e-4)
