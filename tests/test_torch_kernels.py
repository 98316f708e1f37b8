"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These need an NVIDIA GPU with ``nvcc`` (Hopper, ``sm_90a``): they carry the
``cuda`` marker and skip without a card.  ``python3 chip_smoke.py`` runs the
same comparisons at the flagship's full size; on a card, run these with
``python -m pytest tests/test_torch_kernels.py -m cuda``.

The twins run on the card too, on the same tensors.  Costs are compared
with the JAX package's bar (rtol 1e-5) and, in noise mode, must be bitwise
equal: the kernels are built with ``-fmad=false`` and no fast math, so they
round each operation as the twin's separate tensor operations do.  The
partials are sums in another order: weights atol 1e-5, update atol 5e-3,
ESS rtol 1e-3.
"""

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch.core.config import tick_seed
from mppi_playground_tpu_torch.ops import fused_solve

pytestmark = pytest.mark.cuda

SIGMAS = (0.5, 0.1)
U_MIN = (-2.0, -0.25)
U_MAX = (2.0, 0.25)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py runs these checks on the card")
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
    from mppi_playground_tpu_torch.models.racing_mpcc import make_racing_fused_task_from_env

    env = RacingEnv(device="cuda")
    return env, make_racing_fused_task_from_env(env)


def _inputs(env, horizon, num_samples, seed):
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory,
        extend_reference_path,
    )

    rng = np.random.default_rng(seed)
    dev = env.device
    x0 = env.reset() + torch.tensor([0.1, -0.1, 0.0, 5.0], device=dev)
    xref, _ = calc_ref_trajectory(x0, env.racing_center_path, torch.tensor(0, device=dev),
                                  horizon)
    prev = torch.tensor(rng.standard_normal((horizon, 2)) * SIGMAS, dtype=torch.float32,
                        device=dev)
    noise = torch.tensor(rng.standard_normal((num_samples, horizon, 2)) * SIGMAS,
                         dtype=torch.float32, device=dev)
    return x0, prev, extend_reference_path(xref).contiguous(), noise


@pytest.mark.parametrize("mode", ["noise", "seeded"])
@pytest.mark.parametrize("horizon,num_samples,exploration", [(50, 100_000, 0.0),
                                                             (8, 1500, 0.3)])
def test_fused_solve_kernel_matches_twin(card, mode, horizon, num_samples, exploration):
    env, task = card
    x0, prev, xref5, noise = _inputs(env, horizon, num_samples, seed=horizon)
    lam = torch.ones(1, device="cuda")
    threshold = int(num_samples * (1.0 - exploration))
    args = (x0, prev, lam, tick_seed(1, 2), xref5, task, SIGMAS, U_MIN, U_MAX,
            num_samples, threshold, noise if mode == "noise" else None)
    launches = fused_solve.fused_racing_solve.launches
    got = fused_solve.fused_racing_solve(*args)
    assert fused_solve.fused_racing_solve.launches == launches + 1
    want = fused_solve.fused_racing_solve_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    if mode == "noise":
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    g = fused_solve.combine_partials(*got, lam, horizon, 2)
    w = fused_solve.combine_partials(*want, lam, horizon, 2)
    torch.testing.assert_close(g[1], w[1], rtol=0, atol=1e-5)  # weights
    torch.testing.assert_close(g[0], w[0], rtol=0, atol=5e-3)  # update
    torch.testing.assert_close(g[2], w[2], rtol=1e-3, atol=0)  # ESS


def test_reroll_kernel_matches_twin(card):
    env, task = card
    rng = np.random.default_rng(3)
    for horizon in (1, 50, 300):
        x0 = torch.tensor([rng.uniform(-39, 39), rng.uniform(-39, 39), 1.0, 4.0],
                          dtype=torch.float32, device="cuda")
        seq = torch.tensor(np.stack([rng.uniform(-2.5, 2.5, horizon),
                                     rng.uniform(-0.3, 0.3, horizon)], axis=1),
                           dtype=torch.float32, device="cuda")
        got = fused_solve.racing_reroll(x0, seq, task.x_lim, task.y_lim)
        want = fused_solve.racing_reroll_plain(x0, seq, task.x_lim, task.y_lim)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_raises_on_what_the_kernel_does_not_take(card):
    env, task = card
    x0, prev, xref5, _ = _inputs(env, 8, 256, seed=1)
    lam = torch.ones(1, device="cuda")
    base = (x0, prev, lam, 0, xref5, task, SIGMAS, U_MIN, U_MAX, 256, 256)
    with pytest.raises(ValueError, match="dtype"):
        fused_solve.fused_racing_solve(x0.double(), *base[1:])
    with pytest.raises(ValueError, match="contiguous"):
        fused_solve.fused_racing_solve(x0, prev.t().contiguous().t(), *base[2:])
    with pytest.raises(ValueError, match="shape"):
        fused_solve.fused_racing_solve(x0, prev, lam, 0, xref5[:-1].contiguous(), *base[5:])
    with pytest.raises(ValueError, match="horizon"):
        fused_solve.fused_racing_solve(x0, torch.zeros(513, 2, device="cuda"), *base[2:])
