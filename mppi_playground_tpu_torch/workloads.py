"""The flagship workload: racing MPCC at T=50, K=100,000, fixed lambda.

Counterpart of ``mppi_playground_tpu/workloads.py``.  ``build_flagship``
returns ``(env, solver, tick)`` with the JAX package's signature; the solver
is the fused one, so on the card a tick is one launch of the fused solve
kernel, the softmin merge in torch, and one launch of the re-roll kernel.
On the CPU (``device="cpu"``) the same facade runs the kernels' twins.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

FLAGSHIP_HORIZON = 50
FLAGSHIP_NUM_SAMPLES = 100_000


def build_flagship(
    horizon: int = FLAGSHIP_HORIZON,
    num_samples: int = FLAGSHIP_NUM_SAMPLES,
    env=None,
    device: Optional[Union[str, torch.device]] = None,
):
    """Build the flagship racing tick -> ``(env, solver, tick)``.

    ``tick(solver_state, cind, x) -> (action_seq, state_seq, new_state,
    new_cind)``; ``cind`` is a 0-dim int64 tensor (or int) and stays on the
    device.  Pass ``env`` to reuse a built :class:`RacingEnv` on the same
    device (map rasterization takes about a second on the host).
    """
    from mppi_playground_tpu_torch.core.config import MPPIConfig
    from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory,
        make_racing_fused_task_from_env,
    )
    from mppi_playground_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if env is None:
        env = RacingEnv(device=device)
    elif env.device != device:
        raise ValueError(f"env is on {env.device}, the flagship on {device}")
    config = MPPIConfig(
        horizon=horizon,
        num_samples=num_samples,
        dim_state=4,
        dim_control=2,
        u_min=tuple(float(v) for v in env.u_min.tolist()),
        u_max=tuple(float(v) for v in env.u_max.tolist()),
        sigmas=(0.5, 0.1),
        lambda_=1.0,
        store_rollouts=False,
    )
    task = make_racing_fused_task_from_env(env)
    solver = make_fused_solver(config, task, env.dynamics, device=device)
    path = env.racing_center_path

    def tick(solver_state, cind, x):
        xref, new_cind = calc_ref_trajectory(x, path, cind, horizon)
        result = solver.solve(solver_state, x, info={"reference_path": xref})
        return result.action_seq, result.state_seq, result.state, new_cind

    return env, solver, tick
