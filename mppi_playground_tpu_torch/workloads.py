"""The flagship workload and each model family's workload as its example runs it.

Counterpart of ``mppi_playground_tpu/workloads.py``.  ``build_flagship``
(racing MPCC at T=50, K=100,000, fixed lambda) returns ``(env, solver,
tick)`` with the JAX package's signature; the solver is the fused one, so on
the card a tick is one launch of the fused solve kernel, the softmin merge
in torch, and one launch of the re-roll kernel.  On the CPU
(``device="cpu"``) the same facade runs the kernels' twins.

``build_model_workload`` gives the other model families at the
configurations their examples use (``examples/navigation2d.py``,
``examples/goal_in_danger_zone.py``, ``examples/make_media.py``): the
``MPPI`` arguments, the model's :class:`FusedTask`, the initial state and
the plant.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Union

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

    ``tick(solver_state, cind, x, noise=None) -> (action_seq, state_seq,
    new_state, new_cind)``; ``cind`` is a 0-dim int64 tensor (or int) and
    stays on the device; ``noise`` ``[K, T, 2]`` is the solver's injected
    noise (its ``noise=`` seam), else the tick draws from the state's key.  Pass ``env`` to reuse a built :class:`RacingEnv` on the same
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

    def tick(solver_state, cind, x, noise=None):
        xref, new_cind = calc_ref_trajectory(x, path, cind, horizon)
        result = solver.solve(solver_state, x, info={"reference_path": xref}, noise=noise)
        return result.action_seq, result.state_seq, result.state, new_cind

    return env, solver, tick


# name -> (horizon, num_samples, lambda_, sigmas): each example's solver
MODEL_CONFIGS = {
    "navigation": (30, 3000, "ESSPS", (0.5, 0.5)),  # examples/navigation2d.py
    "danger_zone": (30, 3000, 1.0, (0.5, 0.5)),  # examples/goal_in_danger_zone.py
    "pendulum": (15, 1000, "ESSPS", (1.0,)),  # examples/make_media.py, the README
    "cartpole": (10, 100, 0.001, (1.0,)),  # examples/make_media.py
    "mountain_car": (100, 1000, 0.1, (1.0,)),  # examples/make_media.py
    # the quick-start model at the README's horizon and samples, the sigmas
    # of the oracle parity tests
    "integrator": (15, 1000, 1.0, (0.5, 0.5)),
}


@dataclasses.dataclass
class ModelWorkload:
    """One model family as its example drives it.

    ``mppi_kwargs`` are ``MPPI``'s arguments (without the route's
    ``store_rollouts``/``fused_task``); ``plant(x, u) -> x`` steps the
    simulated system (the env's ``step`` where the example has an env, else
    the model's own dynamics); ``env`` is the environment, if any.
    """

    name: str
    mppi_kwargs: Dict[str, Any]
    task: Any
    x0: torch.Tensor
    plant: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    env: Any = None


def build_model_workload(
    name: str,
    device: Optional[Union[str, torch.device]] = None,
    num_samples: Optional[int] = None,
    env=None,
) -> ModelWorkload:
    """The workload of model family ``name`` (a key of :data:`MODEL_CONFIGS`).

    ``num_samples`` overrides the example's K; ``env`` reuses a built
    ``Navigation2DEnv`` or ``GoalInDangerZoneEnv`` (reset with seed 42).
    """
    from mppi_playground_tpu_torch.models import (
        cartpole,
        danger_zone,
        integrator,
        mountain_car,
        pendulum,
    )
    from mppi_playground_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    horizon, k, lam, sigmas = MODEL_CONFIGS[name]
    kw = dict(horizon=horizon, num_samples=num_samples or k, lambda_=lam, sigmas=sigmas,
              device=device)

    def tensor(values):
        return torch.tensor(values, dtype=torch.float32, device=device)

    if name == "navigation":
        from mppi_playground_tpu_torch.envs.navigation_2d import Navigation2DEnv

        env = env or Navigation2DEnv(device=device)
        kw.update(dim_state=3, dim_control=2, dynamics=env.dynamics,
                  cost_func=env.cost_function, u_min=env.u_min, u_max=env.u_max)
        return ModelWorkload(name, kw, env.fused_task(), env.reset(),
                             lambda x, u: env.step(u)[0], env)
    if name == "danger_zone":
        from mppi_playground_tpu_torch.envs.goal_in_danger_zone import GoalInDangerZoneEnv

        env = env or GoalInDangerZoneEnv(seed=42)
        obs, _ = env.reset(seed=42)
        kw.update(dim_state=7, dim_control=2, dynamics=env.parallel_step,
                  cost_func=env.parallel_cost, u_min=danger_zone.U_MIN, u_max=danger_zone.U_MAX)
        return ModelWorkload(name, kw, env.fused_task(), tensor(obs),
                             lambda x, u: tensor(env.step(u)[0]), env)
    module, x0 = {
        "pendulum": (pendulum, [math.pi, 0.0]),  # hanging down
        "cartpole": (cartpole, [0.0, 0.0, 0.1, 0.0]),
        "mountain_car": (mountain_car, [-0.5, 0.0]),  # at the valley floor
        "integrator": (integrator, [0.0, 0.0]),
    }[name]
    kw.update(dim_state=module.DIM_STATE, dim_control=module.DIM_CONTROL,
              dynamics=module.dynamics, cost_func=module.cost, u_min=module.U_MIN,
              u_max=module.U_MAX)
    return ModelWorkload(name, kw, module.fused_task(), tensor(x0),
                         lambda x, u: module.dynamics(x[None], u[None])[0])
