"""Racing contouring controller: reference generation and one solve per tick.

Counterpart of ``mppi_playground_tpu/envs/racing_controller.py``: MPPI at
horizon 25 with 4,000 samples, sigma (0.5, 0.1) and lambda 1 over the MPCC
cost, each tick preceded by the reference trajectory (nearest path index
and lookahead rows, on the device).  The constructor takes the JAX class's
arguments and defaults; the controller runs on the env's device.

Routes (``solver_backend``):

* ``"xla"``, the unfused solver with stored rollouts (the default,
  ``store_rollouts=True``): its softmin tail is the weighted-update kernel
  on the card, and ``get_top_samples`` reads the stored rollouts;
* ``"fused"``, the fused racing kernels: ``get_top_samples`` regenerates
  the winning perturbations with the regeneration kernel and re-rolls them;
* ``"auto"`` picks ``"fused"`` exactly when ``check_fused_envelope``
  accepts the config (``store_rollouts=False`` among its conditions), on
  the card and on the CPU alike.

The solver closes over the env's maps, so :meth:`RacingController.update`
rebuilds it when ``env.obstacle_map.version`` has moved.  ``run_episode``
(N ticks in one dispatched program) is not part of this port yet: it comes
with ``core/closed_loop.py`` as a CUDA graph of the ticks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mppi_playground_tpu_torch.core import diagnostics
from mppi_playground_tpu_torch.core.config import MPPIConfig
from mppi_playground_tpu_torch.core.fused_solver import fused_envelope, make_fused_solver
from mppi_playground_tpu_torch.core.solver import make_solver, warm_reset
from mppi_playground_tpu_torch.models.racing_mpcc import (
    calc_ref_trajectory,
    make_mpcc_cost,
    make_racing_fused_task_from_env,
)

SOLVER_BACKENDS = ("auto", "fused", "xla")


class RacingController:
    """MPCC racing controller, one solve per :meth:`update`."""

    def __init__(
        self,
        env,
        horizon: int = 25,
        num_samples: int = 4000,
        sigmas: Tuple[float, float] = (0.5, 0.1),
        lambda_=1.0,
        lookahead_distance: float = 3.0,
        reference_path_interval: float = 0.85,
        dtype: torch.dtype = torch.float32,
        seed: int = 42,
        store_rollouts: bool = True,
        kernel_backend: str = "auto",
        solver_backend: str = "auto",
    ) -> None:
        if solver_backend not in SOLVER_BACKENDS:
            raise ValueError(f"solver_backend must be one of {SOLVER_BACKENDS}")
        self.env = env
        self.device = env.device
        self.config = MPPIConfig(
            horizon=horizon,
            num_samples=num_samples,
            dim_state=4,
            dim_control=2,
            u_min=tuple(float(v) for v in env.u_min.tolist()),
            u_max=tuple(float(v) for v in env.u_max.tolist()),
            sigmas=tuple(float(v) for v in sigmas),
            lambda_=lambda_,
            dtype=dtype,
            seed=seed,
            store_rollouts=store_rollouts,
            kernel_backend=kernel_backend,
        )
        if solver_backend == "auto":
            solver_backend = "fused" if fused_envelope(self.config) else "xla"
        self.solver_backend = solver_backend
        self._ref_args = dict(
            DL=float(env.dl),
            lookahead_distance=lookahead_distance,
            reference_path_interval=reference_path_interval,
            v_max=float(env.V_MAX),
        )
        self._build_solver()
        self.solver_state = self._solver.init()
        self.current_path_index = torch.zeros((), dtype=torch.int64, device=self.device)
        self.reference_path: Optional[torch.Tensor] = None
        self._last_aux = None
        self._last_noise = None

    def _build_solver(self) -> None:
        """(Re)build the solver over the env's maps as they are now."""
        env = self.env
        if self.solver_backend == "fused":
            task = make_racing_fused_task_from_env(env)
            self._solver = make_fused_solver(self.config, task, env.dynamics, device=self.device)
        else:
            cost_fn = make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map)
            self._solver = make_solver(self.config, env.dynamics, cost_fn, device=self.device)
        self._map_version = env.obstacle_map.version

    def reset(self) -> None:
        """Zero the warm start and the path index; the adapted lambda persists."""
        self.solver_state = warm_reset(self._solver, self.solver_state)
        self.current_path_index = torch.zeros((), dtype=torch.int64, device=self.device)
        self.reference_path = None
        self._last_aux = None
        self._last_noise = None

    def update(
        self, state: torch.Tensor, noise: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One control tick -> ``(action_seq [T, 2], state_seq [T+1, 4])``."""
        if self.env.obstacle_map.version != self._map_version:
            self._build_solver()
        x = torch.as_tensor(state, dtype=self.config.dtype, device=self.device)
        xref, self.current_path_index = calc_ref_trajectory(
            x, self.env.racing_center_path, self.current_path_index, self.config.horizon,
            **self._ref_args,
        )
        result = self._solver.solve(
            self.solver_state, x, info={"reference_path": xref}, noise=noise
        )
        self.reference_path = xref
        self.solver_state = result.state
        self._last_aux = result.aux
        self._last_noise = noise
        return result.action_seq, result.state_seq

    def get_top_samples(self, num_samples: int = 300) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-weighted rollouts of the last tick ``[n, T+1, 4]`` and their weights, descending."""
        return diagnostics.top_samples_from_last(
            self._solver, self._last_aux, num_samples, noise=self._last_noise, what="update()"
        )
