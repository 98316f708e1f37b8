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
and :meth:`RacingController.run_episode` rebuild it when
``env.obstacle_map.version`` has moved, where the JAX controller re-jits.

On the card a seeded ``update`` replays a CUDA graph of the tick (the
reference rows and the solve, ``core/closed_loop.ReplayedTick``, which
holds the state and the path index across ticks): the first seeded update,
and the first after a rebuild, runs eagerly and captures; the later ones
replay, and :attr:`solver_state` and :attr:`current_path_index` read
copies.  ``update`` with ``noise``, and every tick on the CPU, runs
eagerly.  ``run_episode`` runs N ticks
through ``core/closed_loop.make_closed_loop``: one replayed graph of the
tick body on the card.

Each ``update`` is the span ``facade.update`` of ``utils/timing`` at the
tick it starts, and a rebuild after a map change the span
``facade.rebuild``; a rebuild counts in ``solver.rebuilds``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mppi_playground_tpu_torch.core import diagnostics
from mppi_playground_tpu_torch.core.closed_loop import (
    ReplayedTick,
    RunnerCache,
    make_closed_loop,
)
from mppi_playground_tpu_torch.core.config import MPPIConfig, MPPIState
from mppi_playground_tpu_torch.core.fused_solver import fused_envelope, make_fused_solver
from mppi_playground_tpu_torch.core.solver import make_solver, warm_reset
from mppi_playground_tpu_torch.models.racing_mpcc import (
    calc_ref_trajectory,
    make_mpcc_cost,
    make_racing_fused_task_from_env,
)
from mppi_playground_tpu_torch.utils import timing

SOLVER_BACKENDS = ("auto", "fused", "xla")
_UPDATE = timing.Span("facade.update")
_REBUILD = timing.Span("facade.rebuild")


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
        self._ticks: Optional[ReplayedTick] = None
        self._build_solver()
        self._xref: Optional[torch.Tensor] = None
        self._last_aux = None
        self._last_noise = None

    def _build_solver(self) -> None:
        """(Re)build the solver over the env's maps as they are now; a new graph follows."""
        env = self.env
        if self.solver_backend == "fused":
            task = make_racing_fused_task_from_env(env)
            self._solver = make_fused_solver(self.config, task, env.dynamics, device=self.device)
        else:
            cost_fn = make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map)
            self._solver = make_solver(self.config, env.dynamics, cost_fn, device=self.device)
        if self._ticks is None:
            state = self._solver.init()
            cind = torch.zeros((), dtype=torch.int64, device=self.device)
        else:  # the state and the path index carry over; the graph goes
            state, cind = self._ticks.state, self._ticks.carry
        self._ticks = ReplayedTick(self._tick, state, cind)
        self._episode_runners = RunnerCache()  # they close over the previous solver
        self._map_version = env.obstacle_map.version

    def _refresh_if_maps_changed(self) -> None:
        if self.env.obstacle_map.version != self._map_version:
            with _REBUILD:
                self._build_solver()
            timing.count("solver.rebuilds")

    @property
    def solver_state(self) -> MPPIState:
        """The warm-start state carried across ticks (a copy while the graph holds it)."""
        return self._ticks.state

    @solver_state.setter
    def solver_state(self, value: MPPIState) -> None:
        self._ticks.state = value

    @property
    def current_path_index(self) -> torch.Tensor:
        """The monotone progress index along the center path, a 0-dim int64 tensor."""
        return self._ticks.carry

    @current_path_index.setter
    def current_path_index(self, value: torch.Tensor) -> None:
        self._ticks.carry = torch.as_tensor(value, dtype=torch.int64, device=self.device)

    @property
    def reference_path(self) -> Optional[torch.Tensor]:
        """The last tick's reference ``[T+1, 4]``, or None."""
        return self._xref

    def reset(self) -> None:
        """Zero the warm start and the path index; the adapted lambda persists."""
        self.solver_state = warm_reset(self._solver, self.solver_state)
        self.current_path_index = 0
        self._xref = None
        self._last_aux = None
        self._last_noise = None

    def _tick(self, state: MPPIState, x: torch.Tensor, cind: torch.Tensor, noise=None):
        """The reference rows and the solve: ``(result, new_cind, xref)``."""
        xref, new_cind = calc_ref_trajectory(
            x, self.env.racing_center_path, cind, self.config.horizon, **self._ref_args
        )
        result = self._solver.solve(state, x, info={"reference_path": xref}, noise=noise)
        return result, new_cind, xref

    def update(
        self, state: torch.Tensor, noise: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One control tick -> ``(action_seq [T, 2], state_seq [T+1, 4])``."""
        timing.open_span(_UPDATE.code, self._ticks.ticks_run)
        try:
            self._refresh_if_maps_changed()
            x = torch.as_tensor(state, dtype=self.config.dtype, device=self.device)
            action_seq, state_seq, self._last_aux, self._xref = self._ticks.step(
                x, graph=noise is None, noise=noise)
            self._last_noise = noise
            return action_seq, state_seq
        finally:
            timing.close_span()

    def run_episode(self, state: torch.Tensor, num_ticks: int, done_fn=None):
        """``num_ticks`` control ticks as one closed loop (``core/closed_loop``).

        The whole [reference rows -> solve -> apply the first action ->
        ``env.dynamics``] loop, on the card one CUDA graph of the tick
        replayed ``num_ticks`` times.  Moves the warm start and the path index
        on like ``num_ticks`` calls to :meth:`update`.  Returns ``(xs
        [num_ticks+1, 4], us [num_ticks, 2])``, ``xs[t]`` the state ``us[t]``
        was solved at and ``xs[-1]`` the final post-step state; with
        ``done_fn (x [4]) -> bool`` the episode freezes once it fires and a
        third element ``episode`` (``done``, ``ticks``) is returned.  Pass a
        stable callable: runners are cached per ``(num_ticks, done_fn)``
        identity.
        """
        self._refresh_if_maps_changed()

        def build():
            env = self.env

            def info_fn(cind, x):
                xref, new_cind = calc_ref_trajectory(
                    x, env.racing_center_path, cind, self.config.horizon, **self._ref_args
                )
                return {"reference_path": xref}, new_cind

            return make_closed_loop(self._solver, lambda x, u: env.dynamics(x[None], u[None])[0],
                                    num_ticks, info_fn=info_fn, done_fn=done_fn)

        run = self._episode_runners.get_or_build((num_ticks, id(done_fn)), build)
        x0 = torch.as_tensor(state, dtype=self.config.dtype, device=self.device)
        out = run(self.solver_state, x0, self.current_path_index)
        st, xf, xs, us, cind = out[:5]
        self.solver_state, self.current_path_index, self._xref = st, cind, None
        # per-solve diagnostics and the reference are stale after an episode
        self._last_aux = None
        self._last_noise = None
        xs = torch.cat([xs, xf[None]])
        if done_fn is not None:
            return xs, us, out[5]
        return xs, us

    def get_top_samples(self, num_samples: int = 300) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-weighted rollouts of the last tick ``[n, T+1, 4]`` and their weights, descending."""
        return diagnostics.top_samples_from_last(
            self._solver, self._last_aux, num_samples, noise=self._last_noise, what="update()"
        )
