"""Stateful ``MPPI`` controller: the reference-compatible front door.

Counterpart of ``mppi_playground_tpu/core/controller.py``.  A user of the
upstream library constructs ``MPPI(horizon=..., dynamics=..., cost_func=...,
...)`` and calls ``forward(state)``, ``reset()``, ``get_top_samples(n)`` and
``get_samples_from_posterior(...)``; this class has the same names and
defaults, plus ``device`` (``None`` means ``cuda``), over the solvers of
``core/solver.py`` and ``core/fused_solver.py``, and holds the
:class:`MPPIState` across ticks.

Routes, chosen once at construction from the config:

* ``"xla"`` (the JAX package's name for it): the unfused solver, with the
  dynamics and cost given.  ``store_rollouts=True`` (the default) keeps the
  rollouts for ``get_top_samples``; its softmin tail is the weighted-update
  kernel on the card.
* ``"fused"``: with ``fused_task`` (a model's :class:`FusedTask`, e.g.
  ``models.pendulum.fused_task()`` or ``Navigation2DEnv.fused_task()``, or
  a user's own model as ``FusedTask(model=ModelPlug(...), ...)``) and
  ``store_rollouts=False``, when the config fits the fused kernels'
  envelope: the model's fused kernels run each solve (under LBPS/ESSPS the
  solver picks the lambda route by K, as ``make_fused_solver`` does by
  default).  ``get_top_samples`` regenerates the winning perturbations with
  the regeneration kernel.  A config outside the envelope takes the unfused
  route, as in the JAX package.

The route taken is :attr:`MPPI.solver_backend`.

On the card a seeded ``forward`` without ``info`` replays a CUDA graph of the
tick (``core/closed_loop.ReplayedTick``, which holds the state across
ticks): the first such call runs eagerly and captures, every later one
replays; :attr:`solver_state` reads a copy of the state.  ``forward`` with
``info`` or ``noise``, and every tick on the CPU, runs eagerly.
``run_episode`` runs N ticks through ``core/closed_loop.make_closed_loop``:
one replayed graph of the tick body on the card.  Each ``forward`` is the
span ``facade.forward`` of ``utils/timing`` at the tick it starts.

So ``dynamics`` and ``cost_func`` must be capturable on the card: torch
operations on the tensors they are given, no reads of device values on the
host (``float(x)``, ``x.item()``, ``if x > 0``), no tensors made from host
data, and no Python values that change between calls (a replay repeats what
the capture saw).  A capture that fails raises and names this requirement;
nothing falls back to the eager tick.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from mppi_playground_tpu_torch.core import diagnostics
from mppi_playground_tpu_torch.core.closed_loop import (
    ReplayedTick,
    RunnerCache,
    make_closed_loop,
)
from mppi_playground_tpu_torch.core.config import MPPIConfig, MPPIState
from mppi_playground_tpu_torch.core.fused_solver import fused_envelope, make_fused_solver
from mppi_playground_tpu_torch.core.solver import CostFn, Dynamics, SolveAux, make_solver, warm_reset
from mppi_playground_tpu_torch.ops.fused_solve import FusedTask
from mppi_playground_tpu_torch.utils import timing
from mppi_playground_tpu_torch.utils.device import resolve_device

_FORWARD = timing.Span("facade.forward")


def _floats(values) -> Tuple[float, ...]:
    return tuple(float(v) for v in torch.as_tensor(values).reshape(-1).tolist())


class MPPI:
    """MPPI controller with the reference's constructor and methods.

    On the card ``dynamics`` and ``cost_func`` must be capturable in a CUDA
    graph, since a seeded ``forward`` replays one (see the module docstring).
    """

    def __init__(
        self,
        horizon: int,
        num_samples: int,
        dim_state: int,
        dim_control: int,
        dynamics: Dynamics,
        cost_func: CostFn,
        u_min,
        u_max,
        sigmas,
        lambda_: Union[float, str],
        lbps_delta: float = 0.01,
        essps_target_ess: Optional[float] = None,
        lambda_min: float = 0.01,
        lambda_max: float = 10.0,
        exploration: float = 0.0,
        use_sg_filter: bool = False,
        sg_window_size: int = 5,
        sg_poly_order: int = 3,
        dtype: torch.dtype = torch.float32,
        seed: int = 42,
        store_rollouts: bool = True,
        kernel_backend: str = "auto",
        fused_task: Optional[FusedTask] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        """
        Args:
            fused_task: optional :class:`FusedTask` of the model (a bundled
                model's, or a user's ``ModelPlug``); with
                ``store_rollouts=False`` and a config inside the fused
                envelope, each solve runs the model's fused kernels.
            device: where the solver runs; ``None`` means ``cuda``, and
                ``"cpu"`` runs the kernels' plain twins.
        """
        self.config = MPPIConfig(
            horizon=horizon,
            num_samples=num_samples,
            dim_state=dim_state,
            dim_control=dim_control,
            u_min=_floats(u_min),
            u_max=_floats(u_max),
            sigmas=_floats(sigmas),
            lambda_=lambda_,
            lbps_delta=lbps_delta,
            essps_target_ess=essps_target_ess,
            lambda_min=lambda_min,
            lambda_max=lambda_max,
            exploration=exploration,
            use_sg_filter=use_sg_filter,
            sg_window_size=sg_window_size,
            sg_poly_order=sg_poly_order,
            dtype=dtype,
            seed=seed,
            store_rollouts=store_rollouts,
            kernel_backend=kernel_backend,
        )
        self.device = resolve_device(device)
        fused = False
        if fused_task is not None:
            if store_rollouts:
                raise ValueError(
                    "fused_task requires store_rollouts=False (the fused kernel keeps "
                    "rollouts implicit; get_top_samples regenerates them from the seeds)"
                )
            if not isinstance(fused_task, FusedTask):
                raise TypeError(
                    "fused_task must be a FusedTask (a model's fused_task(), "
                    "RacingFusedTask(...) for racing, or FusedTask(model=ModelPlug(...), ...) "
                    f"for your own model), got {type(fused_task).__name__}"
                )
            fused = fused_envelope(self.config)
        self.solver_backend = "fused" if fused else "xla"
        if fused:
            self._solver = make_fused_solver(self.config, fused_task, dynamics, device=self.device)
        else:
            self._solver = make_solver(self.config, dynamics, cost_func, device=self.device)
        self._ticks = ReplayedTick(self._tick, self._solver.init())
        self._episode_runners = RunnerCache()
        self._last_aux: Optional[SolveAux] = None
        self._last_noise: Optional[torch.Tensor] = None
        self._sigmas = torch.tensor(self.config.sigmas, dtype=dtype, device=self.device)
        self._diag_generator = torch.Generator(device=self.device)
        self._diag_generator.manual_seed(seed + 1)

    @property
    def solver_state(self) -> MPPIState:
        """The warm-start state carried across ticks (a copy while the graph holds it)."""
        return self._ticks.state

    @solver_state.setter
    def solver_state(self, value: MPPIState) -> None:
        self._ticks.state = value

    def _tick(self, state: MPPIState, x: torch.Tensor, carry, **kw):
        return self._solver.solve(state, x, **kw), carry, None

    def reset(self) -> None:
        """Zero the warm start; the adapted lambda and MPO state persist.

        The last solve's diagnostics go with it: ``get_top_samples`` then
        raises instead of replaying the previous episode.
        """
        self.solver_state = warm_reset(self._solver, self.solver_state)
        self._last_aux = None
        self._last_noise = None

    def forward(
        self,
        state,
        info: Optional[Dict[str, Any]] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One solve -> ``(action_seq [T, m], state_seq [T+1, n])``."""
        timing.open_span(_FORWARD.code, self._ticks.ticks_run)
        try:
            state = torch.as_tensor(state, dtype=self.config.dtype, device=self.device)
            if tuple(state.shape) != (self.config.dim_state,):
                raise ValueError(
                    f"state must have shape ({self.config.dim_state},) (= dim_state), "
                    f"got {tuple(state.shape)}"
                )
            if info is None and noise is None:
                action_seq, state_seq, aux, _ = self._ticks.step(state)
            else:
                action_seq, state_seq, aux, _ = self._ticks.step(state, graph=False, info=info,
                                                                 noise=noise)
            self._last_aux = aux
            self._last_noise = noise  # the fused top-k replay must reuse it
            return action_seq, state_seq
        finally:
            timing.close_span()

    __call__ = forward

    def get_top_samples(self, num_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-weighted rollouts of the last solve and their weights, descending.

        Read from the stored rollouts on the unfused route; regenerated from
        the solve's seed (or its noise) and re-rolled on the fused route.
        """
        return diagnostics.top_samples_from_last(
            self._solver, self._last_aux, num_samples, noise=self._last_noise
        )

    def run_episode(
        self,
        plant_fn,
        state,
        num_ticks: int,
        info_fn=None,
        carry=None,
        done_fn=None,
    ):
        """``num_ticks`` [solve -> apply the first action -> plant step] ticks as one closed loop.

        ``core/closed_loop.make_closed_loop``: on the card one CUDA graph of
        the tick, replayed ``num_ticks`` times.  ``plant_fn (x [n], u [m]) ->
        x_next [n]`` may differ from the solver's internal model; ``info_fn
        (carry, x) -> (info, carry)`` builds each tick's cost context, seeded
        with ``carry``.  Pass stable callables: runners are cached per
        ``(plant_fn, num_ticks, info_fn, done_fn)`` identity, so a fresh
        lambda per call captures the tick anew every time.  Moves the warm
        start on like ``num_ticks`` calls to :meth:`forward`; per-solve
        diagnostics are gone afterwards (``get_top_samples`` raises).
        Returns ``(xs [num_ticks+1, n], us [num_ticks, m])``, ``xs[t]`` the
        state ``us[t]`` was solved at and ``xs[-1]`` the final post-step
        state, then the final carry when ``info_fn`` is given, then an
        ``episode`` dict (``done``, ``ticks``) when ``done_fn (x) -> bool`` is
        given: the episode freezes once it fires.
        """
        def build():
            return make_closed_loop(self._solver, plant_fn, num_ticks, info_fn=info_fn,
                                    done_fn=done_fn)

        key = (id(plant_fn), num_ticks, id(info_fn), id(done_fn))
        run = self._episode_runners.get_or_build(key, build)
        out = run(self._ticks.state, torch.as_tensor(state, dtype=self.config.dtype,
                                               device=self.device), carry)
        st, xf, xs, us, final_carry = out[:5]
        self.solver_state = st
        self._last_aux = None
        self._last_noise = None
        ret = (torch.cat([xs, xf[None]]), us)
        if info_fn is not None:
            ret = ret + (final_carry,)
        if done_fn is not None:
            ret = ret + (out[5],)
        return ret

    def get_samples_from_posterior(
        self, optimal_solution, state, num_samples: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior action samples ``[N, T, m]`` and their predicted states ``[N, T+1, n]``.

        Drawn from the controller's own generator (seeded ``seed + 1``),
        which advances with every call.
        """
        if num_samples > self.config.num_samples:
            raise ValueError(
                f"requested {num_samples} posterior samples, but the solver was built "
                f"with num_samples={self.config.num_samples}"
            )
        dtype = self.config.dtype
        samples = diagnostics.posterior_samples(
            self._diag_generator,
            torch.as_tensor(optimal_solution, dtype=dtype, device=self.device),
            self._sigmas,
            num_samples,
        )
        states = self._solver.states_prediction(
            torch.as_tensor(state, dtype=dtype, device=self.device), samples
        )
        return samples, states

    @property
    def lambda_(self) -> float:
        """The current temperature (reads it back to the host)."""
        return float(self._ticks.state.lam)
