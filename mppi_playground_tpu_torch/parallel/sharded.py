"""Scenario-batched MPPI solvers: a fleet of independent control problems a tick.

Counterpart of the scenario axis of ``mppi_playground_tpu/parallel/sharded.py``
(``make_batched_solver``, ``make_batched_fused_solver``).  One card holds one
scenario shard, so where the JAX solvers take a ``mesh`` these take a
``device``; sample sharding over ``torch.distributed`` and the mesh are not
ported yet.

**The batched state** is an :class:`MPPIState` whose tensor leaves have a
leading ``[B]`` axis (the device key ``[B, 3]``); its host ``seed`` is the
fleet's seed and its host ``tick`` is shared.  Scenario b's state is
``solver.init(scenario_seed(seed, b))`` leaf for leaf
(``core/config.scenario_seed``; :func:`scenario` takes one out).

**The fused fleet** (:func:`make_batched_fused_solver`) launches each kernel
of its tick once for all B scenarios, the scenarios on the grid's second
axis (``core/fused_solver.make_solve_batch``, whose batch of one is the
single fused solver; ``ops/fused_solve.*_batch``): fixed λ and MPO run the fused solve, then
the tick's tail; ESSPS and LBPS phase 1, one search cluster a scenario and
phase 2, then the tail.  The state advance, MPO's Adam step included, runs as
torch operations over the ``[B]`` axis.  Scenario b's outputs are bit for bit
the single fused solver's on scenario b's state and inputs, in both noise
modes.  The JAX package runs the scenarios of a shard one after another
under ``lax.map``, one kernel launch each.

**The unfused fleet** (:func:`make_batched_solver`) runs the unfused solve of
``core/solver.py`` scenario by scenario, each with its own ``info``: the
counterpart of the JAX ``vmap``, since the user's dynamics and cost are not
kernels.  Its kernels (the draw, the weighted update) launch B times a tick.
The route is fixed when the solver is built.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from mppi_playground_tpu_torch.core.closed_loop import _map
from mppi_playground_tpu_torch.core.config import MPPIConfig, MPPIState, batch_key, scenario_seed
from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver, make_solve_batch
from mppi_playground_tpu_torch.core.solver import (
    CostFn,
    Dynamics,
    MPPISolver,
    SolveResult,
    make_solver,
)
from mppi_playground_tpu_torch.ops.fused_solve import FusedTask


def scenario(states: MPPIState, b: int) -> MPPIState:
    """Scenario ``b``'s single state out of a batched one (its tensors are views)."""
    return dataclasses.replace(_map(lambda t: t[b], states),
                               seed=scenario_seed(states.seed, b), tick=states.tick)


def stack_states(trees):
    """B single states (or solve results) -> the batched one, leaf by leaf; host numbers are the
    first's."""
    return _map(lambda *leaves: torch.stack(leaves), *trees)


def _make_init_batch(config: MPPIConfig, base_init, batch_size: int):
    """``init_batch(seed=None)``: scenario b is ``base_init(scenario_seed(seed, b))``."""

    def init_batch(seed: Optional[int] = None) -> MPPIState:
        seed = config.seed if seed is None else int(seed)
        states = stack_states([base_init(scenario_seed(seed, b)) for b in range(batch_size)])
        return dataclasses.replace(states, seed=seed, tick=0)

    return init_batch


def _merged_info(info, batched_info, b: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """``info`` (shared) updated by ``batched_info`` (``[B, ...]``; row ``b`` where given)."""
    merged = dict(info or {})
    if batched_info is not None:
        merged.update(batched_info if b is None else {k: v[b] for k, v in batched_info.items()})
    return merged or None


@dataclasses.dataclass(frozen=True)
class BatchedMPPISolver:
    """Scenario-batched solver whose ``solve_batch`` runs one solve a scenario."""

    config: MPPIConfig
    device: torch.device
    batch_size: int
    init_batch: Callable[..., MPPIState]
    solve_batch: Callable[..., SolveResult]
    solver: MPPISolver  # the single solver each scenario runs


def scenario_by_scenario(base: MPPISolver, batch_size: int) -> BatchedMPPISolver:
    """``base.solve`` once a scenario, each with its own state, start, ``info`` and noise.

    The batched surface over any single solver: :func:`make_batched_solver`'s
    route, and the JAX package's ``lax.map`` form of a fused fleet.
    """
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    config = base.config

    def solve_batch(
        states: MPPIState,
        x0s: torch.Tensor,
        *,
        info: Optional[Dict[str, Any]] = None,
        noise: Optional[torch.Tensor] = None,
        batched_info: Optional[Dict[str, Any]] = None,
    ) -> SolveResult:
        keys = batch_key(states, batch_size, base.device)
        x0s = torch.as_tensor(x0s, dtype=config.dtype, device=base.device)
        results = []
        for b in range(batch_size):
            one = dataclasses.replace(scenario(states, b), key=keys[b])
            results.append(base.solve(one, x0s[b], info=_merged_info(info, batched_info, b),
                                      noise=None if noise is None else noise[b]))
        out = stack_states(results)
        return out._replace(state=dataclasses.replace(out.state, seed=states.seed,
                                                      tick=states.tick + 1))

    return BatchedMPPISolver(
        config=config, device=base.device, batch_size=batch_size,
        init_batch=_make_init_batch(config, base.init, batch_size), solve_batch=solve_batch,
        solver=base,
    )


def make_batched_solver(
    config: MPPIConfig,
    dynamics: Dynamics,
    cost_fn: CostFn,
    device: Optional[Union[str, torch.device]],
    batch_size: int,
) -> BatchedMPPISolver:
    """Solve ``batch_size`` independent control problems a tick, scenario by scenario.

    ``solve_batch(states, x0s, *, info=None, noise=None, batched_info=None)``
    takes a batched state (``init_batch``), ``x0s [B, n]``, optional shared
    ``info``, optional noise ``[B, K, T, m]`` and optional ``batched_info``,
    a dict of ``[B, ...]`` tensors whose row b is merged into scenario b's
    ``info`` (e.g. each scenario's goal).  Every output has a leading
    ``[B]`` axis.  ``device`` stands where the JAX solver takes its mesh:
    ``None`` means ``cuda``.
    """
    return scenario_by_scenario(make_solver(config, dynamics, cost_fn, device=device),
                                batch_size)


@dataclasses.dataclass(frozen=True)
class BatchedFusedSolver:
    """Scenario-batched fused solve: one launch of each kernel of the tick for the whole fleet."""

    config: MPPIConfig
    device: torch.device
    batch_size: int
    init_batch: Callable[..., MPPIState]
    solve_batch: Callable[..., SolveResult]
    solver: MPPISolver  # the single fused solver whose solve each scenario's outputs equal


def make_batched_fused_solver(
    config: MPPIConfig,
    task: FusedTask,
    dynamics: Dynamics,
    device: Optional[Union[str, torch.device]],
    batch_size: int,
) -> BatchedFusedSolver:
    """The fused solve over ``batch_size`` independent control problems, a launch a kernel.

    ``solve_batch(states, x0s, *, info=None, noise=None, batched_info=None)``
    takes a batched state (``init_batch``), ``x0s [B, n]``, optional shared
    ``info``, optional noise ``[B, K, T, m]`` and optional ``batched_info``
    (``[B, ...]`` entries merged over ``info``).  The fused kernels read only
    racing's ``reference_path``: ``[B, T+1, 4]`` in ``batched_info``, or one
    ``[T+1, 4]`` for every scenario in ``info``.  Every output has a leading
    ``[B]`` axis (``aux.lam`` and ``aux.ess`` ``[B]``).

    ESSPS and LBPS take the standalone search (phase 1, one search cluster a
    scenario, phase 2): the λ epilogue's ticket counts the clusters of one
    launch.  ``solver`` is the single fused solver (its default λ route),
    whose solve each scenario's outputs equal bit for bit.  ``device``
    stands where the JAX solver takes its mesh: ``None`` means ``cuda``.
    """
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    base = make_fused_solver(config, task, dynamics, device=device)
    solve = make_solve_batch(config, task, base.device)

    def solve_batch(
        states: MPPIState,
        x0s: torch.Tensor,
        *,
        info: Optional[Dict[str, Any]] = None,
        noise: Optional[torch.Tensor] = None,
        batched_info: Optional[Dict[str, Any]] = None,
    ) -> SolveResult:
        return solve(states, x0s, info=_merged_info(info, batched_info), noise=noise)

    return BatchedFusedSolver(
        config=config, device=base.device, batch_size=batch_size,
        init_batch=_make_init_batch(config, base.init, batch_size), solve_batch=solve_batch,
        solver=base,
    )
