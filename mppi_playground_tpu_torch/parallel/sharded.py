"""Sample-sharded and scenario-batched MPPI solvers over ``torch.distributed``.

Counterpart of ``mppi_playground_tpu/parallel/sharded.py``.  Two parallel
axes of a :func:`~mppi_playground_tpu_torch.parallel.mesh.make_mesh` mesh,
each rank driving one device:

**Samples** (:func:`make_sharded_fused_solver`, :func:`make_sharded_solver`).
Each rank of the sample axis rolls out ``local_K = ceil(ceil(K / 256) / D) *
256`` of the K samples, from global index ``rank * local_K``; the fused
kernels take that offset and the solve's K (``ops/fused_solve.py``), so a
shard draws, inherits and masks its samples as the whole launch does.  The
collectives are two ``all_gather`` s on the axis's process group: the costs
``[local_K]``, then the block partials ``[local_K / 256, 3 + T*m]``.
Concatenated in rank order and sliced to K costs and ``ceil(K / 256)``
blocks, they are the whole launch's bit for bit, so every rank runs the same
tail (the merge in the whole launch's order, the SG filter, the re-roll), the
same λ search on the same costs, MPO's same step and the same
``top_samples``: every rank's outputs and state are the single solver's.  No
``all_reduce``: a reduction's order would depend on D.  Injected noise ``[K,
T, m]`` is padded with zero rows to ``D * local_K``, and each rank takes its
rows; a shard's samples past K cost 1e30 and weigh 0.  The λ epilogue (row 4)
searches one launch's costs, so a sharded ESSPS or LBPS solve takes the
standalone search, as the JAX package keeps the epilogue off a sharded core.

**Scenarios** (:func:`make_batched_fused_solver`, :func:`make_batched_solver`).
A fleet of B independent control problems a tick.  On a mesh, each rank of
the scenario axis holds and solves its ``B / S`` scenarios, those from
global index ``rank * B / S``, with the seeds of their global indices
(``core/config.scenario_seed``); ``init_batch`` gives the rank's states and
``solve_batch`` takes and returns the rank's scenarios.  ``sample_axis``
shards each scenario's samples besides (the 2-D fleet), the launch's sample
offset shared by its scenarios.  A ``device`` in place of the mesh is one
rank.

**The batched state** is an :class:`MPPIState` whose tensor leaves have a
leading ``[B]`` axis (the device key ``[B, 3]``); its host ``seed`` is the
fleet's seed and its host ``tick`` is shared.  Scenario b's state is
``solver.init(scenario_seed(seed, b))`` leaf for leaf (:func:`scenario`
takes one out).

**The fused fleet** (:func:`make_batched_fused_solver`) launches each kernel
of its tick once for all its scenarios, the scenarios on the grid's second
axis (``core/fused_solver.make_solve_batch``, whose batch of one is the
single fused solver; ``ops/fused_solve.*_batch``): fixed λ and MPO run the
fused solve, then the tick's tail; ESSPS and LBPS phase 1, one search
cluster a scenario and phase 2, then the tail.  The state advance, MPO's
Adam step included, runs as torch operations over the ``[B]`` axis.
Scenario b's outputs are bit for bit the single fused solver's on scenario
b's state and inputs, in both noise modes.  The JAX package runs the
scenarios of a shard one after another under ``lax.map``, one kernel launch
each.

**The unfused fleet** (:func:`make_batched_solver`) runs the unfused solve of
``core/solver.py`` scenario by scenario, each with its own ``info``: the
counterpart of the JAX ``vmap``, since the user's dynamics and cost are not
kernels.  Its kernels (the draw, the weighted update) launch B times a tick.
On a sample axis each scenario runs :func:`make_sharded_solver`'s shard.
The route is fixed when the solver is built.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from mppi_playground_tpu_torch.core.closed_loop import _map
from mppi_playground_tpu_torch.core.config import MPPIConfig, MPPIState, batch_key, scenario_seed
from mppi_playground_tpu_torch.core.fused_solver import (
    SolveCore,
    check_fused_envelope,
    make_fused_solver,
    make_solve_batch,
)
from mppi_playground_tpu_torch.core.sg_filter import config_sg_coeffs
from mppi_playground_tpu_torch.core.solver import (
    CostFn,
    Dynamics,
    MPPISolver,
    SolveAux,
    SolveResult,
    _rollout_and_costs,
    advance_state,
    make_init,
    make_perturbations,
    make_solver,
    make_states_prediction,
    search_lambda,
    smooth_predict_advance,
    state_key,
)
from mppi_playground_tpu_torch.ops.fused_solve import FusedTask
from mppi_playground_tpu_torch.ops.weighted_update import (
    BLOCK,
    combine_partials,
    weighted_update_partials,
)
from mppi_playground_tpu_torch.parallel.mesh import (
    SAMPLE_AXIS,
    SCENARIO_AXIS,
    axis_of,
    cuda_backend,
    mesh_device,
)


def scenario(states: MPPIState, b: int) -> MPPIState:
    """Scenario ``b``'s single state out of a batched one (its tensors are views)."""
    return dataclasses.replace(_map(lambda t: t[b], states),
                               seed=scenario_seed(states.seed, b), tick=states.tick)


def stack_states(trees):
    """B single states (or solve results) -> the batched one, leaf by leaf; host numbers are the
    first's."""
    return _map(lambda *leaves: torch.stack(leaves), *trees)


def _make_init_batch(config: MPPIConfig, base_init, batch_size: int, first: int = 0):
    """``init_batch(seed=None)``: row b is ``base_init(scenario_seed(seed, first + b))``."""

    def init_batch(seed: Optional[int] = None) -> MPPIState:
        seed = config.seed if seed is None else int(seed)
        states = stack_states([base_init(scenario_seed(seed, first + b))
                               for b in range(batch_size)])
        return dataclasses.replace(states, seed=seed, tick=0)

    return init_batch


def _merged_info(info, batched_info, b: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """``info`` (shared) updated by ``batched_info`` (``[B, ...]``; row ``b`` where given)."""
    merged = dict(info or {})
    if batched_info is not None:
        merged.update(batched_info if b is None else {k: v[b] for k, v in batched_info.items()})
    return merged or None


# ---------------------------------------------------------------------------
# Sample sharding
# ---------------------------------------------------------------------------

def shard_size(num_samples: int, shards: int) -> int:
    """Samples a rank of ``shards`` rolls out: ``ceil(ceil(K / 256) / D)`` whole 256-sample
    blocks."""
    blocks = -(-num_samples // BLOCK)
    return -(-blocks // shards) * BLOCK


def all_gather_rows(t: torch.Tensor, group, shards: int) -> torch.Tensor:
    """``[B, n, ...]`` of each rank -> ``[B, shards * n, ...]``, the ranks' rows in rank order.

    One ``all_gather`` on ``group``.  Gloo's collectives on CUDA tensors go
    through host memory and cannot be captured in a CUDA graph: such a
    capture raises here (NCCL's can be captured).
    """
    if (t.is_cuda and torch.cuda.is_current_stream_capturing()
            and cuda_backend(group) != "nccl"):
        raise RuntimeError(f"a {cuda_backend(group)} collective cannot be captured in a "
                           "CUDA graph: capture a sample-sharded solve on an NCCL group")
    t = t.contiguous()
    out = t.new_empty(shards, *t.shape)
    dist.all_gather(list(out.unbind(0)), t, group=group)
    return out.transpose(0, 1).reshape(t.shape[0], shards * t.shape[1], *t.shape[2:])


class ShardedCore(SolveCore):
    """A rank's shard of a sample-sharded fused solve (``core/fused_solver.SolveCore``).

    Its kernels roll out :func:`shard_size` samples from global index
    ``rank * shard_size``; the gathers concatenate every rank's costs and
    block partials in rank order and slice them to the solve's K costs and
    ``ceil(K / 256)`` blocks.
    """

    def __init__(self, config: MPPIConfig, task: FusedTask, group, rank: int, shards: int):
        local = shard_size(config.num_samples, shards)
        super().__init__(config, task, local, rank * local)
        self.group, self.shards = group, shards
        self.blocks = -(-config.num_samples // BLOCK)

    def shard_noise(self, noise: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's rows of the noise ``[B, K, T, m]``, zeros past K: ``[B, local_K, T, m]``."""
        if noise is None:
            return None
        rows = noise[:, self.sample_offset:self.sample_offset + self.num_samples]
        missing = self.num_samples - rows.shape[1]
        if missing:
            rows = torch.cat([rows, rows.new_zeros(rows.shape[0], missing, *rows.shape[2:])], 1)
        return rows.contiguous()

    def gather_costs(self, costs: torch.Tensor) -> torch.Tensor:
        return all_gather_rows(costs, self.group, self.shards)[:, :self.total_samples].contiguous()

    def gather_partials(self, stats: torch.Tensor, numer: torch.Tensor):
        packed = all_gather_rows(torch.cat([stats, numer], dim=2), self.group, self.shards)
        packed = packed[:, :self.blocks]
        return packed[..., :3].contiguous(), packed[..., 3:].contiguous()


@dataclasses.dataclass(frozen=True)
class ShardedFusedSolver:
    """The fused solve with its samples sharded over a mesh's sample axis.

    ``solve`` and ``top_samples`` are the single fused solver's
    (``core/fused_solver.make_fused_solver``) on the rank's
    :class:`ShardedCore`; every output is whole on every rank, sliced to K.
    """

    config: MPPIConfig
    mesh: Any
    init: Callable[..., MPPIState]
    solve: Callable[..., SolveResult]
    top_samples: Optional[Callable] = None
    device: torch.device = torch.device("cpu")


def make_sharded_fused_solver(
    config: MPPIConfig,
    task: FusedTask,
    dynamics: Dynamics,
    mesh,
    sample_axis: str = SAMPLE_AXIS,
) -> ShardedFusedSolver:
    """Shard the fused solve's K samples over ``mesh``'s ``sample_axis``.

    Any ``num_samples``: each rank rolls out :func:`shard_size` samples, the
    last ones past K padded (cost 1e30, weight 0).  ``solve(state, x0,
    info=None, noise=None)`` takes the single solver's arguments on every
    rank (``noise`` the ``[K, T, m]`` of all samples) and returns its results
    bit for bit: costs and weights ``[K]``, the update, λ, the ESS and the
    next state.  ``top_samples(aux, n, noise=None)`` regenerates the top
    rows by their global index.  The rank's device is the mesh's
    (``parallel/mesh.mesh_device``).
    """
    check_fused_envelope(config)
    core = ShardedCore(config, task, *axis_of(mesh, sample_axis))
    facade = make_fused_solver(config, task, dynamics, device=mesh_device(mesh),
                               solve_core=core)
    return ShardedFusedSolver(config=config, mesh=mesh, init=facade.init, solve=facade.solve,
                              top_samples=facade.top_samples, device=facade.device)


@dataclasses.dataclass(frozen=True)
class ShardedMPPISolver:
    """The unfused solve with its samples sharded over a mesh's sample axis."""

    config: MPPIConfig
    mesh: Any
    init: Callable[..., MPPIState]
    solve: Callable[..., SolveResult]
    device: torch.device = torch.device("cpu")


def make_sharded_solver(
    config: MPPIConfig,
    dynamics: Dynamics,
    cost_fn: CostFn,
    mesh,
    sample_axis: str = SAMPLE_AXIS,
) -> ShardedMPPISolver:
    """Shard the unfused solve's K samples over ``mesh``'s ``sample_axis``.

    Each rank draws its rows ``[offset, offset + local_K)`` of the single
    solver's draw (``core/solver.make_perturbations``: row 6's kernel over
    those rows, or the noise's), rolls them out with the user's dynamics and
    cost, and takes the weighted update's block partials (row 9) of its
    rows, the rows past K at cost 1e30.  The costs and the partials are
    gathered as :func:`make_sharded_fused_solver` gathers them; λ is searched
    on the gathered costs and the partials merged by ``combine_partials``.
    Every rank's results are the single unfused solver's with the
    weighted-update kernel (``kernel_backend`` ``"auto"``), bit for bit where
    the user's torch operations round a shard's rows as they round the whole
    batch's (on the card).  With ``store_rollouts`` the rollouts ``[K, T+1,
    n]`` are gathered too, a third collective.
    """
    group, rank, shards = axis_of(mesh, sample_axis)
    device = mesh_device(mesh)
    num_samples, horizon, m = config.num_samples, config.horizon, config.dim_control
    local = shard_size(num_samples, shards)
    first = min(rank * local, num_samples)
    count = min(local, num_samples - first)
    blocks = -(-num_samples // BLOCK)
    sg_coeffs = config_sg_coeffs(config, config.dtype, device)
    perturbations = make_perturbations(config, device)
    states_prediction = make_states_prediction(config, dynamics)

    def solve(
        state: MPPIState,
        x0: torch.Tensor,
        info: Optional[Dict[str, Any]] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> SolveResult:
        x0 = torch.as_tensor(x0, dtype=config.dtype, device=device)
        perturbed, key = perturbations(state_key(state, device), state.previous_action_seq,
                                       noise, first, count)
        costs, rollouts = _rollout_and_costs(dynamics, cost_fn,
                                             x0.expand(count, config.dim_state), perturbed,
                                             {} if info is None else dict(info),
                                             config.store_rollouts)
        # the rows past K: cost 1e30 and zero actions, absent from the partials
        costs = torch.cat([costs, costs.new_full((local - count,), 1e30)])
        flat = torch.cat([perturbed.reshape(count, horizon * m),
                          perturbed.new_zeros(local - count, horizon * m)])
        all_costs = all_gather_rows(costs[None], group, shards)[0, :num_samples].contiguous()
        if config.auto_lambda in ("LBPS", "ESSPS"):
            lam = search_lambda(config, all_costs)
        else:
            lam = state.lam
        stats, numer = weighted_update_partials(costs, flat, lam.reshape(1))
        packed = all_gather_rows(torch.cat([stats, numer], dim=1)[None], group, shards)[0]
        update, weights, ess = combine_partials(all_costs, packed[:blocks, :3].contiguous(),
                                                packed[:blocks, 3:].contiguous(), lam,
                                                horizon, m)
        action_seq, state_seq, history = smooth_predict_advance(
            config, sg_coeffs, states_prediction, state, x0, update)
        new_state = advance_state(config, state, all_costs, lam, action_seq, history, key)
        if rollouts is not None:  # a third gather, of the stored rollouts
            rollouts = torch.cat([rollouts, rollouts.new_zeros(local - count,
                                                               *rollouts.shape[1:])])
            rollouts = all_gather_rows(rollouts[None], group, shards)[0, :num_samples]
        aux = SolveAux(costs=all_costs, weights=weights, lam=lam, ess=ess,
                       state_seq_batch=rollouts)
        return SolveResult(action_seq, state_seq, new_state, aux)

    return ShardedMPPISolver(config=config, mesh=mesh, init=make_init(config, device),
                             solve=solve, device=device)


# ---------------------------------------------------------------------------
# Scenario batching
# ---------------------------------------------------------------------------

def _scenario_shard(mesh_or_device, batch_size: int, scenario_axis: str):
    """``(mesh or None, device, first scenario, scenarios of this rank)``."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if mesh_or_device is None or isinstance(mesh_or_device, (str, torch.device)):
        return None, mesh_or_device, 0, batch_size
    mesh = mesh_or_device
    _, rank, shards = axis_of(mesh, scenario_axis)
    if batch_size % shards != 0:
        raise ValueError(f"batch_size ({batch_size}) must divide over {shards} scenario shards")
    local = batch_size // shards
    return mesh, mesh_device(mesh), rank * local, local


@dataclasses.dataclass(frozen=True)
class BatchedMPPISolver:
    """Scenario-batched solver whose ``solve_batch`` runs one solve a scenario.

    ``batch_size`` is the scenarios this rank holds: on a mesh, the fleet's
    scenarios ``first, first + 1, ...``.
    """

    config: MPPIConfig
    device: torch.device
    batch_size: int
    init_batch: Callable[..., MPPIState]
    solve_batch: Callable[..., SolveResult]
    solver: MPPISolver  # the single solver each scenario runs
    mesh: Any = None
    first: int = 0


def scenario_by_scenario(base: MPPISolver, batch_size: int, mesh=None,
                         first: int = 0) -> BatchedMPPISolver:
    """``base.solve`` once a scenario, each with its own state, start, ``info`` and noise.

    The batched surface over any single solver: :func:`make_batched_solver`'s
    route, and the JAX package's ``lax.map`` form of a fused fleet.  Its
    scenarios are the fleet's ``first, ..., first + batch_size - 1``.
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
        init_batch=_make_init_batch(config, base.init, batch_size, first),
        solve_batch=solve_batch, solver=base, mesh=mesh, first=first,
    )


def make_batched_solver(
    config: MPPIConfig,
    dynamics: Dynamics,
    cost_fn: CostFn,
    mesh,
    batch_size: int,
    scenario_axis: str = SCENARIO_AXIS,
    sample_axis: Optional[str] = SAMPLE_AXIS,
) -> BatchedMPPISolver:
    """Solve ``batch_size`` independent control problems a tick, scenario by scenario.

    ``solve_batch(states, x0s, *, info=None, noise=None, batched_info=None)``
    takes a batched state (``init_batch``), ``x0s [B, n]``, optional shared
    ``info``, optional noise ``[B, K, T, m]`` and optional ``batched_info``,
    a dict of ``[B, ...]`` tensors whose row b is merged into scenario b's
    ``info`` (e.g. each scenario's goal).  Every output has a leading
    ``[B]`` axis.  ``mesh`` is a mesh, whose ``scenario_axis`` splits the
    fleet (each rank's B is then its ``batch_size / S`` scenarios), or a
    device, one rank (``None`` means ``cuda``).  On a mesh whose
    ``sample_axis`` has more than one rank, each scenario's K samples are
    sharded over that axis besides (:func:`make_sharded_solver`: row 6's
    draw over the rank's rows, the rollout, row 9's partials, the two
    gathers, ``combine_partials``), and every rank of the sample axis
    returns its scenarios' whole results; a 1-D mesh, a sample axis of one
    rank or ``sample_axis=None`` solves each scenario's K samples on its rank.
    """
    mesh, device, first, local = _scenario_shard(mesh, batch_size, scenario_axis)
    if (mesh is not None and sample_axis in mesh.mesh_dim_names
            and axis_of(mesh, sample_axis)[2] > 1):
        base = make_sharded_solver(config, dynamics, cost_fn, mesh, sample_axis)
    else:
        base = make_solver(config, dynamics, cost_fn, device=device)
    return scenario_by_scenario(base, local, mesh, first)


@dataclasses.dataclass(frozen=True)
class BatchedFusedSolver:
    """Scenario-batched fused solve: one launch of each kernel of the tick for the whole fleet.

    ``batch_size`` is the scenarios this rank holds: on a mesh, the fleet's
    scenarios ``first, first + 1, ...``.
    """

    config: MPPIConfig
    device: torch.device
    batch_size: int
    init_batch: Callable[..., MPPIState]
    solve_batch: Callable[..., SolveResult]
    solver: MPPISolver  # the single fused solver whose solve each scenario's outputs equal
    mesh: Any = None
    first: int = 0


def make_batched_fused_solver(
    config: MPPIConfig,
    task: FusedTask,
    dynamics: Dynamics,
    mesh,
    batch_size: int,
    scenario_axis: str = SCENARIO_AXIS,
    sample_axis: Optional[str] = None,
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
    whose solve each scenario's outputs equal bit for bit.

    ``mesh`` is a mesh or a device (one rank; ``None`` means ``cuda``).  On
    a mesh each rank of ``scenario_axis`` holds its ``batch_size / S``
    scenarios (B above is then theirs); with ``sample_axis`` each scenario's
    samples are sharded over that axis besides (:class:`ShardedCore`, the
    launch's sample offset shared by its scenarios), and every rank of the
    sample axis returns its scenarios' whole results.
    """
    mesh, device, first, local = _scenario_shard(mesh, batch_size, scenario_axis)
    core = None
    if mesh is not None and sample_axis is not None and axis_of(mesh, sample_axis)[2] > 1:
        check_fused_envelope(config)
        core = ShardedCore(config, task, *axis_of(mesh, sample_axis))
    base = make_fused_solver(config, task, dynamics, device=device, solve_core=core)
    solve = make_solve_batch(config, task, base.device, core)

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
        config=config, device=base.device, batch_size=local,
        init_batch=_make_init_batch(config, base.init, local, first), solve_batch=solve_batch,
        solver=base, mesh=mesh, first=first,
    )
