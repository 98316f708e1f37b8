"""Solver facade over the fused CUDA kernels (``ops/fused_solve.py``), for any model's task.

Counterpart of ``mppi_playground_tpu/core/fused_solver.py``: the same
``MPPISolver`` bundle, state and ``SolveResult`` as
``core/solver.make_solver``, with the sample, rollout, cost and weighting
body run by the kernels of the task's model, and the rest of the tick in one
launch of the tail kernel (``ops/fused_solve.fused_tick_tail``): the block
partials merged into the update, the weights and the ESS, the SG filter and
its history, and the nominal re-roll.

* Fixed lambda and MPO: one launch of the fused solve at the state's
  lambda; MPO then takes its Adam step on the costs (``core/autolambda``).
* LBPS and ESSPS, the JAX package's two-phase route, in one of two forms:
  - standalone: phase 1 (costs and the clamped perturbations dumped), the
    search kernel of ``ops/lambda_search.py`` on the costs, phase 2 (the
    block partials at lambda* from the dump);
  - the lambda epilogue (up to K = 524,288 as in the JAX package): phase 1
    and the search in one launch, then phase 2.  lambda* is bit for bit the
    standalone route's.
  ``lambda_epilogue=True`` or ``False`` forces one; the default (None)
  picks by K (:func:`takes_lambda_epilogue`), as measured on the H100.
  lambda* stays on the device: phase 2 and the tail read it through a
  pointer.

A tick reads its kernel seed from the state's device key (``key[2:]``,
``core/config.make_key``) through a pointer, and its tail writes the next
tick's key: nothing in it waits on the device or on the host, so that a
CUDA graph of the tick draws a new stream at every replay (the λ
epilogue's ticket is zero again after every launch, which the kernel
sees to).  The tick's ``info`` reaches the kernels only through the task's
reference builder (``FusedTask.reference``: racing's reads
``info['reference_path']``).  The envelope is the JAX package's, for a
bundled model and a user's ``ModelPlug`` alike: float32, no stored
rollouts, ``horizon * dim_control <= 1024``, ``dim_state <= 128`` and the
config's dimensions those of the task's model; ``ValueError`` outside it.

The solve core (``make_fused_solver(..., solve_core=)``, the JAX package's
``solve_core`` seam) is what runs a tick's samples: the fused solve, phase 1
and phase 2, and the gathers that make their costs and block partials the
whole launch's.  The default, :class:`SolveCore`, launches them over all K
samples on the solver's device; ``parallel/sharded.py``'s shard core runs a
shard of them and gathers the shards over a process group.  Every rank then
runs the same tail on the same inputs.

Rollouts never reach memory.  ``solver.top_samples(aux, n, noise=None)``
takes the top n samples by weight (as ``jax.lax.top_k`` orders them), then
one launch of the top rows' kernel regenerates their perturbations from the
solve's seed and warm start (or the noise passed back) and rolls them out
through the task's model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from mppi_playground_tpu_torch.core.closed_loop import _map
from mppi_playground_tpu_torch.core.config import MPPIConfig, MPPIState, batch_key
from mppi_playground_tpu_torch.core.diagnostics import TOP_SAMPLES, top_indices
from mppi_playground_tpu_torch.core.sg_filter import config_sg_coeffs
from mppi_playground_tpu_torch.core.solver import (
    LAMBDA,
    SOLVE,
    TAIL,
    Dynamics,
    MPPISolver,
    SolveAux,
    SolveResult,
    advance_state,
    make_init,
    make_states_prediction,
    state_key,
)
from mppi_playground_tpu_torch.ops.fused_solve import (
    EPILOGUE_MAX_SAMPLES,
    MAX_SLOTS,
    MAX_STATE,
    FusedTask,
    fused_costs_dump_batch,
    fused_costs_dump_lambda_batch,
    fused_solve_batch,
    fused_tick_tail_batch,
    fused_top_rollouts,
    fused_weighted_batch,
)
from mppi_playground_tpu_torch.ops.lambda_search import LambdaSearch
from mppi_playground_tpu_torch.utils import timing
from mppi_playground_tpu_torch.utils.device import resolve_device

TOP_ROLLOUTS = timing.Span("solver.top_rollouts")

# The default lambda route (lambda_epilogue=None) takes the epilogue up to
# this K, the crossover measured on an NVIDIA H100 80GB HBM3 at 700 W by
# chip_smoke.py's phase 10 (both routes' device times in turns, ESSPS and
# LBPS, racing T=50 and Navigation2D T=30 at K=3,000-100,000, every other
# family at its example's configuration; the times are in PERF.md): the
# epilogue was no slower in every case up to K=10,000, and slower in some
# from K=20,000 on, where the cluster launch slows phase 1's rollouts.
EPILOGUE_DEFAULT_MAX_SAMPLES = 10_000


def check_fused_envelope(config: MPPIConfig) -> None:
    """Raise ``ValueError`` for a config outside the fused kernels' envelope."""
    if config.horizon * config.dim_control > MAX_SLOTS:
        raise ValueError(f"the fused kernels need horizon * dim_control <= {MAX_SLOTS}")
    if config.dim_state > MAX_STATE:
        raise ValueError(f"the fused kernels need dim_state <= {MAX_STATE}")
    if config.dtype != torch.float32:
        raise ValueError("the fused kernels are float32")
    if config.store_rollouts:
        raise ValueError("the fused kernels do not store rollouts (store_rollouts=False)")


def fused_envelope(config: MPPIConfig) -> bool:
    """Whether :func:`check_fused_envelope` accepts ``config``: the facades' routing test."""
    try:
        check_fused_envelope(config)
    except ValueError:
        return False
    return True


def takes_lambda_epilogue(config: MPPIConfig, lambda_epilogue: Optional[bool] = None) -> bool:
    """Whether a fused solver of ``config`` searches LBPS/ESSPS lambda in phase 1's launch.

    ``True`` and ``False`` force the route; ``None`` decides by K alone, on
    the card and on the CPU alike: the epilogue up to
    :data:`EPILOGUE_DEFAULT_MAX_SAMPLES`.  Never above
    ``EPILOGUE_MAX_SAMPLES`` (524,288, the JAX package's gate).
    """
    if config.auto_lambda not in ("LBPS", "ESSPS") or config.num_samples > EPILOGUE_MAX_SAMPLES:
        return False
    if lambda_epilogue is None:
        return config.num_samples <= EPILOGUE_DEFAULT_MAX_SAMPLES
    return bool(lambda_epilogue)


class SolveCore:
    """The kernels of a tick's samples, and the gathers that make them the whole launch's.

    The methods take B scenarios (every array ``[B, ...]``, the seed words
    ``[B]``), as the ``*_batch`` wrappers of ``ops/fused_solve.py`` do, with
    the injected noise ``[B, K, T, m]`` of all K samples.  This core runs the
    whole launch on one device: its ``num_samples`` samples from
    ``sample_offset`` 0 are all ``total_samples``, and its gathers return
    what they are given.  A shard core (``parallel/sharded.ShardedCore``)
    runs ``num_samples`` samples from its ``sample_offset``, takes its rows
    of the noise (:meth:`shard_noise`), and gathers every rank's costs
    ``[B, K]`` and block partials ``[B, ceil(K / 256), ...]`` in the whole
    launch's order.
    """

    def __init__(self, config: MPPIConfig, task: FusedTask, num_samples: Optional[int] = None,
                 sample_offset: int = 0):
        self.task = task
        self.bounds = (tuple(float(s) for s in config.sigmas),
                       tuple(float(v) for v in config.u_min),
                       tuple(float(v) for v in config.u_max))
        self.total_samples = config.num_samples
        self.num_samples = config.num_samples if num_samples is None else num_samples
        self.sample_offset = sample_offset
        self.threshold = config.inherited_samples

    def shard_noise(self, noise: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This core's rows ``[B, num_samples, T, m]`` of the noise of all K samples."""
        return noise

    def fused_solve(self, x0s, prevs, lams, seeds, refs, noise):
        """Row 1: ``(costs, stats, numer)`` of this core's samples."""
        return fused_solve_batch(x0s, prevs, lams, seeds, refs, self.task, *self.bounds,
                                 self.num_samples, self.threshold, self.shard_noise(noise),
                                 self.sample_offset, self.total_samples)

    def costs_dump(self, x0s, prevs, seeds, refs, noise):
        """Row 3: ``(costs, dump)`` of this core's samples."""
        return fused_costs_dump_batch(x0s, prevs, seeds, refs, self.task, *self.bounds,
                                      self.num_samples, self.threshold, self.shard_noise(noise),
                                      self.sample_offset, self.total_samples)

    def weighted(self, costs, dump, lams):
        """Row 5: the block partials of this core's samples from its phase 1's outputs."""
        return fused_weighted_batch(costs, dump, lams, self.sample_offset, self.total_samples)

    def gather_costs(self, costs: torch.Tensor) -> torch.Tensor:
        """Every sample's costs ``[B, K]`` from this core's."""
        return costs

    def gather_partials(self, stats: torch.Tensor, numer: torch.Tensor):
        """Every block's partials ``([B, blocks, 3], [B, blocks, T*m])`` from this core's."""
        return stats, numer


def make_solve_batch(config: MPPIConfig, task: FusedTask, device: torch.device,
                     core: Optional[SolveCore] = None,
                     lambda_epilogue: Optional[bool] = None):
    """``solve_batch(states, x0s, info=None, noise=None)``: B scenarios' fused solves, a launch
    a kernel.

    Every tensor leaf of the batched ``states`` and ``x0s [B, n]`` has a
    leading ``[B]`` axis (the device keys ``[B, 3]``); the task's reference
    builder gives ``[B, T+1, W]`` from ``info``, or one ``[T+1, W]`` for
    every scenario (racing's from ``info['reference_path']``, ``[B, T+1,
    4]`` or ``[T+1, 4]``); ``noise`` is ``[B, K, T, m]``.  Fixed lambda and MPO
    launch the fused solve at each scenario's lambda.  LBPS and ESSPS take
    the route of :func:`takes_lambda_epilogue` (``lambda_epilogue`` forces
    one; None picks by K): the λ epilogue (phase 1 and the search in one
    launch, a ticket a scenario, then phase 2) or the standalone route
    (phase 1, one search cluster a scenario, phase 2).  Then one launch of
    the tail, which writes each scenario's next key.  The state advance,
    MPO's Adam step included, runs as torch operations over ``[B]``.
    Scenario b's outputs are bit for bit its solve alone: the kernels give
    each scenario its own view of the launch.  ``core`` runs the samples
    (:class:`SolveCore`, the default, all of them on ``device``); a supplied
    core takes the standalone search.  ``config`` is checked by the caller
    (:func:`make_fused_solver`).
    """
    dtype = config.dtype
    use_epilogue = core is None and takes_lambda_epilogue(config, lambda_epilogue)
    core = SolveCore(config, task) if core is None else core
    sg_coeffs = config_sg_coeffs(config, dtype, device)
    search = _search(config)
    # the epilogue's counts of finished clusters, one a scenario, zero between launches
    tickets: Dict[int, torch.Tensor] = {}

    def solve_batch(
        states: MPPIState,
        x0s: torch.Tensor,
        info: Optional[Dict[str, Any]] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> SolveResult:
        with SOLVE:
            x0s = torch.as_tensor(x0s, dtype=dtype, device=device).contiguous()
            batch = x0s.shape[0]
            keys = batch_key(states, batch, device)
            if noise is not None:
                noise = torch.as_tensor(noise, dtype=dtype, device=device).contiguous()
            seeds = keys[:, 2]  # each scenario's seed word, read by the drawing kernels
            refs = task.reference_rows(info, batch, device)
            prevs = states.previous_action_seq.contiguous()
            if use_epilogue:
                if batch not in tickets:
                    tickets[batch] = torch.zeros(batch, dtype=torch.int32, device=device)
                with LAMBDA:
                    costs, dump, lam = fused_costs_dump_lambda_batch(
                        x0s, prevs, seeds, refs, task, *core.bounds, core.num_samples,
                        core.threshold, noise, search, tickets[batch])
                    stats, numer = core.weighted(costs, dump, lam)
            elif search is not None:
                with LAMBDA:
                    local_costs, dump = core.costs_dump(x0s, prevs, seeds, refs, noise)
                    costs = core.gather_costs(local_costs)
                    lam = search.run_batch(costs)
                    stats, numer = core.gather_partials(*core.weighted(local_costs, dump, lam))
            else:  # fixed and MPO weight at each scenario's lambda
                lam = states.lam.contiguous()
                local_costs, stats, numer = core.fused_solve(x0s, prevs, lam, seeds, refs,
                                                             noise)
                costs = core.gather_costs(local_costs)
                stats, numer = core.gather_partials(stats, numer)
            with TAIL:
                keys_out = torch.empty_like(keys)
                action_seq, state_seq, weights, ess, new_sg_history = fused_tick_tail_batch(
                    x0s, costs, stats, numer, lam, task, states.sg_history.contiguous(),
                    sg_coeffs, keys=keys, keys_out=keys_out,
                )
                new_states = advance_state(config, states, costs, lam, action_seq,
                                           new_sg_history, keys_out)
            aux = SolveAux(costs=costs, weights=weights, lam=lam, ess=ess, state_seq_batch=None,
                           # replay handles for top_samples: a scenario's seed word [1]
                           seed=keys[:, 2:], x0=x0s, prev_action_seq=prevs,
                           noise_injected=noise is not None)
            return SolveResult(action_seq, state_seq, new_states, aux)

    return solve_batch


def _search(config: MPPIConfig) -> Optional[LambdaSearch]:
    """The LBPS or ESSPS search of ``config``; None for fixed lambda and MPO."""
    if config.auto_lambda == "LBPS":
        return LambdaSearch("LBPS", config.lambda_min, config.lambda_max, config.lbps_delta,
                            config.lbps_iters)
    if config.auto_lambda == "ESSPS":
        return LambdaSearch("ESSPS", config.lambda_min, config.lambda_max, config.target_ess,
                            config.essps_iters)
    return None


def make_fused_solver(
    config: MPPIConfig,
    task: FusedTask,
    dynamics: Dynamics,
    device: Optional[Union[str, torch.device]] = None,
    lambda_epilogue: Optional[bool] = None,
    solve_core: Optional[SolveCore] = None,
) -> MPPISolver:
    """Build the fused-kernel solver for ``task``'s model.

    Args:
        config: solver config, fixed lambda or ``"MPO"``/``"LBPS"``/``"ESSPS"``.
        task: the model's :class:`FusedTask` (its grids on ``device``): a
            bundled model's, or a user's ``ModelPlug`` with its twins.
        dynamics: array-of-structs dynamics for ``states_prediction``.
        device: ``None`` means ``cuda``; ``"cpu"`` runs the kernels' twins.
        lambda_epilogue: ``True`` runs the LBPS/ESSPS search inside the
            phase-1 launch (for ``num_samples <= 524,288``), ``False`` the
            standalone search kernel; ``None`` picks by K
            (:func:`takes_lambda_epilogue`).
        solve_core: what runs the tick's samples (:class:`SolveCore`); None
            is all of them on ``device``.  A supplied core (a shard of a
            sample-sharded solve) takes the standalone search, as the JAX
            package keeps the epilogue off a sharded core.

    Every route is :func:`make_solve_batch`'s on a batch of one scenario.
    """
    check_fused_envelope(config)
    if (config.dim_state, config.dim_control) != (task.dim_state, task.dim_control):
        raise ValueError(
            f"the {task.name} task has dim_state={task.dim_state}, "
            f"dim_control={task.dim_control}; the config {config.dim_state}, "
            f"{config.dim_control}"
        )
    device = resolve_device(device)
    for i, grid in enumerate(task.grids):
        if grid.device.type != device.type:
            raise ValueError(f"task grid {i} is on {grid.device}, the solver on {device}")
    dtype = config.dtype
    sigmas = tuple(float(s) for s in config.sigmas)
    u_min = tuple(float(v) for v in config.u_min)
    u_max = tuple(float(v) for v in config.u_max)
    threshold = config.inherited_samples
    num_samples = config.num_samples
    if solve_core is not None and lambda_epilogue:
        raise ValueError("a supplied solve_core takes the standalone lambda search: the epilogue "
                         "searches one launch's costs")
    solve_batch = make_solve_batch(config, task, device, solve_core, lambda_epilogue)

    init = make_init(config, device)
    states_prediction = make_states_prediction(config, dynamics)

    def solve(
        state: MPPIState,
        x0: torch.Tensor,
        info: Optional[Dict[str, Any]] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> SolveResult:
        """One fused solve; a task with a reference builder reads ``info`` (racing:
        ``info['reference_path']`` ``[T+1, 4]``)."""
        x0 = torch.as_tensor(x0, dtype=dtype, device=device)
        key = state_key(state, device)
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=dtype, device=device)
        one = dataclasses.replace(_map(lambda t: t[None], state), key=key[None])
        return _map(lambda t: t[0], solve_batch(
            one, x0[None], info=info, noise=None if noise is None else noise[None]))

    def top_samples(
        aux: SolveAux, n: int, noise: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(state_seqs [n, T+1, n_x], weights [n])`` of the top n samples, weight-descending.

        Pass the solve's ``noise`` back when it ran on injected noise.  The call is the span
        ``solver.top_samples``, the selection and the roll-out its children.
        """
        with TOP_SAMPLES:
            timing.count("solver.top_samples")
            if aux.seed is None:
                raise ValueError("aux must come from a fused solve (aux.seed is unset)")
            if n > num_samples:
                raise ValueError(
                    f"requested top {n} samples, but the solver was built with "
                    f"num_samples={num_samples}"
                )
            if noise is None and aux.noise_injected:
                # the seeds would regenerate a stream unrelated to the solve's
                raise ValueError(
                    "this solve ran with injected noise; pass the same noise array to "
                    "top_samples (seed regeneration cannot replay it)"
                )
            if noise is not None:
                noise = torch.as_tensor(noise, dtype=dtype, device=device).contiguous()
            top_w, rows = top_indices(aux.weights, n)
            with TOP_ROLLOUTS:
                states = fused_top_rollouts(aux.x0, aux.prev_action_seq, aux.seed, rows, task,
                                            sigmas, u_min, u_max, num_samples, threshold, noise)
            return states, top_w

    return MPPISolver(
        config=config,
        init=init,
        solve=solve,
        states_prediction=states_prediction,
        device=device,
        top_samples=top_samples,
    )
