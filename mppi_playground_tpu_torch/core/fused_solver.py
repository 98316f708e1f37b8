"""Solver facade over the fused racing CUDA kernels (``ops/fused_solve.py``).

Counterpart of ``mppi_playground_tpu/core/fused_solver.py``: the same
``MPPISolver`` bundle, state and ``SolveResult`` as
``core/solver.make_solver``, with the sample, rollout, cost and weighting
body run by the kernels, ``combine_partials`` in torch, and the nominal
re-roll by the re-roll kernel.

* Fixed lambda and MPO: one launch of the fused solve at the state's
  lambda; MPO then takes its Adam step on the costs (``core/autolambda``).
* LBPS and ESSPS, the JAX package's standalone two-phase route: phase 1
  (costs and the clamped perturbations dumped), the search kernel of
  ``ops/lambda_search.py`` on the costs, phase 2 (the block partials at
  lambda* from the dump).  lambda* stays on the device: phase 2 reads it
  through a pointer.

A tick draws its kernel seed on the host from the state's ``(seed, tick)``,
so nothing in it waits on the device.  The port's envelope: the racing
model (n=4, m=2), float32, no stored rollouts, ``horizon * dim_control <=
1024``; ``ValueError`` outside it.  The in-kernel lambda epilogue raises
``NotImplementedError``.

Rollouts never reach memory.  ``solver.top_samples(aux, n, noise=None)``
takes the top n samples by weight (as ``jax.lax.top_k`` orders them),
regenerates only their perturbations from the solve's seed and warm start
(or the noise passed back) with the regeneration kernel, and re-rolls them
with ``states_prediction``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from mppi_playground_tpu_torch.core.config import MPPIConfig, MPPIState, tick_seed
from mppi_playground_tpu_torch.core.diagnostics import top_indices
from mppi_playground_tpu_torch.core.sg_filter import config_sg_coeffs
from mppi_playground_tpu_torch.core.solver import (
    Dynamics,
    MPPISolver,
    SolveAux,
    SolveResult,
    advance_state,
    make_init,
    make_states_prediction,
    smooth_predict_advance,
)
from mppi_playground_tpu_torch.models.racing_mpcc import extend_reference_path
from mppi_playground_tpu_torch.ops.fused_solve import (
    MAX_SLOTS,
    RacingFusedTask,
    fused_racing_costs_dump,
    fused_racing_solve,
    racing_regen,
    racing_reroll,
    racing_weighted,
)
from mppi_playground_tpu_torch.ops.lambda_search import essps_lambda_fused, lbps_lambda_fused
from mppi_playground_tpu_torch.ops.weighted_update import combine_partials
from mppi_playground_tpu_torch.utils.device import resolve_device


def check_fused_envelope(config: MPPIConfig) -> None:
    """Raise ``ValueError`` for a config outside the fused kernel's envelope."""
    if config.dim_state != 4 or config.dim_control != 2:
        raise ValueError("the fused kernel runs the racing model only (dim_state=4, dim_control=2)")
    if config.horizon * config.dim_control > MAX_SLOTS:
        raise ValueError(f"the fused kernel needs horizon * dim_control <= {MAX_SLOTS}")
    if config.dtype != torch.float32:
        raise ValueError("the fused kernel is float32")
    if config.store_rollouts:
        raise ValueError("the fused kernel does not store rollouts (store_rollouts=False)")


def fused_envelope(config: MPPIConfig) -> bool:
    """Whether :func:`check_fused_envelope` accepts ``config``: the facades' routing test."""
    try:
        check_fused_envelope(config)
    except ValueError:
        return False
    return True


def make_fused_solver(
    config: MPPIConfig,
    task: RacingFusedTask,
    dynamics: Dynamics,
    device: Optional[Union[str, torch.device]] = None,
    lambda_epilogue: Optional[bool] = None,
) -> MPPISolver:
    """Build the fused-kernel solver for the racing model.

    Args:
        config: solver config, fixed lambda or ``"MPO"``/``"LBPS"``/``"ESSPS"``.
        task: the racing maps and bounds, on ``device``.
        dynamics: array-of-structs dynamics for ``states_prediction``.
        device: ``None`` means ``cuda``; ``"cpu"`` runs the kernels' twins.
        lambda_epilogue: the JAX package's switch for the in-kernel LBPS/ESSPS
            search.  ``None`` and ``False`` take the standalone two-phase
            route; ``True`` raises: that kernel mode is not ported.
    """
    if lambda_epilogue:
        raise NotImplementedError(
            "the in-kernel lambda epilogue (run_kernel with lambda_mode) is not ported "
            "(PERF.md, TPU kernel table, row 4); use lambda_epilogue=None or False"
        )
    check_fused_envelope(config)
    device = resolve_device(device)
    for name in ("obstacle_grid", "lane_grid"):
        grid = getattr(task, name)
        if grid.device.type != device.type:
            raise ValueError(f"task.{name} is on {grid.device}, the solver on {device}")
    dtype = config.dtype
    sigmas = tuple(float(s) for s in config.sigmas)
    u_min = tuple(float(v) for v in config.u_min)
    u_max = tuple(float(v) for v in config.u_max)
    threshold = config.inherited_samples
    num_samples = config.num_samples
    auto = config.auto_lambda
    sg_coeffs = config_sg_coeffs(config, dtype, device)

    def search(costs):
        """lambda* of LBPS or ESSPS from its search kernel."""
        if auto == "LBPS":
            return lbps_lambda_fused(
                costs, config.lbps_delta, config.lambda_min, config.lambda_max,
                iters=config.lbps_iters,
            )
        return essps_lambda_fused(
            costs, config.target_ess, config.lambda_min, config.lambda_max,
            iters=config.essps_iters,
        )

    init = make_init(config, device)
    states_prediction = make_states_prediction(config, dynamics)

    def epilogue_prediction(x0, action_seqs):
        return racing_reroll(x0, action_seqs[0], task.x_lim, task.y_lim)[None]

    def solve(
        state: MPPIState,
        x0: torch.Tensor,
        info: Optional[Dict[str, Any]] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> SolveResult:
        """One fused solve; ``info['reference_path']`` ``[T+1, 4]`` is required."""
        x0 = torch.as_tensor(x0, dtype=dtype, device=device).contiguous()
        seed = tick_seed(state.seed, state.tick)
        xref = extend_reference_path(info["reference_path"]).contiguous()
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=dtype, device=device).contiguous()
        prev = state.previous_action_seq
        if auto in ("LBPS", "ESSPS"):
            costs, dump = fused_racing_costs_dump(
                x0, prev, seed, xref, task, sigmas, u_min, u_max, num_samples, threshold, noise,
            )
            lam = search(costs)
            stats, numer = racing_weighted(costs, dump, lam.reshape(1))
        else:  # fixed and MPO weight at the state's lambda
            lam = state.lam
            costs, stats, numer = fused_racing_solve(
                x0, prev, lam.reshape(1), seed, xref, task, sigmas, u_min, u_max,
                num_samples, threshold, noise,
            )
        update, weights, ess = combine_partials(
            costs, stats, numer, lam, config.horizon, config.dim_control
        )
        action_seq, state_seq, new_sg_history = smooth_predict_advance(
            config, sg_coeffs, epilogue_prediction, state, x0, update
        )
        new_state = advance_state(config, state, costs, lam, action_seq, new_sg_history)
        aux = SolveAux(
            costs=costs, weights=weights, lam=lam, ess=ess, state_seq_batch=None,
            # replay handles for top_samples
            seed=seed, x0=x0, prev_action_seq=prev, noise_injected=noise is not None,
        )
        return SolveResult(action_seq, state_seq, new_state, aux)

    def top_samples(
        aux: SolveAux, n: int, noise: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(state_seqs [n, T+1, 4], weights [n])`` of the top n samples, weight-descending.

        Pass the solve's ``noise`` back when it ran on injected noise.
        """
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
        pert = racing_regen(aux.prev_action_seq, aux.seed, rows, sigmas, u_min, u_max,
                            num_samples, threshold, noise)
        return states_prediction(aux.x0, pert), top_w

    return MPPISolver(
        config=config,
        init=init,
        solve=solve,
        states_prediction=states_prediction,
        device=device,
        top_samples=top_samples,
    )
