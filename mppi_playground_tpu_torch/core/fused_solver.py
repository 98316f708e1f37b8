"""Solver facade over the fused racing CUDA kernel (``ops/fused_solve.py``).

Counterpart of the fixed-lambda branch of
``mppi_playground_tpu/core/fused_solver.py``: the same ``MPPISolver``
bundle, state and ``SolveResult`` as ``core/solver.make_solver``, with the
sample, rollout, cost and weighting body run by one launch of the fused
kernel, ``combine_partials`` in torch, and the nominal re-roll by the
re-roll kernel.  A tick draws its kernel seed on the host from the state's
``(seed, tick)``, so nothing in it waits on the device.

The port's envelope: the racing model (n=4, m=2), float32, no stored
rollouts, ``horizon * dim_control <= 1024``; ``ValueError`` outside it.
Auto-lambda (MPO, LBPS, ESSPS) and the SG filter raise
``NotImplementedError`` until their slices land.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from mppi_playground_tpu_torch.core.config import MPPIConfig, MPPIState, tick_seed
from mppi_playground_tpu_torch.core.solver import (
    Dynamics,
    MPPISolver,
    SolveAux,
    SolveResult,
    check_slice_support,
    make_init,
    make_states_prediction,
    smooth_predict_advance,
)
from mppi_playground_tpu_torch.models.racing_mpcc import extend_reference_path
from mppi_playground_tpu_torch.ops.fused_solve import (
    MAX_SLOTS,
    RacingFusedTask,
    combine_partials,
    fused_racing_solve,
    racing_reroll,
)
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


def make_fused_solver(
    config: MPPIConfig,
    task: RacingFusedTask,
    dynamics: Dynamics,
    device: Optional[Union[str, torch.device]] = None,
) -> MPPISolver:
    """Build the fused-kernel solver for the racing model.

    Args:
        config: solver config at a fixed lambda.
        task: the racing maps and bounds, on ``device``.
        dynamics: array-of-structs dynamics for ``states_prediction``.
        device: ``None`` means ``cuda``; ``"cpu"`` runs the kernels' twins.
    """
    check_slice_support(config)
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
        lam = state.lam
        costs, stats, numer = fused_racing_solve(
            x0, state.previous_action_seq, lam.reshape(1), seed, xref, task,
            sigmas, u_min, u_max, config.num_samples, threshold, noise,
        )
        update, weights, ess = combine_partials(
            costs, stats, numer, lam, config.horizon, config.dim_control
        )
        action_seq, state_seq, new_sg_history = smooth_predict_advance(
            config, epilogue_prediction, state, x0, update
        )
        new_state = MPPIState(
            previous_action_seq=action_seq,
            sg_history=new_sg_history,
            lam=lam,
            seed=state.seed,
            tick=state.tick + 1,
        )
        aux = SolveAux(costs=costs, weights=weights, lam=lam, ess=ess, state_seq_batch=None)
        return SolveResult(action_seq, state_seq, new_state, aux)

    return MPPISolver(
        config=config,
        init=init,
        solve=solve,
        states_prediction=states_prediction,
        device=device,
    )
