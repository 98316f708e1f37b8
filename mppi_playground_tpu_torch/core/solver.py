"""The unfused MPPI solver on tensors, one control tick per ``solve``.

Counterpart of ``mppi_playground_tpu/core/solver.py``: sample around the
warm start, roll out and cost every sample step by step, pick the
temperature (fixed, or ESSPS/LBPS from the costs before weighting),
softmin-weight, average, take MPO's step after weighting, re-roll the
nominal trajectory and advance the warm start.  It is written in plain
PyTorch and is the second, independent route that the fused CUDA solver
(``core/fused_solver.py``) is held against.  Behaviours kept from the reference:

* ``info['prev_*']`` at t=0 aliases t=0 itself;
* the terminal cost uses a zero action, ``prev_state`` = the second-to-last
  state, and keeps ``t``/``prev_action`` at their last stage-loop values;
* the quadratic action cost is left out of the trajectory totals.

Noise: ``solve(noise=...)`` takes ``[K, T, m]`` perturbations already
scaled by sigma.  Without it, the noise is the fused kernels' seeded stream
at the seed word of the state's device key (``core/config.make_key``), so
that the unfused route samples exactly the fused route's perturbations and
a CUDA graph of the tick draws a new stream at every replay
(:func:`make_perturbations`: one launch of the regeneration kernel over
rows 0..K-1 where the config is in its envelope).

The softmin tail follows ``config.kernel_backend``, decided once when the
solver is built: ``"auto"`` and ``"pallas"`` run the streaming weighted
update kernel (``ops/weighted_update.py``; its twin for CPU tensors),
``"xla"`` the plain softmax and einsum.  The kernel takes float32: on the
card a float64 config must ask for ``"xla"``, and ``make_solver`` raises
otherwise.  ``store_rollouts=True`` keeps the
``[K, T+1, n]`` rollouts for ``core/diagnostics.top_samples``.

:func:`make_solve_batch` solves B scenarios as one program, the counterpart
of the JAX unfused fleet's ``vmap`` of the solve: one launch of the
regeneration kernel draws every scenario's samples, the rollout and costs
run once for the fleet under ``torch.func.vmap``, one launch of the weighted
update kernel weighs every scenario; scenario b's outputs are bit for bit
the single solve's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from mppi_playground_tpu_torch.core import autolambda
from mppi_playground_tpu_torch.core.config import (
    MPPIConfig,
    MPPIState,
    advance_key_plain,
    batch_key,
    make_key,
)
from mppi_playground_tpu_torch.core.sg_filter import apply_sg_filter, config_sg_coeffs
from mppi_playground_tpu_torch.ops.fused_solve import (
    MAX_SLOTS,
    REGEN_WIDTHS,
    fused_regen,
    fused_regen_batch,
    seeded_normals,
)
from mppi_playground_tpu_torch.ops.weighted_update import (
    own_row,
    weighted_update,
    weighted_update_batch,
)
from mppi_playground_tpu_torch.utils import timing
from mppi_playground_tpu_torch.utils.device import resolve_device

SOLVE = timing.Span("solver.solve")
ROLLOUT = timing.Span("solver.rollout")
LAMBDA = timing.Span("solver.lambda")
TAIL = timing.Span("solver.tail")
DYNAMICS = timing.Span("solver.dynamics")
COST = timing.Span("solver.cost")

Dynamics = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
CostFn = Callable[[torch.Tensor, torch.Tensor, Dict[str, Any]], torch.Tensor]


class SolveAux(NamedTuple):
    """Diagnostics from one solve.

    ``seed``, ``x0``, ``prev_action_seq`` and ``noise_injected`` are the
    fused solver's replay handles (``None`` on the unfused route): the
    kernel seed word of the tick (a one-element int32 tensor on the
    solver's device), the initial state and warm start the samples were
    drawn around, and whether the solve ran on injected noise (a host
    bool), so that ``top_samples`` can regenerate the winning perturbations
    without storing rollouts.  Reading them never syncs.
    """

    costs: torch.Tensor
    weights: torch.Tensor
    lam: torch.Tensor
    ess: torch.Tensor
    state_seq_batch: Optional[torch.Tensor]
    seed: Optional[torch.Tensor] = None
    x0: Optional[torch.Tensor] = None
    prev_action_seq: Optional[torch.Tensor] = None
    noise_injected: Optional[bool] = None


class SolveResult(NamedTuple):
    action_seq: torch.Tensor  # [T, m]
    state_seq: torch.Tensor  # [T+1, n]
    state: MPPIState
    aux: SolveAux


@dataclasses.dataclass(frozen=True)
class MPPISolver:
    """Bundle of solver functions specialized to one config and model."""

    config: MPPIConfig
    init: Callable[..., MPPIState]
    solve: Callable[..., SolveResult]
    states_prediction: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    device: torch.device = torch.device("cpu")
    # fused solvers only: ``top_samples(aux, n, noise=None) -> (state_seqs
    # [n, T+1, n_x], weights [n])``, which regenerates the winning
    # perturbations; the unfused route reads ``aux.state_seq_batch`` instead
    top_samples: Optional[Callable] = None


def warm_reset(solver: MPPISolver, state: MPPIState) -> MPPIState:
    """Zero the warm start and the SG history, keeping the adapted temperature.

    Like the reference's ``reset``: lambda and the MPO state persist across
    episodes, and so does the noise stream (``seed``, ``tick`` and the
    device key, as the JAX package keeps its key).  Shared by the ``MPPI``
    and ``RacingController`` facades.
    """
    fresh = solver.init(seed=state.seed)
    return dataclasses.replace(
        fresh,
        lam=state.lam,
        tick=state.tick,
        mpo_log_temperature=state.mpo_log_temperature,
        mpo_opt_state=state.mpo_opt_state,
        key=state.key,
    )


def state_key(state: MPPIState, device: torch.device) -> torch.Tensor:
    """The state's device key; made from its host ``(seed, tick)`` where it has none."""
    if state.key is not None:
        return state.key
    return make_key(state.seed, state.tick, device)


def _ordered_sum(stages: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """``zeros + stages[0] + stages[1] + ...`` added left to right, the zeros one per row of
    ``like`` in its dtype: the serial adds, bit for bit.

    On the card one launch: ``torch.cumsum`` of the stacked stages over their
    first dimension, whose CUDA kernel for a dimension other than the
    innermost keeps one accumulator a column, from 0, left to right, in the
    sum's dtype; a single column is scanned as two, since CUDA scans a vector
    by blocks from its first element.  On the CPU the serial adds (its
    cumsum accumulates float in double).
    """
    if stages[0].is_cuda:
        stacked = torch.stack(stages)
        dtype = torch.promote_types(stacked.dtype, like.dtype)
        if stacked.numel() == stacked.shape[0]:
            return torch.cumsum(stacked.expand(-1, 2), 0, dtype=dtype)[-1, :1]
        return torch.cumsum(stacked, 0, dtype=dtype)[-1]
    total = torch.zeros(like.shape[0], dtype=like.dtype, device=like.device)
    for stage in stages:
        total = total + stage
    return total


def _rollout_and_costs(
    dynamics: Dynamics,
    cost_fn: CostFn,
    x0_batch: torch.Tensor,
    action_seqs: torch.Tensor,
    user_info: Dict[str, Any],
    store_rollouts: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Rollout with stage and terminal cost -> (costs [K], states [K, T+1, n] or None).

    Each call of ``dynamics`` is the span ``solver.dynamics`` and each call of
    ``cost_fn`` the span ``solver.cost``; the sum and the stack are outside them.
    The costs are ``zeros + stage_0 + ... + stage_{T-1} + terminal``, added in
    that order after the loop (:func:`_ordered_sum`: on the card one launch,
    so that no add waits between one step's state and the next).
    """
    horizon = action_seqs.shape[1]
    x = x0_batch
    x_prev = x0_batch
    stages = []
    states = [x0_batch] if store_rollouts else None
    for t in range(horizon):
        info = dict(user_info)
        info.update(
            prev_state=x_prev,
            prev_action=action_seqs[:, max(t - 1, 0)],
            initial_state=x0_batch,
            t=t,
        )
        with COST:
            stages.append(cost_fn(x, action_seqs[:, t], info))
        x_prev = x
        with DYNAMICS:
            x = dynamics(x, action_seqs[:, t])
        if store_rollouts:
            states.append(x)

    terminal_info = dict(user_info)
    terminal_info.update(
        prev_state=x_prev,
        prev_action=action_seqs[:, max(horizon - 2, 0)],
        initial_state=x0_batch,
        t=horizon - 1,
    )
    zero_action = torch.zeros_like(action_seqs[:, 0])
    with COST:
        stages.append(cost_fn(x, zero_action, terminal_info))
    return (_ordered_sum(stages, x0_batch),
            torch.stack(states, dim=1) if store_rollouts else None)


def make_init(config: MPPIConfig, device: torch.device):
    """Fresh-state factory: zero warm start; MPO's ``log(initial_lambda)`` and Adam at 0."""
    dtype = config.dtype

    def init(seed: Optional[int] = None) -> MPPIState:
        lam = torch.full((), config.initial_lambda, dtype=dtype, device=device)
        if config.auto_lambda == "MPO":
            log_t, opt_state = autolambda.mpo_init(config.initial_lambda, lam)
        else:
            log_t, opt_state = torch.zeros_like(lam), None
        seed = config.seed if seed is None else int(seed)
        return MPPIState(
            previous_action_seq=torch.zeros(
                config.horizon, config.dim_control, dtype=dtype, device=device
            ),
            sg_history=torch.zeros(
                max(config.horizon - 1, 0), config.dim_control, dtype=dtype, device=device
            ),
            lam=lam,
            seed=seed,
            tick=0,
            mpo_log_temperature=log_t,
            mpo_opt_state=opt_state,
            key=make_key(seed, 0, device),
        )

    return init


def make_states_prediction(config: MPPIConfig, dynamics: Dynamics):
    """Nominal-trajectory re-roll of ``action_seqs [B, T, m]`` from ``x0 [n]``; each call of
    ``dynamics`` is the span ``solver.dynamics``."""

    def states_prediction(x0: torch.Tensor, action_seqs: torch.Tensor) -> torch.Tensor:
        x = x0.to(config.dtype).expand(action_seqs.shape[0], config.dim_state)
        states = [x]
        for t in range(action_seqs.shape[1]):
            with DYNAMICS:
                x = dynamics(x, action_seqs[:, t])
            states.append(x)
        return torch.stack(states, dim=1)

    return states_prediction


def search_lambda(config: MPPIConfig, costs: torch.Tensor) -> torch.Tensor:
    """LBPS or ESSPS temperature from the costs by the loops of ``core/autolambda.py``."""
    if config.auto_lambda == "LBPS":
        return autolambda.lbps_lambda(
            costs, config.lbps_delta, config.lambda_min, config.lambda_max,
            iters=config.lbps_iters,
        )
    return autolambda.essps_lambda(
        costs, config.target_ess, config.lambda_min, config.lambda_max,
        iters=config.essps_iters,
    )


def advance_state(
    config: MPPIConfig,
    state: MPPIState,
    costs: torch.Tensor,
    lam: torch.Tensor,
    action_seq: torch.Tensor,
    sg_history: torch.Tensor,
    key: torch.Tensor,
) -> MPPIState:
    """The next tick's state, ``key`` its device key; MPO steps its temperature on this tick's costs."""
    log_t, opt_state = state.mpo_log_temperature, state.mpo_opt_state
    if config.auto_lambda == "MPO":
        if opt_state is None:
            raise ValueError("an MPO solve needs the state's mpo_opt_state: start from init()")
        with LAMBDA:
            lam, log_t, opt_state = autolambda.mpo_step(costs, log_t, opt_state)
    return MPPIState(
        previous_action_seq=action_seq,
        sg_history=sg_history,
        lam=lam.to(config.dtype),
        seed=state.seed,
        tick=state.tick + 1,
        mpo_log_temperature=log_t,
        mpo_opt_state=opt_state,
        key=key,
    )


def smooth_predict_advance(
    config: MPPIConfig,
    sg_coeffs: Optional[torch.Tensor],
    states_prediction,
    state: MPPIState,
    x0: torch.Tensor,
    optimal_action_seq: torch.Tensor,
):
    """Shared solve epilogue: SG filter, nominal re-roll and SG-history shift.

    Returns (action_seq, state_seq, new_sg_history).
    """
    if config.use_sg_filter:
        optimal_action_seq = apply_sg_filter(optimal_action_seq, state.sg_history, sg_coeffs)
    optimal_state_seq = states_prediction(x0, optimal_action_seq[None])[0]
    if config.horizon > 1:
        new_sg_history = torch.cat([state.sg_history[1:], optimal_action_seq[:1]], dim=0)
    else:
        new_sg_history = state.sg_history
    return optimal_action_seq, optimal_state_seq, new_sg_history


def _draws_by_kernel(config: MPPIConfig) -> bool:
    """Whether the regeneration kernel draws ``config``'s samples (its envelope)."""
    return (config.dtype == torch.float32 and config.dim_control in REGEN_WIDTHS
            and config.horizon * config.dim_control <= MAX_SLOTS)


def make_perturbations(config: MPPIConfig, device: torch.device):
    """``perturbations(key, mean, noise, first=0, count=K)``: the unfused draw of rows
    ``[first, first + count)``.

    Returns the clamped perturbed sequences ``[count, T, m]`` of those
    samples around the warm start ``mean [T, m]`` and the next tick's key.
    Row r is sample ``first + r`` of the stream at the key's seed word (or
    of ``noise [K, T, m]``): a shard of a sample-sharded solve draws its rows
    of the whole draw.  For float32 with ``dim_control`` in (1, 2) and
    ``horizon * dim_control <= 1024`` (the regeneration kernel's envelope)
    one launch of that kernel over the rows draws, clamps and moves the key
    on (its twin on the CPU); any other config draws
    ``ops/fused_solve.seeded_normals`` in torch ops and moves the key on by
    its twin.
    """
    dtype = config.dtype
    num_samples, horizon = config.num_samples, config.horizon
    dim_control = config.dim_control
    u_min = torch.tensor(config.u_min, dtype=dtype, device=device)
    u_max = torch.tensor(config.u_max, dtype=dtype, device=device)
    sigmas = torch.tensor(config.sigmas, dtype=dtype, device=device)
    threshold = config.inherited_samples
    # the regeneration kernel draws and clamps the rows in one launch
    regen = _draws_by_kernel(config)
    all_rows = torch.arange(num_samples, device=device) if regen else None

    def perturbations(key: torch.Tensor, mean_action_seq: torch.Tensor,
                      noise: Optional[torch.Tensor], first: int = 0,
                      count: Optional[int] = None):
        count = num_samples - first if count is None else count
        if regen and count:  # a shard with no rows moves the key on by the twin below
            key_out = torch.empty_like(key)
            if noise is not None:
                noise = torch.as_tensor(noise, dtype=dtype, device=device).contiguous()
            rows = all_rows[first:first + count]
            perturbed = fused_regen(
                mean_action_seq.contiguous(), key[2:], rows, config.sigmas, config.u_min,
                config.u_max, num_samples, threshold, noise, key=key, key_out=key_out,
            )
            return perturbed, key_out
        if noise is None:
            normals = seeded_normals(key[2:], count, horizon, device, dim_control, first)
            noise = normals.to(dtype) * sigmas
        else:
            noise = torch.as_tensor(noise, dtype=dtype, device=device)[first:first + count]
        inherit = max(0, min(threshold - first, count))
        if inherit >= count:
            perturbed = mean_action_seq[None] + noise
        elif inherit <= 0:
            perturbed = noise
        else:
            perturbed = torch.cat(
                [mean_action_seq[None] + noise[:inherit], noise[inherit:]], dim=0
            )
        return torch.clamp(perturbed, u_min, u_max), advance_key_plain(key)

    return perturbations


def make_perturbations_batch(config: MPPIConfig, device: torch.device):
    """``perturbations_batch(keys [B, 3], means [B, T, m], noise)``: a fleet's draw.

    Returns the clamped perturbed sequences ``[B, K, T, m]`` of every
    scenario (scenario b's at its key's seed word around ``means[b]``, or
    from ``noise [B, K, T, m]``) and the next keys ``[B, 3]``.  In the
    regeneration kernel's envelope one launch draws, clamps and moves the
    keys on for the whole fleet (:func:`ops.fused_solve.fused_regen_batch`:
    row b bit for bit :func:`make_perturbations`' draw of scenario b); any
    other config runs :func:`make_perturbations` scenario by scenario.
    """
    perturbations = make_perturbations(config, device)
    all_rows = torch.arange(config.num_samples, device=device)
    dtype = config.dtype

    def perturbations_batch(keys: torch.Tensor, means: torch.Tensor,
                            noise: Optional[torch.Tensor]):
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=dtype, device=device).contiguous()
        if not _draws_by_kernel(config):
            parts = [perturbations(keys[b], means[b], None if noise is None else noise[b])
                     for b in range(keys.shape[0])]
            return (torch.stack([p for p, _ in parts]), torch.stack([k for _, k in parts]))
        keys_out = torch.empty_like(keys)
        perturbed = fused_regen_batch(
            means.contiguous(), keys[:, 2], all_rows, config.sigmas, config.u_min, config.u_max,
            config.num_samples, config.inherited_samples, noise, keys=keys, keys_out=keys_out)
        return perturbed, keys_out

    return perturbations_batch


def make_solve_batch(config: MPPIConfig, dynamics: Dynamics, cost_fn: CostFn,
                     device: torch.device):
    """``solve_batch(states, x0s, *, info=None, noise=None, batched_info=None)``: B scenarios'
    unfused solves as one program, the JAX fleet's ``vmap`` of the solve.

    Every tensor leaf of the batched ``states`` and ``x0s [B, n]`` has a
    leading ``[B]`` axis (the device keys ``[B, 3]``); ``noise`` is ``[B, K,
    T, m]``; ``info`` is shared and ``batched_info`` a dict of ``[B, ...]``
    tensors whose row b is merged into scenario b's ``info``.  A tick is one
    drawing launch for the fleet (:func:`make_perturbations_batch`); the
    rollout and costs once for the fleet under ``torch.func.vmap``, so that
    the user's dynamics and cost see one scenario at a time, ``[K, ...]``
    tensors and that scenario's ``info``, as under ``jax.vmap`` (a function
    that cannot be vmapped raises); the LBPS or ESSPS search scenario by
    scenario on its own costs ``[K]`` (the single solve's reductions, whose
    order depends on the shape); one launch of the weighted-update kernel for
    the fleet, each scenario's partials merged as the single solve merges
    them (``ops/weighted_update.weighted_update_batch``); then the SG filter
    scenario by scenario, the nominal re-roll under ``vmap`` and the state
    advance over ``[B]`` (MPO's sums by ``core/autolambda.fold_sum``).
    Scenario b's outputs are :func:`make_solver`'s solve on b's state and
    inputs, bit for bit.  ``config`` is checked by the caller.
    """
    dtype = config.dtype
    num_samples, dim_state = config.num_samples, config.dim_state
    sg_coeffs = config_sg_coeffs(config, dtype, device)
    perturbations_batch = make_perturbations_batch(config, device)
    states_prediction = make_states_prediction(config, dynamics)

    def rollout(x0, perturbed, row_info, shared_info):
        user_info = dict(shared_info)
        user_info.update(row_info)
        costs, states = _rollout_and_costs(dynamics, cost_fn, x0.expand(num_samples, dim_state),
                                           perturbed, user_info, config.store_rollouts)
        return (costs,) if states is None else (costs, states)

    def predict(x0, action_seq):
        return states_prediction(x0, action_seq[None])[0]

    def solve_batch(
        states: MPPIState,
        x0s: torch.Tensor,
        *,
        info: Optional[Dict[str, Any]] = None,
        noise: Optional[torch.Tensor] = None,
        batched_info: Optional[Dict[str, Any]] = None,
    ) -> SolveResult:
        with SOLVE:
            x0s = torch.as_tensor(x0s, dtype=dtype, device=device)
            batch = x0s.shape[0]
            perturbed, keys_out = perturbations_batch(batch_key(states, batch, device),
                                                      states.previous_action_seq, noise)
            shared = {} if info is None else dict(info)
            rows = {} if batched_info is None else dict(batched_info)
            with ROLLOUT:
                out = torch.func.vmap(lambda x0, p, row: rollout(x0, p, row, shared))(
                    x0s, perturbed, rows)
            costs, rollouts = out[0], (out[1] if len(out) > 1 else None)
            # LBPS and ESSPS pick each scenario's temperature from its costs alone
            if config.auto_lambda in ("LBPS", "ESSPS"):
                with LAMBDA:
                    lam = torch.stack([search_lambda(config, own_row(costs, b))
                                       for b in range(batch)])
            else:
                lam = states.lam
            update, weights, ess = weighted_update_batch(costs, perturbed, lam,
                                                         backend=config.kernel_backend)
            with TAIL:
                if config.use_sg_filter:
                    update = torch.stack([apply_sg_filter(update[b], states.sg_history[b],
                                                          sg_coeffs) for b in range(batch)])
                state_seq = torch.func.vmap(predict)(x0s, update)
                if config.horizon > 1:
                    sg_history = torch.cat([states.sg_history[:, 1:], update[:, :1]], dim=1)
                else:
                    sg_history = states.sg_history
                new_states = advance_state(config, states, costs, lam, update, sg_history,
                                           keys_out)
            aux = SolveAux(costs=costs, weights=weights, lam=lam, ess=ess,
                           state_seq_batch=rollouts)
            return SolveResult(update, state_seq, new_states, aux)

    return solve_batch


def make_solver(
    config: MPPIConfig,
    dynamics: Dynamics,
    cost_fn: CostFn,
    device: Optional[Union[str, torch.device]] = None,
) -> MPPISolver:
    """Build the unfused solver for one (config, dynamics, cost) on ``device``."""
    device = resolve_device(device)
    dtype = config.dtype
    if device.type == "cuda" and dtype != torch.float32 and config.kernel_backend != "xla":
        raise ValueError(
            f"the weighted-update kernel takes float32; a {dtype} config on {device} "
            "needs kernel_backend='xla'"
        )
    num_samples = config.num_samples
    dim_state = config.dim_state
    sg_coeffs = config_sg_coeffs(config, dtype, device)

    init = make_init(config, device)
    states_prediction = make_states_prediction(config, dynamics)
    perturbations = make_perturbations(config, device)

    def solve(
        state: MPPIState,
        x0: torch.Tensor,
        info: Optional[Dict[str, Any]] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> SolveResult:
        """One MPPI solve; ``noise`` optional ``[K, T, m]``, already scaled."""
        with SOLVE:
            user_info = {} if info is None else dict(info)
            x0 = torch.as_tensor(x0, dtype=dtype, device=device)
            perturbed, key = perturbations(state_key(state, device), state.previous_action_seq,
                                           noise)

            x0_batch = x0.expand(num_samples, dim_state)
            with ROLLOUT:
                costs, state_seq_batch = _rollout_and_costs(
                    dynamics, cost_fn, x0_batch, perturbed, user_info, config.store_rollouts
                )
            # LBPS and ESSPS pick the temperature before weighting; fixed and MPO
            # weight at the state's (MPO steps it afterwards, in advance_state)
            if config.auto_lambda in ("LBPS", "ESSPS"):
                with LAMBDA:
                    lam = search_lambda(config, costs)
            else:
                lam = state.lam
            update, weights, ess = weighted_update(
                costs, perturbed, lam, backend=config.kernel_backend
            )
            with TAIL:
                action_seq, state_seq, new_sg_history = smooth_predict_advance(
                    config, sg_coeffs, states_prediction, state, x0, update
                )
                new_state = advance_state(config, state, costs, lam, action_seq,
                                          new_sg_history, key)
            aux = SolveAux(
                costs=costs, weights=weights, lam=lam, ess=ess, state_seq_batch=state_seq_batch
            )
            return SolveResult(action_seq, state_seq, new_state, aux)

    return MPPISolver(
        config=config,
        init=init,
        solve=solve,
        states_prediction=states_prediction,
        device=device,
    )
