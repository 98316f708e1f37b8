"""The kernels' roofline arithmetic: the least time a launch could take on one H100.

A frozen copy of the bound functions of ``chip_smoke.py`` (the port's chip
check), kept here so that a later change to the program cannot move the
yardstick.  Work comes from the launch's shapes: each input byte is counted
once, each output byte once, and the float operations are counted from the
CUDA sources (``csrc/racing_model.cuh``, ``csrc/lambda_search.cu``).  A
bound is the larger of bytes over the HBM rate and operations over the
float32 rate, and says which of the two set it.
"""

from __future__ import annotations

import dataclasses

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# Float operations per call of each device function in csrc/racing_model.cuh
# (+, -, *, /, min, max, fmod, rint, sqrt, log; sign flips, compares and
# selects not counted; Philox's integer work not counted).
OPS_ANGLE_NORMALIZE = 4
OPS_SINCOS = 20
OPS_TAN = 8
OPS_BICYCLE = 2 * OPS_ANGLE_NORMALIZE + 4 + OPS_SINCOS + 5 + 5 + OPS_TAN + 4 + 4
OPS_MAP_PAIR = 11
OPS_STAGE_COST = 33 + OPS_MAP_PAIR + 1  # + the accumulation
OPS_NORMAL_PAIR = 10 + OPS_SINCOS
OPS_PERTURB = 6  # mean + z and the clamp, per step (2 slots)
OPS_SCALE = 2  # z * sigma, per step, seeded mode only
# Per cost and evaluation of csrc/lambda_search.cu: ESSPS d * inv, exp, two
# adds, e * e; LBPS c * a, - shift, exp, three adds, e * e, e * c.  Plus the
# min (and max) pass and, for ESSPS, d = min - c once: 2 a cost.
OPS_ESSPS_EVAL, OPS_LBPS_EVAL = 5, 8
OPS_SEARCH_COST = 2


@dataclasses.dataclass(frozen=True)
class ModelOps:
    """A model's shapes and float operations: ``step`` and ``cost`` count one call of its
    device step and of its stage cost with the accumulation; ``ref`` the floats of its
    per-tick reference row."""

    n: int
    m: int
    ref: int
    step: int
    cost: int


RACING = ModelOps(4, 2, 5, OPS_BICYCLE, OPS_STAGE_COST)


def _bound(in_bytes: float, out_bytes: float, ops: float) -> tuple:
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _per_step(ops: ModelOps, seeded: bool) -> int:
    """Float operations of one rollout step: perturb and clamp, stage cost, step, draws."""
    per_slot = OPS_PERTURB // 2 + ((OPS_NORMAL_PAIR + OPS_SCALE) // 2 if seeded else 0)
    return ops.m * per_slot + ops.cost + ops.step


def _rollout_in_bytes(ops: ModelOps, num_samples, horizon, seeded, grid_bytes,
                      batch: int = 1) -> int:
    """Bytes a rollout launch of ``batch`` scenarios reads: each scenario's start, warm start,
    reference rows (and noise), and the grids once, which all scenarios share."""
    per_scenario = 4 * (ops.n + ops.m * horizon + ops.ref * (horizon + 1))
    per_scenario += 0 if seeded else 4 * num_samples * horizon * ops.m
    return batch * per_scenario + grid_bytes


def solve_bound_ms(num_samples: int, horizon: int, seeded: bool, grid_bytes: int,
                   ops: ModelOps = RACING, batch: int = 1) -> tuple:
    """Row 1, the fused solve of ``batch`` scenarios: ``(ms, 'bytes' | 'operations')``.

    Bytes: each input read once (the shared grids once for all scenarios),
    each output written once.  Operations: the rollout with its costs, the
    draws, and e * pert summed into the numerator, once a sample.
    """
    blocks = -(-num_samples // 256)
    slots = ops.m * horizon
    in_bytes = _rollout_in_bytes(ops, num_samples, horizon, seeded, grid_bytes, batch) + 4 * batch
    out_bytes = 4 * batch * (num_samples + 3 * blocks + slots * blocks)
    per_sample = horizon * _per_step(ops, seeded) + ops.cost + 4 + 2 * slots
    return _bound(in_bytes, out_bytes, batch * num_samples * per_sample)


def phase1_bound_ms(num_samples: int, horizon: int, seeded: bool, grid_bytes: int,
                    ops: ModelOps = RACING, search_ops: float = 0.0, batch: int = 1) -> tuple:
    """Row 3, auto-λ phase 1 of ``batch`` scenarios: the rollout and costs, the dump written
    (``search_ops`` adds the λ epilogue's search, once a scenario)."""
    in_bytes = _rollout_in_bytes(ops, num_samples, horizon, seeded, grid_bytes, batch)
    out_bytes = 4 * batch * (num_samples * (1 + ops.m * horizon) + (1 if search_ops else 0))
    rollout = batch * num_samples * (horizon * _per_step(ops, seeded) + ops.cost)
    return _bound(in_bytes, out_bytes, rollout + batch * search_ops)


def search_ops(num_samples: int, iters: int, per_eval: int, per_cost: int) -> float:
    """Float operations of one λ search: per-cost hoists and 2 + iters evaluations."""
    return num_samples * (per_cost + per_eval * (2 + iters))


def search_bound_ms(num_samples: int, iters: int, per_eval: int = OPS_ESSPS_EVAL,
                    per_cost: int = OPS_SEARCH_COST) -> tuple:
    """Rows 7 and 8, one λ search: the costs read once, 2 + iters evaluations."""
    return _bound(4 * num_samples, 4, search_ops(num_samples, iters, per_eval, per_cost))


def weighted_update_bound_ms(num_samples: int, slots: int) -> tuple:
    """Row 9, the weighted update: costs and samples read, the block partials written.

    Operations a sample: -c / λ, the max, the shift, exp, e * e and two
    sums, and e * sample summed into each of the D slots.
    """
    blocks = -(-num_samples // 256)
    in_bytes = 4 * (num_samples * (slots + 1) + 1)
    out_bytes = 4 * blocks * (3 + slots)
    return _bound(in_bytes, out_bytes, num_samples * (7 + 2 * slots))
