"""Row 6, the top rows of ``get_top_samples`` regenerated from the solve's seed and rolled out
(``fused_solve.cuh`` ``regen_rollout_kernel`` on the unicycle plug), at the cell's
``top_samples`` rows: the least time by ``bound_ms`` over the kernel's mean launch.

``bound_ms`` is the port's chip check's bound of this kernel, frozen here on ``bounds``'
constants: x0, the warm start and the row indices read, [rows, T+1, n] written; a row's T m
draws (a share of a normal pair, the scale and the perturbation each) and its T model steps
(the unicycle's 44 operations a step, ``roofline.costs_dump_lambda.NAVIGATION``)."""

from portbench import bounds

KERNELS = ("regen_rollout_kernel<unicycle::",)
N, M, STEP = 3, 2, 44  # the unicycle's state, action and float operations a step


def bound_ms(rows: int, horizon: int) -> tuple:
    slots = M * horizon
    per_slot = bounds.OPS_PERTURB // 2 + (bounds.OPS_NORMAL_PAIR + bounds.OPS_SCALE) // 2
    return bounds._bound(4 * (N + slots) + 8 * rows, 4 * rows * (horizon + 1) * N,
                         rows * (slots * per_slot + horizon * STEP))


def read(reading):
    rows = int(reading.traffic["top_samples"])
    got = reading.roofline(KERNELS, bound_ms(rows, int(reading.solver["horizon"])))
    if got is None:
        return None
    got["launches_per_tick"] = len(reading.slice.matching(KERNELS)) / reading.slice.ticks
    return got
