"""Row 4, the λ epilogue (``fused_solve.cuh`` ``costs_dump_lambda_kernel`` on the unicycle
plug: the rollouts, costs and the clamped perturbations dumped, and the ESSPS search in the
last cluster to finish): the frozen bound at the cell's shapes over the kernel's mean launch.

The bound is ``bounds.phase1_bound_ms`` with the search's operations, as the port's chip check
bounds the epilogue, on the unicycle's shapes and operations (``NAVIGATION``: n = 3, m = 2, no
reference row; 44 float operations a step and 19 a stage cost with its accumulation, counted
from ``csrc/unicycle_model.cuh`` as ``bounds`` counts racing's) and its one uint8 grid.  The
line also carries the launches a tick of row 4 and of the standalone route's rows 3 and 7,
which this route does not launch."""

from portbench import bounds

NAVIGATION = bounds.ModelOps(3, 2, 0, 44, 19)
KERNELS = ("costs_dump_lambda_kernel<unicycle::",)
STANDALONE = {"row3": ("costs_dump_kernel<unicycle::",), "row7": ("search_kernel<",)}


def bound_ms(reading) -> tuple:
    s, sc = reading.solver, reading.scene
    k, horizon = int(s["num_samples"]), int(s["horizon"])
    cells = [round(sc["map_size"][i] / sc["cell_size"]) for i in (0, 1)]
    search = bounds.search_ops(k, int(s["essps_iters"]), bounds.OPS_ESSPS_EVAL,
                               bounds.OPS_SEARCH_COST)
    return bounds.phase1_bound_ms(k, horizon, True, cells[0] * cells[1], NAVIGATION,
                                  search_ops=search)


def read(reading):
    got = reading.roofline(KERNELS, bound_ms(reading))
    if got is None:
        return None
    ticks = reading.slice.ticks
    got["launches_per_tick"] = len(reading.slice.matching(KERNELS)) / ticks
    for row, names in STANDALONE.items():
        got[f"{row}_launches_per_tick"] = len(reading.slice.matching(names)) / ticks
    return got
