"""Row 1 batched, the fleet's fused solve of all B scenarios in one launch
(``fused_solve_kernel`` on ``blockIdx.y``): ``bounds.solve_bound_ms`` with the batch over its
mean launch."""

from portbench import bounds

KERNELS = ("fused_solve_kernel<racing::",)


def read(reading):
    s = reading.solver
    bound = bounds.solve_bound_ms(int(s["num_samples"]), int(s["horizon"]), True,
                                  reading.grid_bytes(), batch=int(reading.traffic["batch"]))
    return reading.roofline(KERNELS, bound)
