"""Row 1, the racing fused solve (``csrc/fused_racing.cu``, ``fused_solve_kernel``): its
least time by ``bounds.solve_bound_ms`` at the cell's shapes over its mean launch."""

from portbench import bounds

KERNELS = ("fused_solve_kernel<racing::",)


def read(reading):
    s = reading.solver
    bound = bounds.solve_bound_ms(int(s["num_samples"]), int(s["horizon"]), True,
                                  reading.grid_bytes())
    return reading.roofline(KERNELS, bound)
