"""Row 9, the unfused route's softmin partials (``csrc/weighted_update.cu``,
``weighted_update_kernel``): ``bounds.weighted_update_bound_ms`` at K and D = T*m over its
mean launch."""

from portbench import bounds

KERNELS = ("weighted_update_kernel<",)


def read(reading):
    s = reading.solver
    bound = bounds.weighted_update_bound_ms(int(s["num_samples"]), 2 * int(s["horizon"]))
    return reading.roofline(KERNELS, bound)
