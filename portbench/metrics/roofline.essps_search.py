"""Row 7, the ESSPS search (``csrc/lambda_search.cu``, ``search_kernel<false>``): its least
time by ``bounds.search_bound_ms`` over its mean launch."""

from portbench import bounds

KERNELS = ("search_kernel<false>",)


def read(reading):
    s = reading.solver
    bound = bounds.search_bound_ms(int(s["num_samples"]), int(s.get("essps_iters", 40)))
    return reading.roofline(KERNELS, bound)
