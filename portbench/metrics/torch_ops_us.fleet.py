"""Device time a fleet tick (all B scenarios) in activities that are not the port's own CUDA
kernels, by the union of their intervals."""

from portbench import tracing


def read(reading):
    others = [a for a in reading.slice.device if not tracing.is_port_kernel(a[0])]
    if not others or not reading.slice.ticks:
        return None
    return tracing.covered_us(others) / reading.slice.ticks
