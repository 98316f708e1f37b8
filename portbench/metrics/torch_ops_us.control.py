"""Device time a control tick in activities that are not the port's own CUDA kernels (the
torch operations around them, copies and fills), by the union of their intervals."""

from portbench import tracing


def read(reading):
    others = [a for a in reading.slice.device if not tracing.is_port_kernel(a[0])]
    if not others or not reading.slice.ticks:
        return None
    return tracing.covered_us(others) / reading.slice.ticks
