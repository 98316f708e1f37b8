"""Share of the traced slice's wall time in which no activity ran on the device: one less
the union of the device intervals over the slice's window.  The profiler slows each graph
launch on the host, so this reads above the untraced loop's idle share."""

from portbench import tracing


def read(reading):
    sl = reading.slice
    if not sl.device or sl.window_us <= 0:
        return None
    return 100.0 * (1.0 - tracing.covered_us(sl.device) / sl.window_us)
