"""Mean host time of ``RacingController.update`` from the call to its return, before the
action is read: the benchmark's own span around the facade, over the traced run's window
ticks outside the profiled slice (the profiler slows a graph's launch on the host)."""


def read(reading):
    spans = reading.slice.spans.get("facade_enqueue_us")
    return sum(spans) / len(spans) if spans else None
