"""Mean host time of a replayed tick's launch: the port's span ``tick.replay`` around
``CUDAGraph.replay()`` (``core/closed_loop.TickGraph``), over the window's ticks after the
profiled slice, read from the port's span ring (``utils/timing``); the spans recorded while
the profiler collected are left out.  None where the port records no spans."""


def read(reading):
    try:
        from mppi_playground_tpu_torch.utils import timing

        records = timing.after_profiling() or []  # None: no slice was profiled
    except (ImportError, AttributeError):
        return None
    us = [r.us for r in records if r.name == "tick.replay"]
    if not us:
        return None
    return {"value": sum(us) / len(us), "replays": len(us)}
