"""Share of the window's ticks after the profiled slice whose ``facade.update`` span has no
``tick.replay`` child: ticks that ran eagerly or captured a graph instead of replaying one
(``utils/timing``'s ring, the spans recorded while the profiler collected left out).  The
line also carries the port's counters (graph replays, eager ticks, captures, rebuilds after
a map change, kernel libraries built and loaded).  None where the port records no spans."""


def read(reading):
    try:
        from mppi_playground_tpu_torch.utils import timing

        records = timing.after_profiling() or []  # None: no slice was profiled
        counters = {k: v for k, v in timing.counters().items() if k != "kernel.launches"}
    except (ImportError, AttributeError):
        return None
    kids = timing.children(records)
    updates = [r for r in records if r.name == "facade.update"]
    if not updates:
        return None
    missed = sum(not any(c.name == "tick.replay" for c in kids.get(u.id, ())) for u in updates)
    return {"value": 100.0 * missed / len(updates), "ticks": len(updates), "missed": missed,
            "counters": counters}
