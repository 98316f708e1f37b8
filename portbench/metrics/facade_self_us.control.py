"""Mean self time of ``RacingController.update``: the port's span ``facade.update`` less the
part its child spans cover (``tick.copy_in``, ``tick.replay``, ``tick.copy_out``), over the
window's ticks after the profiled slice (``utils/timing``'s ring, the spans recorded while the
profiler collected left out).  What remains is the facade's own Python and the plant state's
copy to the card.  None where the port records no spans."""


def read(reading):
    try:
        from mppi_playground_tpu_torch.utils import timing

        records = timing.after_profiling() or []  # None: no slice was profiled
    except (ImportError, AttributeError):
        return None
    kids = timing.children(records)
    own = [u.us - sum(c.us for c in kids.get(u.id, ())) for u in records
           if u.name == "facade.update"]
    if not own:
        return None
    return {"value": sum(own) / len(own), "ticks": len(own)}
