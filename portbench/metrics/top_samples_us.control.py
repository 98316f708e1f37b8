"""Device time a tick of the work launched under the port's span ``solver.top_samples``
(``get_top_samples``: the top rows chosen by a stable sort of the weights, then row 6, the
top rows regenerated and rolled out), from the traced slice.  A call's window runs from its
span's host range to the next ``facade.forward``: the cell's loop has read every earlier result
to the host before the call, so the device runs nothing else there but the loop's reads of the
call's outputs, the device-to-host copies that start after the span has closed, which are
left out.  The device time is the union of the window's activities.  None where the trace
holds no such range (a port without the span)."""

import bisect

from portbench import tracing

SPAN, NEXT = "solver.top_samples", "facade.forward"


def read(reading):
    sl = reading.slice
    calls = sorted((h for h in sl.host if h[0] == SPAN), key=lambda h: h[1])
    if not calls:
        return None
    forwards = sorted(h[1] for h in sl.host if h[0] == NEXT)
    total, launches, kernels = 0.0, 0, {}
    for _, start, end in calls:
        i = bisect.bisect_right(forwards, end)
        until = forwards[i] if i < len(forwards) else sl.end
        mine = [a for a in sl.device if start <= a[1] < until
                and not (a[1] >= end and a[0].startswith("Memcpy DtoH"))]
        total += tracing.covered_us(mine)
        launches += len(mine)
        for name, s, e in mine:
            kernels[name[:80]] = kernels.get(name[:80], 0.0) + (e - s) / len(calls)
    return {"value": total / len(calls), "calls": len(calls),
            "activities_per_call": launches / len(calls),
            "us_per_call_by_activity": dict(sorted(kernels.items(), key=lambda kv: -kv[1]))}
