"""The device trace of a bounded slice of the window, and what the per-layer readers read.

``profile_slice`` runs ``body()`` (a fixed number of ticks) under
``torch.profiler`` with the CPU and CUDA activities, inside a host range
named ``portbench.slice`` whose wall time is the slice's window.  The trace
is known to drop the first device activities after it starts, so the
profiler is primed with empty kernels and a marker kernel first.  A
:class:`Slice` holds the device activities (kernels, copies, fills) and the
host operations that fall inside the window.

Interval arithmetic is on the union of the device intervals, so two
activities that overlap count once.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PRIMING_KERNELS = 200
MARGIN_S = 0.2
SLICE = "portbench.slice"
# The port's own CUDA kernels (csrc/), by the function names the trace shows.
PORT_KERNELS = (
    "fused_solve_kernel<", "costs_dump_kernel<", "costs_dump_lambda_kernel<",
    "tick_tail_kernel<", "reroll_kernel<", "regen_rollout_kernel<", "weighted_kernel(",
    "weighted_update_kernel<", "search_kernel<",
)

Interval = Tuple[str, float, float]  # name, start us, end us


@dataclasses.dataclass
class Slice:
    """A traced slice: device activities and host operations inside ``[start, end]`` (us)."""

    device: List[Interval]
    host: List[Interval]
    start: float
    end: float
    ticks: int
    spans: Dict[str, List[float]]

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def matching(self, names: Sequence[str]) -> List[Interval]:
        """The device activities whose name contains one of ``names``."""
        return [a for a in self.device if any(n in a[0] for n in names)]


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def union(intervals: Sequence[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals, as sorted disjoint ``(start, end)`` pairs."""
    merged: List[Tuple[float, float]] = []
    for _, s, e in sorted(intervals, key=lambda a: a[1]):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def covered_us(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in union(intervals))


def profile_slice(torch, body: Callable[[], Tuple[int, Dict[str, List[float]]]]) -> Slice:
    """``body()`` under the device trace; it returns ``(ticks run, host spans)``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PRIMING_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(MARGIN_S)
        torch.cuda._sleep(1000)  # the marker the slice must find before it
        torch.cuda.synchronize()
        with record_function(SLICE):
            ticks, spans = body()
            torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    window = [e for e in events if e.name == SLICE and e.device_type != cuda]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} slice ranges, not one")
    start, end = window[0].time_range.start, window[0].time_range.end
    device, host, marked = [], [], False
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if e.name == SLICE:  # the range's own annotation on the device's timeline
                continue
            if "sleep" in e.name or "spin_kernel" in e.name:
                marked = marked or s < start
                continue
            if start <= s <= end:
                device.append((e.name, s, t))
        elif e.name != SLICE and start <= s <= end:
            host.append((e.name, s, t))
    if not marked:
        raise RuntimeError("the device trace lost its marker kernel: it may have lost others")
    if not device:
        raise RuntimeError("the device trace holds no activity inside the slice")
    return Slice(device, host, start, end, ticks, spans)


def breakdown(sl: Slice, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps by the host
    operation under way at each gap's middle (the shortest range that covers it)."""
    by_name: Dict[str, float] = {}
    for name, s, e in sl.device:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union(sl.device)
    edges = [sl.start] + [x for pair in busy for x in pair] + [sl.end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        under = [h for h in sl.host if h[1] <= mid <= h[2]]
        label = min(under, key=lambda h: h[2] - h[1])[0] if under else "python (no op)"
        named.append([label[:120], (e - s) * 1e-6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the slice, the cell's settings, the card."""

    slice: Slice
    solver: dict
    scene: dict
    traffic: dict
    card: dict

    def mean_launch_us(self, names: Sequence[str]) -> Optional[float]:
        """Mean device time a launch of the kernels named, or None where the slice has none."""
        hits = self.slice.matching(names)
        if not hits:
            return None
        return sum(e - s for _, s, e in hits) / len(hits)

    def grid_bytes(self) -> int:
        """Bytes of the two uint8 grids the racing kernels read."""
        cells = [round(self.scene["map_size"][i] / self.scene["cell_size"]) for i in (0, 1)]
        return 2 * cells[0] * cells[1]

    def roofline(self, names: Sequence[str], bound: Tuple[float, str]) -> Optional[dict]:
        """``bound`` (ms, what sets it) over the mean launch of ``names``, in percent."""
        us = self.mean_launch_us(names)
        if us is None:
            return None
        return {"value": 100.0 * bound[0] * 1e3 / us, "bound_by": bound[1],
                "mean_launch_us": us, "power_limit": self.card.get("power_limit")}
