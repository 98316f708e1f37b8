"""The nodes of the replayed control tick's CUDA graph: the capture map (``utils/timing``'s
``SpanMap``) of the graph the process replayed most, every node counted (kernels, copies,
fills and any other).  The line also carries the nodes by kind, the nodes by the span they
were captured under, and that graph's replays.  None where the port keeps no capture map or
no graph was replayed."""

import collections


def read(reading):
    try:
        from mppi_playground_tpu_torch.utils import timing

        maps = timing.graph_maps()
    except (ImportError, AttributeError):
        return None
    replayed = [m for m in maps if m.replays]
    if not replayed:
        return None
    tick = max(replayed, key=lambda m: m.replays)
    kinds = collections.Counter(n.kind for n in tick.nodes)
    spans = collections.Counter(n.span for n in tick.nodes)
    return {"value": len(tick.nodes), "by_kind": dict(kinds),
            "by_span": dict(spans.most_common()), "replays": tick.replays}
