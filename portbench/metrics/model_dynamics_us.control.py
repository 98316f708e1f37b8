"""Device time a control tick under the port's span ``solver.dynamics`` (each call of the
user's ``dynamics`` in the unfused rollout and the nominal re-roll, racing's ``env.dynamics``
inside it): the traced slice's replays matched against the capture maps of the port's graphs
(``utils/timing.attribute``), their activities charged to the spans they were captured under.
The line also carries the replays matched, the slice's ticks and the share of the slice's
device time attributed.  None where the port has no such span or no replay matches."""

SPAN = "solver.dynamics"


def read(reading):
    try:
        from mppi_playground_tpu_torch.utils import timing

        got = timing.attribute(reading.slice.device)
    except (ImportError, AttributeError):
        return None
    if not got or not got["replays"]:
        return None
    spans = got["us_per_tick"]
    if not any(SPAN in path.split("/") for path in spans):
        return None
    return {"value": timing.under(spans, SPAN), "replays_matched": got["replays"],
            "ticks_in_slice": reading.slice.ticks, "attributed_share": got["attributed_share"]}
