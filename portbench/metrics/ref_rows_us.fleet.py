"""Device time a fleet tick (all B scenarios) under the port's span
``solver.reference_rows`` (the racing reference rows, ``calc_ref_trajectory_batch``): the
traced slice's replays matched against the capture maps of the port's graphs
(``utils/timing.attribute``), their activities charged to the spans they were captured under.
The line also carries the device us a tick of every span of the map, the replays matched
against the slice's fleet ticks, and the share of the slice's device time attributed.  None
where the port has no capture map or no replay matches."""


def read(reading):
    try:
        from mppi_playground_tpu_torch.utils import timing

        got = timing.attribute(reading.slice.device)
    except (ImportError, AttributeError):
        return None
    if not got or not got["replays"]:
        return None
    spans = got["us_per_tick"]
    if not any("solver.reference_rows" in path.split("/") for path in spans):
        return None
    return {"value": timing.under(spans, "solver.reference_rows"), "us_per_tick": spans,
            "replays_matched": got["replays"], "ticks_in_slice": reading.slice.ticks,
            "attributed_share": got["attributed_share"]}
