"""Each cell's last line at a small size on the CPU, through the run's seam.

The port's CPU path runs the kernels' plain twins, so the line is the one a
run prints, with the CPU in the card's place: the cell's end-to-end metrics,
the device, the numbers compared beside their limits last, and ``correct``.
"""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.tests.common import CELLS, line_of


@pytest.mark.parametrize("workload", CELLS)
def test_a_cells_line_at_a_small_size(workload):
    line = line_of(workload)
    cell = harness.load_cell(workload)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(line["checks"]) == set(cell.limits)
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_a_traced_line_on_the_cpu_has_no_device_metrics():
    """Without a card nothing is traced: no per-layer metric is read, none is made up."""
    line = line_of("racing_flagship.control", trace=True)
    assert line["metrics"] == {} and "busy_s" not in line["device"]
    assert line["correct"] is True
