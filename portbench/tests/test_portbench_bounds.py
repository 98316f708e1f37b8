"""The frozen roofline arithmetic reproduces the bounds the port's kernel table records."""

from __future__ import annotations

import pytest

from portbench import bounds

GRIDS = 2 * 800 * 800  # racing's two uint8 grids, 80 m at 0.1 m


@pytest.mark.parametrize("bound, want, by", [
    (lambda: bounds.solve_bound_ms(100_000, 50, True, GRIDS), 0.01089, "operations"),  # row 1
    (lambda: bounds.phase1_bound_ms(100_000, 50, True, GRIDS), 0.01244, "bytes"),  # row 3
    (lambda: bounds.search_bound_ms(100_000, 40), 0.00032, "operations"),  # row 7
    (lambda: bounds.weighted_update_bound_ms(100_000, 100), 0.01211, "bytes"),  # row 9
])
def test_kernel_table_bounds(bound, want, by):
    ms, what = bound()
    assert round(ms, 5) == want and what == by


def test_the_cells_own_bounds():
    """The shapes the rooflines of the cells read: rows 1 (one and 32 scenarios), 7 and 9."""
    assert bounds.solve_bound_ms(100_000, 50, True, GRIDS)[0] == pytest.approx(0.010894, 1e-4)
    ms, by = bounds.solve_bound_ms(4000, 25, True, GRIDS, batch=32)
    assert (round(ms, 6), by) == (0.007019, "operations")
    ms, by = bounds.weighted_update_bound_ms(4000, 50)
    assert (round(ms, 7), by) == (0.0002446, "bytes")
