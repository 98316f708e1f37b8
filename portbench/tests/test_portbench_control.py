"""The control: the reference in bfloat16, put in the program's place, comes out not correct.

On the CPU at a small size; on the card (marker ``cuda``) at each cell's own
size on three seeds:

    python3 -m pytest portbench/tests/test_portbench_control.py -m cuda -q -s
"""

from __future__ import annotations

import json

import pytest

from portbench import harness
from portbench.readings import readings
from portbench.tests.common import CELLS, small


def failed(gaps: dict, limits: dict) -> list:
    return [k for k, limit in limits.items() if not gaps.get(k, float("nan")) <= limit]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_where_the_program_passes(workload):
    got = readings(workload, 23, 1.5, "cpu", small(harness.load_cell(workload)))
    assert failed(got["program"], got["limits"]) == []
    assert failed(got["control"], got["limits"]), got["control"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_at_the_cells_size(workload, card):
    for seed in (1_100_000_001, 1_200_000_002, 1_300_000_003):
        got = readings(workload, seed, 2.0, "cuda")
        print(json.dumps(dict(got, card=card)))
        assert failed(got["program"], got["limits"]) == []
        assert failed(got["control"], got["limits"])
