"""Shared by the benchmark's CPU tests: a cell run at a small size through the harness."""

from __future__ import annotations

import importlib.util
import time

from portbench import harness

# Small enough for the CPU: a few hundred samples, short windows, checks often.
SMALL = {
    "control": dict(solver={"num_samples": 256}, check_every=3, warmup_ticks=3),
    "fleet": dict(solver={"num_samples": 256}, batch=4, episode_ticks=6, check_every=1,
                  warmup_episodes=2),
}
CELLS = ("racing_flagship.control", "racing_ref.fleet32", "racing_ref.control_xla",
         "racing_flagship.control_essps")


def small(cell: harness.Cell) -> dict:
    return SMALL[cell.traffic["driver"]]


def run_module():
    spec = importlib.util.spec_from_file_location("portbench_run", harness.HERE / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def line_of(workload: str, seed: int = 7, seconds: float = 1.0, trace: bool = False) -> dict:
    """The result line of ``workload`` on the CPU at a small size (the run's seam)."""
    cell = harness.load_cell(workload)
    job = harness.Job(cell, seed, seconds, trace, "cpu", time.perf_counter(), small(cell))
    return run_module().execute(job)
