"""The benchmark's core: the manifest, a run's job, its checks and its result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``'s
``workloads``, its configuration in the file the manifest names, its
traffic mix in ``portbench/traffic/<traffic>.json`` (whose ``driver`` names
``portbench/drivers/<driver>.py``), its correctness limits in
``portbench/limits/<cell>.json`` and each per-layer metric's reader in
``portbench/metrics/<metric>.py``.  A driver runs the cell and returns an
:class:`Outcome`; this module turns it into the line the run prints.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FOREIGN = ("jax", "jaxlib", "flax", "mppi_playground_tpu")
MIN_CHECKED = 2  # the start and at least one tick (or episode) of the window


def solver_seed(seed: int) -> int:
    """The solver's seed of a run's ``--seed`` (the port's seeds are non-negative ints)."""
    return seed % 2**31


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with everything it names, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    config = next(c for c in manifest["configs"] if c["name"] == w["config"])
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)],
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text())["limits"],
    )


def load_file(path: Path, label: str):
    """A module of ``portbench/`` loaded from its file (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{label}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(cell: Cell):
    return load_file(HERE / "drivers" / f"{cell.traffic['driver']}.py",
                     f"driver_{cell.traffic['driver']}")


def reader(metric: str) -> Callable:
    return load_file(HERE / "metrics" / f"{metric}.py", "metric_" + metric.replace(".", "_")).read


def solver_settings(cell: Cell, overrides: Optional[dict] = None) -> dict:
    """The configuration's solver settings, then the traffic mix's, then a test's overrides."""
    return {**cell.config["solver"], **cell.traffic.get("solver", {}), **(overrides or {})}


@dataclasses.dataclass
class Job:
    """A run: the cell, its seed and window, whether it traces, the device, its start."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float  # perf_counter at the process's start, for the set-up time
    overrides: dict = dataclasses.field(default_factory=dict)

    @property
    def solver(self) -> dict:
        return solver_settings(self.cell, self.overrides.get("solver"))

    def param(self, key: str):
        return self.overrides.get(key, self.cell.traffic[key])


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end values, the counts, the gaps compared,
    the peak memory, and with tracing the slice's reading."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    gaps: Dict[str, float]
    memory_peak_bytes: int
    reading: Any = None  # tracing.Reading
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Phases:
    """The set-up's phases on the host clock, each printed to standard error as it ends."""

    def __init__(self, started: float):
        self.started = self.last = started

    def mark(self, name: str) -> float:
        """End phase ``name``; returns the seconds since the process started."""
        now = time.perf_counter()
        print(f"portbench: set-up {name} {now - self.last:.3f} s", file=sys.stderr, flush=True)
        self.last = now
        return now - self.started


def settle() -> None:
    """Before the window: collect the set-up's garbage and keep the collector off what
    survives it, so that the window's collections see only the window's objects."""
    gc.collect()
    gc.freeze()


def pin() -> None:
    """Keep the process on the last two of the CPUs it may use, so that its host work
    does not move between cores from run to run."""
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cpus[-2:])


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        name, limit = (part.strip() for part in out.split(",", 1))
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": None, "power_limit": None}


def foreign_modules(names) -> List[str]:
    """Loaded modules of jax, jaxlib, flax or the JAX package, by whole top-level name."""
    return sorted(n for n in names if n.split(".")[0] in FOREIGN)


def checks(limits: Dict[str, float], gaps: Dict[str, float]) -> Dict[str, dict]:
    """Each number compared beside its limit; a number missing or not finite fails."""
    out = {}
    for name, limit in limits.items():
        value = gaps.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit,
                     "ok": bool(math.isfinite(value) and value <= limit)}
    return out


def result_line(job: Job, outcome: Outcome, device: dict) -> dict:
    """The run's last line: the metrics of its kind, the device, the checks last."""
    compared = checks(job.cell.limits, outcome.gaps)
    correct = outcome.failed == 0 and all(c["ok"] for c in compared.values())
    line: Dict[str, Any] = {"correct": correct, "attempted": outcome.attempted,
                            "failed": outcome.failed}
    units = {m["name"]: m["unit"] for m in job.cell.end_to_end + job.cell.per_layer}
    metrics: Dict[str, dict] = {}
    if not job.trace:
        for m in job.cell.end_to_end:
            if m["name"] in outcome.end_to_end:
                metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
    elif outcome.reading is not None:
        for m in job.cell.per_layer:
            got = reader(m["name"])(outcome.reading)
            if got is None:
                continue
            entry = got if isinstance(got, dict) else {"value": got}
            metrics[m["name"]] = {"value": entry["value"], "unit": units[m["name"]],
                                  **{k: v for k, v in entry.items() if k != "value"}}
    line["metrics"] = metrics
    line["device"] = device
    if job.trace and outcome.reading is not None:
        from portbench import tracing

        line["breakdown"] = tracing.breakdown(outcome.reading.slice)
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in compared.items()}
    return line


def print_checks(line: dict, stream=sys.stderr) -> None:
    """The numbers compared, each beside its limit: the last lines on standard error."""
    for name, c in line["checks"].items():
        verdict = "ok" if math.isfinite(c["value"]) and c["value"] <= c["limit"] else "FAILED"
        print(f"portbench check {name}: {c['value']!r} (limit {c['limit']!r}) {verdict}",
              file=stream, flush=True)
