"""The two readings every correctness limit of ``navigation.control`` is set between.

    python3 -m portbench.nav_readings --seeds 11 12 13 --seconds 2

``portbench/readings.py`` for the navigation cell, whose reference is not
racing's: for each seed, a short window of the cell's timed path, its gaps
against the float32 reference (the lower reading), and the gaps of the
control, the reference computed in bfloat16 and put in the program's place
on the same inputs (the upper reading).  Prints one JSON line a seed.  The
CPU tests call :func:`readings` with a short window.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.readings import LOW  # noqa: E402

WORKLOAD = "navigation.control"


def readings(seed: int, seconds: float, device: str, overrides=None,
             workload: str = WORKLOAD) -> dict:
    import torch

    cell = harness.load_cell(workload)
    job = harness.Job(cell, seed, seconds, False, device, time.perf_counter(),
                      dict(overrides or {}, keep=True))
    drv = harness.driver(cell)
    outcome = drv.run(job)
    records = outcome.extra["records"]
    low = drv.reference(job, getattr(torch, LOW), device)
    control = drv.gaps(job, drv.reference(job, torch.float32, device),
                       drv.substitute(job, low, records))
    lams = [float(r["after"]["lam"]) for r in records]
    return {"workload": workload, "seed": seed, "program": outcome.gaps, "control": control,
            "checked": len(records), "limits": cell.limits,
            "lambda_seen": [min(lams), max(lams)] if lams else None}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(seed, args.seconds, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
