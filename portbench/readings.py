"""The two readings every correctness limit is set between, for one cell and some seeds.

    python3 -m portbench.readings --workload <cell> --seeds 11 12 13 --seconds 2

For each seed: a short window of the cell's timed path (the same driver a
run uses), its gaps against the float32 reference (the lower reading), and
the gaps of the control, the reference computed in bfloat16 and put in the
program's place on the same inputs (the upper reading).  Prints one JSON
line a seed.  The CPU tests call :func:`readings` at a small size.
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
from portbench.reference import maps  # noqa: E402
from portbench.reference.racing import Racing  # noqa: E402

LOW = "bfloat16"  # the precision below the configurations' float32


def readings(workload: str, seed: int, seconds: float, device: str, overrides=None) -> dict:
    import torch

    cell = harness.load_cell(workload)
    job = harness.Job(cell, seed, seconds, False, device, time.perf_counter(),
                      dict(overrides or {}, keep=True))
    drv = harness.driver(cell)
    outcome = drv.run(job)
    records = outcome.extra["records"]
    scene = maps.scene(cell.config, seed % 2**32)
    ref = Racing(scene, job.solver, torch.float32, device)
    low = Racing(scene, job.solver, getattr(torch, LOW), device)
    control = drv.gaps(job, ref, drv.substitute(job, low, records))
    lams = [float(r["after"]["lam"]) for r in records if "after" in r]
    return {"workload": workload, "seed": seed, "program": outcome.gaps, "control": control,
            "checked": len(records), "limits": cell.limits,
            "lambda_seen": [min(lams), max(lams)] if lams else None}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
