"""The two readings every correctness limit of ``mountaincar.control`` is set between.

    python3 -m portbench.mc_readings --seeds 11 12 13 --seconds 2

``portbench/nav_readings.readings`` for the mountain-car cell, whose driver
brings its own reference: for each seed, a short window of the cell's timed
path, its gaps against the float32 reference (the lower reading), and the
gaps of the control, the reference computed in bfloat16 and put in the
program's place on the same inputs (the upper reading).  Prints one JSON
line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.nav_readings import readings  # noqa: E402

WORKLOAD = "mountaincar.control"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(seed, args.seconds, "cuda", workload=WORKLOAD)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
