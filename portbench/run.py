"""Run one cell of the port's benchmark and print its result as the last line of stdout.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``mppi_playground_tpu_torch``)
and ``BENCHMARK.json``, on a machine with as many CUDA cards as the cell
asks for.  ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics, read from a device trace of a bounded slice of the
window.  Both check the timed path's outputs against the plain reference
(``portbench/reference``) once the window has closed, and print each number
compared beside its limit.  The exit code is 0 only where a result was
printed; a run without a card, without the port, or that finds JAX or the
JAX package loaded prints none.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def execute(job: harness.Job) -> dict:
    """Run ``job`` and return its result line (the seam the CPU tests drive)."""
    import torch

    outcome = harness.driver(job.cell).run(job)
    if job.device == "cuda":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": job.cell.chips, "memory_peak_bytes": outcome.memory_peak_bytes}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if job.trace and outcome.reading is not None:
        from portbench import tracing

        sl = outcome.reading.slice
        device.update(busy_s=tracing.covered_us(sl.device) * 1e-6, window_s=sl.window_us * 1e-6)
    return harness.result_line(job, outcome, device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = harness.load_cell(args.workload)
    try:
        import mppi_playground_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"portbench: the port is not in this checkout: {err}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    harness.pin()
    torch.set_num_threads(2)
    job = harness.Job(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    line = execute(job)
    foreign = harness.foreign_modules(sys.modules)
    if foreign:
        print(f"portbench: jax or the JAX package was loaded: {foreign}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    harness.print_checks(line)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.environ["PYTHONHASHSEED"] = "0"
        # one hash seed for every run: string hashing seeded anew in each process moved the
        # host's share of a tick by several percent from run to run
        os.execv(sys.executable, [sys.executable, *sys.argv])
    sys.exit(main())
