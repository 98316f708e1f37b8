"""Two-process bootstrap dry run: one ``env://`` rendezvous, one cross-process sharded solve.

Counterpart of ``benchmarks/multihost_dryrun.py``.  A single host stands in
for two: the parent starts two separate Python processes (not children of
one ``torch.multiprocessing`` spawn), each given ``MASTER_ADDR=localhost``,
one free ``MASTER_PORT``, ``WORLD_SIZE=2`` and its ``RANK``.  Each child

* joins the default process group through
  ``parallel.mesh.initialize_distributed()``'s ``env://`` rendezvous (rank 0
  hosts the ``TCPStore``): with ``--device cuda`` (the default) process r
  drives card r on a ``cpu:gloo,cuda:nccl`` group, which needs two cards;
  with ``--device cpu`` a gloo group over the CPU;
* builds the global ``(1, 2)`` mesh and runs one sample-sharded pendulum
  solve (``make_sharded_solver``, ESSPS, K=512: each process rolls out 256
  samples, the costs and block partials gathered across the process
  boundary);
* holds it against the single unsharded solver in the same process, bit for
  bit (every output and the next state), and prints one JSON line.

The parent waits for both children with one deadline an attempt, ends the
other child when one fails or hangs, and checks that both report the same
checksum.  A free port picked by binding and closing can be taken before
the rendezvous, so a failed attempt is retried on a fresh port, three
attempts in all.

Run:  ``python -m mppi_playground_tpu_torch.parallel.multihost_dryrun
[--device cuda|cpu]`` (from the repository's root).  Prints one summary JSON
line; exits non-zero on failure, with each failed child's output on stderr.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import time

NUM_PROCESSES = 2
ATTEMPTS = 3
ATTEMPT_TIMEOUT_S = 180.0
_MODULE = "mppi_playground_tpu_torch.parallel.multihost_dryrun"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _child(device: str) -> None:
    import torch
    import torch.distributed as dist

    from mppi_playground_tpu_torch.core.closed_loop import bitwise_equal, result_leaves
    from mppi_playground_tpu_torch.core.config import MPPIConfig
    from mppi_playground_tpu_torch.core.solver import make_solver
    from mppi_playground_tpu_torch.models import pendulum
    from mppi_playground_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
        mesh_device,
    )
    from mppi_playground_tpu_torch.parallel.sharded import make_sharded_solver

    if device == "cuda":
        device = f"cuda:{os.environ['RANK']}"  # one card a process
    initialize_distributed(device=device)  # env://: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        if world != NUM_PROCESSES:
            raise RuntimeError(f"the group has {world} processes, not {NUM_PROCESSES}")
        config = MPPIConfig(horizon=15, num_samples=512, dim_state=2, dim_control=1,
                            u_min=pendulum.U_MIN, u_max=pendulum.U_MAX, sigmas=(1.0,),
                            lambda_="ESSPS", store_rollouts=False)
        mesh = make_mesh(mesh_shape=(1, world))  # K sharded over both processes
        dev = mesh_device(mesh)
        sharded = make_sharded_solver(config, pendulum.dynamics, pendulum.cost, mesh)
        x0 = torch.tensor([math.pi, 0.0], device=dev)
        got = sharded.solve(sharded.init(seed=0), x0)
        local = make_solver(config, pendulum.dynamics, pendulum.cost, device=dev)
        want = local.solve(local.init(seed=0), x0)
        if not bitwise_equal(result_leaves(got), result_leaves(want)):
            raise RuntimeError("the sharded solve is not the single solver's bit for bit")
        if not torch.isfinite(got.action_seq).all():
            raise RuntimeError("the sharded solve's actions are not finite")
        print(json.dumps({
            "process_id": rank,
            "process_count": world,
            "device": str(dev),
            "pid": os.getpid(),
            "checksum": float(got.action_seq.double().abs().sum()),
            "bitwise_vs_local": True,
            "ok": True,
        }), flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_once(device: str) -> tuple:
    port = _free_port()
    procs = []
    path = os.pathsep.join(filter(None, [_ROOT, os.environ.get("PYTHONPATH")]))
    for rank in range(NUM_PROCESSES):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(NUM_PROCESSES), RANK=str(rank), PYTHONPATH=path)
        procs.append(subprocess.Popen([sys.executable, "-m", _MODULE, "--child",
                                       "--device", device],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                      env=env))
    deadline = time.monotonic() + ATTEMPT_TIMEOUT_S
    reports, ok = [], True
    for rank, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            # a hung child means the rendezvous is dead: end both
            for p in procs:
                p.kill()
            out, err = proc.communicate()
            err += f"\nkilled after {ATTEMPT_TIMEOUT_S:.0f} s"
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            ok = False
            for p in procs:  # the other child would wait for this one at the next collective
                if p.poll() is None:
                    p.kill()
            sys.stderr.write(f"child {rank} rc={proc.returncode}\n"
                             f"{out[-2000:]}\n{err[-4000:]}\n")
            continue
        reports.append(json.loads(lines[-1]))
    ok = (ok and len(reports) == NUM_PROCESSES and all(r["ok"] for r in reports)
          and len({r["checksum"] for r in reports}) == 1
          and len({r["pid"] for r in reports}) == NUM_PROCESSES)
    return ok, reports


def main(device=None) -> int:
    from mppi_playground_tpu_torch.parallel.mesh import device_of_ranks

    device = device_of_ranks(device, NUM_PROCESSES).type
    for attempt in range(ATTEMPTS):
        ok, reports = _run_once(device)
        if ok:
            break
        sys.stderr.write(f"attempt {attempt} failed\n")
    print(json.dumps({"check": "multihost_dryrun", "ok": ok, "num_processes": NUM_PROCESSES,
                      "device": device, "reports": reports}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Two-process bootstrap dry run.")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        _child(args.device)
    else:
        sys.exit(main(args.device))
