#!/usr/bin/env python3
"""Drive the port's paths on one NVIDIA GPU and check every CUDA kernel against its twin.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of ``mppi_playground_tpu_torch/csrc`` with ``nvcc``
   (one process per source, started together), and the exhaustive sweeps of
   ``csrc/exact_checks.cu``, each bit for bit: every float32 input of
   ``angle_normalize`` against its ``fmodf`` form; the Box–Muller radius
   against ``sqrtf(-2 logf(u1))`` on all 2^24 values of u1; the cell index
   from the reciprocal against the IEEE division's on every float32
   position, at the racing and Navigation2D maps' geometry and at
   :data:`OTHER_CELL_SIZES`; and the device key's advance (the device
   ``tick_seed``) against the host's on 4,100 keys (:func:`key_sweep`);
3. hold racing's kernels against their plain PyTorch twins on the card, at
   the flagship's shapes (T=50, K=100,000): the fused solve with injected
   noise and with its seeded Philox stream, the re-roll, and the tick's
   tail on each fused route's partials (fixed lambda, standalone,
   epilogue), the SG filter off and on, eagerly and from a CUDA graph
   replayed twice, bit for bit; then time each kernel (graph replay) and
   twin (CUDA events), the tail beside the tail without its weights plus
   the weights as torch ops, and beside ``combine_partials`` then the
   re-roll;
4. the auto-lambda kernels against their twins at the same shapes: phase 1
   (costs and perturbation dump, both noise modes), the ESSPS and LBPS
   searches (on the flagship's costs and on vectors that reach each ESSPS
   clamp and the interior), phase 2 at lambda* and, at lambda=1, against
   the fixed solve's partials; each timed, phase 2 beside ``torch.softmax``
   then ``torch.mv`` of the dump;
5. the weighted update (D=100 at lambda 1 and 10 on the unfused route's
   perturbations and costs; D=100, 1,536 and 2,000 under spread costs; and
   every (K, D) an unfused path of phases 7, 8 and 11 launches) against its
   twin, the block partials and the combined output each held to a bar,
   and against phase 2 on the same perturbations (the same statistics bit
   for bit, the numerators to the partials bar); regeneration of all K
   rows, seeded and in noise mode, against phase 1's dump (bitwise) and of
   the top 300 rows against those rows, and the top 300 rows regenerated
   and rolled out against their twin (bitwise); each timed, the weighted
   update at
   each width and shape beside its bound and ``torch.softmax`` then
   ``torch.mv``, at D=100 also with a cold L2; 5b, the racing reference
   rows' kernel (:func:`check_reference_rows`): ``calc_ref_trajectory`` (the
   kernel at B=1) and ``calc_ref_trajectory_batch`` at B=32 against their
   torch ops on the same card tensors at T=25 and 50, rows and indices bit
   for bit, one launch a call, timed by graph replay beside the torch ops
   and the bound; every racing path of phases 6-15 counts the kernel once
   a tick; 5c, the racing plant's kernel (:func:`check_racing_plant`):
   ``RacingEnv.dynamics`` against ``models/bicycle.make_dynamics``'s torch
   ops on the same card tensors (:func:`racing_plant_inputs`: rows at and
   beyond the map's edges, headings at and beyond +-pi, speeds at and beyond
   +-V_MAX, actions beyond their clamps, NaN and infinite entries) at R = 1,
   32 and 4,000, from an expanded state and the columns of a sequence of
   actions, under ``torch.func.vmap`` at B=8 x K=4,096 and from a CUDA graph
   replayed with new inputs, bit for bit and NaN where they give NaN, one
   launch a call; timed by graph replay at each R beside the torch ops and
   the bound; every racing path of phases 6-15 counts its launches: one a
   plant step (eager, or in the fleet's and the episodes' graphs), 2T a
   solve on the unfused route (the rollout, the nominal re-roll), T a
   posterior of ``get_samples_from_posterior``; 5d, the MPCC stage cost's
   kernel (:func:`check_mpcc_cost`): ``make_mpcc_cost`` against
   ``make_mpcc_cost_plain``'s torch ops on the same card tensors
   (:func:`mpcc_cost_inputs`: each map's first and last cells, half-cell
   boundaries, positions far off the maps, NaN and infinite entries) at R =
   1, 32 and 4,000 on the racing maps and on two maps of other rasters, from
   an expanded state and every column of a sequence of actions, under
   ``torch.func.vmap`` at B=8 x K=4,096 (each scenario its own reference) and
   from a CUDA graph replayed with new inputs, bit for bit and NaN where they
   give NaN, one launch a call; timed by graph replay at each R beside the
   torch ops and the bound; every racing path of phases 6-15 counts its
   launches: T+1 a solve on the unfused route, none on the fused one;
6. drive the flagship, ``build_flagship(device="cuda")``, at its fixed
   lambda and under ESSPS, LBPS and MPO (the solver's default lambda route),
   and ESSPS and LBPS forced onto the lambda epilogue and onto the
   standalone search, for 50 closed-loop ticks of ``RacingEnv.step`` each,
   every launch counter set to 0 just before each mode and read just after:
   each kernel of the mode's path launched once a tick and every other
   kernel never, lambda in bounds, actions in bounds, progress, and one
   solve per mode with no host sync
   (``torch.cuda.set_sync_debug_mode("error")``); then a profile and the
   modes' ticks timed in turns; 6b, the graft entry
   (:func:`drive_entry`): ``graft_entry_torch.entry()`` with no arguments,
   its first tick bit for bit the fixed-lambda flagship tick on the same
   state, seed and ``cind``, then five chained ticks of its ``fn`` under
   the device trace, rows 1 and 2 once a tick;
7. drive ``RacingController(env)`` on its unfused route (the default) and
   its fused route (``store_rollouts=False``) at T=25, K=4,000 and at T=50,
   K=100,000: 50 ticks each of ``update``, ``env.step`` and
   ``get_top_samples(300)``, counted as in phase 6, one tick with no host
   sync, the median update and ``get_top_samples`` times and a profile;
8. drive ``MPPI`` on both routes at a fixed lambda and under ESSPS with the
   SG filter: 10 ``forward`` calls with the racing dynamics and the MPCC
   cost, then ``get_top_samples(50)`` and ``get_samples_from_posterior``,
   counted;
9. every other model family's kernels against their twins at its example's
   configuration (Navigation2D also at K=100,000): the fused solve, phase 1,
   phase 1 with the lambda epilogue, phase 2, regeneration, 300 rows
   regenerated and rolled out, and the re-roll, seeded and in noise mode,
   and the tick's tail on each route as in phase 3, each timed;
10. the lambda epilogue (phase 1 and the search in one launch, run by the
    last cluster) against phase 1 then the search kernel, costs, dump,
    lambda* and the ticket bitwise in both noise modes, under ESSPS and
    LBPS: racing and Navigation2D at each K of ``ROUTE_SAMPLES``
    (3,000-100,000), every other family at its example's configuration, and
    Navigation2D at K=524,288, the epilogue's gate, under ESSPS; the routes
    timed in turns (standalone, epilogue, epilogue, standalone), and the
    epilogue's phase-1 part (no bisection steps) beside phase 1 alone; the
    K at which the epilogue was no slower in every case; each epilogue
    kernel's registers and spills;
11. every model family's closed loops (``MODEL_PATHS``): through ``MPPI``
    (the default lambda route), and through ``make_fused_solver`` where a
    path forces the lambda epilogue or the standalone search: Navigation2D
    to its goal on both lambda routes and unfused (and at K=100,000), the
    danger zone's 100-step episode, the pendulum upright after 200 steps,
    the classic models fused and unfused; counted, one fused tick with no
    host sync, medians of ``forward`` and ``get_top_samples``, a profile of
    the Navigation2D tick;
12. the closed loops on the card (:func:`drive_closed_loops`): 50 flagship
    ticks as one replayed CUDA graph (``make_closed_loop``, the plant
    ``RacingEnv.dynamics``) at fixed lambda, under MPO and under ESSPS on
    both lambda routes, each bit for bit 50 eager ticks, its replays counted
    (each kernel of the route 50 times) with any host sync an error, timed
    (amortized tick and ticks/s, capture time, the device-busy share of an
    episode from the profiler); ``RacingController.update`` replayed from its graph against the
    eager tick on both routes at T=25, K=4,000 and T=50, K=100,000 (two
    replays draw different streams, each its eager tick's;
    ``get_top_samples(300)`` after them; the medians of both in turns); a
    moved map version recaptures; ``RacingController.run_episode`` on both
    routes with the racing example's goal ``done_fn`` and ``MPPI.run_episode``
    (Navigation2D to its goal, the pendulum upright after 200 ticks) bit
    for bit as many ``update``/``forward`` calls; ``PipelinedRunner`` at
    depth 1 and 2 bit for bit ``make_pipelined_closed_loop``;
13. the fleet (:func:`drive_fleets`): the racing fleet of
    ``benchmarks/fleet.py`` (T=25, K=4,096, σ=(0.5, 0.1), λ=1, the plant
    ``RacingEnv.dynamics``, the scenarios staggered along the path, each
    one's reference rows from ``calc_ref_trajectory_batch``) at B=8, 32 and
    128 for 50 ticks through ``make_batched_fused_solver`` and
    ``make_fleet_closed_loop``, each bit for bit its B independent
    ``make_closed_loop`` episodes (xs, us, final states and keys), its
    replays counted in the device trace (each batched kernel once a tick,
    not B times) with any host sync an error, and timed (solves/s, amortized
    tick, capture, device-busy share) in turns with the same scenarios as B
    single solves a tick in one graph (``scenario_by_scenario``, the JAX
    package's ``lax.map`` form); the MPO, ESSPS and LBPS fleets at B=32 and
    every other family's fleet (fixed λ and ESSPS, B=8, 10 ticks) the same
    way; the batched launches (rows 1, 2, 3, 5, 7 and 8 for racing at
    B=128; rows 1, 2 and 3 of every other family at B=8) bit for bit their
    single launches in both noise modes and at their twins' bars, timed by
    graph replay in turns with their B single launches beside the batched
    launch's bound (the shared grids read once), each kernel's row of the
    kernels line holding its batched launch as ``batched``; and the utils on the flagship: ``checked_solve`` raising
    the JAX message after a plant that turns the state into NaN,
    ``time_fn`` beside :func:`graph_ms`, and an episode saved after 25
    ticks, restored and run on bit for bit the uninterrupted one;
14. sample sharding (:func:`drive_sharding`): rows 1, 3 and 5 launched shard
    by shard at D = 2, 4 and 8 (``parallel/sharded.shard_size`` samples from
    each shard's offset, the inheritance threshold in a later shard), at the
    flagship and on a B=8 fleet launch, in both noise modes, concatenated and
    sliced to K bit for bit the whole launch, D=2's last shard against its
    twins; ``make_sharded_fused_solver`` on the one-rank group
    ``initialize_distributed`` makes for a CUDA device (``cpu:gloo,cuda:nccl``),
    50 flagship ticks at fixed λ, MPO and ESSPS bit for bit
    ``make_fused_solver``'s, counted, the host-driven tick in turns with the
    single solver, the replayed episode (NCCL's collectives captured) bit for
    bit and in turns, and the sharded state through the directory checkpoint
    with and without ``wait``, bit for bit; two gloo ranks sharing the card,
    five sharded flagship ticks bit for bit the single solve on both ranks, a
    capture raising ``closed_loop.CAPTURABLE``;
15. the examples on the card (:func:`drive_examples`): each script of
    ``mppi_playground_tpu_torch/examples`` through its ``main`` on ``cuda``,
    headless, at its own configuration for a few steps: the default route,
    ``--fused`` where the script has it, ``--episode`` where it has it, and
    racing's ``--pipelined 2``; each run under the device trace, every
    counter set to 0 before it, the kernels it ran held to the route's
    (:data:`EXAMPLE_RUNS`), its average solve time printed; the mujoco
    script and ``make_media`` where gymnasium (and mujoco) are installed,
    else their solvers a few ticks against their own dynamics; then the
    pendulum's ``--episode`` at its configuration ends upright
    (:data:`PENDULUM_EPISODE_THETA_BOUND`) and the pipelined-quality bounds
    hold (:func:`pipelined_quality`);
16. a user's own model on the fused kernels (:func:`drive_plugs`): the
    JAX package's user-defined tasks as ``ModelPlug`` s (:func:`every_plug`:
    the linear task at n=3 and m=1-4, the toy with its target table, the
    quad, the speed-tracking bicycle of ``benchmarks/scaling.py``), each
    unit built from its source at once, each build's seconds printed; every
    plug's rows 1, 3, 4 (ESSPS and LBPS), 5, 6 and 2 against their twins in
    both noise modes at T=50, K=98,304 (:func:`check_task_kernels`), timed
    beside their bounds, rows 1 and 3 per action slot; each plug's fused
    routes, counted (:func:`plug_routes`); the bicycle through
    ``MPPI(kernel_backend="auto", fused_task=...)`` at fixed λ, MPO and
    ESSPS and on the λ epilogue, 5 replayed ticks bit for bit the eager ones,
    ``get_top_samples(300)``, and a 50-tick ``make_closed_loop`` episode
    bit for bit 50 eager ticks (:func:`bicycle_paths`); and a plug's tail and
    re-roll past 48 KB of shared memory (:func:`wide_prepare_tails`).

Every kernel is timed as the device time of launches replayed in a CUDA
graph (:func:`graph_ms`; the event loop beside it).  It prints each TPU
kernel row's launches x (time - bound) over the run's paths, a ``kernels``
JSON line before the last (every kernel, each launched on some path but
:data:`OFF_PATHS`, or the run fails), and as its last line ``{"ok": true,
"device": {...}}``.  Without a card, or without the package beside it, it
exits non-zero and prints no result.  It fails if jax or the JAX package
was imported (:func:`foreign_modules`), checked after the port and
``graft_entry_torch`` are imported and again after the last phase.

To compare two trees, run ``python3 chip_smoke.py`` in each, in turns, and
compare the two ``kernels`` lines.  :func:`chain_bounds` derives rows 2 and
6's latency bounds from this tree's SASS.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# The peaks, the racing model's operation counts and the bounds of rows 1, 3, 4, 7, 8
# and 9; the bounds of the other kernels are below.
from portbench.bounds import (
    OPS_BICYCLE,
    OPS_ESSPS_EVAL,
    OPS_LBPS_EVAL,
    OPS_NORMAL_PAIR,
    OPS_PERTURB,
    OPS_SCALE,
    OPS_SINCOS,
    PEAK_BYTES_PER_S,  # noqa: F401  (the tests' bounds read it here)
    RACING,
    ModelOps,
    _bound,
    phase1_bound_ms,
    search_bound_ms,
    search_ops,
    solve_bound_ms,
    weighted_update_bound_ms,
)

T, K = 50, 100_000
TICKS = 50
# A trace lost the first device activities after its start (even 1 s after it),
# so each begins with PRIMING_KERNELS empty kernels and a marker kernel, which
# must be seen, and keeps TRACE_MARGIN_S of idle time at each end.
PRIMING_KERNELS = 200
TRACE_MARGIN_S = 0.2
SEED = 0

AUTO_MODES = ("ESSPS", "LBPS", "MPO")  # the solver's default lambda route
# mode -> lambda_epilogue: a lambda route forced on make_fused_solver
ROUTE_MODES = {"ESSPS epilogue": True, "LBPS epilogue": True, "ESSPS standalone": False,
               "LBPS standalone": False}
# K at which phase 10 times the two lambda routes in turns, racing and Navigation2D
ROUTE_SAMPLES = (3000, 10_000, 20_000, 30_000, K)


FUSED_SOLVE_PY = "mppi_playground_tpu/ops/fused_solve.py"
LAMBDA_SEARCH_PY = "mppi_playground_tpu/ops/lambda_search.py"


def kernel_row(name, source, replaces, err, ms, plain, bound, by, **extra) -> dict:
    """A kernel's entry of the kernels line (``library_ms`` None: no library call computes it)."""
    return {**dict(name=name, route="cuda", source=f"mppi_playground_tpu_torch/csrc/{source}",
                   replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                   bound_by=by, library_ms=None), **extra}


def device_seed(torch, word: int):
    """A kernel seed word on the card, as a solver passes it (its key's ``key[2:]``).

    A host int seed is filled into a tensor at every call, which would put a
    fill kernel into every timed graph.
    """
    from mppi_playground_tpu_torch.ops.fused_solve import _seed_tensor

    return _seed_tensor(word, torch.device("cuda"))


def foreign_modules(names) -> list:
    """The modules among ``names`` that the port must not import: jax and the JAX package."""
    return sorted(m for m in names if m.split(".")[0] in ("jax", "jaxlib", "mppi_playground_tpu"))


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# Counted from csrc/unicycle_model.cuh, danger_zone_model.cuh and
# classic_models.cuh as racing's from racing_model.cuh (libm sinf, cosf and
# sqrtf one operation each).
MODEL_OPS = {
    "racing": RACING,
    "navigation": ModelOps(3, 2, 0, 44, 19),
    "danger_zone": ModelOps(7, 2, 0, 26, 11),
    "pendulum": ModelOps(2, 1, 0, 13, 9),
    "cartpole": ModelOps(4, 1, 0, 32, 12),
    "mountain_car": ModelOps(2, 1, 0, 13, 3),
    "integrator": ModelOps(2, 2, 0, 2, 6),
}


def phase2_bound_ms(num_samples: int, horizon: int, m: int = 2) -> tuple:
    """Least time of auto-lambda phase 2: costs and dump read, the partials written.

    Operations per sample: -c / lambda, the max, the shift, exp, e * e and
    two sums, and e * pert summed into each of the T*m slots.
    """
    blocks = -(-num_samples // 256)
    in_bytes = 4 * (num_samples * (1 + m * horizon) + 1)
    out_bytes = 4 * blocks * (3 + m * horizon)
    return _bound(in_bytes, out_bytes, num_samples * (7 + 2 * m * horizon))


def reroll_bound_ms(horizon: int, ops: ModelOps = RACING) -> tuple:
    in_bytes = 4 * (ops.n + ops.m * horizon + ops.n * (horizon + 1))
    return _bound(in_bytes, 0, horizon * ops.step)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean time per call over ``reps`` back-to-back calls, by CUDA events.

    Below ~0.05 ms a kernel's calls wait on the host's launches, so this
    reads the launch rate; :func:`graph_ms` is the device's time.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int) -> tuple:
    """``(graph-replay ms, event-loop ms)`` per call: :func:`graph_ms`, :func:`cuda_ms`."""
    return graph_ms(torch, fn, reps), cuda_ms(torch, fn, reps)


def profile_ticks(torch, run_tick, ticks: int, what: str = "with env.step") -> str:
    """Where a tick's time goes: device busy share and kernels by device time.

    ``torch.profiler`` over ``ticks`` calls of ``run_tick()``, one closed-loop
    tick each; the device time is the sum of the kernels' durations on the
    one stream.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        t0 = time.perf_counter()
        for _ in range(ticks):
            run_tick()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
        time.sleep(TRACE_MARGIN_S)
    activities = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not activities:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy_us = sum(e.time_range.elapsed_us() for e in activities)
    # device time by the host operation that launched it (aten ops, our two wrappers'
    # kernels appear under their own names)
    ops = sorted(
        (e for e in prof.key_averages() if e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )[:8]
    return (
        f"profile ({ticks} ticks {what}): wall {wall_us / ticks:.1f} us/tick, device "
        f"busy {busy_us / ticks:.1f} us/tick ({100 * busy_us / wall_us:.1f}%), "
        f"{len(activities) / ticks:.1f} device activities/tick; by self device time: "
        + "; ".join(f"{e.key[:48]} {e.self_device_time_total / ticks:.1f} us x{e.count / ticks:g}"
                    for e in ops)
    )


def check_auto_kernels(torch, fused_solve, x0, prev, noise, xref5, task, seed, sig, u_min,
                       u_max, grid_bytes, card):
    """Phase 4: hold phase 1, the searches and phase 2 against their twins; time them.

    Returns ``{"kernels": [...]}`` for the kernels line, or None after a failure.
    """
    from mppi_playground_tpu_torch.ops import lambda_search
    from mppi_playground_tpu_torch.ops.weighted_update import combine_partials

    def phase1(fn, mode_noise):
        return fn(x0, prev, seed, xref5, task, sig, u_min, u_max, K, K, mode_noise)

    p1_err = 0.0
    for mode, nz in (("noise", noise), ("seeded", None)):
        costs, dump = phase1(fused_solve.fused_costs_dump, nz)
        w_costs, w_dump = phase1(fused_solve.fused_costs_dump_plain, nz)
        torch.cuda.synchronize()
        rel = ((costs - w_costs).abs() / w_costs.abs()).max().item()
        res = dict(cost_max_abs_err=(costs - w_costs).abs().max().item(), cost_max_rel_err=rel,
                   costs_bitwise_equal=bool(torch.equal(costs, w_costs)),
                   dump_max_abs_err=(dump - w_dump).abs().max().item(),
                   dump_bitwise_equal=bool(torch.equal(dump, w_dump)))
        print(f"phase 1 vs twin ({mode}, T={T}, K={K}): {json.dumps(res)}", flush=True)
        p1_err = max(p1_err, res["cost_max_abs_err"], res["dump_max_abs_err"])
        if not (rel <= 1e-5 and res["dump_bitwise_equal"]):
            fail(f"phase 1 ({mode}) off the bar: costs rtol 1e-5, dump bitwise")
            return None
    # phase 1's seeded outputs feed the searches and phase 2
    target, lam_min, lam_max, delta = K / 10.0, 0.01, 10.0, 0.01
    rng = torch.Generator(device="cuda").manual_seed(SEED)
    spike = torch.full((K,), 1e6, device="cuda")
    spike[0] = 0.0
    vectors = {
        "flagship": costs,
        "to_min": torch.arange(K, device="cuda", dtype=torch.float32) * 1e-9,
        "to_max": spike,
        "interior": torch.rand(K, generator=rng, device="cuda") * 20.0,
    }
    search_err = {"essps": 0.0, "lbps": 0.0}
    lam_star = None
    for name, c in vectors.items():
        ge = lambda_search.essps_lambda_fused(c, target, lam_min, lam_max)
        we = lambda_search.essps_lambda_plain(c, target, lam_min, lam_max)
        gl = lambda_search.lbps_lambda_fused(c, delta, lam_min, lam_max)
        wl = lambda_search.lbps_lambda_plain(c, delta, lam_min, lam_max)
        pen = lambda_search.lbps_range_penalty(c, delta)
        f_g = lambda_search.lbps_objective_plain(c, gl, pen).item()
        f_w = lambda_search.lbps_objective_plain(c, wl, pen).item()
        ge, we, gl, wl = ge.item(), we.item(), gl.item(), wl.item()
        search_err["essps"] = max(search_err["essps"], abs(ge - we))
        search_err["lbps"] = max(search_err["lbps"], abs(gl - wl))
        print(f"lambda search vs twin ({name}, K={K}): ESSPS {ge!r} vs {we!r}; LBPS {gl!r} vs "
              f"{wl!r}, objective {f_g!r} vs {f_w!r}", flush=True)
        if not (abs(ge - we) <= 1e-6 + 1e-4 * abs(we) and abs(gl - wl) <= 1e-4 + 1e-3 * abs(wl)
                and abs(f_g - f_w) <= 1e-5 * abs(f_w)):
            fail(f"lambda search ({name}) off the bar: ESSPS rtol 1e-4 atol 1e-6, LBPS rtol "
                 "1e-3 atol 1e-4, LBPS objective rtol 1e-5")
            return None
        clamp = {"to_min": lam_min, "to_max": lam_max}.get(name)
        if clamp is not None and ge != torch.tensor(clamp).item():
            fail(f"ESSPS on {name} returned {ge!r}, not the clamp {clamp}")
            return None
        if name == "flagship":
            lam_star = lambda_search.essps_lambda_fused(c, target, lam_min, lam_max).reshape(1)

    got = fused_solve.fused_weighted(costs, dump, lam_star)
    want = fused_solve.fused_weighted_plain(costs, dump, lam_star)
    g = combine_partials(costs, *got, lam_star, T, 2)
    w = combine_partials(costs, *want, lam_star, T, 2)
    p2_err = max((got[0] - want[0]).abs().max().item(), (got[1] - want[1]).abs().max().item())
    res = dict(partials_max_abs_err=p2_err,
               partials=partials_errors(torch, got, want, costs, dump.t(), lam_star),
               weights_max_abs_err=(g[1] - w[1]).abs().max().item(),
               update_max_abs_err=(g[0] - w[0]).abs().max().item(), ess=(g[2].item(), w[2].item()),
               lam_star=lam_star.item())
    print(f"phase 2 vs twin at lambda* (T={T}, K={K}): {json.dumps(res)}", flush=True)
    if not (res["partials"]["ok"] and res["weights_max_abs_err"] <= 1e-5
            and res["update_max_abs_err"] <= 5e-3
            and abs(res["ess"][0] - res["ess"][1]) <= 1e-3 * abs(res["ess"][1])):
        fail(f"phase 2 off the bar: partials {PARTIALS_BAR}; weights atol 1e-5, update atol "
             "5e-3, ESS rtol 1e-3")
        return None
    one = torch.ones(1, device="cuda")
    fixed = fused_solve.fused_solve(x0, prev, one, seed, xref5, task, sig, u_min, u_max,
                                           K, K, None)
    stats, numer = fused_solve.fused_weighted(costs, dump, one)
    same = all(torch.equal(a, b) for a, b in ((fixed[0], costs), (fixed[1], stats),
                                               (fixed[2], numer)))
    print(f"phase 1 + phase 2 at lambda=1 vs the fixed solve: bitwise={same}", flush=True)
    if not same:
        fail("phase 1 + phase 2 at lambda=1 differ from the fixed solve's costs and partials")
        return None

    # timings: kernel and twin, on this card
    flag = vectors["flagship"]
    t_p1, t_p1_loop = device_ms(torch, lambda: phase1(fused_solve.fused_costs_dump, None), 20)
    t_p1_noise, _ = device_ms(torch, lambda: phase1(fused_solve.fused_costs_dump, noise), 20)
    t_p1_plain = cuda_ms(torch, lambda: phase1(fused_solve.fused_costs_dump_plain, None),
                         3, warmup=1)
    t_es, t_es_loop = device_ms(torch, lambda: lambda_search.essps_lambda_fused(
        flag, target, lam_min, lam_max), 50)
    t_es_plain = cuda_ms(torch, lambda: lambda_search.essps_lambda_plain(flag, target, lam_min,
                                                                         lam_max), 3, warmup=1)
    t_lb, t_lb_loop = device_ms(torch, lambda: lambda_search.lbps_lambda_fused(
        flag, delta, lam_min, lam_max), 50)
    t_lb_plain = cuda_ms(torch, lambda: lambda_search.lbps_lambda_plain(flag, delta, lam_min,
                                                                        lam_max), 3, warmup=1)
    t_p2, t_p2_loop = device_ms(torch, lambda: fused_solve.fused_weighted(costs, dump, lam_star),
                                50)
    t_p2_plain = cuda_ms(torch, lambda: fused_solve.fused_weighted_plain(costs, dump, lam_star),
                         5, warmup=1)
    # one library pair for row 5's function: the weights, then the dump times them
    t_p2_library = graph_ms(torch, lambda: torch.mv(dump, torch.softmax(-costs / lam_star, 0)),
                            50)
    b_p1, by_p1 = phase1_bound_ms(K, T, True, grid_bytes)
    b_p1_noise, _ = phase1_bound_ms(K, T, False, grid_bytes)
    b_es, by_es = search_bound_ms(K, 40, OPS_ESSPS_EVAL, 2)
    b_lb, by_lb = search_bound_ms(K, 32, OPS_LBPS_EVAL, 2)
    b_p2, by_p2 = phase2_bound_ms(K, T)
    print(f"times on {card} (graph replay; event loop in brackets): phase 1 {t_p1:.4f} ms "
          f"({t_p1_loop:.4f}; noise mode {t_p1_noise:.4f} ms, bound {b_p1:.5f} / "
          f"{b_p1_noise:.5f} ms), twin {t_p1_plain:.3f} ms; ESSPS search {t_es:.4f} ms "
          f"({t_es_loop:.4f}; bound {b_es:.5f} ms), twin {t_es_plain:.3f} ms; LBPS search "
          f"{t_lb:.4f} ms ({t_lb_loop:.4f}; bound {b_lb:.5f} ms), twin {t_lb_plain:.3f} ms; "
          f"phase 2 {t_p2:.4f} ms ({t_p2_loop:.4f}; bound {b_p2:.5f} ms), twin {t_p2_plain:.3f} "
          f"ms, torch.softmax + torch.mv {t_p2_library:.4f} ms", flush=True)

    return {"kernels": [
        kernel_row("racing_costs_dump", "fused_racing.cu", f"{FUSED_SOLVE_PY}:783", p1_err, t_p1,
                   t_p1_plain, b_p1, by_p1, noise_mode_ms=t_p1_noise,
                   noise_mode_bound_ms=b_p1_noise, launch_loop_ms=t_p1_loop),
        kernel_row("essps_lambda_fused", "lambda_search.cu", f"{LAMBDA_SEARCH_PY}:354",
                   search_err["essps"], t_es, t_es_plain, b_es, by_es, launch_loop_ms=t_es_loop),
        kernel_row("lbps_lambda_fused", "lambda_search.cu", f"{LAMBDA_SEARCH_PY}:394",
                   search_err["lbps"], t_lb, t_lb_plain, b_lb, by_lb, launch_loop_ms=t_lb_loop),
        kernel_row("fused_weighted", "fused_solve.cu", f"{FUSED_SOLVE_PY}:887", p2_err, t_p2,
                   t_p2_plain, b_p2, by_p2, launch_loop_ms=t_p2_loop, library_ms=t_p2_library),
    ]}


def mode_solvers(env, task, flagship_solver, flagship_tick) -> dict:
    """``{mode: (solver, tick)}``: the flagship as built, and under each auto-lambda mode.

    The auto-lambda solvers are built as ``benchmarks/autolambda_flagship.py``
    builds them: the flagship's config with ``lambda_`` replaced.
    """
    from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
    from mppi_playground_tpu_torch.models.racing_mpcc import calc_ref_trajectory

    path = env.racing_center_path
    solvers = {"fixed": (flagship_solver, flagship_tick)}
    for mode in AUTO_MODES + tuple(ROUTE_MODES):
        cfg = dataclasses.replace(flagship_solver.config, lambda_=mode.split()[0])
        solver = make_fused_solver(cfg, task, env.dynamics, device="cuda",
                                   lambda_epilogue=ROUTE_MODES.get(mode))

        def tick(state, cind, x, solver=solver, horizon=cfg.horizon):
            xref, new_cind = calc_ref_trajectory(x, path, cind, horizon)
            result = solver.solve(state, x, info={"reference_path": xref})
            return result.action_seq, result.state_seq, result.state, new_cind

        solvers[mode] = (solver, tick)
    return solvers


def launch_counters(plugs=()) -> dict:
    """Every kernel, by name: ``{name: (wrapper, key)}``; the bundled models' and
    those of ``plugs``, the ``ModelPlug`` objects given.

    The fused-solve wrappers count their launches in a Counter under each
    kernel's name (``key``); the search, weighted-update, reference-rows,
    racing-plant and MPCC-cost wrappers, one kernel each, in an int (``key``
    None).
    """
    from mppi_playground_tpu_torch.ops import (
        fused_solve,
        lambda_search,
        mpcc_cost,
        racing_plant,
        reference_rows,
        weighted_update,
    )

    counted = {}
    for wrapper in fused_solve.WRAPPERS:
        for name in fused_solve.kernel_names(wrapper, plugs):
            counted[name] = (wrapper, name)
    for search in (lambda_search.essps_lambda_fused, lambda_search.lbps_lambda_fused):
        counted[search.__name__] = (search, None)
    counted["weighted_update_partials"] = (weighted_update.weighted_update_partials, None)
    counted["reference_rows"] = (reference_rows.reference_rows, None)
    counted["racing_plant"] = (racing_plant.racing_plant, None)
    counted["mpcc_cost"] = (mpcc_cost.mpcc_cost, None)
    return counted


# the racing reference rows' kernel: once a tick on every racing path, which computes the
# tick's rows through models/racing_mpcc.calc_ref_trajectory(_batch)
REFERENCE_ROWS = frozenset({"reference_rows"})
# the racing plant's kernel: once a step of RacingEnv.dynamics (env.step, a closed loop's
# plant, each step of the unfused route's rollout and nominal re-roll)
RACING_PLANT = frozenset({"racing_plant"})
# the unfused route's MPCC cost: T+1 launches a solve (models/racing_mpcc.make_mpcc_cost on the
# card), none on the fused route
MPCC_COST = frozenset({"mpcc_cost"})


def racing_plant_launches(ticks: int, horizon: int, unfused: bool, steps: int) -> int:
    """The racing plant's launches over ``ticks`` solves and ``steps`` plant steps: 2T a
    solve on the unfused route (its rollout and its nominal re-roll), none on the fused one
    (its kernels roll out the model themselves), one a step."""
    return ticks * 2 * horizon * unfused + steps


def fused_kernels(name, config, lambda_epilogue=None) -> set:
    """The kernels one fused tick of ``config`` and its get_top_samples launch once each.

    The lambda route is the solver's own choice
    (``core.fused_solver.takes_lambda_epilogue``).
    """
    from mppi_playground_tpu_torch.core.fused_solver import takes_lambda_epilogue

    tail = {f"{name}_tick_tail", f"{name}_top_rollouts"}
    lam = config.auto_lambda
    if lam in ("ESSPS", "LBPS"):
        if takes_lambda_epilogue(config, lambda_epilogue):
            return tail | {f"{name}_costs_dump_lambda", "fused_weighted"}
        return tail | {f"{name}_costs_dump", "fused_weighted", f"{lam.lower()}_lambda_fused"}
    return tail | {f"{name}_fused_solve"}


def read_counters(counted: dict) -> dict:
    """``{kernel: launches}`` now."""
    return {name: (fn.launches[key] if key else fn.launches) for name, (fn, key) in counted.items()}


def zero_counters(plugs=()) -> dict:
    """Set every launch count to 0; returns :func:`launch_counters` of ``plugs``."""
    counted = launch_counters(plugs)
    for fn, key in counted.values():
        if key is None:
            fn.launches = 0
        else:
            fn.launches.clear()
    return counted


# The kernel functions of csrc/ in a profiler's (demangled) kernel names, and the launch
# counters they belong to; longer names first where one begins another
KERNEL_FUNCTIONS = (
    ("costs_dump_lambda_kernel<", "costs_dump_lambda"), ("costs_dump_kernel<", "costs_dump"),
    ("fused_solve_kernel<", "fused_solve"), ("tick_tail_kernel<", "tick_tail"),
    ("reroll_kernel<", "reroll"), ("regen_rollout_kernel<", "top_rollouts"),
)
KERNEL_MODELS = (
    ("racing::", "racing"), ("unicycle::NavigationModel", "navigation"),
    ("danger_zone::", "danger_zone"), ("classic::Pendulum", "pendulum"),
    ("classic::Cartpole", "cartpole"), ("classic::MountainCar", "mountain_car"),
    ("classic::Integrator", "integrator"),
)


def counter_of(kernel: str, plugs=()):
    """The launch counter of a device kernel named in a profiler trace; None for torch's own.

    A kernel of a user's model plug is named by its struct, one of ``plugs``.
    """
    for function, counter in (("weighted_update_kernel<", "weighted_update_partials"),
                              ("weighted_kernel(", "fused_weighted"),
                              ("search_kernel<false>", "essps_lambda_fused"),
                              ("search_kernel<true>", "lbps_lambda_fused"),
                              ("reference_rows_kernel(", "reference_rows"),
                              ("racing_plant_kernel(", "racing_plant"),
                              ("mpcc_cost_kernel(", "mpcc_cost")):
        if function in kernel:
            return counter
    for function, suffix in KERNEL_FUNCTIONS:
        if function in kernel:
            model_arg = kernel[kernel.index(function) + len(function):].split(",")[0]
            for m in (1, 2):
                if model_arg.startswith(f"fused::ActionsOnly<{m}>"):
                    return f"fused_regen_m{m}"
            for prefix, model in KERNEL_MODELS:
                if model_arg.startswith(prefix):
                    return f"{model}_{suffix}"
            struct = model_arg.split(">")[0].strip()
            for plug in plugs:
                if struct == plug.struct.lstrip(":"):
                    return f"{plug.name}_{suffix}"
            raise ValueError(f"kernel {kernel!r}: no launch counter for its model")
    return None


@dataclasses.dataclass
class Trace:
    """The device's side of a traced run: ``{counter: kernels run}``, busy time, activities."""

    launches: dict
    busy_us: float
    activities: int
    sequence: list  # our kernels' counters in the order the device started them
    skew_ms: float  # a marker kernel's start in the trace less its launch on the host clock


def traced(torch, fn, no_sync: bool = False, plugs=()):
    """``fn()`` under ``torch.profiler``'s device trace -> ``(fn's result, Trace)``.

    The trace sees every kernel the device ran, eager launches and the
    replays of a CUDA graph alike (no wrapper counts a replay: the graph
    launches its kernels itself); :func:`counter_of` names each of ours
    (and of ``plugs``, the user's model plugs ``fn`` drives).  The priming and marker kernels before ``fn`` are left out of the
    result.  With ``no_sync`` any host sync inside ``fn`` raises.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_start = time.perf_counter()
        for _ in range(PRIMING_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
        t_mark = time.perf_counter() - t_start
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        if no_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("torch.profiler recorded no device activity")
    events.sort(key=lambda e: e.time_range.start)
    marks = [e for e in events if "spin_kernel" in e.name]
    if not marks or abs(marks[-1].time_range.start / 1e3 - 1e3 * t_mark) > 1e3 * TRACE_MARGIN_S:
        raise RuntimeError("the device trace lost its marker kernel: it may have lost others")
    skew_ms = marks[-1].time_range.start / 1e3 - 1e3 * t_mark
    events = [e for e in events if "spin_kernel" not in e.name]
    sequence = [c for c in (counter_of(e.name, plugs) for e in events) if c is not None]
    launches = {}
    for counter in sequence:
        launches[counter] = launches.get(counter, 0) + 1
    return out, Trace(launches, sum(e.time_range.elapsed_us() for e in events), len(events),
                      sequence, skew_ms)


def path_launches(label: str, counted: dict, traces: list, want: dict):
    """A path's launches, each seen on the device, or None after a failure.

    Every counter was set to 0 just before the path, whose runs that launch
    kernels were each traced (:func:`traced`, ``traces``); the counters are
    read now.  The device must have run each kernel as often as ``want``
    says (0 where it says nothing); each wrapper must have counted a launch
    of each kernel of the path (an eager tick; a CUDA graph's capture and
    replays count nothing), and never more than the device ran.
    """
    device = {name: sum(t.launches.get(name, 0) for t in traces) for name in counted}
    want = {name: want.get(name, 0) for name in counted}
    wrappers = read_counters(counted)
    uncounted = sorted(name for name in counted if want[name] and not wrappers[name])
    over = sorted(name for name in counted if wrappers[name] > device[name])
    if device != want or uncounted or over:
        def nonzero(d):
            return {k: v for k, v in d.items() if v}

        letters = {name: chr(ord("A") + i) for i, name in enumerate(sorted(set(
            n for t in traces for n in t.sequence)))}
        fail(f"{label}: kernels run on the device {nonzero(device)}, expected {nonzero(want)}; "
             f"wrappers' counts {nonzero(wrappers)} (none for {uncounted}, more than the "
             f"device ran for {over}); marker skews {[t.skew_ms for t in traces]} ms; the device's "
             f"order {letters}: "
             + " | ".join("".join(letters[n] for n in t.sequence) for t in traces))
        return None
    return device


def drive_modes(torch, fused_solve, env, solvers, card):
    """Phase 6: 50 closed-loop flagship ticks under each mode, every kernel counted.

    ``solvers`` is :func:`mode_solvers`'s.  Before each mode every launch
    counter is set to 0, and they are read after its last tick.  Returns
    ``{mode: {"launches", "median_ms", "tick", "init", "state", "cind", "x"}}``
    or None after a failure.
    """
    from mppi_playground_tpu_torch.models.racing_mpcc import calc_ref_trajectory

    counted = launch_counters()
    path = env.racing_center_path
    out = {}
    for mode, (solver, tick) in solvers.items():
        cfg = solver.config
        # one solve with any host sync made an error
        state = solver.init()
        x = env.reset()
        xref, _ = calc_ref_trajectory(x, path, torch.tensor(0, device=x.device), cfg.horizon)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            solver.solve(state, x, info={"reference_path": xref})
        except RuntimeError as err:
            fail(f"{mode}: a solve synchronized with the host: {err}")
            return None
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()

        zero_counters()
        state = solver.init()
        x = env.reset()
        cind = torch.tensor(0, device=x.device)
        tick_ms, lams = [], []
        for _ in range(TICKS):
            t0 = time.perf_counter()
            action_seq, state_seq, state, cind = tick(state, cind, x)
            torch.cuda.synchronize()
            tick_ms.append(1e3 * (time.perf_counter() - t0))
            lam = state.lam.item()
            lams.append(lam)
            if mode == "fixed":
                in_range = lam == torch.tensor(cfg.lambda_).item()
            elif mode == "MPO":
                in_range = lam > 0
            else:
                in_range = cfg.lambda_min <= lam <= cfg.lambda_max
            if not (torch.isfinite(action_seq).all() and torch.isfinite(state_seq).all()
                    and lam == lam and abs(lam) != float("inf") and in_range):
                fail(f"{mode}: a tick returned non-finite actions or states, or lambda {lam!r}")
                return None
            excess = torch.maximum(env.u_min - action_seq, action_seq - env.u_max).max().item()
            if excess > 1e-5:
                fail(f"{mode}: actions outside [u_min, u_max] by {excess!r}")
                return None
            x, _ = env.step(action_seq[0])
        launches = read_counters(counted)
        once = (fused_kernels("racing", cfg, ROUTE_MODES.get(mode)) - {"racing_top_rollouts"}
                | REFERENCE_ROWS | RACING_PLANT)  # the plant: env.step
        want = {name: (TICKS if name in once else 0) for name in counted}
        if launches != want:
            fail(f"{mode}: launches {launches}, expected {want}")
            return None
        progress = int(cind)
        if progress <= 0 or not torch.isfinite(x).all():
            fail(f"{mode}: the car made no progress along the track (index {progress})")
            return None
        median = statistics.median(tick_ms)
        print(f"flagship {mode}: {TICKS} ticks at T={T}, K={K} on {card}: median tick "
              f"{median:.3f} ms (host clock, synchronized), min {min(tick_ms):.3f} ms; "
              f"lambda first/last {lams[0]!r}/{lams[-1]!r}, range "
              f"[{min(lams)!r}, {max(lams)!r}]; track index {progress}; launches {launches}",
              flush=True)
        out[mode] = dict(launches=launches, median_ms=median, tick=tick, init=solver.init,
                         state=state, cind=cind, x=x)
    return out


def ticks_in_turns(torch, env, runners, windows: int = 10, per_window: int = 10) -> dict:
    """Median host-clock tick per mode, the modes timed in turns.

    ``runners`` maps a mode to ``(tick, init)``.  Each mode keeps its own
    state and car (advanced by the dynamics, without ``env.step``'s goal
    check); window after window every mode runs ``per_window`` ticks, so all
    of them meet the same drift of the host.
    """
    x0 = env.reset()
    runs = {m: [init(), torch.tensor(0, device=x0.device), x0]
            for m, (_, init) in runners.items()}
    times = {m: [] for m in runners}
    for _ in range(windows):
        for mode, (tick, _) in runners.items():
            state, cind, x = runs[mode]
            for _ in range(per_window):
                t0 = time.perf_counter()
                action_seq, _, state, cind = tick(state, cind, x)
                torch.cuda.synchronize()
                times[mode].append(1e3 * (time.perf_counter() - t0))
                x = env.dynamics(x[None], action_seq[:1])[0]
            runs[mode] = [state, cind, x]
    return {m: statistics.median(t) for m, t in times.items()}


ENTRY_TICKS = 5  # the graft entry's chained ticks, traced
# rows 1 and 2 and the reference rows, once a tick
ENTRY_KERNELS = ("racing_fused_solve", "racing_tick_tail", "reference_rows")


def drive_entry(torch, flagship_tick, card):
    """Phase 6b: the graft entry, ``graft_entry_torch.entry()`` with no arguments.

    Its first tick is held bit for bit against ``flagship_tick`` (phase 6's
    fixed-lambda tick, K=100,000, T=50) on the same state, seed, ``cind``
    and start; then ``fn`` runs :data:`ENTRY_TICKS` chained ticks under the
    device trace, every counter set to 0 just before: each tick launches
    rows 1 and 2 and the reference rows (:data:`ENTRY_KERNELS`) once and no
    other kernel of ours.
    Returns ``{"launches", "build_s", "seconds"}``, or None after a failure.
    """
    import graft_entry_torch

    t0 = time.perf_counter()
    fn, args = graft_entry_torch.entry()
    build_s = time.perf_counter() - t0
    state, cind, x = args
    if not (x.is_cuda and cind.is_cuda and state.previous_action_seq.is_cuda):
        fail("entry(): its example arguments are not on the card")
        return None
    want = flagship_tick(state, cind, x)

    def ticks():
        out, s, c = [], state, cind
        for _ in range(ENTRY_TICKS):
            action_seq, state_seq, s, c = fn(s, c, x)
            out.append((action_seq, state_seq, s, c))
        torch.cuda.synchronize()
        return out

    counted = zero_counters()
    outs, trace = traced(torch, ticks)
    launches = path_launches("entry()", counted, [trace],
                             {name: ENTRY_TICKS for name in ENTRY_KERNELS})
    if launches is None:
        return None
    if not _bitwise(outs[0], want):
        fail("entry(): its first tick is not the flagship phase's tick bit for bit")
        return None
    for action_seq, state_seq, _, c in outs:
        if not (action_seq.shape == (T, 2) and state_seq.shape == (T + 1, 4)
                and torch.isfinite(action_seq).all() and torch.isfinite(state_seq).all()
                and int(c) >= 0):
            fail(f"entry(): a tick gave shapes {tuple(action_seq.shape)}, "
                 f"{tuple(state_seq.shape)} or non-finite values")
            return None
    print(f"graft entry on {card}: graft_entry_torch.entry() built in {build_s:.2f} s; its "
          f"first tick bit for bit the flagship's; {ENTRY_TICKS} ticks traced, "
          f"{json.dumps({name: n for name, n in launches.items() if n})}", flush=True)
    return dict(launches=launches, build_s=build_s, seconds=time.perf_counter() - t0)


def entry_alone() -> int:
    """Phase 6b alone, after the build: ``python3 -c 'import sys, chip_smoke;
    sys.exit(chip_smoke.entry_alone())'``."""
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mppi_playground_tpu_torch.ops import cuda_build
    from mppi_playground_tpu_torch.workloads import build_flagship

    card = card_line()
    print(card, flush=True)
    print(f"build: {cuda_build.build():.1f} s", flush=True)
    _, _, tick = build_flagship(horizon=T, num_samples=K, device="cuda")
    return 1 if drive_entry(torch, tick, card) is None else 0


def regen_bound_ms(rows: int, horizon: int, seeded: bool, m: int = 2) -> tuple:
    """Least time of regenerating ``rows`` samples: [rows, T, m] written.

    Reads the warm start and the row indices, and in noise mode those rows'
    noise; per slot its share of a normal pair (seeded), the scale and the
    perturb.
    """
    slots = m * horizon
    in_bytes = 4 * slots + 8 * rows + (0 if seeded else 4 * rows * slots)
    per_slot = OPS_PERTURB // 2 + ((OPS_NORMAL_PAIR + OPS_SCALE) // 2 if seeded else 0)
    return _bound(in_bytes, 4 * rows * slots, rows * slots * per_slot)


def top_rollouts_bound_ms(rows: int, horizon: int, seeded: bool, ops: ModelOps = RACING) -> tuple:
    """Least time of regenerating ``rows`` samples and rolling them out: [rows, T+1, n] written.

    Reads x0, the warm start and the row indices, and in noise mode those
    rows' noise; per row its T m draws (as :func:`regen_bound_ms` counts
    them) and T model steps.
    """
    slots = ops.m * horizon
    in_bytes = 4 * (ops.n + slots) + 8 * rows + (0 if seeded else 4 * rows * slots)
    per_slot = OPS_PERTURB // 2 + ((OPS_NORMAL_PAIR + OPS_SCALE) // 2 if seeded else 0)
    return _bound(in_bytes, 4 * rows * (horizon + 1) * ops.n,
                  rows * (slots * per_slot + horizon * ops.step))


PARTIALS_BAR = ("block maxima bitwise, sums of e and e^2 rtol 1e-6, each numerator within "
                "1e-5 of its sum of |e * sample|")


def partials_errors(torch, got, want, costs, samples, lam) -> dict:
    """Block partials against the twin's, each error over its own scale.

    The block maxima of ``-c / lambda`` are one IEEE division and a max, so
    they must be equal.  The sums of e and e^2 hold the block maximum's
    e = 1, so they are at least 1 and are compared relatively.  A numerator
    sums e * sample over 256 rows: its rounding is bounded by its sum of
    ``|e * sample|`` (the twin's partials of ``|samples|``), which keeps a
    dropped row visible wherever it carries weight.  ``samples`` is ``[K, D]``.
    """
    from mppi_playground_tpu_torch.ops.weighted_update import block_partials_plain

    scale = block_partials_plain(costs, samples.abs(), lam)[1]
    (g_stats, g_numer), (w_stats, w_numer) = got, want
    res = dict(
        maxima_bitwise=bool(torch.equal(g_stats[:, 0], w_stats[:, 0])),
        sums_max_rel_err=((g_stats[:, 1:] - w_stats[:, 1:]).abs() / w_stats[:, 1:]).max().item(),
        numer_max_err_over_scale=((g_numer - w_numer).abs() / (scale + 1e-30)).max().item(),
    )
    res["ok"] = (res["maxima_bitwise"] and res["sums_max_rel_err"] <= 1e-6
                 and res["numer_max_err_over_scale"] <= 1e-5)
    return res


def cold_graph_ms(torch, fn, reps: int, flush) -> float:
    """Device ms of one call of ``fn`` with a cold L2, the mean of ``reps``.

    ``flush`` (past the 50 MB L2) is zeroed before each call, outside the
    timed events; the call is a one-call CUDA graph, enqueued while the
    flush still runs, so no host gap enters the time.
    """
    graph, _ = captured(torch, fn, 1)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


WEIGHTED_UPDATE_WIDTHS = (100, 1536, 2000)  # D: the flagship's unfused width, the JAX gate, past it


def unfused_shapes() -> list:
    """``(K, D)`` of every weighted update an unfused path of this script launches.

    ``RacingController`` at its defaults (T=25, K=4,000) and ``MPPI`` at the
    same size (phases 7 and 8), the racing flagship's width (T=50,
    K=100,000), and each unfused path of :data:`MODEL_PATHS` at its
    example's configuration (``D = T * m``).
    """
    from mppi_playground_tpu_torch.workloads import MODEL_CONFIGS

    shapes = {(4000, 2 * 25), (K, 2 * T)}
    for name, _, kw, _ in MODEL_PATHS:
        if kw.get("unfused"):
            horizon, k = MODEL_CONFIGS[name][:2]
            shapes.add((kw.get("num_samples", k), horizon * MODEL_OPS[name].m))
    return sorted(shapes)


def weighted_update_vs_twin(torch, label, costs, samples, lam: float):
    """Row 9 against its twin on one input; the result, or None after a failure.

    The block partials are held to ``PARTIALS_BAR``; merged by
    ``combine_partials``, the weights to atol 1e-5, the update to atol 5e-3
    and the ESS to rtol 1e-3.
    """
    from mppi_playground_tpu_torch.ops import weighted_update as wu

    lam_t = torch.full((1,), lam, device=costs.device)
    slots = samples.shape[1]
    got = wu.weighted_update_partials(costs, samples, lam_t)
    want = wu.block_partials_plain(costs, samples, lam_t)
    g = wu.combine_partials(costs, *got, lam_t, slots, 1)
    w = wu.combine_partials(costs, *want, lam_t, slots, 1)
    torch.cuda.synchronize()
    res = dict(partials_max_abs_err=max((got[0] - want[0]).abs().max().item(),
                                        (got[1] - want[1]).abs().max().item()),
               partials=partials_errors(torch, got, want, costs, samples, lam_t),
               weights_max_abs_err=(g[1] - w[1]).abs().max().item(),
               update_max_abs_err=(g[0] - w[0]).abs().max().item(),
               ess=(g[2].item(), w[2].item()))
    print(f"weighted update vs twin ({label}): {json.dumps(res)}", flush=True)
    if not (res["partials"]["ok"] and res["weights_max_abs_err"] <= 1e-5
            and res["update_max_abs_err"] <= 5e-3
            and abs(res["ess"][0] - res["ess"][1]) <= 1e-3 * abs(res["ess"][1])):
        fail(f"weighted update ({label}) off the bar: partials {PARTIALS_BAR}; weights atol "
             "1e-5, update atol 5e-3, ESS rtol 1e-3")
        return None
    return res


def check_weighted_update(torch, fused_solve, pert, costs, dump_costs, dump, card):
    """Row 9: the kernel against its twin and phase 2; timed at each width and path shape.

    ``pert [K, T, 2]`` are the unfused route's clamped perturbations and
    ``costs`` theirs; ``dump_costs``/``dump`` phase 1's seeded outputs.
    The flagship's costs (about 1e5) leave a few rows with weight, so
    seeded normal samples of each width also run under spread costs
    (uniform in [0, 100)), where many rows carry weight.  Then seeded
    samples under spread costs at every shape of :func:`unfused_shapes`
    (the 4-byte-load kernel where D % 4 != 0, narrow row groups, ragged
    last blocks).  Each width and shape is timed beside ``torch.softmax``
    then ``torch.mv`` on the same inputs, warm (repeated launches; at D=100
    the 40 MB of samples stay in the 50 MB L2); at D=100 also cold (L2
    flushed before each launch), the cache state of the byte bound, which
    is the row's ``ms``.  Returns the kernels-line row, or None after a
    failure.
    """
    from mppi_playground_tpu_torch.ops import weighted_update as wu

    dev = costs.device
    flat = pert.reshape(K, 2 * T).contiguous()
    rng = torch.Generator(device=dev).manual_seed(SEED + 9)
    spread = torch.rand(K, generator=rng, device=dev) * 100.0
    one = torch.ones(1, device=dev)
    err, times = 0.0, {}
    for slots in WEIGHTED_UPDATE_WIDTHS:
        wide = torch.randn(K, slots, generator=rng, device=dev)
        cases = [(f"D={slots}, spread costs, lambda=1", spread, wide, 1.0)]
        if slots == 2 * T:
            cases = [(f"D={slots}, lambda=1", costs, flat, 1.0),
                     (f"D={slots}, lambda=10", costs, flat, 10.0),
                     (f"D={slots}, spread costs, lambda=1", spread, flat, 1.0)] + cases
        for name, c, samples, lam in cases:
            res = weighted_update_vs_twin(torch, f"{name}, K={K}", c, samples, lam)
            if res is None:
                return None
            err = max(err, res["partials_max_abs_err"])
        x, c = (flat, costs) if slots == 2 * T else (wide, spread)

        def kernel(c=c, x=x):
            return wu.weighted_update_partials(c, x, one)

        def library(c=c, x=x):
            return torch.mv(x.t(), torch.softmax(-c / one, dim=0))

        times[slots] = dict(
            ms=graph_ms(torch, kernel, 50), library_ms=graph_ms(torch, library, 50),
            launch_loop_ms=cuda_ms(torch, kernel, 50),
            plain_ms=cuda_ms(torch, lambda: wu.block_partials_plain(c, x, one), 3, warmup=1),
            bound_ms=weighted_update_bound_ms(K, slots)[0])
        if slots == 2 * T:
            flush = torch.empty(32 * 1024 * 1024, device=dev)  # 128 MB
            times[slots].update(cold_ms=cold_graph_ms(torch, kernel, 20, flush),
                                cold_library_ms=cold_graph_ms(torch, library, 20, flush))
            del flush
        del wide
    # phase 2 and row 9 share the statistics' code; their numerators sum in other orders
    samples = dump.t().contiguous()
    for lam in (1.0, 10.0):
        lam_t = torch.full((1,), lam, device=dev)
        p2 = fused_solve.fused_weighted(dump_costs, dump, lam_t)
        r9 = wu.weighted_update_partials(dump_costs, samples, lam_t)
        res = partials_errors(torch, r9, p2, dump_costs, samples, lam_t)
        res["stats_bitwise"] = bool(torch.equal(p2[0], r9[0]))
        print(f"phase 2 vs the weighted update on the transposed dump (lambda={lam}): "
              f"{json.dumps(res)}", flush=True)
        if not (res["ok"] and res["stats_bitwise"]):
            fail(f"phase 2 and the weighted update differ on the same perturbations: statistics "
                 f"bitwise, partials {PARTIALS_BAR}")
            return None
    del samples

    at_paths = {}
    for k, slots in unfused_shapes():
        c = torch.rand(k, generator=rng, device=dev) * 100.0
        x = torch.randn(k, slots, generator=rng, device=dev)
        for lam in (1.0, 10.0):
            res = weighted_update_vs_twin(torch, f"K={k}, D={slots}, spread costs, lambda={lam:g}",
                                          c, x, lam)
            if res is None:
                return None
            err = max(err, res["partials_max_abs_err"])
        at_paths[f"K={k} D={slots}"] = dict(
            ms=graph_ms(torch, lambda c=c, x=x: wu.weighted_update_partials(c, x, one), 50),
            library_ms=graph_ms(torch, lambda c=c, x=x: torch.mv(x.t(), torch.softmax(-c / one,
                                                                                        dim=0)),
                                50),
            bound_ms=weighted_update_bound_ms(k, slots)[0])

    by = weighted_update_bound_ms(K, 2 * T)[1]
    print(f"times on {card}, weighted update at K={K} (device time of launches replayed in a "
          "CUDA graph, warm; cold: L2 flushed before each launch; launch loop: events around "
          "back-to-back wrapper calls): " + "; ".join(
              f"D={d}: {t['ms']:.4f} ms (launch loop {t['launch_loop_ms']:.4f} ms), bound "
              f"{t['bound_ms']:.5f} ms, softmax + mv {t['library_ms']:.4f} ms, twin "
              f"{t['plain_ms']:.3f} ms"
              + (f", cold {t['cold_ms']:.4f} ms (softmax + mv {t['cold_library_ms']:.4f} ms)"
                 if "cold_ms" in t else "")
              for d, t in times.items()), flush=True)
    print(f"times on {card}, weighted update at the unfused paths' shapes (graph replay, warm): "
          + "; ".join(f"{shape}: {t['ms']:.4f} ms, bound {t['bound_ms']:.6f} ms, softmax + mv "
                      f"{t['library_ms']:.4f} ms" for shape, t in at_paths.items()), flush=True)
    t100 = times[2 * T]
    return dict(name="weighted_update_partials", route="cuda",
                source="mppi_playground_tpu_torch/csrc/weighted_update.cu",
                replaces="mppi_playground_tpu/ops/pallas_kernels.py:142", max_abs_err=err,
                ms=t100["cold_ms"], plain_ms=t100["plain_ms"], bound_ms=t100["bound_ms"],
                bound_by=by, library_ms=t100["cold_library_ms"],
                library_calls="torch.softmax then torch.mv (2)", cache="cold (L2 flushed)",
                warm_ms=t100["ms"], warm_library_ms=t100["library_ms"],
                launch_loop_ms=t100["launch_loop_ms"], at_paths=at_paths,
                **{f"d{d}_{key}": value for d, t in times.items() if d != 2 * T
                   for key, value in t.items()})


def reference_rows_bound_ms(batch: int, points: int, rows: int) -> tuple:
    """Least time of the reference rows of ``batch`` states on a path of ``points`` points.

    Bytes: the path once (12 bytes a point), each state (16) and progress
    index (8), the ``rows`` lookahead offsets (8 each); each scenario's
    ``rows`` rows of 16 bytes and its index written.  Operations per state
    and point: two subtractions, two products, a sum and the root.
    """
    in_bytes = 12 * points + batch * (16 + 8) + 8 * rows
    out_bytes = batch * (16 * rows + 8)
    return _bound(in_bytes, out_bytes, 6 * batch * points)


REF_ROWS_FLEET_B = 32  # the fleet's batch (FLEET_T); the single call is the flagship's (T)


def reference_rows_inputs(torch, path, batch: int, seed: int) -> tuple:
    """``(states [batch, 4], cinds [batch])`` on ``path``'s device: states scattered about
    random points of the path, a third of the progress indices within 30 points of its end
    (rows clamped, the velocity column zeroed), the rest 0 or ahead of the state."""
    g = torch.Generator().manual_seed(seed)
    n = path.shape[0]
    near = path.cpu()[torch.randint(0, n, (batch,), generator=g)]
    xs = torch.empty(batch, 4)
    xs[:, :2] = near[:, :2] + 1.5 * torch.randn(batch, 2, generator=g)
    xs[:, 2] = near[:, 2] + 0.3 * torch.randn(batch, generator=g)
    xs[:, 3] = 5.0 * torch.rand(batch, generator=g)
    cinds = torch.randint(0, n, (batch,), generator=g)
    cinds[::2] = 0
    cinds[::3] = n - 1 - torch.randint(0, 30, (cinds[::3].shape[0],), generator=g)
    return xs.to(path.device), cinds.to(path.device)


def check_reference_rows(torch, env, card):
    """Phase 5b: the racing reference rows' kernel against its torch ops on the scene's circuit.

    ``calc_ref_trajectory`` (the kernel at B=1) on 16 states one at a time,
    and ``calc_ref_trajectory_batch`` on B=32 states, each at T=25 and 50,
    against ``calc_ref_trajectory_plain`` and ``calc_ref_trajectory_batch_plain``
    on the same card tensors (:func:`reference_rows_inputs`): rows and
    indices bit for bit, and one launch a call.  Then each timed by graph
    replay, as the torch ops are (their 17 kernels' device time), beside
    :func:`reference_rows_bound_ms`: the single call at the flagship's T
    (``ms``), the batch at the fleet's B and T (``batched``).  Returns the
    kernels-line row, or None after a failure.
    """
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory,
        calc_ref_trajectory_batch,
        calc_ref_trajectory_batch_plain,
        calc_ref_trajectory_plain,
    )
    from mppi_playground_tpu_torch.ops.reference_rows import reference_rows

    path = env.racing_center_path
    checked = 0
    for horizon in (FLEET_T, T):
        xs, cinds = reference_rows_inputs(torch, path, 16, SEED + horizon)
        for x, c in zip(xs, cinds):
            reference_rows.launches = 0
            got = calc_ref_trajectory(x, path, c, horizon)
            launches = reference_rows.launches
            want = calc_ref_trajectory_plain(x, path, c, horizon)
            if launches != 1 or not _bitwise(got, want):
                fail(f"reference rows, single call at T={horizon}: {launches} launches, or "
                     "rows or index not bit for bit the torch ops")
                return None
            checked += 1
        xs, cinds = reference_rows_inputs(torch, path, REF_ROWS_FLEET_B, SEED + 1 + horizon)
        reference_rows.launches = 0
        got = calc_ref_trajectory_batch(xs, path, cinds, horizon)
        launches = reference_rows.launches
        want = calc_ref_trajectory_batch_plain(xs, path, cinds, horizon)
        zeroed = int((got[0][:, 0, 3] == 0).sum())
        if launches != 1 or not _bitwise(got, want) or not 0 < zeroed < REF_ROWS_FLEET_B:
            fail(f"reference rows, B={REF_ROWS_FLEET_B} at T={horizon}: {launches} launches, "
                 f"rows or indices not bit for bit the torch ops, or {zeroed} velocity "
                 "columns zeroed (some and not all expected)")
            return None
        checked += REF_ROWS_FLEET_B
    n = path.shape[0]
    x, c = xs[0], cinds[0]
    ms = graph_ms(torch, lambda: calc_ref_trajectory(x, path, c, T), 200)
    plain_ms = graph_ms(torch, lambda: calc_ref_trajectory_plain(x, path, c, T), 50)
    bound, by = reference_rows_bound_ms(1, n, T + 1)
    xs, cinds = reference_rows_inputs(torch, path, REF_ROWS_FLEET_B, SEED)
    batched = dict(
        batch=REF_ROWS_FLEET_B, horizon=FLEET_T,
        ms=graph_ms(torch, lambda: calc_ref_trajectory_batch(xs, path, cinds, FLEET_T), 200),
        plain_ms=graph_ms(torch, lambda: calc_ref_trajectory_batch_plain(xs, path, cinds,
                                                                         FLEET_T), 50),
        bound_ms=reference_rows_bound_ms(REF_ROWS_FLEET_B, n, FLEET_T + 1)[0])
    print(f"reference rows on {card}, N={n}: {checked} states bit for bit the torch ops "
          f"(single calls and B={REF_ROWS_FLEET_B}, T={FLEET_T} and {T}; {zeroed} of the last "
          f"batch's velocity columns zeroed), one launch a call; graph replay: B=1 T={T} "
          f"{1e3 * ms:.3f} us (torch ops {1e3 * plain_ms:.3f} us, bound {1e3 * bound:.5f} us); "
          f"B={REF_ROWS_FLEET_B} T={FLEET_T} {1e3 * batched['ms']:.3f} us (torch ops "
          f"{1e3 * batched['plain_ms']:.3f} us, bound {1e3 * batched['bound_ms']:.5f} us)",
          flush=True)
    return kernel_row("reference_rows", "reference_rows.cu",
                      "mppi_playground_tpu/models/racing_mpcc.py calc_ref_trajectory (XLA ops)",
                      0.0, ms, plain_ms, bound, by, batched=batched, states_checked=checked)


def racing_plant_bound_ms(rows: int) -> tuple:
    """Least time of the racing plant's step on ``rows`` rows: each state (16 bytes) and action
    (8) read once and each next state (16) written; the bicycle step's operations a row."""
    return _bound(24 * rows, 16 * rows, OPS_BICYCLE * rows)


PLANT_ROWS = (1, REF_ROWS_FLEET_B, 4000)  # an eager plant step, the fleet's, the unfused K
PLANT_VMAP = (8, 4096)  # B x K of a vmapped call: an unfused racing fleet (FLEET_K)


def racing_plant_edges(x_lim, y_lim) -> list:
    """The plant's edge rows ``(x, y, theta, v, accel, steer)``: a position at each edge of
    the map, moving out, and one beyond two edges; headings at +-pi (float32's pi lies beyond
    pi) and beyond them; speeds at +-V_MAX, accelerating out, and beyond; accelerations and
    steers at and beyond their clamps; a NaN row and a NaN in each entry alone; an infinite
    position, heading and speed and infinite actions (an infinite speed at a heading whose
    cosine is 0: inf * 0 is NaN)."""
    import math

    from mppi_playground_tpu_torch.models import bicycle

    pi, v_max = math.pi, bicycle.V_MAX
    nan, inf = float("nan"), float("inf")
    (x_lo, x_hi), (y_lo, y_hi) = x_lim, y_lim
    return [
        (x_hi, 0.0, 0.0, 5.0, 0.0, 0.0), (x_lo, 0.0, pi, 5.0, 0.0, 0.0),
        (0.0, y_hi, pi / 2, 5.0, 0.0, 0.0), (0.0, y_lo, -pi / 2, 5.0, 0.0, 0.0),
        (x_hi + 3.0, y_lo - 3.0, 1.0, 2.0, 0.5, 0.1),
        (1.0, 2.0, -pi, 3.0, 0.0, 0.2), (1.0, 2.0, 3 * pi + 0.5, 3.0, 0.0, -0.2),
        (1.0, 2.0, -7.0, 3.0, 1.0, 0.1), (1.0, 2.0, pi - 1e-7, 6.0, 0.0, 0.25),
        (0.0, 0.0, 0.3, v_max, 2.0, 0.0), (0.0, 0.0, 0.3, -v_max, -2.0, 0.0),
        (0.0, 0.0, 0.3, v_max + 1.5, 0.0, 0.0), (0.0, 0.0, 0.3, -v_max - 1.5, 0.5, 0.0),
        (0.0, 0.0, 0.3, 1.0, 5.0, 0.25), (0.0, 0.0, 0.3, 1.0, -5.0, -0.9),
        (0.0, 0.0, 0.3, 1.0, -2.0, 0.9),
        (nan, nan, nan, nan, nan, nan),
        (nan, 1.0, 0.2, 2.0, 0.1, 0.1), (1.0, nan, 0.2, 2.0, 0.1, 0.1),
        (1.0, 1.0, nan, 2.0, 0.1, 0.1), (1.0, 1.0, 0.2, nan, 0.1, 0.1),
        (1.0, 1.0, 0.2, 2.0, nan, 0.1), (1.0, 1.0, 0.2, 2.0, 0.1, nan),
        (inf, -inf, 0.2, 2.0, 0.1, 0.1), (1.0, 1.0, inf, 2.0, 0.1, 0.1),
        (1.0, 1.0, pi / 2, inf, 0.1, 0.1), (1.0, 1.0, 0.2, -inf, inf, -inf),
    ]


def racing_plant_inputs(torch, rows: int, seed: int, x_lim, y_lim) -> tuple:
    """``(states [rows, 4], actions [rows, 2])`` on the CPU: the edge rows first
    (:func:`racing_plant_edges`), then rows drawn from the seed over and beyond the map and
    every clamp."""
    from mppi_playground_tpu_torch.models import bicycle

    v_max = bicycle.V_MAX
    (x_lo, x_hi), (y_lo, y_hi) = x_lim, y_lim
    edges = racing_plant_edges(x_lim, y_lim)
    g = torch.Generator().manual_seed(seed)
    drawn = torch.rand(max(rows - len(edges), 0), 6, generator=g)
    lo = torch.tensor([x_lo - 5.0, y_lo - 5.0, -4.0, -v_max - 1.0, -3.0, -0.4])
    hi = torch.tensor([x_hi + 5.0, y_hi + 5.0, 4.0, v_max + 1.0, 3.0, 0.4])
    table = torch.cat([torch.tensor(edges, dtype=torch.float32), lo + drawn * (hi - lo)])[:rows]
    return table[:, :4].contiguous(), table[:, 4:].contiguous()


def same_steps(torch, got, want) -> bool:
    """Next states equal bit for bit where ``want`` is a number, and NaN where it is NaN."""
    nan = torch.isnan(want)
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(torch.isnan(got), nan)
            and torch.equal(got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0)))


def check_racing_plant(torch, env, card):
    """Phase 5c: the racing plant's kernel against the torch ops of its step on the card.

    ``env.dynamics`` (the kernel) against ``models/bicycle.make_dynamics`` at the
    map's limits on the same card tensors (:func:`racing_plant_inputs`), next
    states bit for bit and NaN where they give NaN (:func:`same_steps`), one
    launch a call: at each R of :data:`PLANT_ROWS`; from ``x0.expand(K, 4)`` (row
    stride 0) and each column ``action_seqs[:, t]`` (row stride T m) of a
    sequence at T=25, K=4,000, as the unfused rollout steps; under
    ``torch.func.vmap`` at B x K = :data:`PLANT_VMAP`, on whole groups and from
    each scenario's expanded state and action columns (one launch for the B
    groups); and captured in a CUDA graph, replayed with new inputs.  Then each R
    timed by graph replay beside the torch ops (their kernels' device time) and
    :func:`racing_plant_bound_ms`.  Returns the kernels-line row, or None after a
    failure.
    """
    from mppi_playground_tpu_torch.models import bicycle
    from mppi_playground_tpu_torch.ops.racing_plant import racing_plant

    x_lim, y_lim = tuple(env.obstacle_map.x_lim), tuple(env.obstacle_map.y_lim)
    plain = bicycle.make_dynamics(x_lim, y_lim)

    def held(label, call, want, launches):
        racing_plant.launches = 0
        got = call()
        if racing_plant.launches != launches or not same_steps(torch, got, want):
            fail(f"racing plant, {label}: {racing_plant.launches} launches (want {launches}), "
                 "or the next states not bit for bit the torch ops")
            return False
        return True

    checked = 0
    for rows in PLANT_ROWS:
        xs, us = (t.cuda() for t in racing_plant_inputs(torch, rows, SEED + rows, x_lim, y_lim))
        if not held(f"R={rows}", lambda: env.dynamics(xs, us), plain(xs, us), 1):
            return None
        checked += rows
    horizon, rows = FLEET_T, PLANT_ROWS[-1]
    xs, _ = racing_plant_inputs(torch, rows, SEED, x_lim, y_lim)
    _, seqs = racing_plant_inputs(torch, rows * horizon, SEED + 1, x_lim, y_lim)
    x0, seqs = xs[-1].cuda(), seqs.reshape(rows, horizon, 2).cuda()
    for t in range(horizon):
        x = x0.expand(rows, 4)
        if not held(f"expanded state, column {t} of the actions", lambda: env.dynamics(
                x, seqs[:, t]), plain(x, seqs[:, t]), 1):
            return None
    checked += rows * horizon
    batch, per = PLANT_VMAP
    xs, us = (t.reshape(batch, per, -1).cuda() for t in racing_plant_inputs(
        torch, batch * per, SEED + 2, x_lim, y_lim))
    if not held(f"vmapped, B={batch} x K={per}", lambda: torch.func.vmap(env.dynamics)(xs, us),
                plain(xs.reshape(-1, 4), us.reshape(-1, 2)).reshape(batch, per, 4), 1):
        return None
    _, seqs = racing_plant_inputs(torch, batch * per * horizon, SEED + 3, x_lim, y_lim)
    seqs = seqs.reshape(batch, per, horizon, 2).cuda()
    for t in (0, horizon - 1):
        def vmapped(t=t):
            return torch.func.vmap(lambda x0, seq: env.dynamics(x0.expand(per, 4), seq[:, t]))(
                xs[:, 0], seqs)

        want = torch.stack([plain(xs[b, 0].expand(per, 4), seqs[b, :, t]) for b in range(batch)])
        if not held(f"vmapped from expanded states, column {t}", vmapped, want, 1):
            return None
    checked += 3 * batch * per
    static_x = torch.zeros(REF_ROWS_FLEET_B, 4, device="cuda")
    static_u = torch.zeros(REF_ROWS_FLEET_B, horizon, 2, device="cuda")
    graph, out = captured(torch, lambda: env.dynamics(static_x, static_u[:, 3]), 1)
    for seed in range(3):
        xs, us = racing_plant_inputs(torch, REF_ROWS_FLEET_B * (horizon + 1), SEED + 10 + seed,
                                     x_lim, y_lim)
        static_x.copy_(xs[:REF_ROWS_FLEET_B])
        static_u.copy_(us[:REF_ROWS_FLEET_B * horizon].reshape(REF_ROWS_FLEET_B, horizon, 2))
        graph.replay()
        torch.cuda.synchronize()
        if not same_steps(torch, out, plain(static_x, static_u[:, 3])):
            fail(f"racing plant: replay {seed} of a captured call not bit for bit the torch ops")
            return None
        checked += REF_ROWS_FLEET_B
    timed = {}
    for rows in PLANT_ROWS:
        xs, us = (t.cuda() for t in racing_plant_inputs(torch, rows, SEED + rows, x_lim, y_lim))
        bound, by = racing_plant_bound_ms(rows)
        timed[rows] = dict(ms=graph_ms(torch, lambda: env.dynamics(xs, us), 200),
                           plain_ms=graph_ms(torch, lambda: plain(xs, us), 50), bound_ms=bound,
                           bound_by=by)
    print(f"racing plant on {card}: {checked} rows bit for bit the torch ops (NaN where they "
          "give NaN; R = " + ", ".join(str(r) for r in PLANT_ROWS) + f", an expanded state and "
          f"{horizon} action columns at K={PLANT_ROWS[-1]}, vmapped at B={batch} x K={per}, a "
          "graph replayed), one launch a call; graph replay: " + "; ".join(
              f"R={r} {1e3 * t['ms']:.3f} us (torch ops {1e3 * t['plain_ms']:.3f} us, bound "
              f"{1e3 * t['bound_ms']:.5f} us, {t['bound_by']})" for r, t in timed.items()),
          flush=True)
    main = timed[PLANT_ROWS[-1]]
    return kernel_row("racing_plant", "racing_plant.cu",
                      "mppi_playground_tpu/models/bicycle.py make_dynamics (XLA ops)", 0.0,
                      main["ms"], main["plain_ms"], main["bound_ms"], main["bound_by"],
                      rows=PLANT_ROWS[-1], by_rows=timed, rows_checked=checked)


# Float operations a row of the MPCC stage cost (csrc/mpcc_cost.cu; counted as portbench/bounds.py
# counts): the path, velocity and input terms and the sums 31, each map's cell 6 and their sum and
# weight 2, and the reference yaw's sine and cosine
OPS_MPCC_COST = 31 + 2 * 6 + 2 + OPS_SINCOS
COST_ROWS = PLANT_ROWS  # a single row, the fleet's batch, the unfused K
COST_VMAP = PLANT_VMAP  # B x K of a vmapped call: an unfused racing fleet


def mpcc_cost_bound_ms(rows: int, groups: int = 1) -> tuple:
    """Least time of the MPCC stage cost on ``rows`` rows in ``groups`` groups: each state
    (16 bytes), action (8), previous action (8) and two grid cells (8) read once, each group's
    reference row (16) once, each cost (4) written; :data:`OPS_MPCC_COST` a row."""
    return _bound(40 * rows + 16 * groups, 4 * rows, OPS_MPCC_COST * rows)


def mpcc_cost_launches(ticks: int, horizon: int, unfused: bool) -> int:
    """The MPCC cost's launches over ``ticks`` solves: T+1 a solve on the unfused route (T
    stage costs and the terminal one), none on the fused one (its kernels cost in the
    rollout)."""
    return ticks * (horizon + 1) * unfused


def mpcc_cost_edges(x_lim, y_lim, cell: float) -> list:
    """The cost's edge rows ``(x, y, theta, v, u0, u1, p0, p1)`` on a map of ``cell`` whose
    cell 0 lies at the lower limits: the first and last cells of each axis, positions on the
    half-cell boundaries at and beyond both edges and at the centre, positions far off the map
    (past int64, at float32's largest), a NaN row and a NaN in each entry alone, infinite
    positions, speeds and actions (an infinite action less its infinite previous action is
    NaN)."""
    nan, inf, big = float("nan"), float("inf"), 3.0e38
    (x_lo, x_hi), (y_lo, y_hi) = x_lim, y_lim
    rows = [(x_lo, y_lo), (x_hi - cell, y_hi - cell), (x_lo, y_hi - cell), (x_hi - cell, y_lo),
            (x_lo + 0.5 * cell, 0.0), (x_lo - 0.5 * cell, 1.0), (x_lo - 1.5 * cell, 2.0),
            (x_hi - 0.5 * cell, 0.0), (x_hi + 0.5 * cell, -1.0), (0.0, y_lo + 0.5 * cell),
            (1.0, y_lo - 0.5 * cell), (2.0, y_hi - 0.5 * cell), (-3.0, y_hi - 1.5 * cell),
            (0.5 * cell, -0.5 * cell), (1.5 * cell, 2.5 * cell), (-2.5 * cell, 3.5 * cell),
            (x_lo - 0.4 * cell, y_lo - 0.6 * cell), (x_hi - 0.6 * cell, y_hi - 0.4 * cell),
            (1e10, 0.0), (0.0, -1e20), (big, -big), (x_hi + 1.0, y_lo - 1.0)]
    out = [(x, y, 0.3, 4.0, 0.5, -0.1, 0.2, 0.05) for x, y in rows]
    out += [
        (nan, nan, nan, nan, nan, nan, nan, nan),
        (nan, 1.0, 0.2, 2.0, 0.1, 0.1, 0.0, 0.0), (1.0, nan, 0.2, 2.0, 0.1, 0.1, 0.0, 0.0),
        (1.0, 1.0, nan, 2.0, 0.1, 0.1, 0.0, 0.0), (1.0, 1.0, 0.2, nan, 0.1, 0.1, 0.0, 0.0),
        (1.0, 1.0, 0.2, 2.0, nan, 0.1, 0.0, 0.0), (1.0, 1.0, 0.2, 2.0, 0.1, nan, 0.0, 0.0),
        (1.0, 1.0, 0.2, 2.0, 0.1, 0.1, nan, 0.0), (1.0, 1.0, 0.2, 2.0, 0.1, 0.1, 0.0, nan),
        (inf, 1.0, 0.2, 2.0, 0.1, 0.1, 0.0, 0.0), (1.0, -inf, 0.2, 2.0, 0.1, 0.1, 0.0, 0.0),
        (1.0, 1.0, inf, 2.0, 0.1, 0.1, 0.0, 0.0), (1.0, 1.0, 0.2, inf, 0.1, 0.1, 0.0, 0.0),
        (1.0, 1.0, 0.2, 2.0, inf, 0.1, 0.0, 0.0), (1.0, 1.0, 0.2, 2.0, 0.1, -inf, 0.0, inf),
        (1.0, 1.0, 0.2, 2.0, inf, 0.1, inf, 0.0),
    ]
    return out


def mpcc_cost_inputs(torch, rows: int, seed: int, x_lim, y_lim, cell: float) -> tuple:
    """``(states [rows, 4], actions [rows, 2], prev_actions [rows, 2])`` on the CPU: the edge
    rows first (:func:`mpcc_cost_edges`), then rows drawn from the seed over and beyond the map,
    the speed and the actions' clamps."""
    (x_lo, x_hi), (y_lo, y_hi) = x_lim, y_lim
    edges = mpcc_cost_edges(x_lim, y_lim, cell)
    g = torch.Generator().manual_seed(seed)
    drawn = torch.rand(max(rows - len(edges), 0), 8, generator=g)
    lo = torch.tensor([x_lo - 5.0, y_lo - 5.0, -4.0, -9.0, -3.0, -0.4, -3.0, -0.4])
    hi = torch.tensor([x_hi + 5.0, y_hi + 5.0, 4.0, 9.0, 3.0, 0.4, 3.0, 0.4])
    table = torch.cat([torch.tensor(edges, dtype=torch.float32), lo + drawn * (hi - lo)])[:rows]
    return table[:, :4].contiguous(), table[:, 4:6].contiguous(), table[:, 6:].contiguous()


def mpcc_reference_path(torch, rows: int, seed: int, x_lim, y_lim):
    """A reference path ``[rows, 4]`` (x, y, yaw, v) on the CPU: positions on the map, yaws
    at and beyond +-pi, the velocity column 0 or the speed limit, as the reference rows give
    it."""
    import math

    from mppi_playground_tpu_torch.models import bicycle

    (x_lo, x_hi), (y_lo, y_hi) = x_lim, y_lim
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(rows, 4, generator=g)
    path = torch.stack([x_lo + u[:, 0] * (x_hi - x_lo), y_lo + u[:, 1] * (y_hi - y_lo),
                        -4.0 + 8.0 * u[:, 2], (u[:, 3] < 0.8).float() * bicycle.V_MAX], dim=1)
    path[0, 2], path[-1, 2] = math.pi, -math.pi
    return path


def other_rasters(torch, seed: int, device):
    """Two grid maps on rasters of their own, unlike the racing maps and unlike each other:
    ``(obstacle, lane)`` of 300 x 200 cells of 0.25 m at origin (150, 60.5), and of a 500 x
    700 grid's transpose (strides (1, 700)) of 0.15 m cells at origin (350, 250); their cells
    0, 0.5 or 1."""
    from mppi_playground_tpu_torch.maps.grid_cost import GridMapData

    g = torch.Generator().manual_seed(seed)
    values = torch.tensor([0.0, 0.5, 1.0])
    first = values[torch.randint(0, 3, (300, 200), generator=g)]
    second = values[torch.randint(0, 3, (500, 700), generator=g)].to(device).t()
    return (GridMapData(first.to(device), torch.tensor([150.0, 60.5], device=device), 0.25),
            GridMapData(second, torch.tensor([350.0, 250.0], device=device), 0.15))


def check_mpcc_cost(torch, env, card):
    """Phase 5d: the MPCC stage cost's kernel against the torch ops of ``make_mpcc_cost`` on
    the card.

    ``make_mpcc_cost`` (the kernel) against ``make_mpcc_cost_plain`` on the
    same card tensors (:func:`mpcc_cost_inputs`: the maps' first and last
    cells, half-cell boundaries, far off-map positions, NaN and infinite
    entries), costs bit for bit and NaN where they give NaN
    (:func:`same_steps`), one launch a call: at each R of :data:`COST_ROWS`
    on the racing maps and on two maps of other rasters
    (:func:`other_rasters`); from ``x0.expand(K, 4)`` and each column of a
    sequence of actions at T=25, K=4,000, as the unfused rollout costs
    (the terminal cost on zeros); under ``torch.func.vmap`` at B x K =
    :data:`COST_VMAP`, each scenario against its own reference path (one
    launch for the B groups); and captured in a CUDA graph, replayed with
    new inputs.  Then each R timed by graph replay beside the torch ops and
    :func:`mpcc_cost_bound_ms`.  Returns the kernels-line row, or None after
    a failure.
    """
    from mppi_playground_tpu_torch.models.racing_mpcc import make_mpcc_cost, make_mpcc_cost_plain
    from mppi_playground_tpu_torch.ops.mpcc_cost import mpcc_cost

    x_lim, y_lim = tuple(env.obstacle_map.x_lim), tuple(env.obstacle_map.y_lim)
    cell = float(env.obstacle_cost_map.cell_size)
    horizon = FLEET_T
    path = mpcc_reference_path(torch, horizon + 1, SEED, x_lim, y_lim).cuda()
    rasters = {"racing maps": (env.obstacle_cost_map, env.lane_cost_map),
               "other rasters": other_rasters(torch, SEED, "cuda")}

    def inputs(rows, seed):
        return (t.cuda() for t in mpcc_cost_inputs(torch, rows, seed, x_lim, y_lim, cell))

    def held(label, call, want, launches):
        mpcc_cost.launches = 0
        got = call()
        if mpcc_cost.launches != launches or not same_steps(torch, got, want):
            fail(f"MPCC cost, {label}: {mpcc_cost.launches} launches (want {launches}), or the "
                 "costs not bit for bit the torch ops")
            return False
        return True

    checked = 0
    for name, maps in rasters.items():
        cost, plain = make_mpcc_cost(*maps), make_mpcc_cost_plain(*maps)
        for rows in COST_ROWS:
            xs, us, ps = inputs(rows, SEED + rows)
            for t in (0, 7, horizon):
                info = {"reference_path": path, "t": t, "prev_action": ps}
                if not held(f"{name}, R={rows}, t={t}", lambda: cost(xs, us, info),
                            plain(xs, us, ps, path[t]), 1):
                    return None
                checked += rows
    cost, plain = make_mpcc_cost(*rasters["racing maps"]), make_mpcc_cost_plain(
        *rasters["racing maps"])
    rows = COST_ROWS[-1]
    xs, _, _ = inputs(rows, SEED)
    _, seqs, _ = inputs(rows * horizon, SEED + 1)
    x0, seqs = xs[-1], seqs.reshape(rows, horizon, 2)
    for t in range(horizon + 1):
        u = seqs[:, t] if t < horizon else torch.zeros_like(seqs[:, 0])
        prev = seqs[:, max(t - 1, 0)] if t < horizon else seqs[:, max(horizon - 2, 0)]
        info = {"reference_path": path, "t": min(t, horizon - 1), "prev_action": prev}
        x = x0.expand(rows, 4)
        if not held(f"expanded state, column {t} of the actions", lambda: cost(x, u, info),
                    plain(x, u, prev, path[info["t"]]), 1):
            return None
    checked += rows * (horizon + 1)
    batch, per = COST_VMAP
    paths = torch.stack([mpcc_reference_path(torch, horizon + 1, SEED + 2 + b, x_lim, y_lim)
                         for b in range(batch)]).cuda()
    xs, us, ps = (t.reshape(batch, per, -1) for t in inputs(batch * per, SEED + 2))

    def on_groups(x, u, p, ref_path, t):
        return cost(x, u, {"reference_path": ref_path, "t": t, "prev_action": p})

    if not held(f"vmapped, B={batch} x K={per}",
                lambda: torch.func.vmap(lambda x, u, p, r: on_groups(x, u, p, r, 3))(
                    xs, us, ps, paths),
                torch.stack([plain(xs[b], us[b], ps[b], paths[b, 3]) for b in range(batch)]), 1):
        return None
    _, seqs, _ = inputs(batch * per * horizon, SEED + 3)
    seqs = seqs.reshape(batch, per, horizon, 2)
    for t in (0, horizon - 1):
        def vmapped(t=t):
            return torch.func.vmap(lambda x0, seq, r: on_groups(
                x0.expand(per, 4), seq[:, t], seq[:, max(t - 1, 0)], r, t))(xs[:, 0], seqs, paths)

        want = torch.stack([plain(xs[b, 0].expand(per, 4), seqs[b, :, t],
                                  seqs[b, :, max(t - 1, 0)], paths[b, t]) for b in range(batch)])
        if not held(f"vmapped from expanded states, column {t}", vmapped, want, 1):
            return None
    checked += 3 * batch * per
    static = [torch.zeros(REF_ROWS_FLEET_B, 4, device="cuda"),
              torch.zeros(REF_ROWS_FLEET_B, horizon, 2, device="cuda"),
              torch.zeros(horizon + 1, 4, device="cuda")]

    def static_call():
        return cost(static[0], static[1][:, 3], {"reference_path": static[2], "t": 3,
                                                 "prev_action": static[1][:, 2]})

    graph, out = captured(torch, static_call, 1)
    for seed in range(3):
        xs, us, _ = mpcc_cost_inputs(torch, REF_ROWS_FLEET_B * (horizon + 1), SEED + 10 + seed,
                                     x_lim, y_lim, cell)
        static[0].copy_(xs[:REF_ROWS_FLEET_B])
        static[1].copy_(us[:REF_ROWS_FLEET_B * horizon].reshape(REF_ROWS_FLEET_B, horizon, 2))
        static[2].copy_(mpcc_reference_path(torch, horizon + 1, SEED + 20 + seed, x_lim, y_lim))
        graph.replay()
        torch.cuda.synchronize()
        if not same_steps(torch, out, plain(static[0], static[1][:, 3], static[1][:, 2],
                                            static[2][3])):
            fail(f"MPCC cost: replay {seed} of a captured call not bit for bit the torch ops")
            return None
        checked += REF_ROWS_FLEET_B
    timed = {}
    for rows in COST_ROWS:
        xs, us, ps = inputs(rows, SEED + rows)
        info = {"reference_path": path, "t": 3, "prev_action": ps}
        bound, by = mpcc_cost_bound_ms(rows)
        timed[rows] = dict(ms=graph_ms(torch, lambda: cost(xs, us, info), 200),
                           plain_ms=graph_ms(torch, lambda: plain(xs, us, ps, path[3]), 50),
                           bound_ms=bound, bound_by=by)
    print(f"MPCC cost on {card}: {checked} rows bit for bit the torch ops (NaN where they give "
          "NaN; R = " + ", ".join(str(r) for r in COST_ROWS) + f" on the racing maps and on "
          f"other rasters, an expanded state and {horizon + 1} action columns at "
          f"K={COST_ROWS[-1]}, vmapped at B={batch} x K={per}, a graph replayed), one launch a "
          "call; graph replay: " + "; ".join(
              f"R={r} {1e3 * t['ms']:.3f} us (torch ops {1e3 * t['plain_ms']:.3f} us, bound "
              f"{1e3 * t['bound_ms']:.5f} us, {t['bound_by']})" for r, t in timed.items()),
          flush=True)
    main = timed[COST_ROWS[-1]]
    return kernel_row("mpcc_cost", "mpcc_cost.cu",
                      "mppi_playground_tpu/models/racing_mpcc.py make_mpcc_cost (XLA ops)", 0.0,
                      main["ms"], main["plain_ms"], main["bound_ms"], main["bound_by"],
                      rows=COST_ROWS[-1], by_rows=timed, rows_checked=checked)


def check_regen(torch, fused_solve, x0, prev, noise, xref5, task, seed, sig, u_min, u_max,
                weights, card):
    """Row 6 at T=50, K=100,000, seeded and in noise mode, against the twins.

    The actions-only kernel: all K rows against phase 1's dump, the top 300
    against them.  The top 300 rows regenerated and rolled out
    (``racing_top_rollouts``) against their twin, bit for bit.  Returns the
    kernels-line rows of both, or None after a failure.
    """
    from mppi_playground_tpu_torch.core.diagnostics import top_indices

    dev = x0.device
    threshold = int(0.8 * K)  # both sides of the inherit split
    rows = torch.arange(K, device=dev)
    top = top_indices(weights, 300)[1]
    err = top_err = 0.0
    for mode, nz in (("seeded", None), ("noise", noise)):
        args = (sig, u_min, u_max, K, threshold, nz)
        _, dump = fused_solve.fused_costs_dump(x0, prev, seed, xref5, task, *args)
        full = fused_solve.fused_regen(prev, seed, rows, *args)
        twin = fused_solve.fused_regen_plain(prev, seed, rows, *args)
        sub = fused_solve.fused_regen(prev, seed, top, *args)
        states = fused_solve.fused_top_rollouts(x0, prev, seed, top, task, *args)
        w_states = fused_solve.fused_top_rollouts_plain(x0, prev, seed, top, task, *args)
        torch.cuda.synchronize()
        res = dict(all_rows_vs_phase1_dump=bool(torch.equal(full, dump.t().reshape(K, T, 2))),
                   all_rows_vs_twin=bool(torch.equal(full, twin)),
                   max_abs_err=(full - twin).abs().max().item(),
                   top300_vs_all_rows=bool(torch.equal(sub, full[top])),
                   top_rollouts_vs_twin=bool(torch.equal(states, w_states)),
                   top_rollouts_max_abs_err=(states - w_states).abs().max().item())
        print(f"regeneration ({mode}, T={T}, K={K}): {json.dumps(res)}", flush=True)
        err = max(err, res["max_abs_err"])
        top_err = max(top_err, res["top_rollouts_max_abs_err"])
        if not all(v for k, v in res.items() if not k.endswith("max_abs_err")):
            fail(f"regeneration ({mode}) is not bit for bit the solve's perturbations, or the top "
                 "rows' roll-out not its twin's")
            return None
    args = (sig, u_min, u_max, K, threshold)
    t_all, t_all_loop = device_ms(torch, lambda: fused_solve.fused_regen(prev, seed, rows, *args),
                                  20)
    t_top, t_top_loop = device_ms(torch, lambda: fused_solve.fused_regen(prev, seed, top, *args),
                                  50)
    t_noise, _ = device_ms(torch, lambda: fused_solve.fused_regen(prev, seed, rows, *args, noise),
                           20)
    t_plain = cuda_ms(torch, lambda: fused_solve.fused_regen_plain(prev, seed, rows, *args), 3,
                      warmup=1)
    t_top_plain = cuda_ms(torch, lambda: fused_solve.fused_regen_plain(prev, seed, top, *args),
                          3, warmup=1)
    t_roll, t_roll_loop = device_ms(
        torch, lambda: fused_solve.fused_top_rollouts(x0, prev, seed, top, task, *args), 50)
    t_roll_noise, _ = device_ms(
        torch, lambda: fused_solve.fused_top_rollouts(x0, prev, seed, top, task, *args, noise), 50)
    t_roll_plain = cuda_ms(torch, lambda: fused_solve.fused_top_rollouts_plain(
        x0, prev, seed, top, task, *args), 3, warmup=1)
    b_roll, by_roll = top_rollouts_bound_ms(300, T, True)
    b_roll_noise, _ = top_rollouts_bound_ms(300, T, False)
    b_all, by_all = regen_bound_ms(K, T, True)
    b_top, by_top = regen_bound_ms(300, T, True)
    b_noise, _ = regen_bound_ms(K, T, False)
    print(f"times on {card} (graph replay): regeneration of all {K} rows {t_all:.4f} ms (bound "
          f"{b_all:.5f} ms, {by_all}; noise mode {t_noise:.4f} ms, bound {b_noise:.5f} ms), twin "
          f"{t_plain:.3f} ms; of the top 300 {t_top:.4f} ms (event loop {t_top_loop:.4f} ms; "
          f"bound {b_top:.6f} ms, {by_top}), twin {t_top_plain:.3f} ms; the top 300 rolled out "
          f"{t_roll:.4f} ms (event loop {t_roll_loop:.4f} ms; noise mode {t_roll_noise:.4f} ms; "
          f"bound {b_roll:.6f} ms, {by_roll}), twin {t_roll_plain:.3f} ms", flush=True)
    return [
        # all K rows: the unfused route's draw at the flagship's shape
        kernel_row("fused_regen_m2", "fused_solve.cu", f"{FUSED_SOLVE_PY}:937", err, t_all,
                   t_plain, b_all, by_all, rows=K, horizon=T, launch_loop_ms=t_all_loop,
                   noise_mode_ms=t_noise, noise_mode_bound_ms=b_noise, top_300_ms=t_top,
                   top_300_plain_ms=t_top_plain, top_300_bound_ms=b_top,
                   top_300_launch_loop_ms=t_top_loop),
        kernel_row("racing_top_rollouts", "reroll.cu", f"{FUSED_SOLVE_PY}:937", top_err, t_roll,
                   t_roll_plain, b_roll, by_roll, rows=300, horizon=T, num_samples=K,
                   launch_loop_ms=t_roll_loop, noise_mode_ms=t_roll_noise,
                   noise_mode_bound_ms=b_roll_noise),
    ]


FACADE_ROUTES = (
    ("T=25 K=4000 unfused", dict()),
    ("T=25 K=4000 fused", dict(store_rollouts=False)),
    ("T=50 K=100000 unfused", dict(horizon=50, num_samples=100_000)),
    ("T=50 K=100000 fused", dict(horizon=50, num_samples=100_000, store_rollouts=False)),
)


def drive_facades(torch, env, card):
    """Phase 7: ``RacingController`` on both routes at two widths, 50 ticks each.

    Each tick is ``update``, ``env.step`` and ``get_top_samples(300)``, as
    the racing example runs them.  A route's first update runs eagerly and
    captures the tick's graph; one replayed tick (without ``env.step``) runs
    under ``set_sync_debug_mode("error")``; then the 50 ticks, checked.  All
    of it runs under the device trace (:func:`traced`), every counter set to
    0 before and read after (:func:`path_launches`).  Then 50 more ticks,
    untraced and uncounted, give the medians (host clock, synchronized).
    Returns ``{route: {"launches", "tick_ms", "top_ms", "profile"}}`` or None.
    """
    from mppi_playground_tpu_torch.envs import RacingController

    out = {}
    for route, kw in FACADE_ROUTES:
        ctrl = RacingController(env, **kw)
        fused = "store_rollouts" in kw
        if ctrl.solver_backend != ("fused" if fused else "xla"):
            fail(f"{route}: RacingController took the {ctrl.solver_backend} route")
            return None
        def ticks():
            x = env.reset()
            ctrl.update(x)  # eager (builds the kernels, the lookahead table), then the capture
            ctrl.get_top_samples(300)
            ctrl.reset()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                ctrl.update(x)
                ctrl.get_top_samples(300)
            except RuntimeError as err:
                return f"a tick synchronized with the host: {err}"
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            ctrl.reset()
            x = env.reset()
            for _ in range(TICKS):
                action_seq, state_seq = ctrl.update(x)
                x, _ = env.step(action_seq[0])
                seqs, weights = ctrl.get_top_samples(300)
                excess = torch.maximum(env.u_min - action_seq,
                                       action_seq - env.u_max).max().item()
                if not (torch.isfinite(action_seq).all() and torch.isfinite(state_seq).all()
                        and torch.isfinite(seqs).all() and excess <= 1e-5
                        and seqs.shape == (300, ctrl.config.horizon + 1, 4)
                        and bool((weights[:-1] >= weights[1:]).all())):
                    return (f"non-finite output, actions out of bounds by {excess!r}, or top "
                            "samples not in descending weight order")
            return None

        counted = zero_counters()
        err, trace = traced(torch, ticks)
        if err is not None:
            fail(f"{route}: {err}")
            return None
        once = ({"racing_fused_solve", "racing_tick_tail", "racing_top_rollouts"} if fused
                else {"fused_regen_m2", "weighted_update_partials"}) | REFERENCE_ROWS
        want = {name: TICKS + 2 for name in once}
        want["racing_plant"] = racing_plant_launches(TICKS + 2, ctrl.config.horizon, not fused,
                                                     TICKS)
        want["mpcc_cost"] = mpcc_cost_launches(TICKS + 2, ctrl.config.horizon, not fused)
        launches = path_launches(f"RacingController {route}", counted, [trace], want)
        if launches is None:
            return None
        progress = int(ctrl.current_path_index)
        if progress <= 0:
            fail(f"{route}: the car made no progress along the track (index {progress})")
            return None
        tick_ms, top_ms = [], []
        ctrl.reset()
        x = env.reset()
        for _ in range(TICKS):
            t0 = time.perf_counter()
            action_seq, _ = ctrl.update(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            x, _ = env.step(action_seq[0])
            t2 = time.perf_counter()
            ctrl.get_top_samples(300)
            torch.cuda.synchronize()
            tick_ms.append(1e3 * (t1 - t0))
            top_ms.append(1e3 * (time.perf_counter() - t2))
        x = env.reset()

        def facade_tick(ctrl=ctrl):
            nonlocal x
            action_seq, _ = ctrl.update(x)
            x, _ = env.step(action_seq[0])
            ctrl.get_top_samples(300)

        prof = profile_ticks(torch, facade_tick, 5, "with env.step and get_top_samples(300)")
        res = dict(launches=launches, tick_ms=statistics.median(tick_ms),
                   top_ms=statistics.median(top_ms), profile=prof)
        print(f"RacingController {route} ({ctrl.solver_backend}): {TICKS} ticks on {card}: "
              f"median update {res['tick_ms']:.3f} ms, median get_top_samples(300) "
              f"{res['top_ms']:.3f} ms (host clock, synchronized, untraced); track index "
              f"{progress}; launches on the device {launches}; {prof}", flush=True)
        out[route] = res
    return out


def drive_mppi(torch, env, task, card):
    """Phase 8: ``MPPI`` on both routes, fixed lambda and ESSPS, 10 ``forward`` calls each.

    Racing dynamics and the MPCC cost through ``info``, T=25, K=4,000, the
    ESSPS runs with the SG filter on; then
    ``get_top_samples(50)`` and ``get_samples_from_posterior``.  Counters set
    to 0 before each run and read after.  Returns ``{run: launches}`` or None.
    """
    from mppi_playground_tpu_torch import MPPI
    from mppi_playground_tpu_torch.models.racing_mpcc import calc_ref_trajectory, make_mpcc_cost

    cost = make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map)
    calls, horizon = 10, 25
    out = {}
    for route in ("xla", "fused"):
        for mode in (1.0, "ESSPS"):
            kw = dict(horizon=horizon, num_samples=4000, dim_state=4, dim_control=2,
                      dynamics=env.dynamics, cost_func=cost, u_min=env.u_min, u_max=env.u_max,
                      sigmas=(0.5, 0.1), lambda_=mode, use_sg_filter=mode == "ESSPS",
                      device=env.device)
            if route == "fused":
                kw.update(fused_task=task, store_rollouts=False)
            c = MPPI(**kw)
            run = f"MPPI {route} {'fixed' if mode == 1.0 else 'ESSPS+SG'}"
            if c.solver_backend != route:
                fail(f"{run}: took the {c.solver_backend} route")
                return None
            counted = zero_counters()
            x = env.reset()
            cind = torch.tensor(0, device=x.device)
            for _ in range(calls):
                xref, cind = calc_ref_trajectory(x, env.racing_center_path, cind, horizon)
                action_seq, state_seq = c.forward(x, info={"reference_path": xref})
                x = env.dynamics(x[None], action_seq[:1])[0]
            seqs, weights = c.get_top_samples(50)
            samples, states = c.get_samples_from_posterior(action_seq, x, 100)
            launches = read_counters(counted)
            if route == "xla":
                want_once = {"fused_regen_m2": calls, "weighted_update_partials": calls}
            else:  # one top-samples call after the ticks
                want_once = {name: calls for name in fused_kernels("racing", c.config)}
                want_once["racing_top_rollouts"] = 1
            want_once["reference_rows"] = calls
            # the plant a call, and the posterior's states predicted from its 100 samples
            want_once["racing_plant"] = racing_plant_launches(calls, horizon, route == "xla",
                                                              calls) + horizon
            want_once["mpcc_cost"] = mpcc_cost_launches(calls, horizon, route == "xla")
            want = {name: want_once.get(name, 0) for name in counted}
            lam = c.lambda_
            ok = (torch.isfinite(action_seq).all() and torch.isfinite(seqs).all()
                  and seqs.shape == (50, horizon + 1, 4) and bool((weights[:-1] >= weights[1:]).all())
                  and samples.shape == (100, horizon, 2) and states.shape == (100, horizon + 1, 4)
                  and torch.isfinite(states).all() and 0.01 <= lam <= 10.0)
            print(f"{run}: {calls} forward calls, get_top_samples(50), posterior of 100 on "
                  f"{card}: lambda {lam!r}; launches {launches}", flush=True)
            if not ok or launches != want:
                fail(f"{run}: bad outputs or launches {launches}, expected {want}")
                return None
            out[run] = launches
    return out


SG_WINDOW = (5, 3)  # the SG filter the tails are checked with: MPPIConfig's default window


def tail_routes(torch, fs, x0, prev, seed, ref, task, bounds, k, noise) -> dict:
    """``{route: (costs, stats, numer, lam [1])}``: each fused route's partials, seeded.

    Fixed lambda 1 (the fused solve), standalone (phase 1, the ESSPS search
    kernel, phase 2 at lambda*) and the epilogue (phase 1 with the search,
    phase 2), as ``core/fused_solver.solve`` runs them.
    """
    from mppi_playground_tpu_torch.ops.lambda_search import LambdaSearch

    search = LambdaSearch("ESSPS", 0.01, 10.0, k / 10.0, 40)
    sampling = (seed, ref, task, *bounds, k, k, noise)
    lam = torch.ones(1, device="cuda")
    out = {"fixed": fs.fused_solve(x0, prev, lam, *sampling) + (lam,)}
    costs, dump = fs.fused_costs_dump(x0, prev, *sampling)
    lam_s = search.run(costs).reshape(1)
    out["standalone"] = (costs, *fs.fused_weighted(costs, dump, lam_s), lam_s)
    ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
    costs, dump, lam_e = fs.fused_costs_dump_lambda(x0, prev, *sampling, search, ticket)
    out["epilogue"] = (costs, *fs.fused_weighted(costs, dump, lam_e), lam_e)
    return out


def check_tails(torch, fs, label, task, x0, routes: dict, libm: bool = False):
    """The tick tail against its twin on each route's partials, eagerly and in a graph.

    For each route of :func:`tail_routes`, with the SG filter off and on
    (window :data:`SG_WINDOW` on a seeded history): the kernel's action
    sequence, states, weights, ESS and shifted history bit for bit the
    twin's (the libm models' states: bitwise or atol 5e-3, the re-roll's
    bar), and the outputs of a CUDA graph of the launch, replayed twice, bit
    for bit the eager launch's.  Returns ``(max_abs_err, results)`` or None
    after a failure.
    """
    from mppi_playground_tpu_torch.core.sg_filter import savitzky_golay_coeffs

    horizon = routes["fixed"][2].shape[1] // task.dim_control
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    history = (0.1 * torch.randn(horizon - 1, task.dim_control, generator=gen,
                                 device="cuda")).contiguous()
    coeffs = torch.tensor(savitzky_golay_coeffs(*SG_WINDOW), dtype=torch.float32,
                          device="cuda")
    err, results = 0.0, {}
    for route, (costs, stats, numer, lam) in routes.items():
        for sg in (None, coeffs):
            args = (x0, costs, stats, numer, lam, task, history, sg)
            got = fs.fused_tick_tail(*args)
            want = fs.fused_tick_tail_plain(*args)
            graph, replayed = captured(torch, lambda args=args: fs.fused_tick_tail(*args), 1)
            graph.replay()
            graph.replay()
            torch.cuda.synchronize()
            errs = [(g - w).abs().max().item() if g.numel() else 0.0 for g, w in zip(got, want)]
            bitwise = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
            states_ok = bitwise[1] or (libm and errs[1] <= 5e-3)
            res = dict(bitwise_twin=bitwise, max_abs_err=errs,
                       graph_bitwise_eager=all(torch.equal(g, r) for g, r in zip(got, replayed)),
                       ess=got[3].item())
            key = f"{route}{' SG' if sg is not None else ''}"
            results[key] = res
            err = max(err, *errs)
            if not (all(b for i, b in enumerate(bitwise) if i != 1) and states_ok
                    and res["graph_bitwise_eager"] and torch.isfinite(got[1]).all()):
                print(f"{label} tick tail vs twin ({key}): {json.dumps(res)}", flush=True)
                fail(f"{label} tick tail ({key}) off the bar: actions, weights, ESS and history "
                     "bitwise the twin's, states bitwise (libm: atol 5e-3), a replayed graph "
                     "bitwise the eager launch")
                return None
    print(f"{label} tick tail vs twin on every route, SG off and on, eager and a graph replayed "
          f"twice: bitwise {all(all(r['bitwise_twin']) for r in results.values())}, max_abs_err "
          f"{err!r}", flush=True)
    return err, results


def tail_bound_ms(num_samples: int, horizon: int, ops: ModelOps = RACING) -> tuple:
    """Least time of one tick tail: the partials read, the weights and states written.

    Bytes: costs, block statistics and numerators, x0 and lambda in; weights,
    actions, states, ESS and history out.  Operations: per block exp and
    four for the sums, per block and slot two, per sample five for a weight,
    and the re-roll's steps.
    """
    blocks, slots = -(-num_samples // 256), ops.m * horizon
    in_bytes = 4 * (num_samples + blocks * (3 + slots) + ops.n + 1)
    out_bytes = 4 * (num_samples + slots + ops.n * (horizon + 1) + 1 + slots - ops.m)
    flops = blocks * (5 + 2 * slots) + 5 * num_samples + horizon * ops.step
    return _bound(in_bytes, out_bytes, flops)


def time_tails(torch, fs, task, x0, route, horizon: int) -> dict:
    """Device ms by graph replay (event loop beside it) of the tail and its alternatives.

    On one route's partials: the tail launch with its weights; the tail
    without weights, then the weights as torch ops (the max, the sum of the
    rescaled block sums, the weights' four elementwise ops); and the tail it replaced,
    ``combine_partials`` then the re-roll launch.
    """
    from mppi_playground_tpu_torch.ops import cuda_build
    from mppi_playground_tpu_torch.ops.weighted_update import combine_partials

    costs, stats, numer, lam = route
    history = torch.zeros(horizon - 1, task.dim_control, device="cuda")
    tail = cuda_build.function(*task.entry("tick_tail_batch"), fs._TAIL_BATCH_ARGTYPES)
    outs = [torch.empty(n, device="cuda") for n in
            (horizon * task.dim_control, (horizon + 1) * task.dim_state, 1,
             (horizon - 1) * task.dim_control)]

    def torch_weights():  # a batch of one with a null weights pointer: one CTA, no weights
        err = tail(x0.data_ptr(), costs.data_ptr(), stats.data_ptr(), numer.data_ptr(),
                   lam.data_ptr(), history.data_ptr(), None, fs._floats(task.floats),
                   fs._ints(task.ints), stats.shape[0], horizon, costs.shape[0], 0, 1,
                   *(t.data_ptr() for t in outs[:3]), None, outs[3].data_ptr(), None, None,
                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the tail without weights failed: cudaError_t {err}")
        mx = stats[:, 0].max()
        z = torch.sum(torch.exp(stats[:, 0] - mx) * stats[:, 1])
        return torch.exp(-costs / lam - mx) / z

    def combine_then_reroll():
        update = combine_partials(costs, stats, numer, lam, horizon, task.dim_control)[0]
        return fs.fused_reroll(x0, update, task)

    out = {}
    for key, fn in (("tail", lambda: fs.fused_tick_tail(x0, costs, stats, numer, lam, task,
                                                        history)),
                    ("tail_torch_weights", torch_weights),
                    ("combine_partials_then_reroll", combine_then_reroll)):
        out[f"{key}_ms"], out[f"{key}_launch_loop_ms"] = device_ms(torch, fn, 20)
    return out


NEW_MODELS = ("navigation", "danger_zone", "pendulum", "cartpole", "mountain_car", "integrator")
# Held against their twins but launched on no path: the re-roll alone, since
# the tick's tail re-rolls in its own launch (<model>_tick_tail).  Row 6's
# kernel on its actions-only plug (fused_regen_m1/_m2) is the unfused route's
# draw.
OFF_PATHS = tuple(f"{m}_reroll" for m in MODEL_OPS)
# step with libm sinf/cosf: held to the JAX package's fused-vs-XLA cost bar,
# rtol 2e-5 and atol 1e-5, where their costs are not bitwise the twin's
LIBM_MODELS = ("danger_zone", "pendulum", "cartpole", "mountain_car")


def model_inputs(torch, np, name, num_samples=None):
    """A model's workload and seeded warm start and noise at its configuration."""
    from mppi_playground_tpu_torch.workloads import build_model_workload

    w = build_model_workload(name, device="cuda", num_samples=num_samples)
    kw = w.mppi_kwargs
    horizon, m, k = kw["horizon"], kw["dim_control"], kw["num_samples"]
    rng = np.random.default_rng(SEED + len(name))
    sig = tuple(float(v) for v in kw["sigmas"])
    prev = torch.tensor(rng.standard_normal((horizon, m)) * sig, dtype=torch.float32,
                        device="cuda")
    noise = torch.tensor(rng.standard_normal((k, horizon, m)) * sig, dtype=torch.float32,
                         device="cuda")
    bounds = (sig, tuple(float(v) for v in torch.as_tensor(kw["u_min"]).tolist()),
              tuple(float(v) for v in torch.as_tensor(kw["u_max"]).tolist()))
    return w, prev, noise, bounds


def lambda_vs_plain(search, costs, lam, want=None) -> tuple:
    """``lam`` against the plain search on ``costs``: ``(abs error, within the bar)``.

    The bar of the search kernels' own check: ESSPS rtol 1e-4 atol 1e-6;
    LBPS rtol 1e-3 atol 1e-4 and its objective within rtol 1e-5.  ``want``
    is the plain search's λ* where the caller has it.
    """
    from mppi_playground_tpu_torch.ops import lambda_search

    got = lam.reshape(())
    want = search.plain(costs) if want is None else want.reshape(())
    err = abs(got.item() - want.item())
    if search.mode == "ESSPS":
        return err, err <= 1e-6 + 1e-4 * abs(want.item())
    pen = lambda_search.lbps_range_penalty(costs, search.param)
    f_got = lambda_search.lbps_objective_plain(costs, got, pen).item()
    f_want = lambda_search.lbps_objective_plain(costs, want, pen).item()
    return err, (err <= 1e-4 + 1e-3 * abs(want.item())
                 and abs(f_got - f_want) <= 1e-5 * abs(f_want))


def check_model_kernels(torch, np, name, card, num_samples=None):
    """Phase 9: one model's fused kernels against their twins at its configuration.

    :func:`check_task_kernels` on the model's workload (``model_inputs``).
    """
    w, prev, noise, bounds = model_inputs(torch, np, name, num_samples)
    k = w.mppi_kwargs["num_samples"]
    return check_task_kernels(torch, f"{name} (T={prev.shape[0]}, K={k})", w.task, w.x0, prev,
                              noise, bounds, None, MODEL_OPS[name], card,
                              libm=name in LIBM_MODELS)


def check_task_kernels(torch, label, task, x0, prev, noise, bounds, ref, ops, card,
                       libm=False, searches=("ESSPS",), source=None):
    """One model's fused kernels against their twins at one configuration (phases 9 and 16).

    The fused solve, phase 1, phase 1 with the epilogue of each search in
    ``searches``, phase 2 at lambda=1, regeneration of all K rows (m = 1 or
    2: the unfused route's draw), 300 rows regenerated and rolled out, and
    the re-roll, seeded and in noise mode.  Gates: costs bitwise (``libm``:
    bitwise or the bar above, reported), the partials by
    ``partials_errors``, the dump and the regenerated rows bitwise, phase 1
    + 2 at lambda=1 bitwise the fixed solve (whose numerator pass
    regenerates the slots past its tile), the epilogue's costs, dump and
    lambda* bitwise the standalone route's, the rolled-out rows bitwise
    their twin's and the twin's roll-out of phase 1's dump at those rows
    (``libm``: states atol 5e-3).  ``ref`` is the reference rows ``[T+1,
    W]`` or None; ``source`` the file of the model's rollout kernels (None:
    ``fused_<model>.cu``).  Returns ``{kernel: row}`` (``m{m}_regen`` for
    the regeneration of this model's m, and ``weighted``, phase 2's time
    here) or None after a failure.  The epilogue's lambda* is also held
    against the plain search on the twin's costs (``lambda_vs_plain``); its
    row's error is the largest gap of its costs, dump and lambda* to its
    twin's.
    """
    from mppi_playground_tpu_torch.core.config import tick_seed
    from mppi_playground_tpu_torch.core.diagnostics import top_indices
    from mppi_playground_tpu_torch.ops import fused_solve as fs
    from mppi_playground_tpu_torch.ops.lambda_search import LambdaSearch
    from mppi_playground_tpu_torch.ops.weighted_update import combine_partials

    sig, lo, hi = bounds
    name = task.name
    horizon, m = prev.shape
    k = noise.shape[0]
    regen_kernel = m in fs.REGEN_WIDTHS
    threshold = int(0.8 * k)  # both sides of the inherit split
    seed = device_seed(torch, tick_seed(42, 1))
    lam = torch.ones(1, device="cuda")
    grid_bytes = sum(g.numel() for g in task.grids)
    search = LambdaSearch("ESSPS", 0.01, 10.0, k / 10.0, 40)
    ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
    rows = torch.arange(k, device="cuda")
    err = dict(solve=0.0, dump=0.0, regen=0.0, reroll=0.0, epilogue=0.0, top_rollouts=0.0,
               tick_tail=0.0)
    # rows the top rows' kernel rolls out against its twin: any 300 (every row if fewer)
    picked = torch.randperm(k, generator=torch.Generator().manual_seed(SEED))[:300].to("cuda")

    def within_bar(got_costs, want_costs):  # the libm models' cost bar
        return bool(((got_costs - want_costs).abs() <= 1e-5 + 2e-5 * want_costs.abs()).all())

    bitwise = {}
    for mode, nz in (("noise", noise), ("seeded", None)):
        args = (x0, prev, lam, seed, ref, task, sig, lo, hi, k, threshold, nz)
        got = fs.fused_solve(*args)
        want = fs.fused_solve_plain(*args)
        p1 = fs.fused_costs_dump(x0, prev, *args[3:])
        w_p1 = fs.fused_costs_dump_plain(x0, prev, *args[3:])
        p2 = fs.fused_weighted(*p1, lam)
        epis = {}
        for mode_search in searches:
            s = search if mode_search == "ESSPS" else LambdaSearch("LBPS", 0.01, 10.0, 0.01, 32)
            epis[mode_search] = (s, fs.fused_costs_dump_lambda(x0, prev, *args[3:], s, ticket),
                                 s.run(p1[0]))
        epi = epis[searches[0]][1]
        if regen_kernel:
            regen = fs.fused_regen(prev, seed, rows, sig, lo, hi, k, threshold, nz)
        w_regen = fs.fused_regen_plain(prev, seed, rows, sig, lo, hi, k, threshold, nz)
        tops = fs.fused_top_rollouts(x0, prev, seed, picked, task, sig, lo, hi, k, threshold, nz)
        w_tops = fs.fused_top_rollouts_plain(x0, prev, seed, picked, task, sig, lo, hi, k,
                                             threshold, nz)
        dump_tops = fs.rolled_out_plain(x0, p1[1].t().reshape(k, horizon, m)[picked], task)
        torch.cuda.synchronize()
        lam_checks = {mode_search: lambda_vs_plain(s, w_p1[0], out[2])
                      for mode_search, (s, out, _) in epis.items()}
        lam_err = max(e for e, _ in lam_checks.values())
        lam_ok = all(ok for _, ok in lam_checks.values())
        costs_bitwise = bool(torch.equal(got[0], want[0]))
        rel = ((got[0] - want[0]).abs() / (want[0].abs() + 1e-30)).max().item()
        g = combine_partials(*got, lam, horizon, m)
        v = combine_partials(*want, lam, horizon, m)
        res = dict(
            costs_bitwise_equal=costs_bitwise, cost_max_rel_err=rel,
            cost_max_abs_err=(got[0] - want[0]).abs().max().item(),
            partials=partials_errors(torch, got[1:], want[1:], want[0], p1[1].t(), lam),
            weights_max_abs_err=(g[1] - v[1]).abs().max().item(),
            update_max_abs_err=(g[0] - v[0]).abs().max().item(),
            phase1_costs_equal_fixed=bool(torch.equal(p1[0], got[0])),
            phase1_dump_vs_twin_bitwise=bool(torch.equal(p1[1], w_p1[1])),
            phase2_at_1_equals_fixed=all(torch.equal(a, b) for a, b in zip(p2, got[1:])),
            epilogue_equals_standalone=all(
                torch.equal(out[0], p1[0]) and torch.equal(out[1], p1[1])
                and out[2].item() == standalone.item() for _, out, standalone in epis.values()),
            epilogue_lam={mode_search: out[2].item() for mode_search, (_, out, _) in epis.items()},
            epilogue_lam_vs_plain_abs_err=lam_err,
            epilogue_lam_within_plain_bar=lam_ok,
            regen_equals_dump=(bool(torch.equal(regen, p1[1].t().reshape(k, horizon, m)))
                               if regen_kernel else None),
            top_rollouts_bitwise=bool(torch.equal(tops, w_tops)),
            top_rollouts_max_abs_err=(tops - w_tops).abs().max().item(),
            top_rollouts_equal_dump_rolled_out=bool(torch.equal(tops, dump_tops)),
        )
        bitwise[mode] = costs_bitwise
        print(f"{label} kernels vs twins ({mode}): {json.dumps(res)}", flush=True)
        err["solve"] = max(err["solve"], res["cost_max_abs_err"])
        err["dump"] = max(err["dump"], (p1[1] - w_p1[1]).abs().max().item())
        err["epilogue"] = max(err["epilogue"], (epi[0] - w_p1[0]).abs().max().item(),
                              (epi[1] - w_p1[1]).abs().max().item(), lam_err)
        if regen_kernel:
            err["regen"] = max(err["regen"], (regen - w_regen).abs().max().item())
        err["top_rollouts"] = max(err["top_rollouts"], res["top_rollouts_max_abs_err"])
        tops_ok = (res["top_rollouts_bitwise"] and res["top_rollouts_equal_dump_rolled_out"]) or (
            libm and res["top_rollouts_max_abs_err"] <= 5e-3)
        costs_ok = costs_bitwise or (libm and within_bar(got[0], want[0]))
        partials_ok = res["partials"]["ok"] or (
            not costs_bitwise and res["weights_max_abs_err"] <= 1e-5
            and res["update_max_abs_err"] <= 5e-3)
        if not (costs_ok and partials_ok and res["phase1_costs_equal_fixed"]
                and res["phase1_dump_vs_twin_bitwise"] and res["phase2_at_1_equals_fixed"]
                and res["epilogue_equals_standalone"] and lam_ok
                and res["regen_equals_dump"] is not False and tops_ok):
            fail(f"{label} kernels ({mode}) off the bar: costs bitwise (libm: rtol 2e-5, atol "
                 f"1e-5), partials {PARTIALS_BAR}, dump, regeneration, phase 1 + 2 and the "
                 "epilogue bitwise, the epilogue's lambda* within the plain search's bar, the "
                 "top rows' roll-out bitwise its twin and phase 1's dump rolled out (libm: "
                 "atol 5e-3)")
            return None
    seq = g[0].contiguous()
    got_r = fs.fused_reroll(x0, seq, task)
    want_r = fs.fused_reroll_plain(x0, seq, task)
    torch.cuda.synchronize()
    err["reroll"] = (got_r - want_r).abs().max().item()
    reroll_bitwise = bool(torch.equal(got_r, want_r))
    print(f"{label} re-roll vs twin: max_abs_err={err['reroll']!r} bitwise={reroll_bitwise}",
          flush=True)
    if not (reroll_bitwise or (libm and err["reroll"] <= 5e-3)):
        fail(f"{label} re-roll off the bar: bitwise (libm models: states atol 5e-3)")
        return None
    routes = tail_routes(torch, fs, x0, prev, seed, ref, task, (sig, lo, hi), k, None)
    tails = check_tails(torch, fs, label, task, x0, routes, libm=libm)
    if tails is None:
        return None
    err["tick_tail"] = tails[0]
    tail_args = (x0, *routes["fixed"], task, torch.zeros(horizon - 1, m, device="cuda"))

    args = (x0, prev, lam, seed, ref, task, sig, lo, hi, k, threshold, None)
    p1_args = (x0, prev) + args[3:]
    top = top_indices(g[1], min(300, k))[1]  # the seeded solve's heaviest rows
    kernels = dict(
        solve=(lambda: fs.fused_solve(*args), 20),
        dump=(lambda: fs.fused_costs_dump(*p1_args), 20),
        epilogue=(lambda: fs.fused_costs_dump_lambda(*p1_args, search, ticket), 20),
        reroll=(lambda: fs.fused_reroll(x0, seq, task), 50),
        weighted=(lambda: fs.fused_weighted(*p1, lam), 50),
        top_rollouts=(lambda: fs.fused_top_rollouts(x0, prev, seed, top, task, sig, lo, hi, k,
                                                    threshold), 50),
        tick_tail=(lambda: fs.fused_tick_tail(*tail_args), 50),
    )
    if regen_kernel:  # all K rows: the unfused route's draw at this configuration
        kernels["regen"] = (lambda: fs.fused_regen(prev, seed, rows, sig, lo, hi, k, threshold),
                            50)
    t, loop = {}, {}
    for key, (fn, reps) in kernels.items():  # graph replay, and the event loop beside it
        t[key], loop[key] = device_ms(torch, fn, reps)
    t.update(
        solve_plain=cuda_ms(torch, lambda: fs.fused_solve_plain(*args), 3, warmup=1),
        dump_plain=cuda_ms(torch, lambda: fs.fused_costs_dump_plain(*p1_args), 3, warmup=1),
        epilogue_plain=cuda_ms(torch, lambda: fs.fused_costs_dump_lambda_plain(*p1_args, search),
                               3, warmup=1),
        reroll_plain=cuda_ms(torch, lambda: fs.fused_reroll_plain(x0, seq, task), 5, warmup=1),
        top_rollouts_plain=cuda_ms(torch, lambda: fs.fused_top_rollouts_plain(
            x0, prev, seed, top, task, sig, lo, hi, k, threshold), 3, warmup=1),
        tick_tail_plain=cuda_ms(torch, lambda: fs.fused_tick_tail_plain(*tail_args), 3, warmup=1),
    )
    b_solve = solve_bound_ms(k, horizon, True, grid_bytes, ops)
    b_dump = phase1_bound_ms(k, horizon, True, grid_bytes, ops)
    b_epi = phase1_bound_ms(k, horizon, True, grid_bytes, ops,
                            search_ops(k, 40, OPS_ESSPS_EVAL, 2))
    b_reroll = reroll_bound_ms(horizon, ops)
    b_regen = regen_bound_ms(k, horizon, True, m)
    b_weighted = phase2_bound_ms(k, horizon, m)
    b_tops = top_rollouts_bound_ms(len(top), horizon, True, ops)
    b_tail = tail_bound_ms(k, horizon, ops)
    print(f"times on {card}, {label} (kernels by graph replay, their event loops in brackets; "
          "twins by events): " + "; ".join(
              f"{key} {value:.4f} ms" + (f" ({loop[key]:.4f})" if key in loop else "")
              for key, value in t.items())
          + f"; bounds solve {b_solve[0]:.6f}, phase 1 {b_dump[0]:.6f}, epilogue {b_epi[0]:.6f},"
          f" re-roll {b_reroll[0]:.8f}, regeneration of all {k} rows {b_regen[0]:.7f}, the top "
          f"{len(top)} rows' roll-out {b_tops[0]:.7f}, phase 2 {b_weighted[0]:.7f}, tick tail {b_tail[0]:.7f} ms",
          flush=True)
    if regen_kernel:
        t["regen_plain"] = cuda_ms(torch, lambda: fs.fused_regen_plain(
            prev, seed, rows, sig, lo, hi, k, threshold), 3, warmup=1)
    shape = dict(horizon=horizon, num_samples=k, costs_bitwise_equal_to_twin=bitwise)
    rollout = (source or f"fused_{name}.cu", f"{FUSED_SOLVE_PY}:783")
    tail_source = source or "reroll.cu"
    out = {
        f"{name}_fused_solve": kernel_row(f"{name}_fused_solve", *rollout, err["solve"],
                                          t["solve"], t["solve_plain"], *b_solve,
                                          launch_loop_ms=loop["solve"], **shape),
        f"{name}_costs_dump": kernel_row(f"{name}_costs_dump", *rollout, err["dump"], t["dump"],
                                         t["dump_plain"], *b_dump, launch_loop_ms=loop["dump"],
                                         **shape),
        f"{name}_costs_dump_lambda": kernel_row(
            f"{name}_costs_dump_lambda", *rollout, err["epilogue"], t["epilogue"],
            t["epilogue_plain"], *b_epi, search="ESSPS", launch_loop_ms=loop["epilogue"],
            **shape),
        f"{name}_reroll": kernel_row(f"{name}_reroll", tail_source, f"{FUSED_SOLVE_PY}:272",
                                     err["reroll"], t["reroll"], t["reroll_plain"], *b_reroll,
                                     horizon=horizon, launch_loop_ms=loop["reroll"]),
        f"{name}_tick_tail": kernel_row(f"{name}_tick_tail", tail_source, f"{FUSED_SOLVE_PY}:272",
                                        err["tick_tail"], t["tick_tail"], t["tick_tail_plain"],
                                        *b_tail, horizon=horizon, num_samples=k,
                                        launch_loop_ms=loop["tick_tail"]),
        f"{name}_top_rollouts": kernel_row(
            f"{name}_top_rollouts", tail_source, f"{FUSED_SOLVE_PY}:937", err["top_rollouts"],
            t["top_rollouts"], t["top_rollouts_plain"], *b_tops, rows=len(top), horizon=horizon,
            num_samples=k, launch_loop_ms=loop["top_rollouts"]),
        # phase 2 at this family's configuration: the kernel's time on its paths
        "weighted": dict(ms=t["weighted"], launch_loop_ms=loop["weighted"],
                         bound_ms=b_weighted[0]),
    }
    if regen_kernel:
        out[f"m{m}_regen"] = kernel_row(
            f"fused_regen_m{m}", "fused_solve.cu", f"{FUSED_SOLVE_PY}:937", err["regen"],
            t["regen"], t["regen_plain"], *b_regen, rows=k, horizon=horizon, num_samples=k,
            model=name, launch_loop_ms=loop["regen"])
    return out


def captured(torch, fn, reps: int):
    """A CUDA graph of ``reps`` calls of ``fn`` (warmed up once off the default stream).

    Returns ``(graph, outputs)``: the outputs of the last captured call, which
    each replay writes anew.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            out = fn()
    return graph, out


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device ms per call of ``fn``: ``reps`` calls replayed as one CUDA graph.

    Unlike :func:`cuda_ms` the host's launch rate does not enter: the
    wrappers' Python and ``ctypes`` work happens once, at capture.
    """
    graph, _ = captured(torch, fn, reps)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(torch, fns: dict, windows: int = 6, per_window: int = 10) -> dict:
    """Median device ms per call of each of ``fns``, timed window by window in turns.

    Each function's ``per_window`` calls are one CUDA graph (device time, no
    host launch gaps); the order flips every window (a, b, c, then c, b, a),
    so that every function meets the same drift of the card.
    """
    graphs = {name: captured(torch, fn, per_window)[0] for name, fn in fns.items()}
    for graph in graphs.values():
        graph.replay()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(graphs.items())
    for _ in range(windows):
        for name, graph in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / per_window)
        order.reverse()
    return {name: statistics.median(v) for name, v in times.items()}


def ptxas_report(logs: dict, pattern: str) -> list:
    """``library:kernel: registers, spills`` of the kernels whose name holds ``pattern``.

    From ``nvcc -Xptxas -v``'s log of each library built in this run.
    """
    out = []
    for lib, log in sorted(logs.items()):
        fn = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif fn and pattern in fn and ("spill" in line or "registers" in line):
                out.append(f"{lib}:{fn}: {line.split(':', 1)[-1].strip()}")
    return out


# Latency of one dependent issue on the H100's FP32 and integer pipes, in
# cycles: the number each link of a chain of dependent SASS instructions adds.
DEPENDENT_CYCLES = 4


def _sass_program(dump: str, pattern: str) -> list:
    """``[(address, predicate, opcode, operands)]`` of the first kernel whose name holds ``pattern``."""
    import re

    program, inside = [], False
    for line in dump.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = pattern in line
        elif inside:
            found = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if found:
                words = found.group(2).replace(",", " ").split()
                pred = words.pop(0) if words[0].startswith("@") else None
                program.append((int(found.group(1), 16), pred, words[0], words[1:]))
    return program


def loop_chain(program: list, stores_a_step: int, max_paths: int = 20_000) -> tuple:
    """``(dependent instructions a step, paths)`` of the kernel's outermost loop.

    The loop is the widest backward branch.  Every path through its body
    from the head to that branch (a conditional branch may go either way;
    inner backward branches are taken as not taken) is run for six trips,
    each instruction one link after the latest of its operand registers and
    predicate; a trip's chain is what each of the last four trips adds to the
    deepest register, on average.  The least over the paths is the
    loop-carried chain: no schedule of a trip issues its dependent
    instructions in fewer links.  A trip of a loop the compiler unrolled
    holds several steps: the global stores of a trip over ``stores_a_step``.
    """
    import re

    index = {addr: i for i, (addr, *_rest) in enumerate(program)}
    loops = [(index[int(ops[-1], 16)], i) for i, (addr, pred, op, ops) in enumerate(program)
             if op.startswith("BRA") and ops and ops[-1].startswith("0x")
             and int(ops[-1], 16) < addr]
    head, back = max(loops, key=lambda span: span[1] - span[0])

    def regs(words):
        return re.findall(r"\b(U?R\d+|U?P\d+)\b", " ".join(words))

    def paths(i, trail):
        while i < back:
            addr, pred, op, ops = program[i]
            if op.startswith("BRA") and ops and ops[-1].startswith("0x"):
                target = index[int(ops[-1], 16)]
                if target > i:
                    if pred is None and "P" not in " ".join(ops[:-1]):
                        i = target
                        continue
                    yield from paths(target, trail)
            elif op in ("EXIT", "RET"):
                return
            trail = trail + [i]
            i += 1
        yield trail

    best, count = None, 0
    for trail in paths(head, []):
        count += 1
        depth = {}
        ends = []
        for _ in range(6):
            for i in trail:
                _, pred, op, ops = program[i]
                if op.startswith(("BRA", "BSSY", "BSYNC", "NOP")) or op.startswith("ST"):
                    continue
                dst, srcs = (ops[0], ops[1:]) if ops else (None, [])
                dst_regs = regs([dst]) if dst else []
                sources = regs(srcs) + (regs([pred]) if pred else [])
                if pred:  # a predicated write keeps the old value where it is off
                    sources += dst_regs
                if op.startswith(("ISETP", "FSETP", "LOP3")) and "P" in (dst or ""):
                    sources = regs(srcs[1:]) + (regs([pred]) if pred else [])
                    dst_regs = regs([dst]) + regs(srcs[:1])
                link = max((depth.get(r, 0) for r in sources if r not in ("RZ", "PT")),
                           default=0) + 1
                for r in dst_regs:
                    depth[r] = link
            ends.append(max(depth.values(), default=0))
        steps = sum(program[i][2].startswith("STG") for i in trail) / stores_a_step
        chain = (ends[5] - ends[1]) / 4 / steps
        best = chain if best is None else min(best, chain)
        if count >= max_paths:
            break
    return best, count


def chain_bounds() -> int:
    """The loop-carried latency bound of rows 2 and 6 for every model, from the SASS.

        python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.chain_bounds())'

    Builds ``reroll.cu``, reads the SASS of each model's re-roll
    (``reroll_kernel``) with ``cuobjdump``, finds its loop's least chain of
    dependent instructions a step (:func:`loop_chain`), and prints, beside
    the card's line and its top SM clock (``nvidia-smi``), the bound T x
    chain x :data:`DEPENDENT_CYCLES` / clock at the model's horizon: no
    launch can roll a sequence's states faster, whatever its bytes or
    operations.  Row 6 rolls each of its rows through the same step (its
    draws do not depend on the state), so a row's chain, and the launch's
    bound, is the same.
    """
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mppi_playground_tpu_torch.ops import cuda_build
    from mppi_playground_tpu_torch.workloads import MODEL_CONFIGS

    card = card_line()
    print(card, flush=True)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    cuda_build.build(["reroll"])
    tool = Path(cuda_build.nvcc()).parent / "cuobjdump"
    dump = subprocess.run([str(tool), "-sass", str(cuda_build._target("reroll"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    plugs = {"racing": "6racing5Model", "navigation": "8unicycle15NavigationModel",
             "danger_zone": "11danger_zone5Model", "pendulum": "7classic8Pendulum",
             "cartpole": "7classic8Cartpole", "mountain_car": "7classic11MountainCar",
             "integrator": "7classic10Integrator"}  # mangled plug names
    for model, plug in plugs.items():
        horizon = T if model == "racing" else MODEL_CONFIGS[model][0]
        out = {"model": model, "horizon": horizon, "card": card, "sm_clock_mhz": clock_mhz}
        chain, paths = loop_chain(_sass_program(dump, f"13reroll_kernelIN{plug}E"),
                                  MODEL_OPS[model].n)
        out.update(dependent_a_step=chain, paths=paths,
                   bound_ms=horizon * chain * DEPENDENT_CYCLES / (clock_mhz * 1e3))
        print(json.dumps(out), flush=True)
    return 0


def check_epilogue(torch, fused_solve, cases, card):
    """Row 4: phase 1 with the search against phase 1 then the search kernel; timed in turns.

    ``cases`` are ``(label, mode, phase-1 args without the noise, noise)``.
    In each noise mode the costs, dump and lambda* must be bitwise the
    standalone route's and the ticket 0 after the launch; lambda* within the
    bar of ``lambda_vs_plain`` of the plain search on the twin's costs;
    ``max_abs_err`` is the largest gap of costs, dump and lambda* to the
    epilogue's plain twin.  Timed in turns on the seeded stream: the
    standalone route, the epilogue, its phase-1 part (the search with no
    bisection or golden steps: the min/max pass and two evaluations) and
    phase 1 alone.  Returns ``{label mode: result}`` or None after a
    failure.
    """
    from mppi_playground_tpu_torch.ops.lambda_search import LambdaSearch

    out = {}
    for label, mode, args, noise in cases:
        k = args[-2]
        param = k / 10.0 if mode == "ESSPS" else 0.01
        search = LambdaSearch(mode, 0.01, 10.0, param, 40 if mode == "ESSPS" else 32)
        no_steps = dataclasses.replace(search, iters=0)
        ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
        seeded = args + (None,)

        def standalone(a=seeded):
            costs, dump = fused_solve.fused_costs_dump(*a)
            return costs, dump, search.run(costs)

        def epilogue(a=seeded, s=search):
            return fused_solve.fused_costs_dump_lambda(*a, s, ticket)

        same, lam_ok, err, lam_gap = True, True, 0.0, 0.0
        for nz in (noise, None):
            a = args + (nz,)
            got, want = epilogue(a), standalone(a)
            torch.cuda.synchronize()
            same = same and (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                             and got[2].item() == want[2].item() and int(ticket.item()) == 0)
            twin = fused_solve.fused_costs_dump_lambda_plain(*a, search)
            lam_err, ok = lambda_vs_plain(search, twin[0], got[2])
            lam_ok, lam_gap = lam_ok and ok, max(lam_gap, lam_err)
            err = max([err, lam_err] + [(x - y).abs().max().item()
                                        for x, y in zip(got[:2], twin[:2])])
            del twin, got, want
        turns = in_turns(torch, {
            "standalone": standalone,
            "epilogue": epilogue,
            "epilogue_no_steps": lambda: epilogue(s=no_steps),
            "phase1": lambda: fused_solve.fused_costs_dump(*seeded),
        })
        res = dict(bitwise=bool(same), lam=epilogue()[2].item(), lam_vs_plain_abs_err=lam_gap,
                   lam_within_plain_bar=lam_ok, max_abs_err=err,
                   standalone_ms=turns["standalone"], epilogue_ms=turns["epilogue"],
                   epilogue_no_steps_ms=turns["epilogue_no_steps"], phase1_ms=turns["phase1"])
        print(f"lambda epilogue vs standalone route ({label}, {mode}) on {card}, in turns: "
              f"{json.dumps(res)}", flush=True)
        if not same:
            fail(f"lambda epilogue ({label}, {mode}) differs from phase 1 + the search kernel, "
                 "or left its ticket set")
            return None
        if not lam_ok:
            fail(f"lambda epilogue ({label}, {mode}): lambda* off the plain search's bar (ESSPS "
                 "rtol 1e-4 atol 1e-6; LBPS rtol 1e-3 atol 1e-4, objective rtol 1e-5)")
            return None
        out[f"{label} {mode}"] = res
    return out


# (model, path, MPPI overrides, ticks): the closed loops of the model families.
# "fused"/"unfused" at the example's configuration, through MPPI and its
# default lambda route; "lambda_epilogue" forces a lambda route through
# make_fused_solver (SolverLoop), so that each model's phase-1 kernels of
# both routes run on a path.
MODEL_PATHS = (
    ("navigation", "fused ESSPS", {}, 300),
    ("navigation", "fused ESSPS epilogue", dict(lambda_epilogue=True), 300),
    ("navigation", "fused ESSPS standalone", dict(lambda_epilogue=False), 300),
    ("navigation", "unfused ESSPS", dict(unfused=True), 300),
    ("navigation", "fused MPO", dict(lambda_="MPO"), 10),
    ("navigation", "K=100000 fused ESSPS", dict(num_samples=100_000), 30),
    ("navigation", "K=100000 fused ESSPS epilogue", dict(num_samples=100_000,
                                                        lambda_epilogue=True), 30),
    ("navigation", "K=100000 fused ESSPS standalone", dict(num_samples=100_000,
                                                          lambda_epilogue=False), 10),
    ("danger_zone", "fused", {}, 100),
    ("danger_zone", "unfused", dict(unfused=True), 100),
    ("pendulum", "fused ESSPS", {}, 200),
    ("pendulum", "fused ESSPS epilogue", dict(lambda_epilogue=True), 10),
    ("pendulum", "fused ESSPS standalone", dict(lambda_epilogue=False), 30),
    ("pendulum", "unfused", dict(unfused=True), 30),
    ("pendulum", "fused fixed", dict(lambda_=1.0), 10),
) + tuple(
    (name, path, kw, ticks)
    for name, fixed_paths in (("danger_zone", ()),
                              ("cartpole", (("fused", {}, 50), ("unfused", dict(unfused=True), 50))),
                              ("mountain_car", (("fused", {}, 50),
                                                ("unfused", dict(unfused=True), 50))),
                              ("integrator", (("fused", {}, 50),
                                              ("unfused", dict(unfused=True), 50))))
    for path, kw, ticks in fixed_paths + (
        ("fused ESSPS", dict(lambda_="ESSPS"), 10),
        ("fused ESSPS standalone", dict(lambda_="ESSPS", lambda_epilogue=False), 10),
        ("fused LBPS epilogue", dict(lambda_="LBPS", lambda_epilogue=True), 10))
)


class SolverLoop:
    """``MPPI``'s tick loop over a fused solver built with a forced lambda route.

    ``MPPI`` takes no lambda-route option (as the JAX facade); a path that
    forces one drives ``make_fused_solver(..., lambda_epilogue=...)`` through
    the same ``forward``, ``get_top_samples`` and ``reset``.
    """

    solver_backend = "fused"

    def __init__(self, solver):
        self.solver, self.state, self.aux = solver, solver.init(), None

    def forward(self, x):
        result = self.solver.solve(self.state, x)
        self.state, self.aux = result.state, result.aux
        return result.action_seq, result.state_seq

    def get_top_samples(self, n):
        return self.solver.top_samples(self.aux, n)

    def reset(self):
        from mppi_playground_tpu_torch.core.solver import warm_reset

        self.state, self.aux = warm_reset(self.solver, self.state), None

    @property
    def lambda_(self) -> float:
        return float(self.state.lam)


def drive_model_paths(torch, card):
    """Phases 10 and 11: every model family's closed loops through ``MPPI``, counted.

    Each path: ``forward``, ``get_top_samples`` and the plant, tick after
    tick (on the fused route after an eager tick, which ``MPPI`` follows
    with the capture, and one tick under ``set_sync_debug_mode("error")``),
    all of it under the device trace, every launch counter set to 0 before
    the path and read after (:func:`path_launches`); the median forward and
    get_top_samples times (host clock, under the trace).  Navigation stops
    at the goal (0.5 m); the pendulum must stand upright after 200 steps;
    the danger zone sums its episode's reward and cost.  Returns ``{path:
    result}`` or None.
    """
    from mppi_playground_tpu_torch import MPPI
    from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
    from mppi_playground_tpu_torch.utils.angles import angle_normalize
    from mppi_playground_tpu_torch.workloads import build_model_workload

    envs, out = {}, {}
    for name, path, kw, ticks in MODEL_PATHS:
        kw = dict(kw)
        fused = not kw.pop("unfused", False)
        epilogue = kw.pop("lambda_epilogue", None)
        w = build_model_workload(name, device="cuda", num_samples=kw.pop("num_samples", None),
                                 env=envs.get(name))
        envs[name] = w.env
        args = dict(w.mppi_kwargs, **kw)
        if fused:
            args.update(store_rollouts=False, fused_task=w.task)
        c = MPPI(**args)
        config = c.config
        if epilogue is not None:
            c = SolverLoop(make_fused_solver(config, w.task, args["dynamics"], device="cuda",
                                             lambda_epilogue=epilogue))
        label = f"{name} {path}"
        if c.solver_backend != ("fused" if fused else "xla"):
            fail(f"{label}: MPPI took the {c.solver_backend} route")
            return None
        top_n = {"navigation": 300, "danger_zone": 100}.get(name, 50)
        top_n = min(top_n, args["num_samples"])
        if name == "danger_zone":
            obs, _ = w.env.reset(seed=42)
            x = torch.tensor(obs, device="cuda")
        else:
            x = w.env.reset() if name == "navigation" else w.x0
        fwd_ms, top_ms, reward, cost, reached, dist_100 = [], [], 0.0, 0.0, None, None
        lo = torch.as_tensor(args["u_min"], dtype=torch.float32, device="cuda")
        hi = torch.as_tensor(args["u_max"], dtype=torch.float32, device="cuda")
        done = 0

        def drive():
            nonlocal x, reward, cost, reached, dist_100, done
            if fused:  # the eager tick (MPPI: and the capture), then one with no host sync
                c.forward(w.x0)
                c.get_top_samples(top_n)
                c.reset()
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    c.forward(w.x0)
                    c.get_top_samples(top_n)
                except RuntimeError as err:
                    return f"a tick synchronized with the host: {err}"
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                c.reset()
            for i in range(ticks):
                t0 = time.perf_counter()
                action_seq, state_seq = c.forward(x)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                seqs, weights = c.get_top_samples(top_n)
                torch.cuda.synchronize()
                fwd_ms.append(1e3 * (t1 - t0))
                top_ms.append(1e3 * (time.perf_counter() - t1))
                done += 1
                excess = torch.maximum(lo - action_seq, action_seq - hi).max().item()
                if not (torch.isfinite(action_seq).all() and torch.isfinite(state_seq).all()
                        and torch.isfinite(seqs).all() and excess <= 1e-5
                        and bool((weights[:-1] >= weights[1:]).all())):
                    return (f"non-finite output, actions out of bounds by {excess!r}, or top "
                            "samples not in descending weight order")
                if name == "navigation":
                    x, at_goal = w.env.step(action_seq[0])
                    if i == 99:
                        dist_100 = (x[:2] - w.env.goal_pos).norm().item()
                    if at_goal:
                        reached = i + 1
                        break
                elif name == "danger_zone":
                    obs, r, _, _, info = w.env.step(action_seq[0].cpu().numpy())
                    reward, cost = reward + r, cost + info["cost"]
                    x = torch.tensor(obs, device="cuda")
                else:
                    x = w.plant(x, action_seq[0])
            return None

        counted = zero_counters()
        err, trace = traced(torch, drive)
        if err is not None:
            fail(f"{label}: {err}")
            return None
        once = (fused_kernels(name, config, epilogue) if fused else
                {f"fused_regen_m{config.dim_control}", "weighted_update_partials"})
        launches = path_launches(label, counted, [trace],
                                 {kernel: done + (2 if fused else 0) for kernel in once})
        if launches is None:
            return None
        res = dict(ticks=done, forward_ms_traced=statistics.median(fwd_ms),
                   top_samples_ms_traced=statistics.median(top_ms), lambda_=c.lambda_,
                   device_launches={k: v for k, v in launches.items() if v},
                   final_state=[float(v) for v in x.tolist()])
        if name == "navigation":
            res.update(goal_reached_at_tick=reached, distance_at_tick_100=dist_100,
                       final_distance=(x[:2] - w.env.goal_pos).norm().item())
            start = (w.env.reset()[:2] - w.env.goal_pos).norm().item()
            if ticks >= 100 and not res["final_distance"] < start - 10.0:  # the example's loops
                fail(f"{label}: no progress to the goal ({res['final_distance']!r} m left)")
                return None
        if name == "danger_zone":
            res.update(episodic_reward=reward, episodic_cost=cost)
        if name == "pendulum" and path == "fused ESSPS":
            res["theta"] = float(angle_normalize(x[0]))
            if abs(res["theta"]) >= 0.15:
                fail(f"{label}: not upright after {ticks} steps (theta {res['theta']!r})")
                return None
        res["launches"] = launches
        print(f"{label} ({c.solver_backend}, T={args['horizon']}, K={args['num_samples']}) on "
              f"{card}: {json.dumps({k: v for k, v in res.items() if k != 'launches'})}",
              flush=True)
        out[label] = res
        if name == "navigation" and path in ("fused ESSPS epilogue", "fused ESSPS standalone"):
            def nav_tick(c=c, env=w.env):
                nonlocal x
                a, _ = c.forward(x)
                x, _ = env.step(a[0])
                c.get_top_samples(top_n)

            x = w.env.reset()
            res["profile"] = profile_ticks(torch, nav_tick, 20,
                                           "with env.step and get_top_samples(300)")
            print(f"{label}: {res['profile']}", flush=True)
    return out


EPISODE_TICKS = 50  # phase 12's flagship and facade episodes


def _bitwise(a, b) -> bool:
    """Two trees of tensors equal bit for bit, leaf by leaf (``closed_loop.bitwise_equal``)."""
    from mppi_playground_tpu_torch.core.closed_loop import bitwise_equal

    return bitwise_equal(a, b)


def eager_episode(torch, solver, plant, num_ticks, state, x, carry=None, info_fn=None):
    """The closed loop one eager solve at a time -> ``(state, x, xs, us, carry)``."""
    xs, us = [], []
    for _ in range(num_ticks):
        info, carry_next = info_fn(carry, x) if info_fn is not None else (None, carry)
        r = solver.solve(state, x, info=info)
        u = r.action_seq[0]
        xs.append(x)
        us.append(u)
        state, x, carry = r.state, plant(x, u), carry_next
    return state, x, torch.stack(xs), torch.stack(us), carry


def synced_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def flagship_episodes(torch, env, card):
    """Phase 12a: 50 flagship ticks as one replayed graph: fixed lambda, MPO, ESSPS on both routes.

    Each episode (``make_closed_loop`` with ``RacingEnv.dynamics`` as the
    plant and the reference rows through ``info_fn``) must be bit for bit 50
    eager ticks from the same state.  Its first two runs go under the device
    trace, every counter set to 0 before them: the device must run each
    kernel of the route 50 times a run, the wrappers count tick 0 of the
    first run (eager) and nothing else, and the second run (all replays) may
    not sync with the host.  Then it is timed (three untraced runs, host
    clock, synchronized), and the second run's trace gives the device's busy
    time.  Returns ``{mode: {...}}`` or None.
    """
    from mppi_playground_tpu_torch.core.closed_loop import make_closed_loop
    from mppi_playground_tpu_torch.core.config import make_key
    from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory,
        make_racing_fused_task_from_env,
    )
    from mppi_playground_tpu_torch.workloads import build_flagship

    _, fixed, _ = build_flagship(horizon=T, num_samples=K, env=env, device="cuda")
    task = make_racing_fused_task_from_env(env)
    essps = dataclasses.replace(fixed.config, lambda_="ESSPS")
    mpo = dataclasses.replace(fixed.config, lambda_="MPO")
    solvers = {"fixed": (fixed, None),
               "MPO": (make_fused_solver(mpo, task, env.dynamics, device="cuda"), None),
               "ESSPS standalone": (make_fused_solver(essps, task, env.dynamics, device="cuda"),
                                    None),
               "ESSPS epilogue": (make_fused_solver(essps, task, env.dynamics, device="cuda",
                                                    lambda_epilogue=True), True)}
    path = env.racing_center_path

    def info_fn(cind, x):
        xref, new_cind = calc_ref_trajectory(x, path, cind, T)
        return {"reference_path": xref}, new_cind

    def plant(x, u):
        return env.dynamics(x[None], u[None])[0]

    out = {}
    for mode, (solver, epilogue) in solvers.items():
        run = make_closed_loop(solver, plant, EPISODE_TICKS, info_fn=info_fn)
        state0, x0 = solver.init(), env.reset()
        c0 = torch.zeros((), dtype=torch.int64, device="cuda")
        counted = zero_counters()
        # tick 0 eagerly, the capture, the replays; then replays only
        first, first_trace = traced(torch, lambda: run(state0, x0, c0))
        try:
            second, second_trace = traced(torch, lambda: run(state0, x0, c0), no_sync=True)
        except RuntimeError as err:
            fail(f"flagship {mode} episode: the replays synchronized with the host: {err}")
            return None
        once = (fused_kernels("racing", solver.config, epilogue) - {"racing_top_rollouts"}
                | REFERENCE_ROWS | RACING_PLANT)
        launches = path_launches(f"flagship episode {mode}", counted,
                                 [first_trace, second_trace],
                                 {name: 2 * EPISODE_TICKS for name in once})
        if launches is None:
            return None
        # the wrappers counted tick 0 of the first run, the one eager tick, and nothing else
        eager_once = read_counters(counted) == {name: int(name in once) for name in counted}
        eager = eager_episode(torch, solver, plant, EPISODE_TICKS, state0, x0, c0, info_fn)
        exact = _bitwise(first, eager)
        key_ok = bool(torch.equal(first[0].key, make_key(solver.config.seed, EPISODE_TICKS,
                                                          "cuda")))
        runs = [synced_ms(torch, lambda: run(state0, x0, c0)) for _ in range(3)]
        ms = statistics.median(runs) / EPISODE_TICKS
        busy_us, activities = second_trace.busy_us, second_trace.activities
        res = dict(bitwise_eager=exact, replays_repeat=_bitwise(second, first),
                   key_after=key_ok, progress=int(first[4]), launches=launches,
                   wrappers_counted_the_eager_tick_only=eager_once,
                   capture_s=run.episode.graph.capture_s, amortized_tick_ms=ms,
                   ticks_per_s=1e3 / ms, episode_device_busy_us=busy_us,
                   device_activities_a_tick=activities / EPISODE_TICKS,
                   busy_share_of_unprofiled_episode=busy_us / (1e3 * ms * EPISODE_TICKS))
        print(f"phase 12 flagship {mode}: {EPISODE_TICKS} ticks (T={T}, K={K}) replayed from "
              f"one CUDA graph on {card}: {json.dumps({k: v for k, v in res.items()})}",
              flush=True)
        print(f"phase 12 flagship {mode}: device trace of the second episode on {card}: busy "
              f"{busy_us:.1f} us ({busy_us / EPISODE_TICKS:.1f} us a tick, "
              f"{activities / EPISODE_TICKS:.1f} activities a tick), "
              f"{100 * res['busy_share_of_unprofiled_episode']:.1f}% of the untraced "
              f"episode's {1e3 * ms * EPISODE_TICKS:.1f} us", flush=True)
        if not (exact and res["replays_repeat"] and key_ok and eager_once
                and res["progress"] > 0 and torch.isfinite(first[2]).all()):
            fail(f"flagship {mode} episode: bitwise {exact}, repeat {res['replays_repeat']}, key "
                 f"{key_ok}, wrappers counted the eager tick only {eager_once}, track index "
                 f"{res['progress']}")
            return None
        out[mode] = res
    return out


FACADE_GRAPH_ROUTES = (("T=25 K=4000", dict()), ("T=50 K=100000", dict(horizon=50,
                                                                        num_samples=100_000)))


def facade_graphs(torch, env, card):
    """Phase 12b: ``RacingController.update`` replayed from a graph against the eager tick.

    On both routes at T=25, K=4,000 and T=50, K=100,000: each update
    (the first eager, then the capture; the later ones replayed) bit for bit the eager tick
    (``_tick``: the reference rows and the solve) from the same state, the
    state and path index after them, and ``get_top_samples(300)`` after the
    last; on the fused route two replays' seed words and costs differ.
    Then the medians of replayed updates and of eager ticks, each
    synchronized, in turns, the plant outside the clock.  Returns
    ``{label: {...}}`` or None.
    """
    from mppi_playground_tpu_torch.core import diagnostics
    from mppi_playground_tpu_torch.envs import RacingController

    out = {}
    for size, kw in FACADE_GRAPH_ROUTES:
        for fused in (False, True):
            label = f"{size} {'fused' if fused else 'unfused'}"
            ctrl = RacingController(env, store_rollouts=not fused, **kw)
            ref = RacingController(env, store_rollouts=not fused, **kw)
            heavy = not fused and "T=50" in size
            ticks = 6 if heavy else 12
            x = env.reset()
            st, cind = ref.solver_state, ref.current_path_index
            exact, seeds, costs = True, [], []
            for i in range(ticks):
                a, s_ = ctrl.update(x)
                aux = ctrl._last_aux
                r, cind, _ = ref._tick(st, x, cind)
                st = r.state
                exact = exact and all(torch.equal(p, q) for p, q in (
                    (a, r.action_seq), (s_, r.state_seq), (aux.costs, r.aux.costs),
                    (aux.weights, r.aux.weights)))
                if fused and i in (1, 2):  # the first two replays
                    seeds.append((aux.seed.clone(), r.aux.seed.clone()))
                    costs.append(aux.costs.clone())
                x = env.dynamics(x[None], a[:1])[0]
            tops = ctrl.get_top_samples(300)
            want_tops = diagnostics.top_samples_from_last(ref._solver, r.aux, 300)
            exact = (exact and _bitwise(tops, want_tops)
                     and _bitwise(ctrl.solver_state, st)
                     and torch.equal(ctrl.current_path_index, cind))
            streams = None
            if fused:
                streams = (all(torch.equal(g, e) for g, e in seeds)
                           and not torch.equal(seeds[0][0], seeds[1][0])
                           and not torch.equal(costs[0], costs[1]))
            reps = 4 if heavy else 20

            def replayed(x):
                return ctrl.update(x)[0]

            def eager(x):
                nonlocal st, cind
                r, cind, _ = ref._tick(st, x, cind)
                st = r.state
                return r.action_seq

            times = {"replayed": [], "eager": []}  # the tick alone, the plant outside
            for _ in range(2):
                for name, step in (("replayed", replayed), ("eager", eager)):
                    for _ in range(reps):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        a = step(x)
                        torch.cuda.synchronize()
                        times[name].append(1e3 * (time.perf_counter() - t0))
                        x = env.dynamics(x[None], a[:1])[0]
            res = dict(bitwise_eager=bool(exact), streams_differ_and_match=streams,
                       capture_s=ctrl._ticks.graph.capture_s,
                       replayed_update_ms=statistics.median(times["replayed"]),
                       eager_tick_ms=statistics.median(times["eager"]))
            print(f"phase 12 RacingController {label} ({ctrl.solver_backend}) on {card}: "
                  f"{json.dumps(res)}", flush=True)
            if not exact or streams is False:
                fail(f"RacingController {label}: replayed updates differ from the eager ticks "
                     f"(bitwise {exact}, streams {streams})")
                return None
            out[label] = res
    return out


def map_move_recapture(torch, card):
    """Phase 12c: a moved map version rebuilds the solver and recaptures the graph."""
    import numpy as np

    from mppi_playground_tpu_torch.envs import RacingController, RacingEnv

    env = RacingEnv(device="cuda")  # its own: this check adds an obstacle
    ctrl = RacingController(env, store_rollouts=False)
    ref = RacingController(env, store_rollouts=False)
    x = env.reset()
    st, cind = ref.solver_state, ref.current_path_index
    exact, graphs = True, []
    for i in range(6):
        if i == 3:
            env.obstacle_map.add_circle_obstacle(np.asarray([30.0, 30.0]), 2.0)
            ref._refresh_if_maps_changed()
        a, _ = ctrl.update(x)
        graphs.append(ctrl._ticks.graph)
        r, cind, _ = ref._tick(st, x, cind)
        st = r.state
        exact = exact and torch.equal(a, r.action_seq) and torch.equal(ctrl._last_aux.costs,
                                                                        r.aux.costs)
        x = env.dynamics(x[None], a[:1])[0]
    # ticks 0 and 3 eager and then the capture, the others replays
    recaptured = (graphs[0] is graphs[1] is graphs[2] is not None
                  and graphs[3] is graphs[4] is graphs[5] is not None
                  and graphs[3] is not graphs[0])
    print(f"phase 12 map version moved after 3 ticks on {card}: bitwise {exact}, recaptured "
          f"{recaptured}", flush=True)
    return exact and recaptured


def facade_episodes(torch, env, card):
    """Phase 12d: ``run_episode`` on both facades, each bit for bit as many ticks by hand.

    ``RacingController.run_episode`` on both routes at T=25, K=4,000 with
    the racing example's goal ``done_fn``, against ``update`` tick after
    tick (the same plant); its first two episodes traced and counted
    (:func:`path_launches`: each kernel of the route 50 times an episode on
    the device).  ``MPPI.run_episode``:
    Navigation2D to its goal (ESSPS, T=30, K=3,000, fused) and the pendulum
    after 200 ticks (ESSPS, T=15, K=1,000, fused), against ``forward``.
    Returns ``{label: {...}}`` or None.
    """
    import numpy as np

    from mppi_playground_tpu_torch import MPPI
    from mppi_playground_tpu_torch.envs import RacingController
    from mppi_playground_tpu_torch.utils.angles import angle_normalize
    from mppi_playground_tpu_torch.workloads import build_model_workload

    def against_ticks(label, xs, us, ep, step, done_fn, budget):
        """``xs``, ``us`` and ``ep`` of an episode against ``step(x) -> x`` by hand."""
        x = xs[0]
        got_x, got_u, done = [x], [], False
        for _ in range(budget):
            x, u = step(x)
            got_x.append(x)
            got_u.append(u)
            if done_fn is not None and bool(done_fn(x)):
                done = True
                break
        n = len(got_u)
        ok = (torch.equal(xs[:n + 1], torch.stack(got_x)) and torch.equal(us[:n], torch.stack(got_u))
              and (ep is None or (int(ep["ticks"]) == n and bool(ep["done"]) == done)))
        if done:
            ok = ok and bool((us[n:] == 0).all()) and bool((xs[n + 1:] == x).all())
        return ok, n, done

    out = {}
    goal, thr = env.racing_center_path[-1, :2], env.GOAL_THRESHOLD

    def racing_done(x):
        return torch.linalg.norm(x[:2] - goal) < thr

    for fused in (False, True):
        label = f"RacingController.run_episode T=25 K=4000 {'fused' if fused else 'unfused'}"
        ctrl = RacingController(env, store_rollouts=not fused)
        ref = RacingController(env, store_rollouts=not fused)
        x0 = env.reset()
        counted = zero_counters()  # two traced episodes: tick 0 eager, the capture, replays
        (xs, us, ep), first = traced(
            torch, lambda: ctrl.run_episode(x0, EPISODE_TICKS, done_fn=racing_done))
        after_first = (ctrl.solver_state, ctrl.current_path_index)
        _, second = traced(
            torch, lambda: ctrl.run_episode(xs[-1], EPISODE_TICKS, done_fn=racing_done))
        once = ({"racing_fused_solve", "racing_tick_tail"} if fused
                else {"fused_regen_m2", "weighted_update_partials"}) | REFERENCE_ROWS
        want = {name: 2 * EPISODE_TICKS for name in once}
        want["racing_plant"] = racing_plant_launches(2 * EPISODE_TICKS, ctrl.config.horizon,
                                                     not fused, 2 * EPISODE_TICKS)
        want["mpcc_cost"] = mpcc_cost_launches(2 * EPISODE_TICKS, ctrl.config.horizon, not fused)
        launches = path_launches(label, counted, [first, second], want)
        if launches is None:
            return None

        def step(x, ref=ref):
            a, _ = ref.update(x)
            return env.dynamics(x[None], a[:1])[0], a[0]

        ok, n, done = against_ticks(label, xs, us, ep, step, racing_done, EPISODE_TICKS)
        ok = ok and (done or (_bitwise(after_first[0], ref.solver_state)
                              and torch.equal(after_first[1], ref.current_path_index)))
        try:
            ctrl.get_top_samples(10)
            ok = False  # diagnostics must be gone after an episode
        except RuntimeError:
            pass
        res = dict(bitwise_updates=bool(ok), ticks=n, done=done, launches=launches,
                   xs_shape=list(xs.shape), us_shape=list(us.shape))
        print(f"phase 12 {label} on {card}: {json.dumps(res)}", flush=True)
        if not ok:
            fail(f"{label}: episode against update calls {ok}")
            return None
        out[label] = res

    for name, budget in (("navigation", 300), ("pendulum", 200)):
        w = build_model_workload(name, device="cuda")
        args = dict(w.mppi_kwargs, store_rollouts=False, fused_task=w.task)
        a_c, b_c = MPPI(**args), MPPI(**args)
        dynamics = args["dynamics"]

        def plant(x, u, dynamics=dynamics):
            return dynamics(x[None], u[None])[0]

        x0 = w.env.reset() if name == "navigation" else w.x0
        done_fn = None
        if name == "navigation":
            goal_pos, g_thr = w.env.goal_pos, w.env.GOAL_THRESHOLD

            def done_fn(x, goal_pos=goal_pos, g_thr=g_thr):
                return torch.linalg.norm(x[:2] - goal_pos) < g_thr

            xs, us, ep = a_c.run_episode(plant, x0, budget, done_fn=done_fn)
        else:
            (xs, us), ep = a_c.run_episode(plant, x0, budget), None

        def step(x, b_c=b_c, plant=plant):
            a, _ = b_c.forward(x)
            return plant(x, a[0]), a[0]

        label = f"MPPI.run_episode {name} T={args['horizon']} K={args['num_samples']} fused"
        ok, n, done = against_ticks(label, xs, us, ep, step, done_fn, budget)
        res = dict(bitwise_forward=bool(ok), ticks=n, done=done,
                   xs_shape=list(xs.shape), us_shape=list(us.shape))
        if name == "pendulum":
            res["theta"] = float(angle_normalize(xs[-1, 0]))
            ok = ok and abs(res["theta"]) < 0.15
        else:
            ok = ok and done
        print(f"phase 12 {label} on {card}: {json.dumps(res)}", flush=True)
        if not ok:
            fail(f"{label}: {res}")
            return None
        out[label] = res
    return out


def pipelined_episodes(torch, card):
    """Phase 12e: ``PipelinedRunner``'s host loop against ``make_pipelined_closed_loop``.

    The pendulum's fused solver (ESSPS, T=15, K=1,000), 100 ticks at depth 1
    and 2, compensated: the states visited bit for bit.
    """
    from mppi_playground_tpu_torch import MPPI, PipelinedRunner
    from mppi_playground_tpu_torch.core.closed_loop import make_pipelined_closed_loop
    from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
    from mppi_playground_tpu_torch.workloads import build_model_workload

    w = build_model_workload("pendulum", device="cuda")
    args = dict(w.mppi_kwargs, store_rollouts=False, fused_task=w.task)
    solver = make_fused_solver(MPPI(**args).config, w.task, args["dynamics"], device="cuda")

    def plant(x, u):
        return args["dynamics"](x[None], u[None])[0]

    out = {}
    for depth in (1, 2):
        runner = PipelinedRunner(solver, depth=depth)
        runner.reset(seed=3)
        x, host = w.x0, []
        for _ in range(100):
            host.append(x)
            x = plant(x, torch.as_tensor(runner.step(x), device="cuda"))
        run = make_pipelined_closed_loop(solver, plant, 100, depth)
        _, xf, xs, us, _ = run(solver.init(seed=3), w.x0)
        ok = torch.equal(torch.stack(host), xs) and torch.equal(x, xf)
        out[f"depth {depth}"] = bool(ok)
    print(f"phase 12 PipelinedRunner against make_pipelined_closed_loop (pendulum, 100 ticks) on "
          f"{card}: {json.dumps(out)}", flush=True)
    return out if all(out.values()) else None


def drive_closed_loops(torch, env, card):
    """Phase 12: the closed loops on the card (12a-12e); returns their results or None."""
    t0 = time.perf_counter()
    flagship = flagship_episodes(torch, env, card)
    if flagship is None:
        return None
    facades = facade_graphs(torch, env, card)
    if facades is None:
        return None
    if not map_move_recapture(torch, card):
        fail("a moved map did not rebuild and recapture, or the ticks after it differ")
        return None
    episodes = facade_episodes(torch, env, card)
    if episodes is None:
        return None
    if pipelined_episodes(torch, card) is None:
        fail("PipelinedRunner differs from make_pipelined_closed_loop")
        return None
    seconds = time.perf_counter() - t0
    print(f"phase 12 took {seconds:.1f} s on {card}", flush=True)
    return dict(flagship=flagship, facades=facades, episodes=episodes, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 13: the fleet
# ---------------------------------------------------------------------------

FLEET_T, FLEET_K, FLEET_TICKS = 25, 4096, 50  # benchmarks/fleet.py's racing fleet
FLEET_BATCHES = (8, 32, 128)
FLEET_MODES_B = 32  # the MPO, ESSPS and LBPS fleets
MODEL_FLEET_B, MODEL_FLEET_TICKS = 8, 10  # every other family's fleets
KERNELS_B = 128  # the batched launches held against their twins and timed
FLEET_DEVICE = "cuda"
UNFUSED_FLEET_BATCHES = (8, 32)  # the unfused racing fleets, in turns with B single solves
UNFUSED_FLEET_TICKS = 10  # their episodes (a single unfused racing tick is ~8 ms)
UNFUSED_FLEET_KERNELS = frozenset({"fused_regen_m2", "weighted_update_partials"})
# the searches rows 4, 7 and 8 are held with over a fleet: a bracket to λ = 1,000, so that
# the racing costs' λ* lies inside it
FLEET_SEARCHES = (("ESSPS", 1000.0, None, 40), ("LBPS", 1000.0, 0.01, 32))


def fleet_searches(k: int) -> list:
    """The :data:`FLEET_SEARCHES` at K samples (ESSPS targets an ESS of K / 10)."""
    from mppi_playground_tpu_torch.ops.lambda_search import LambdaSearch

    return [LambdaSearch(mode, 0.01, lam_max, k / 10.0 if param is None else param, iters)
            for mode, lam_max, param, iters in FLEET_SEARCHES]


def fleet_kernels(model: str, config) -> set:
    """The kernels one fused fleet tick of ``config`` launches once each, for all B scenarios:
    ESSPS and LBPS by the single solver's route (the λ epilogue up to K=10,000)."""
    from mppi_playground_tpu_torch.core.fused_solver import takes_lambda_epilogue

    lam = config.auto_lambda
    if lam in ("ESSPS", "LBPS"):
        if takes_lambda_epilogue(config):
            return {f"{model}_costs_dump_lambda", "fused_weighted", f"{model}_tick_tail"}
        return {f"{model}_costs_dump", f"{lam.lower()}_lambda_fused", "fused_weighted",
                f"{model}_tick_tail"}
    return {f"{model}_fused_solve", f"{model}_tick_tail"}


def standalone_fleet(batched, task):
    """``batched`` (a fused fleet) with its ESSPS/LBPS tick on the standalone route: phase 1,
    one search cluster a scenario, phase 2 (``core.fused_solver.make_solve_batch`` with the
    route forced; the fleet itself takes no route option)."""
    from mppi_playground_tpu_torch.core.fused_solver import make_solve_batch

    solve = make_solve_batch(batched.config, task, batched.device, lambda_epilogue=False)

    def solve_batch(states, x0s, *, info=None, noise=None, batched_info=None):
        merged = dict(info or {}, **(batched_info or {}))
        return solve(states, x0s, info=merged or None, noise=noise)

    return dataclasses.replace(batched, solve_batch=solve_batch)


def fleet_config(lam, horizon=FLEET_T, num_samples=FLEET_K):
    """The racing fleet's configuration (benchmarks/fleet.py; examples/racing.py:24-35)."""
    from mppi_playground_tpu_torch.core.config import MPPIConfig

    return MPPIConfig(horizon=horizon, num_samples=num_samples, dim_state=4, dim_control=2,
                      u_min=FLEET_BOUNDS[1], u_max=FLEET_BOUNDS[2], sigmas=FLEET_BOUNDS[0],
                      lambda_=lam, store_rollouts=False)


FLEET_BOUNDS = ((0.5, 0.1), (-2.0, -0.25), (2.0, 0.25))  # RacingEnv's u_min, u_max


def racing_fleet_starts(torch, env, batch: int):
    """``(x0s [B, 4], cinds [B])``: the fleet staggered along the path (benchmarks/fleet.py:84-92)."""
    path = env.racing_center_path
    step = len(path) // batch
    x0s = env.reset().repeat(batch, 1)
    x0s[:, :3] = path[::max(1, step)][:batch]
    cinds = torch.arange(batch, dtype=torch.int64, device=path.device) * step
    return x0s.contiguous(), cinds


def racing_fleet_fns(env, horizon=FLEET_T):
    """``(info_batch, info_one, plant_one)`` of the racing fleet and of its single episodes."""
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory,
        calc_ref_trajectory_batch,
    )

    path = env.racing_center_path

    def info_batch(cinds, xs):
        xrefs, new = calc_ref_trajectory_batch(xs, path, cinds, horizon)
        return {"reference_path": xrefs}, new

    def info_one(cind, x):
        xref, new = calc_ref_trajectory(x, path, cind, horizon)
        return {"reference_path": xref}, new

    return info_batch, info_one, lambda x, u: env.dynamics(x[None], u[None])[0]


def fleet_vs_episodes(torch, solver, plant_one, num_ticks, states, x0s, carry0, info_one,
                      fleet_out) -> list:
    """The scenarios whose fleet episode differs from their own ``make_closed_loop`` episode.

    Each scenario runs alone from its state (``scenario(states, b)``), start
    and carry; its xs, us, final plant state, final solver state (device key
    included) and final carry must equal the fleet's row b bit for bit.
    """
    from mppi_playground_tpu_torch.core.closed_loop import make_closed_loop
    from mppi_playground_tpu_torch.parallel import scenario

    st, xf, xs, us, c = fleet_out[:5]
    loop = make_closed_loop(solver, plant_one, num_ticks, info_fn=info_one)
    differ = []
    for b in range(x0s.shape[0]):
        st_b, xf_b, xs_b, us_b, c_b = loop(scenario(states, b), x0s[b],
                                           None if carry0 is None else carry0[b])
        same = (torch.equal(xs[:, b], xs_b) and torch.equal(us[:, b], us_b)
                and torch.equal(xf[b], xf_b) and _bitwise(scenario(st, b), st_b)
                and (c is None or torch.equal(c[b], c_b)))
        if not same:
            differ.append(b)
    return differ


def drive_fleet(torch, label, batched, plant, x0s, carry0, info_batch, plant_one, info_one,
                num_ticks, card, turns: bool = False, once=None, trace_looped: bool = True):
    """One fleet path: traced twice, every kernel counted, bit for bit its episodes; timed.

    Every counter is set to 0 first.  The first run (tick 0 eager, the
    capture, the replays) and the second (replays only, any host sync an
    error) run under the device trace, which must see each batched kernel of
    the fleet's tick once a tick, not B times; the wrappers count tick 0
    alone.  The fleet must equal B ``make_closed_loop`` episodes bit for bit,
    and its two runs each other.  It is then timed: three untraced runs
    (host clock ending in a synchronize) give the fleet's solves/s and
    amortized tick, the second run's trace its device-busy share.  With
    ``turns``, the same B scenarios as B single solves a tick in one captured
    graph (``parallel.sharded.scenario_by_scenario`` of the single solver: the
    JAX package's ``lax.map`` form of a fused fleet, and the port's earlier
    form of the unfused one) run in turns with it (fleet, looped, looped,
    fleet, ...), bit for bit the fleet; with ``trace_looped`` one looped run
    is traced for its busy share (an unfused looped form's ~750 torch kernels
    a solve make a trace of ~240,000 kernels at B=32, which the profiler takes
    minutes to read).  ``once``: the kernels of the fleet's tick, each launched
    once a tick (:func:`fleet_kernels` of the fused fleet's config where
    None), or a dict of each one's launches a tick.  Returns the results or
    None.
    """
    from mppi_playground_tpu_torch.core.closed_loop import make_fleet_closed_loop
    from mppi_playground_tpu_torch.parallel.sharded import scenario_by_scenario

    batch = x0s.shape[0]
    run = make_fleet_closed_loop(batched, plant, num_ticks, info_fn=info_batch)
    states = batched.init_batch()
    t0, seconds = time.perf_counter(), {}

    def mark(step):
        seconds[step] = round(time.perf_counter() - t0 - sum(seconds.values()), 2)

    counted = zero_counters()
    first, first_trace = traced(torch, lambda: run(states, x0s, carry0))
    mark("first traced run")
    try:
        second, second_trace = traced(torch, lambda: run(states, x0s, carry0), no_sync=True)
    except RuntimeError as err:
        fail(f"{label}: the replays synchronized with the host: {err}")
        return None
    once = fleet_kernels(label.split()[0], batched.config) if once is None else once
    per_tick = once if isinstance(once, dict) else dict.fromkeys(once, 1)
    launches = path_launches(label, counted, [first_trace, second_trace],
                             {name: 2 * num_ticks * n for name, n in per_tick.items()})
    if launches is None:
        return None
    eager_once = read_counters(counted) == {name: per_tick.get(name, 0) for name in counted}
    mark("second traced run")
    differ = fleet_vs_episodes(torch, batched.solver, plant_one, num_ticks, states, x0s, carry0,
                               info_one, first)
    mark("single episodes")
    runs = [synced_ms(torch, lambda: run(states, x0s, carry0)) for _ in range(3)]
    ms = statistics.median(runs)
    res = dict(batch=batch, ticks=num_ticks, bitwise_episodes=not differ,
               replays_repeat=_bitwise(first, second),
               wrappers_counted_the_eager_tick_only=eager_once, launches=launches,
               capture_s=getattr(run.episode.graph, "capture_s", None), episode_ms=ms,
               amortized_tick_ms=ms / num_ticks, solves_per_s=batch * num_ticks / (ms / 1e3),
               device_busy_us=second_trace.busy_us,
               busy_share=second_trace.busy_us / (1e3 * ms),
               finite=bool(torch.isfinite(first[1]).all() and torch.isfinite(first[3]).all()))
    if turns:
        looped = make_fleet_closed_loop(scenario_by_scenario(batched.solver, batch), plant,
                                        num_ticks, info_fn=info_batch)
        mark("timed runs")
        looped_out = looped(states, x0s, carry0)
        mark("looped first run")
        looped_trace = None
        if trace_looped:
            _, looped_trace = traced(torch, lambda: looped(states, x0s, carry0))
            mark("looped traced run")
        fns = {"fleet": lambda: run(states, x0s, carry0),
               "looped": lambda: looped(states, x0s, carry0)}
        times = {name: [] for name in fns}
        order = list(fns)
        for _ in range(3):
            for name in order:
                times[name].append(synced_ms(torch, fns[name]))
            order.reverse()
        fleet_ms, looped_ms = (statistics.median(times[n]) for n in ("fleet", "looped"))
        mark("in turns")
        res.update(looped_bitwise=_bitwise(looped_out, first),
                   looped_capture_s=getattr(looped.episode.graph, "capture_s", None),
                   in_turns_fleet_episode_ms=fleet_ms, in_turns_looped_episode_ms=looped_ms,
                   in_turns_fleet_solves_per_s=batch * num_ticks / (fleet_ms / 1e3),
                   in_turns_looped_solves_per_s=batch * num_ticks / (looped_ms / 1e3))
        if looped_trace is not None:
            res.update(looped_busy_share=looped_trace.busy_us / (1e3 * looped_ms),
                       looped_device_busy_us=looped_trace.busy_us)
    res["seconds"] = seconds
    shown = dict(res, launches={k: v for k, v in launches.items() if v})
    print(f"phase 13 {label}: {num_ticks} ticks of {batch} scenarios replayed from one CUDA "
          f"graph on {card}: {json.dumps(shown)}", flush=True)
    if not (res["bitwise_episodes"] and res["replays_repeat"] and eager_once and res["finite"]
            and res.get("looped_bitwise", True)):
        fail(f"{label}: scenarios differing from their own episodes {differ}; repeat "
             f"{res['replays_repeat']}; the wrappers counted the eager tick only {eager_once}; "
             f"finite {res['finite']}; the looped form bitwise {res.get('looped_bitwise')}")
        return None
    return res


def racing_fleets(torch, env, card):
    """Phase 13a: the racing fleet at B=8, 32 and 128 (fixed λ, in turns with the looped
    form), under MPO, ESSPS and LBPS at B=32 (ESSPS and LBPS on the batched λ epilogue), and
    the unfused racing fleet at B=8 and 32 (in turns with B single unfused solves a tick).
    Returns ``{label: result}`` or None."""
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        make_mpcc_cost,
        make_racing_fused_task_from_env,
    )
    from mppi_playground_tpu_torch.parallel import make_batched_fused_solver, make_batched_solver

    task = make_racing_fused_task_from_env(env)
    info_batch, info_one, plant_one = racing_fleet_fns(env)
    cases = [(f"racing fleet B={b}", 1.0, b, True) for b in FLEET_BATCHES]
    cases += [(f"racing fleet {m} B={FLEET_MODES_B}", m, FLEET_MODES_B, False)
              for m in ("MPO", "ESSPS", "LBPS")]
    cases += [(f"racing unfused fleet B={b}", 1.0, b, True) for b in UNFUSED_FLEET_BATCHES]
    cost = make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map)
    out = {}
    for label, lam, batch, turns in cases:
        unfused = " unfused " in label
        if unfused:  # the user's dynamics and cost under vmap; rows 6 and 9 a launch each
            batched = make_batched_solver(fleet_config(lam), env.dynamics, cost, FLEET_DEVICE,
                                          batch)
        else:
            batched = make_batched_fused_solver(fleet_config(lam), task, env.dynamics,
                                                FLEET_DEVICE, batch)
        x0s, cinds = racing_fleet_starts(torch, env, batch)
        once = dict.fromkeys((UNFUSED_FLEET_KERNELS if unfused
                              else fleet_kernels("racing", batched.config)) | REFERENCE_ROWS, 1)
        # the plant a tick; under vmap the rollout and the re-roll a launch a step for all B
        once["racing_plant"] = racing_plant_launches(1, FLEET_T, unfused, 1)
        once["mpcc_cost"] = mpcc_cost_launches(1, FLEET_T, unfused)  # under vmap, for all B
        res = drive_fleet(torch, label, batched, env.dynamics, x0s, cinds, info_batch,
                          plant_one, info_one, UNFUSED_FLEET_TICKS if unfused else FLEET_TICKS,
                          card, turns=turns, once=once, trace_looped=not unfused)
        if res is None:
            return None
        out[label] = res
    return out


def epilogue_fleets_in_turns(torch, env, card):
    """Phase 13a: the ESSPS and LBPS racing fleets at B=8, 32 and 128 on the batched λ
    epilogue against the standalone route (:func:`standalone_fleet`).

    Each fleet's episode of 50 replayed ticks runs twice; both runs must
    equal the standalone fleet's episode bit for bit (every tick's actions
    and states, and the final states, λ included).  Then the two run in
    turns (epilogue, standalone, standalone, epilogue, ...), three of each,
    host clock ending in a synchronize.  Returns ``{label: result}`` or None.
    """
    from mppi_playground_tpu_torch.core.closed_loop import make_fleet_closed_loop
    from mppi_playground_tpu_torch.models.racing_mpcc import make_racing_fused_task_from_env
    from mppi_playground_tpu_torch.parallel import make_batched_fused_solver

    task = make_racing_fused_task_from_env(env)
    info_batch = racing_fleet_fns(env)[0]
    out = {}
    for mode in ("ESSPS", "LBPS"):
        for batch in FLEET_BATCHES:
            label = f"racing fleet {mode} B={batch} epilogue against standalone"
            batched = make_batched_fused_solver(fleet_config(mode), task, env.dynamics,
                                                FLEET_DEVICE, batch)
            runs = {route: make_fleet_closed_loop(fleet, env.dynamics, FLEET_TICKS,
                                                  info_fn=info_batch)
                    for route, fleet in (("epilogue", batched),
                                         ("standalone", standalone_fleet(batched, task)))}
            x0s, cinds = racing_fleet_starts(torch, env, batch)
            states = batched.init_batch()
            first = runs["epilogue"](states, x0s, cinds)
            second = runs["epilogue"](states, x0s, cinds)  # every tick replayed
            alone = runs["standalone"](states, x0s, cinds)
            times = {route: [] for route in runs}
            order = list(runs)
            for _ in range(3):
                for route in order:
                    times[route].append(synced_ms(torch, lambda r=runs[route]: r(states, x0s,
                                                                                  cinds)))
                order.reverse()
            ep_ms, st_ms = (statistics.median(times[r]) for r in ("epilogue", "standalone"))
            res = dict(batch=batch, ticks=FLEET_TICKS,
                       replays_bitwise_standalone=_bitwise(first, alone)
                       and _bitwise(second, alone),
                       final_lam_range=(first[0].lam.min().item(), first[0].lam.max().item()),
                       in_turns_epilogue_episode_ms=ep_ms, in_turns_standalone_episode_ms=st_ms,
                       epilogue_tick_ms=ep_ms / FLEET_TICKS, standalone_tick_ms=st_ms / FLEET_TICKS,
                       epilogue_vs_standalone=(ep_ms - st_ms) / st_ms)
            print(f"phase 13 {label} on {card}: {json.dumps(res)}", flush=True)
            if not res["replays_bitwise_standalone"]:
                fail(f"{label}: the epilogue fleet's replays differ from the standalone fleet")
                return None
            out[label] = res
    return out


def model_fleets(torch, card):
    """Phase 13b: every other family's fleet at its example's configuration, fixed λ and ESSPS.

    B=8 scenarios (the example's start, each moved by 0.05 b in every
    coordinate), 10 ticks, the model's own dynamics as the plant: each run as
    :func:`drive_fleet` runs the racing fleet.  Returns ``{label: result}`` or None.
    """
    from mppi_playground_tpu_torch.core.config import MPPIConfig
    from mppi_playground_tpu_torch.parallel import make_batched_fused_solver
    from mppi_playground_tpu_torch.workloads import build_model_workload

    out = {}
    for name in NEW_MODELS:
        w = build_model_workload(name, device=FLEET_DEVICE)
        kw = w.mppi_kwargs
        plant = kw["dynamics"]
        x0s = model_starts(torch, w.x0, MODEL_FLEET_B)
        for lam in (1.0, "ESSPS"):
            config = MPPIConfig(
                horizon=kw["horizon"], num_samples=kw["num_samples"],
                dim_state=kw["dim_state"], dim_control=kw["dim_control"],
                u_min=tuple(float(v) for v in torch.as_tensor(kw["u_min"]).tolist()),
                u_max=tuple(float(v) for v in torch.as_tensor(kw["u_max"]).tolist()),
                sigmas=tuple(kw["sigmas"]), lambda_=lam, store_rollouts=False)
            batched = make_batched_fused_solver(config, w.task, plant, FLEET_DEVICE,
                                                MODEL_FLEET_B)
            label = f"{name} fleet {'fixed' if lam == 1.0 else lam} B={MODEL_FLEET_B}"
            res = drive_fleet(torch, label, batched, plant, x0s, None, None,
                              lambda x, u: plant(x[None], u[None])[0], None, MODEL_FLEET_TICKS,
                              card)
            if res is None:
                return None
            out[label] = res
    return out


def model_starts(torch, x0, batch: int):
    """``[B, n]`` starts: ``x0`` moved by 0.05 b in every coordinate."""
    return (x0[None] + 0.05 * torch.arange(batch, device=x0.device)[:, None]).contiguous()


class BatchedRows:
    """The kernels line's rows of one batch's launches (phase 13c).

    Each batched launch is timed by graph replay in turns with its B single
    launches (:meth:`timed`), beside its batch symbol, its twin's time (one
    call, CUDA events, where ``time_twins``) and the batched work's bound.
    """

    def __init__(self, torch, model: str, batch: int, horizon: int, num_samples: int,
                 time_twins: bool = True):
        self.torch, self.model, self.batch = torch, model, batch
        self.horizon, self.num_samples, self.time_twins = horizon, num_samples, time_twins
        self.rows, self.plain_ms = {}, {}

    def twin(self, name: str, fn):
        """The twin's output; its time kept for ``name``'s row."""
        torch = self.torch
        if not self.time_twins:
            return fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        self.plain_ms[name] = start.elapsed_time(end)
        return out

    def singles(self, fn):
        """The B single launches, ``fn(b)`` for each scenario b."""
        return lambda: [fn(b) for b in range(self.batch)]

    def times_b(self, bound: tuple) -> tuple:
        """B times a single launch's bound: no input of these is shared by the scenarios."""
        return self.batch * bound[0], bound[1]

    def timed(self, name: str, symbol: str, batched_fn, single_fn, bound: tuple, err) -> None:
        """``name``'s row: ``bound`` is the batched launch's (``batch=`` of the bound
        functions, or :meth:`times_b`)."""
        turns = in_turns(self.torch, {"batched": batched_fn, "singles": single_fn}, windows=4,
                         per_window=5)
        source, replaces = SOURCES_OF[name.replace(f"{self.model}_", "<model>_")]
        self.rows[name] = kernel_row(
            name, source.replace("<model>", self.model), replaces, err, turns["batched"],
            self.plain_ms.get(name), *bound, batch=self.batch, horizon=self.horizon,
            num_samples=self.num_samples, symbol=symbol, single_launches_ms=turns["singles"])

    def report(self, label: str, card: str) -> dict:
        """Print the rows' times; returns ``{kernel: row}``."""
        print(f"phase 13 {label}: batched launches on {card} (graph replay, in turns with B "
              "single launches; bound of the batched launch's work): " + "; ".join(
                  f"{r['symbol']} {r['ms']:.4f} ms against {r['single_launches_ms']:.4f} ms of "
                  f"{self.batch} single launches (bound {r['bound_ms']:.5f} ms, {r['bound_by']};"
                  f" twin {r['plain_ms'] or 0.0:.1f} ms)" for r in self.rows.values()),
              flush=True)
        return self.rows


def batched_kernel_rows(torch, label, task, ops, x0s, prevs, refs, noise, bounds, k, card,
                        grid_bytes, searches: bool):
    """Phase 13c: the batched launches against the single launches and their twins; timed.

    Each batched launch (row 1, row 3 in both noise modes; rows 7 and 8,
    row 5 and row 2 on its outputs where ``searches``, else row 2 on row 1's)
    must give each scenario b the single launch's outputs on b's inputs bit
    for bit, and meet its twin at the single kernels' bars (costs rtol 1e-5
    seeded and bitwise in noise mode, the dump bitwise, the weights atol
    1e-5 and the update atol 5e-3 from the partials, λ* within the
    searches' bars, the tail's weights atol 1e-5 and actions atol 5e-3).
    Each is timed by graph replay, in turns with its B single launches,
    beside the bound of the batched launch's work (the rollouts' shared grids
    read once, everything else B times the single launch's).  Returns
    ``{kernel: row}`` (the kernels' names, as the kernels line has them) or
    None.
    """
    from mppi_playground_tpu_torch.core.config import make_batch_key
    from mppi_playground_tpu_torch.ops import fused_solve as fs
    from mppi_playground_tpu_torch.ops.lambda_search import LambdaSearch
    from mppi_playground_tpu_torch.ops.weighted_update import combine_partials

    batch, horizon, m = prevs.shape
    dev = x0s.device
    keys = make_batch_key(SEED, 0, batch, dev)
    seeds, lams = keys[:, 2], torch.ones(batch, device=dev)
    model = task.model
    ref = (lambda b: refs[b]) if refs is not None else (lambda b: None)
    args = (task, *bounds, k, k)
    checks = {}

    def slices(batched_out, singles) -> bool:
        return all(torch.equal(t[b], s) for b, one in enumerate(singles)
                   for t, s in zip(batched_out, one))

    def merged(costs, stats, numer, lam):
        return combine_partials(costs, stats, numer, lam, horizon, m)

    def partials_vs_twin(got, want, lam):
        """Weights and update from each scenario's partials against the twin's."""
        w_err = u_err = 0.0
        for b in range(batch):
            g = merged(got[0][b], got[1][b], got[2][b], lam[b])
            v = merged(want[0][b], want[1][b], want[2][b], lam[b])
            w_err = max(w_err, (g[1] - v[1]).abs().max().item())
            u_err = max(u_err, (g[0] - v[0]).abs().max().item())
        return w_err, u_err

    out = BatchedRows(torch, model, batch, horizon, k)
    twin = out.twin

    solved = {}
    for mode, nz in (("seeded", None), ("noise", noise)):
        one_noise = (lambda b: None) if nz is None else (lambda b, nz=nz: nz[b])
        got = fs.fused_solve_batch(x0s, prevs, lams, seeds, refs, *args, nz)
        singles = [fs.fused_solve(x0s[b], prevs[b], lams[b:b + 1], keys[b, 2:], ref(b), *args,
                                  one_noise(b)) for b in range(batch)]
        want = twin(f"{model}_fused_solve" if nz is None else "",
                    lambda: fs.fused_solve_batch_plain(x0s, prevs, lams, seeds, refs, *args, nz))
        rel = ((got[0] - want[0]).abs() / want[0].abs()).max().item()
        w_err, u_err = partials_vs_twin(got, want, lams)
        checks[f"row 1 {mode}"] = dict(
            singles_bitwise=slices(got, singles), cost_max_rel_err=rel,
            costs_bitwise=bool(torch.equal(got[0], want[0])), weights_max_abs_err=w_err,
            update_max_abs_err=u_err,
            ok=rel <= 1e-5 and w_err <= 1e-5 and u_err <= 5e-3
            and (mode == "seeded" or bool(torch.equal(got[0], want[0]))))
        solved[mode] = got
        dumped = fs.fused_costs_dump_batch(x0s, prevs, seeds, refs, *args, nz)
        singles = [fs.fused_costs_dump(x0s[b], prevs[b], keys[b, 2:], ref(b), *args,
                                       one_noise(b)) for b in range(batch)]
        want = twin(f"{model}_costs_dump" if nz is None else "",
                    lambda: fs.fused_costs_dump_batch_plain(x0s, prevs, seeds, refs, *args, nz))
        rel = ((dumped[0] - want[0]).abs() / want[0].abs()).max().item()
        checks[f"row 3 {mode}"] = dict(
            singles_bitwise=slices(dumped, singles), cost_max_rel_err=rel,
            dump_bitwise=bool(torch.equal(dumped[1], want[1])),
            ok=rel <= 1e-5 and bool(torch.equal(dumped[1], want[1]))
            and (mode == "seeded" or bool(torch.equal(dumped[0], want[0]))))
        if mode == "seeded":
            seeded_dump = dumped
    costs, stats, numer = solved["seeded"]
    lam_star = lams
    if searches:
        costs, dump = seeded_dump
        # spread costs put each scenario's λ* inside the bracket
        spread = ((costs - costs.min(dim=1, keepdim=True).values) * 1e-2).contiguous()
        for mode, search in (("ESSPS", LambdaSearch("ESSPS", 0.01, 10.0, k / 10.0, 40)),
                             ("LBPS", LambdaSearch("LBPS", 0.01, 10.0, 0.01, 32))):
            for which, c in (("costs", costs), ("spread", spread)):
                lam = search.run_batch(c)
                singles = [search.run(c[b]) for b in range(batch)]
                want = twin(f"{mode.lower()}_lambda_fused" if which == "spread" else "",
                            lambda s=search, c=c: torch.stack([s.plain(c[b])
                                                               for b in range(batch)]))
                bars = [lambda_vs_plain(search, c[b], lam[b], want[b]) for b in range(batch)]
                checks[f"row {7 if mode == 'ESSPS' else 8} {which}"] = dict(
                    singles_bitwise=all(torch.equal(lam[b], s) for b, s in enumerate(singles)),
                    max_abs_err=max(e for e, _ in bars), lam_range=(lam.min().item(),
                                                                   lam.max().item()),
                    ok=all(ok for _, ok in bars))
        lam_star = LambdaSearch("ESSPS", 0.01, 10.0, k / 10.0, 40).run_batch(spread)
        stats, numer = fs.fused_weighted_batch(costs, dump, lam_star)
        singles = [fs.fused_weighted(costs[b], dump[b], lam_star[b:b + 1]) for b in range(batch)]
        want = twin("fused_weighted",
                    lambda: fs.fused_weighted_batch_plain(costs, dump, lam_star))
        w_err, u_err = partials_vs_twin((costs, stats, numer), (costs, *want), lam_star)
        checks["row 5"] = dict(singles_bitwise=slices((stats, numer), singles),
                               weights_max_abs_err=w_err, update_max_abs_err=u_err,
                               ok=w_err <= 1e-5 and u_err <= 5e-3)
    history = torch.zeros(batch, horizon - 1, m, device=dev)
    keys_out = torch.empty_like(keys)
    tail = fs.fused_tick_tail_batch(x0s, costs, stats, numer, lam_star, task, history,
                                    keys=keys, keys_out=keys_out)
    singles = []
    for b in range(batch):
        key_out = torch.empty(3, dtype=torch.int32, device=dev)
        one = fs.fused_tick_tail(x0s[b], costs[b], stats[b], numer[b], lam_star[b:b + 1], task,
                                 history[b].contiguous(), key=keys[b].contiguous(),
                                 key_out=key_out)
        singles.append((*one[:3], one[3].reshape(()), one[4], key_out))
    want = twin(f"{model}_tick_tail",
                lambda: fs.fused_tick_tail_batch_plain(x0s, costs, stats, numer, lam_star, task,
                                                       history))
    w_err = (tail[2] - want[2]).abs().max().item()
    a_err = (tail[0] - want[0]).abs().max().item()
    checks["row 2"] = dict(singles_bitwise=slices((*tail, keys_out), singles),
                           weights_max_abs_err=w_err, actions_max_abs_err=a_err,
                           ok=w_err <= 1e-5 and a_err <= 5e-3)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"phase 13 {label}: batched launches against the single launches and their twins "
          f"on {card}: {json.dumps(checks)}", flush=True)
    if not all(c["ok"] and c["singles_bitwise"] for c in checks.values()):
        fail(f"{label}: a batched launch differs from its single launches or misses its "
             "twin's bar")
        return None

    # timings: graph replay of the batched launch in turns with its B single launches
    out.timed(f"{model}_fused_solve", f"{model}_fused_solve_batch",
              lambda: fs.fused_solve_batch(x0s, prevs, lams, seeds, refs, *args),
              out.singles(lambda b: fs.fused_solve(x0s[b], prevs[b], lams[b:b + 1], keys[b, 2:],
                                                   ref(b), *args)),
              solve_bound_ms(k, horizon, True, grid_bytes, ops, batch=batch),
              max(checks["row 1 seeded"]["cost_max_rel_err"],
                  checks["row 1 noise"]["cost_max_rel_err"]))
    out.timed(f"{model}_costs_dump", f"{model}_costs_dump_batch",
              lambda: fs.fused_costs_dump_batch(x0s, prevs, seeds, refs, *args),
              out.singles(lambda b: fs.fused_costs_dump(x0s[b], prevs[b], keys[b, 2:], ref(b),
                                                        *args)),
              phase1_bound_ms(k, horizon, True, grid_bytes, ops, batch=batch),
              max(checks["row 3 seeded"]["cost_max_rel_err"],
                  checks["row 3 noise"]["cost_max_rel_err"]))
    out.timed(f"{model}_tick_tail", f"{model}_tick_tail_batch",
              lambda: fs.fused_tick_tail_batch(x0s, costs, stats, numer, lam_star, task, history,
                                               keys=keys, keys_out=keys_out),
              out.singles(lambda b: fs.fused_tick_tail(x0s[b], costs[b], stats[b], numer[b],
                                                       lam_star[b:b + 1], task, history[b])),
              out.times_b(tail_bound_ms(k, horizon, ops)), checks["row 2"]["weights_max_abs_err"])
    if searches:
        out.timed("fused_weighted", "fused_weighted_batch",
                  lambda: fs.fused_weighted_batch(costs, dump, lam_star),
                  out.singles(lambda b: fs.fused_weighted(costs[b], dump[b], lam_star[b:b + 1])),
                  out.times_b(phase2_bound_ms(k, horizon, m)),
                  checks["row 5"]["weights_max_abs_err"])
        for mode, search, per_eval, per_cost in (
                ("essps", LambdaSearch("ESSPS", 0.01, 10.0, k / 10.0, 40), OPS_ESSPS_EVAL, 2),
                ("lbps", LambdaSearch("LBPS", 0.01, 10.0, 0.01, 32), OPS_LBPS_EVAL, 2)):
            out.timed(f"{mode}_lambda_fused", f"{mode}_search_batch",
                      lambda s=search: s.run_batch(spread),
                      out.singles(lambda b, s=search: s.run(spread[b])),
                      out.times_b(search_bound_ms(k, search.iters, per_eval, per_cost)),
                      checks[f"row {7 if mode == 'essps' else 8} spread"]["max_abs_err"])
    return out.report(label, card)


def epilogue_draw_weigh_rows(torch, label, task, ops, x0s, prevs, refs, noise, bounds, k, card,
                             grid_bytes, unfused: bool):
    """Phase 13c: rows 4 (the λ epilogue, a ticket a scenario), 6 (the draw) and 9 (the
    weighted update) over a fleet; rows 6 and 9 where ``unfused`` (the racing fleet's widths).

    Row 4, ESSPS and LBPS (:func:`fleet_searches`), seeded and in noise
    mode: each scenario's costs, dump and λ* bit for bit its single launch's
    and the standalone route's (row 3, then one search cluster a scenario),
    eagerly and from a CUDA graph replayed twice, every ticket 0 after each;
    λ* at the search twins' bar (:func:`lambda_vs_plain`, every B/4-th
    scenario).  Row 6, both modes, m = 2 (and m = 1 at B <= 8): each
    scenario's rows and next key bit for bit its single launch's and the
    twin's.  Row 9: each scenario's partials its single launch's, and at
    :data:`PARTIALS_BAR` against the twin.  Each is timed by graph replay in
    turns with its B single launches (row 4 under ESSPS, row 6 seeded),
    beside the batched launch's bound: row 4's shared grids read once,
    everything else B times the single launch's; the twins are timed at B
    <= 8 (one call each; ``plain_ms`` None above).  Returns ``{kernel:
    row}`` or None.
    """
    from mppi_playground_tpu_torch.core.config import make_batch_key
    from mppi_playground_tpu_torch.ops import fused_solve as fs
    from mppi_playground_tpu_torch.ops import weighted_update as wu

    batch, horizon, m = prevs.shape
    dev = x0s.device
    keys = make_batch_key(SEED, 0, batch, dev)
    seeds = keys[:, 2]
    model = task.model
    ref = (lambda b: refs[b]) if refs is not None else (lambda b: None)
    bar_rows = range(0, batch, max(1, batch // 4))
    small = batch <= MODEL_FLEET_B
    checks = {}
    out = BatchedRows(torch, model, batch, horizon, k, time_twins=small)
    twin = out.twin

    def one_ticket():
        return torch.zeros(1, dtype=torch.int32, device=dev)

    # row 4: ESSPS and LBPS, seeded and in noise mode
    searches = fleet_searches(k)
    lam_errs = []
    for mode, nz in (("seeded", None), ("noise", noise)):
        phase1 = fs.fused_costs_dump_batch(x0s, prevs, seeds, refs, task, *bounds, k, k, nz)
        for search in searches:
            tickets = torch.zeros(batch, dtype=torch.int32, device=dev)
            args = (x0s, prevs, seeds, refs, task, *bounds, k, k, nz, search, tickets)
            got = fs.fused_costs_dump_lambda_batch(*args)
            standalone = (*phase1, search.run_batch(phase1[0]))
            singles = [fs.fused_costs_dump_lambda(x0s[b], prevs[b], keys[b, 2:], ref(b), task,
                                                  *bounds, k, k, None if nz is None else nz[b],
                                                  search, one_ticket())
                       for b in range(batch)]
            graph, replayed = captured(
                torch, lambda a=args: fs.fused_costs_dump_lambda_batch(*a), 1)
            replays = []
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                replays.append(_bitwise(replayed, got) and bool((tickets == 0).all()))
            bars = [lambda_vs_plain(search, got[0][b], got[2][b]) for b in bar_rows]
            lam_errs += [e for e, _ in bars]
            checks[f"row 4 {search.mode} {mode}"] = dict(
                singles_bitwise=all(
                    torch.equal(got[0][b], one[0]) and torch.equal(got[1][b], one[1])
                    and torch.equal(got[2][b:b + 1], one[2]) for b, one in enumerate(singles)),
                standalone_bitwise=_bitwise(got, standalone),
                replays_bitwise_tickets_zero=replays,
                lam_range=(got[2].min().item(), got[2].max().item()),
                lam_max_abs_err=max(e for e, _ in bars),
                ok=all(ok for _, ok in bars) and all(replays)
                and _bitwise(got, standalone))
    essps = searches[0]
    tickets = torch.zeros(batch, dtype=torch.int32, device=dev)
    if small:
        twin(f"{model}_costs_dump_lambda", lambda: fs.fused_costs_dump_lambda_batch_plain(
            x0s, prevs, seeds, refs, task, *bounds, k, k, None, essps))
    if unfused:
        # row 6, m = 2 and m = 1 (the first action of each step); half the samples inherit
        all_rows = torch.arange(k, device=dev)
        for width in (m, 1) if small else (m,):
            p_w = prevs[..., :width].contiguous()
            b_w = tuple(b[:width] for b in bounds)
            for mode, nz in (("seeded", None), ("noise", noise)):
                nz_w = None if nz is None else nz[..., :width].contiguous()
                keys_out, twin_out = torch.empty_like(keys), torch.empty_like(keys)
                got = fs.fused_regen_batch(p_w, seeds, all_rows, *b_w, k, k // 2, nz_w,
                                           keys=keys, keys_out=keys_out)
                want = fs.fused_regen_batch_plain(p_w, seeds, all_rows, *b_w, k, k // 2, nz_w,
                                                  keys, twin_out)
                same = True
                for b in range(batch):
                    key_out = torch.empty(3, dtype=torch.int32, device=dev)
                    one = fs.fused_regen(p_w[b], keys[b, 2:], all_rows, *b_w, k, k // 2,
                                         None if nz_w is None else nz_w[b],
                                         key=keys[b].contiguous(), key_out=key_out)
                    same = same and torch.equal(got[b], one) and torch.equal(keys_out[b], key_out)
                checks[f"row 6 m={width} {mode}"] = dict(
                    singles_bitwise=same, twin_bitwise=bool(torch.equal(got, want)),
                    keys_bitwise=bool(torch.equal(keys_out, twin_out)),
                    distinct_streams=len(set(got[:, -1, 0, 0].tolist())) == batch,
                    ok=bool(torch.equal(got, want) and torch.equal(keys_out, twin_out)))
                if width == m and mode == "seeded":
                    drawn = got
        keys_out = torch.empty_like(keys)
        regen_args = (prevs, seeds, all_rows, *bounds, k, k // 2)
        if small:
            twin(f"fused_regen_m{m}", lambda: fs.fused_regen_batch_plain(
                *regen_args, None, keys, torch.empty_like(keys)))
        # row 9 on the drawn samples at the epilogue's λ*
        costs = phase1[0]
        lams = fs.fused_costs_dump_lambda_batch(x0s, prevs, seeds, refs, task, *bounds, k, k,
                                                None, essps, tickets)[2]
        samples = drawn.reshape(batch, k, -1)
        stats, numer = wu.weighted_update_partials_batch(costs, samples, lams)
        want = twin("weighted_update_partials",
                    lambda: wu.weighted_update_partials_batch_plain(costs, samples, lams))
        same = all(_bitwise((stats[b], numer[b]), wu.weighted_update_partials(
            costs[b], samples[b], lams[b:b + 1])) for b in range(batch))
        errs = [partials_errors(torch, (stats[b], numer[b]), (want[0][b], want[1][b]), costs[b],
                                samples[b], lams[b:b + 1]) for b in bar_rows]
        checks["row 9"] = dict(singles_bitwise=same, partials=errs[0],
                               lam_range=(lams.min().item(), lams.max().item()),
                               ok=all(e["ok"] for e in errs))
    torch.cuda.synchronize()
    rows_of = "4, 6 and 9" if unfused else "4"
    print(f"phase 13 {label}: rows {rows_of} over a fleet against the single launches, the "
          f"standalone route and their twins on {card}: {json.dumps(checks)}", flush=True)
    if not all(c["ok"] and c["singles_bitwise"] for c in checks.values()):
        fail(f"{label}: a batched launch of rows {rows_of} differs from its single launches or "
             "its standalone route, or misses its twin's bar")
        return None

    single_ticket = one_ticket()
    out.timed(f"{model}_costs_dump_lambda", f"{model}_costs_dump_lambda_batch",
              lambda: fs.fused_costs_dump_lambda_batch(x0s, prevs, seeds, refs, task, *bounds, k,
                                                       k, None, essps, tickets),
              out.singles(lambda b: fs.fused_costs_dump_lambda(
                  x0s[b], prevs[b], keys[b, 2:], ref(b), task, *bounds, k, k, None, essps,
                  single_ticket)),
              phase1_bound_ms(k, horizon, True, grid_bytes, ops,
                              search_ops(k, essps.iters, OPS_ESSPS_EVAL, 2), batch=batch),
              max(lam_errs))
    if unfused:
        out.timed(f"fused_regen_m{m}", f"fused_regen_m{m}_batch",
                  lambda: fs.fused_regen_batch(*regen_args, keys=keys, keys_out=keys_out),
                  out.singles(lambda b: fs.fused_regen(prevs[b], keys[b, 2:], all_rows, *bounds,
                                                       k, k // 2, key=keys[b],
                                                       key_out=keys_out[b])),
                  out.times_b(regen_bound_ms(k, horizon, True, m)), 0.0)
        out.timed("weighted_update_partials", "weighted_update_batch",
                  lambda: wu.weighted_update_partials_batch(costs, samples, lams),
                  out.singles(lambda b: wu.weighted_update_partials(costs[b], samples[b],
                                                                    lams[b:b + 1])),
                  out.times_b(weighted_update_bound_ms(k, horizon * m)),
                  max((stats - want[0]).abs().max().item(),
                      (numer - want[1]).abs().max().item()))
    return out.report(f"{label} (rows {rows_of})", card)


def fleet_rows_4_6_9(torch, np, env, card):
    """Rows 4, 6 and 9 over the racing fleet at B=8, 32 and 128
    (:func:`epilogue_draw_weigh_rows`): ``{kernel: row at B=128}``, each row's ``by_batch``
    holding its time, its B single launches' and its bound at every B.  None after a
    failure."""
    from mppi_playground_tpu_torch.models.racing_mpcc import make_racing_fused_task_from_env

    task = make_racing_fused_task_from_env(env)
    grid_bytes = sum(g.numel() for g in task.grids)
    by_batch = {}
    for batch in FLEET_BATCHES:
        got = epilogue_draw_weigh_rows(
            torch, f"racing T={FLEET_T} K={FLEET_K} B={batch}", task, RACING,
            *fleet_kernel_inputs(torch, np, env, batch), FLEET_BOUNDS, FLEET_K, card,
            grid_bytes, unfused=True)
        if got is None:
            return None
        by_batch[batch] = got
    rows = by_batch[max(FLEET_BATCHES)]
    for name, row in rows.items():
        row["by_batch"] = {b: {f: r[name][f] for f in ("ms", "single_launches_ms", "bound_ms",
                                                      "bound_by", "plain_ms")}
                           for b, r in by_batch.items()}
    return rows


# source file and TPU kernel line of each kernel with a batched launch (<model> stands for
# the model)
SOURCES_OF = {
    "<model>_fused_solve": ("fused_<model>.cu", f"{FUSED_SOLVE_PY}:783"),
    "<model>_costs_dump": ("fused_<model>.cu", f"{FUSED_SOLVE_PY}:783"),
    "<model>_costs_dump_lambda": ("fused_<model>.cu", f"{FUSED_SOLVE_PY}:783"),
    "fused_regen_m2": ("fused_solve.cu", f"{FUSED_SOLVE_PY}:937"),
    "weighted_update_partials": ("weighted_update.cu",
                                 "mppi_playground_tpu/ops/pallas_kernels.py:142"),
    "<model>_tick_tail": ("reroll.cu", f"{FUSED_SOLVE_PY}:272"),
    "fused_weighted": ("fused_solve.cu", f"{FUSED_SOLVE_PY}:887"),
    "essps_lambda_fused": ("lambda_search.cu", f"{LAMBDA_SEARCH_PY}:354"),
    "lbps_lambda_fused": ("lambda_search.cu", f"{LAMBDA_SEARCH_PY}:394"),
}


def fleet_kernel_inputs(torch, np, env, batch: int):
    """Racing's batched-launch inputs at the fleet's width: the staggered starts, their
    reference rows, seeded warm starts and noise ``[B, K, T, 2]``."""
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory_batch,
        extend_reference_path,
    )

    dev = env.racing_center_path.device
    x0s, cinds = racing_fleet_starts(torch, env, batch)
    xrefs, _ = calc_ref_trajectory_batch(x0s, env.racing_center_path, cinds, FLEET_T)
    rng = np.random.default_rng(SEED)
    sig = FLEET_BOUNDS[0]
    prevs = torch.tensor(rng.standard_normal((batch, FLEET_T, 2)) * sig, dtype=torch.float32,
                         device=dev)
    noise = torch.tensor((rng.standard_normal((batch, FLEET_K, FLEET_T, 2)) * sig)
                         .astype(np.float32), device=dev)
    return x0s, prevs, extend_reference_path(xrefs).contiguous(), noise


def model_kernel_inputs(torch, np, name, batch: int):
    """A family's batched-launch inputs at its configuration: its seeded warm start and
    noise, each scenario's scaled by 1 + b/10 and 1 + b/100, and :func:`model_starts`."""
    w, prev, noise, bounds = model_inputs(torch, np, name)
    scale = torch.arange(batch, device=prev.device, dtype=torch.float32)
    prevs = (prev[None] * (1 + 0.1 * scale)[:, None, None]).contiguous()
    noises = (noise[None] * (1 + 0.01 * scale)[:, None, None, None]).contiguous()
    return w, model_starts(torch, w.x0, batch), prevs, noises, bounds


def utils_on_card(torch, env, card):
    """Phase 13d: ``checked_solve``, ``time_fn`` and the checkpoint on the flagship, on the card.

    A checked flagship solve passes, then a plant that turns the state into
    NaN makes the next checked solve raise with the JAX package's message;
    ``time_fn`` times the flagship tick beside :func:`graph_ms`; a flagship
    episode of 50 ticks saved after 25 (``save_state``), restored
    (``load_state``) and run for 25 more is bit for bit the uninterrupted
    episode.  Returns the results or None.
    """
    import tempfile

    from mppi_playground_tpu_torch.core.closed_loop import make_closed_loop
    from mppi_playground_tpu_torch.utils.checkpoint import load_state, save_state
    from mppi_playground_tpu_torch.utils.guards import NonFiniteSolveError, checked_solve
    from mppi_playground_tpu_torch.utils.timing import time_fn
    from mppi_playground_tpu_torch.workloads import build_flagship

    _, solver, _ = build_flagship(horizon=T, num_samples=K, env=env, device=FLEET_DEVICE)
    _, info_one, plant_one = racing_fleet_fns(env, T)
    x, c = env.reset(), torch.zeros((), dtype=torch.int64, device=FLEET_DEVICE)
    checked = checked_solve(solver)
    info, c = info_one(c, x)
    r = checked(solver.init(), x, info=info)
    x_nan = torch.full_like(x, float("nan"))  # the plant's next state
    info, c = info_one(c, x_nan)
    message = None
    try:
        checked(r.state, x_nan, info=info)
    except NonFiniteSolveError as err:
        message = str(err)
    nan_raised = message == "non-finite trajectory costs (dynamics or cost overflow)"

    x0, c0 = env.reset(), torch.zeros((), dtype=torch.int64, device=FLEET_DEVICE)
    info0, _ = info_one(c0, x0)
    state0 = solver.init()
    stats = time_fn(lambda: solver.solve(state0, x0, info=info0), warmup=3, iters=20)
    tick_graph_ms = graph_ms(torch, lambda: solver.solve(state0, x0, info=info0), 20) \
        if x0.device.type == "cuda" else None

    half = EPISODE_TICKS // 2
    whole = make_closed_loop(solver, plant_one, EPISODE_TICKS, info_fn=info_one)
    part = make_closed_loop(solver, plant_one, half, info_fn=info_one)
    want = whole(state0, x0, c0)
    st, xf, xs_a, us_a, c_half = part(state0, x0, c0)
    with tempfile.TemporaryDirectory() as tmp:
        restored = load_state(save_state(f"{tmp}/flagship", st), solver.init())
    st, xf, xs_b, us_b, c_end = part(restored, xf, c_half)
    resumed = (st, xf, torch.cat([xs_a, xs_b]), torch.cat([us_a, us_b]), c_end)
    res = dict(checked_nan_raised=nan_raised, checked_message=message,
               checked_first_solve_finite=bool(torch.isfinite(r.action_seq).all()),
               time_fn_ms={k[:-2] + "_ms": 1e3 * v for k, v in stats.items() if k != "per_s"},
               time_fn_per_s=stats["per_s"], tick_graph_ms=tick_graph_ms,
               resume_bitwise=_bitwise(resumed, want) and st.tick == want[0].tick)
    print(f"phase 13 utils on the flagship (T={T}, K={K}) on {card}: {json.dumps(res)}",
          flush=True)
    if not (nan_raised and res["checked_first_solve_finite"] and res["resume_bitwise"]):
        fail(f"utils on the card: NaN raised with the JAX message {nan_raised} ({message!r}); "
             f"the resumed episode bitwise {res['resume_bitwise']}")
        return None
    return res


def drive_fleets(torch, np, env, card):
    """Phase 13: the fleet (13a-13d); returns its results or None."""
    from mppi_playground_tpu_torch.models.racing_mpcc import make_racing_fused_task_from_env

    t0 = time.perf_counter()

    def took(part):
        print(f"phase 13 {part} took {time.perf_counter() - t0:.1f} s since its start", flush=True)

    racing = racing_fleets(torch, env, card)
    if racing is None:
        return None
    took("13a racing fleets")
    models = model_fleets(torch, card)
    if models is None:
        return None
    took("13b model fleets")
    task = make_racing_fused_task_from_env(env)
    epilogue = epilogue_fleets_in_turns(torch, env, card)
    if epilogue is None:
        return None
    took("13a epilogue against standalone")
    rows = batched_kernel_rows(
        torch, f"racing T={FLEET_T} K={FLEET_K} B={KERNELS_B}", task, RACING,
        *fleet_kernel_inputs(torch, np, env, KERNELS_B), FLEET_BOUNDS, FLEET_K, card,
        sum(g.numel() for g in task.grids), searches=True)
    if rows is None:
        return None
    took("13c racing batched launches")
    got = fleet_rows_4_6_9(torch, np, env, card)
    if got is None:
        return None
    rows.update(got)
    took("13c racing rows 4, 6, 9")
    for name in NEW_MODELS:
        w, x0s, prevs, noises, bounds = model_kernel_inputs(torch, np, name, MODEL_FLEET_B)
        k = w.mppi_kwargs["num_samples"]
        label = f"{name} T={prevs.shape[1]} K={k} B={MODEL_FLEET_B}"
        grid_bytes = sum(g.numel() for g in w.task.grids)
        got = batched_kernel_rows(torch, label, w.task, MODEL_OPS[name], x0s, prevs, None,
                                  noises, bounds, k, card, grid_bytes, searches=False)
        row4 = epilogue_draw_weigh_rows(torch, label, w.task, MODEL_OPS[name], x0s, prevs,
                                        None, noises, bounds, k, card, grid_bytes,
                                        unfused=False)
        if got is None or row4 is None:
            return None
        rows.update(got)
        rows.update(row4)
    took("13c the families' batched launches")
    utils = utils_on_card(torch, env, card)
    if utils is None:
        return None
    seconds = time.perf_counter() - t0
    print(f"phase 13 took {seconds:.1f} s on {card}", flush=True)
    return dict(racing=racing, models=models, rows=rows, utils=utils, epilogue=epilogue,
                seconds=seconds)


def fleets_alone() -> int:
    """Phase 13 alone, after a build of ``csrc/``::

        python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.fleets_alone())'
    """
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mppi_playground_tpu_torch.envs import RacingEnv
    from mppi_playground_tpu_torch.ops import cuda_build

    card = card_line()
    print(card, flush=True)
    print(f"build: {cuda_build.build():.1f} s", flush=True)
    return 0 if drive_fleets(torch, np, RacingEnv(device="cuda"), card) is not None else 1


def tpu_row(name: str):
    """The row of PERF.md's table of TPU kernels that kernel ``name`` ports; None for the
    reference rows, the racing plant and the MPCC cost, which port XLA's ops (the JAX package
    has no kernel for them)."""
    if name in ("reference_rows", "racing_plant", "mpcc_cost"):
        return None
    for part, row in (("_fused_solve", 1), ("_reroll", 2), ("_tick_tail", 2),
                      ("_costs_dump_lambda", 4),
                      ("_costs_dump", 3), ("fused_weighted", 5), ("fused_regen_m", 6),
                      ("_top_rollouts", 6), ("essps_lambda_fused", 7), ("lbps_lambda_fused", 8),
                      ("weighted_update_partials", 9)):
        if part in name:
            return row
    raise ValueError(f"no TPU kernel row for {name}")


def path_model(path: str, plugs=()) -> str:
    """The model family (or one of ``plugs``) a path of this run drives (the flagship and
    both facades: racing)."""
    first = path.split()[0]
    return first if first in MODEL_OPS or first in {p.name for p in plugs} else "racing"


def is_fleet_path(path: str) -> bool:
    """Whether a path of this run is a fleet's (phase 13), whose launches are batched."""
    return " fleet" in path


def row_products(kernels: list, shared: dict, plugs=()) -> dict:
    """``{row: ms}``: launches x (ms - bound_ms) summed over the kernels of each row.

    A kernel of one model takes its own row's time; a kernel every model
    shares (phase 2, the regeneration of m=1 and m=2) takes, path by path,
    the time at that path's model's configuration (``shared``).  Model paths
    at K=100,000 take the example configuration's time; a fleet's path takes
    the kernel's batched launch's (``batched``, phase 13).
    """
    out = {}
    for k in kernels:
        if k["row"] is None:  # ports no TPU kernel
            continue
        total = 0.0
        for path, n in k["launches_by_path"].items():
            if not n:
                continue
            ms, bound = shared.get((k["name"], path_model(path, plugs)), (k["ms"], k["bound_ms"]))
            if is_fleet_path(path):
                ms, bound = k["batched"]["ms"], k["batched"]["bound_ms"]
            total += n * (ms - bound)
        out[k["row"]] = out.get(k["row"], 0.0) + total
    return dict(sorted(out.items(), key=lambda item: -item[1]))


FLAGSHIP_BOUNDS = ((0.5, 0.1), (-2.0, -0.25), (2.0, 0.25))  # sigma, u_min, u_max


def exact_sweep(torch, symbol: str, counts: int, *args) -> tuple:
    """The counts of ``csrc/exact_checks.cu``'s exhaustive sweep ``symbol``.

    ``args`` are the sweep's leading pointers; it adds into ``counts``
    zeroed int64 counters.
    """
    import ctypes

    from mppi_playground_tpu_torch.ops import cuda_build

    out = torch.zeros(counts, dtype=torch.int64, device="cuda")
    cuda_build.launch("exact_checks", symbol, [ctypes.c_void_p] * (len(args) + 1), out.device,
                      *args, out.data_ptr())
    return tuple(out.tolist())


def key_sweep(torch, np) -> dict:
    """``devmath::advance_key`` (and so ``devmath::tick_seed``) against the host's ``tick_seed``.

    4,096 random seeds (the top bit set in about half) and ticks up to 2^40,
    and the edges (seed 2^64 - 1, ticks 2^32 - 1 and 2^32); each device key
    moved on one tick must equal ``make_key(seed, tick + 1)`` word for word.
    """
    import ctypes

    from mppi_playground_tpu_torch.core.config import make_key
    from mppi_playground_tpu_torch.ops import cuda_build

    rng = np.random.default_rng(SEED)
    pairs = [(int(s), int(t)) for s, t in zip(rng.integers(0, 2**64, 4096, dtype=np.uint64),
                                              rng.integers(0, 2**40, 4096))]
    pairs += [(2**64 - 1, 2**32 - 1), (2**63 + 1, 2**32), (0, 0), (7, 2**32 + 5)]
    keys = torch.stack([make_key(s, t, "cpu") for s, t in pairs]).cuda()
    out = torch.empty_like(keys)
    cuda_build.launch("exact_checks", "key_sweep",
                      [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], keys.device,
                      keys.data_ptr(), len(pairs), out.data_ptr())
    want = torch.stack([make_key(s, t + 1, "cpu") for s, t in pairs])
    differ = int((out.cpu() != want).any(dim=1).sum())
    return dict(keys=len(pairs), differ=differ,
                top_bit_seeds=sum(s >= 2**63 for s, _ in pairs),
                ticks_past_2_32=sum(t >= 2**32 for _, t in pairs))


# Cell sizes of the cell-index sweep besides the repo's maps' (at racing's origin
# and width): a user can pass any, and the reciprocal's proof does not depend on it.
OTHER_CELL_SIZES = (0.01, 0.05, 0.07, 0.25, 0.3, 1.0)


def cell_sweeps(torch, geometries: dict) -> dict:
    """``csrc/exact_checks.cu``'s cell-index sweep over all 2^32 positions at each geometry.

    ``geometries`` maps a label to a task's ``(floats, ints)``; each gives
    ``{label: (cells that differ, quotients that differ (positions from
    2^-100, quotients below 2^100), positions on the grid)}``.
    """
    from mppi_playground_tpu_torch.ops.fused_solve import _floats, _ints

    return {label: exact_sweep(torch, "cell_sweep", 3, _floats(floats[:7]), _ints(ints[:2]))
            for label, (floats, ints) in geometries.items()}


# --- phase 14: sample sharding -------------------------------------------------

SHARDS = (2, 4, 8)
# inside a later shard at every D: the shards are 50,176, 25,088 and 12,544 samples
SHARD_THRESHOLD = 70_000
FLEET_SHARD_B, FLEET_SHARD_THRESHOLD = 8, 3_000  # the fleet's launch: its K=4,096 in 2-8 shards
SHARDED_TICKS = 50  # the one-rank facade's ticks a mode
GLOO_TICKS = 5  # the two gloo ranks' ticks


def shard_rows(torch, fs, x0s, prevs, lams, seeds, refs, task, k, threshold, noise) -> dict:
    """Rows 1, 3 and 5 of every shard at D = 2, 4, 8, concatenated and sliced, against the whole.

    ``noise [B, K, T, 2]``; every other array as the ``*_batch`` wrappers
    take it.  In both noise modes each shard launches at its sample offset
    (``parallel/sharded.shard_size``); its costs, partials and dump,
    concatenated in shard order and sliced to K samples and ``ceil(K /
    256)`` blocks, must be the whole launch's bit for bit, and its samples
    past K must cost 1e30 and dump zeros.  D=2's last shard is also held
    against its twins (costs and dump bitwise, the partials at
    :data:`PARTIALS_BAR`'s tolerance through ``partials_errors``-style
    checks: the block maxima bitwise).  Returns ``{f"{mode} D={d}": {...}}``.
    """
    from mppi_playground_tpu_torch.parallel.sharded import shard_size

    sig, lo, hi = FLAGSHIP_BOUNDS
    blocks = -(-k // 256)
    out = {}
    for mode, nz in (("seeded", None), ("noise", noise)):
        whole1 = fs.fused_solve_batch(x0s, prevs, lams, seeds, refs, task, sig, lo, hi, k,
                                      threshold, nz)
        whole3 = fs.fused_costs_dump_batch(x0s, prevs, seeds, refs, task, sig, lo, hi, k,
                                           threshold, nz)
        whole5 = fs.fused_weighted_batch(*whole3, lams)
        for d in SHARDS:
            local = shard_size(k, d)
            r1, r3, r5, padding = [], [], [], True
            for rank in range(d):
                off, rows = rank * local, None
                if nz is not None:
                    rows = nz[:, off:off + local]
                    rows = torch.cat([rows, rows.new_zeros(rows.shape[0], local - rows.shape[1],
                                                           *rows.shape[2:])], 1).contiguous()
                shard = (local, threshold, rows, off, k)
                r1.append(fs.fused_solve_batch(x0s, prevs, lams, seeds, refs, task, sig, lo, hi,
                                               *shard))
                r3.append(fs.fused_costs_dump_batch(x0s, prevs, seeds, refs, task, sig, lo, hi,
                                                    *shard))
                r5.append(fs.fused_weighted_batch(*r3[-1], lams, off, k))
                past = torch.arange(off, off + local, device=x0s.device) >= k
                padding = padding and bool((r1[-1][0][:, past] == 1e30).all()
                                           and (r3[-1][0][:, past] == 1e30).all()
                                           and (r3[-1][1][:, :, past] == 0).all())
            torch.cuda.synchronize()

            def same(parts, whole, dim, n):
                return bool(torch.equal(torch.cat(parts, dim).narrow(dim, 0, n), whole))

            res = {
                "row1": same([r[0] for r in r1], whole1[0], 1, k)
                and same([r[1] for r in r1], whole1[1], 1, blocks)
                and same([r[2] for r in r1], whole1[2], 1, blocks),
                "row3": same([r[0] for r in r3], whole3[0], 1, k)
                and same([r[1] for r in r3], whole3[1], 2, k),
                "row5": same([r[0] for r in r5], whole5[0], 1, blocks)
                and same([r[1] for r in r5], whole5[1], 1, blocks),
                "padding": padding, "shard_samples": local,
            }
            if d == 2 and mode == "seeded":  # the last shard against its twins
                off = local
                tw1 = fs.fused_solve_batch_plain(x0s, prevs, lams, seeds, refs, task, sig, lo,
                                                 hi, local, threshold, None, off, k)
                tw3 = fs.fused_costs_dump_batch_plain(x0s, prevs, seeds, refs, task, sig, lo,
                                                      hi, local, threshold, None, off, k)
                tw5 = fs.fused_weighted_batch_plain(*tw3, lams, off, k)
                res["twin_costs_bitwise"] = bool(torch.equal(r1[1][0], tw1[0])
                                                 and torch.equal(r3[1][0], tw3[0]))
                res["twin_dump_bitwise"] = bool(torch.equal(r3[1][1], tw3[1]))
                res["twin_block_max_bitwise"] = bool(torch.equal(r1[1][1][..., 0], tw1[1][..., 0])
                                                     and torch.equal(r5[1][0][..., 0],
                                                                     tw5[0][..., 0]))
                res["twin_partials_max_rel_err"] = max(
                    ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
                    for a, b in ((r1[1][1][..., 1:], tw1[1][..., 1:]),
                                 (r5[1][0][..., 1:], tw5[0][..., 1:])))
                res["twin_numer_max_abs_err"] = max(
                    (r1[1][2] - tw1[2]).abs().max().item(), (r5[1][1] - tw5[1]).abs().max().item())
            out[f"{mode} D={d}"] = res
    return out


def free_port() -> int:
    """A TCP port on localhost that no process listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def flagship_closed_loop_fns(env):
    """``(info_fn, plant)`` of the flagship's closed loop (phase 12's)."""
    from mppi_playground_tpu_torch.models.racing_mpcc import calc_ref_trajectory

    path = env.racing_center_path

    def info_fn(cind, x):
        xref, new_cind = calc_ref_trajectory(x, path, cind, T)
        return {"reference_path": xref}, new_cind

    return info_fn, lambda x, u: env.dynamics(x[None], u[None])[0]


def checkpoint_round_trips(torch, state, template) -> dict:
    """The directory checkpoint of ``state`` on this group: saved with and without ``wait``.

    ``save_state_orbax`` then ``load_state_orbax`` into ``template``, once
    with ``wait=True`` and once with ``wait=False`` and ``wait_until_saved``;
    ``{wait: restored bit for bit}``, or the error's text.
    """
    import tempfile

    from mppi_playground_tpu_torch.ops import cuda_build
    from mppi_playground_tpu_torch.utils.checkpoint import (
        load_state_orbax,
        save_state_orbax,
        wait_until_saved,
    )

    out = {}
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR.parent) as d:
        for wait in (True, False):
            try:
                path = save_state_orbax(str(Path(d) / f"wait_{wait}"), state, wait=wait)
                wait_until_saved()
                restored = load_state_orbax(path, template)
                out[f"wait={wait}"] = (_bitwise(restored, state)
                                       and (restored.seed, restored.tick)
                                       == (state.seed, state.tick))
            except Exception as err:  # recorded, and the phase fails on it
                out[f"wait={wait}"] = f"{type(err).__name__}: {str(err)[-300:]}"
    return out


def sharded_facade(torch, env, card):
    """Phase 14b: ``make_sharded_fused_solver`` on a one-rank group, against the single solver.

    The group is ``initialize_distributed``'s for a CUDA device,
    ``"cpu:gloo,cuda:nccl"``: NCCL for the CUDA tensors, gloo for the CPU
    ones.  At the flagship (T=50, K=100,000), fixed λ, MPO and ESSPS: 50
    eager ticks of each, counted, bit for bit (the final state and key,
    every tick's state and action); the host-driven tick of both in turns
    (10 windows of 5 ticks); then the 50-tick episode through
    ``make_closed_loop``, which must capture (NCCL's collectives in the
    mixed group), be bit for bit the eager ticks, and whose replays are
    timed in turns with the single solver's; last, the sharded solver's
    state after its ticks through the directory checkpoint, with and without
    ``wait`` (:func:`checkpoint_round_trips`), bit for bit.  Returns ``{mode:
    {...}}`` or None.
    """
    import torch.distributed as dist

    from mppi_playground_tpu_torch.core.closed_loop import make_closed_loop
    from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
    from mppi_playground_tpu_torch.models.racing_mpcc import make_racing_fused_task_from_env
    from mppi_playground_tpu_torch.parallel import (
        cuda_backend,
        initialize_distributed,
        make_mesh,
        make_sharded_fused_solver,
    )
    from mppi_playground_tpu_torch.workloads import build_flagship

    initialize_distributed(f"localhost:{free_port()}", 1, 0, device="cuda")
    try:
        group = dict(backend=str(dist.get_backend()), cuda_backend=cuda_backend(),
                     current_device=torch.cuda.current_device())
        print(f"phase 14 the one-rank group on {card}: {json.dumps(group)}", flush=True)
        if group["cuda_backend"] != "nccl" or "cpu:gloo" not in group["backend"]:
            fail(f"initialize_distributed on a CUDA device made the group {group}, not "
                 "cpu:gloo,cuda:nccl")
            return None
        mesh = make_mesh()
        _, fixed, _ = build_flagship(horizon=T, num_samples=K, env=env, device="cuda")
        task = make_racing_fused_task_from_env(env)
        info_fn, plant = flagship_closed_loop_fns(env)
        out = {}
        for mode in ("fixed", "MPO", "ESSPS"):
            config = fixed.config if mode == "fixed" else dataclasses.replace(fixed.config,
                                                                              lambda_=mode)
            single = make_fused_solver(config, task, env.dynamics, device="cuda")
            sharded = make_sharded_fused_solver(config, task, env.dynamics, mesh)
            x0 = env.reset()
            c0 = torch.zeros((), dtype=torch.int64, device="cuda")
            counted = zero_counters()
            got = eager_episode(torch, sharded, plant, SHARDED_TICKS, sharded.init(), x0, c0,
                                info_fn)
            launches = read_counters(counted)
            want = eager_episode(torch, single, plant, SHARDED_TICKS, single.init(), x0, c0,
                                 info_fn)
            exact = _bitwise(got, want)
            runners = {"single": single, "sharded": sharded}
            states = {name: solver.init() for name, solver in runners.items()}
            carry = {name: (x0, c0) for name in runners}
            times = {name: [] for name in runners}
            order = list(runners)
            for _ in range(10):
                for name in order:
                    def ticks(name=name):
                        for _ in range(5):
                            x, c = carry[name]
                            info, c_next = info_fn(c, x)
                            r = runners[name].solve(states[name], x, info=info)
                            states[name], carry[name] = r.state, (plant(x, r.action_seq[0]),
                                                                  c_next)
                    times[name].append(synced_ms(torch, ticks) / 5)
                order.reverse()
            res = dict(bitwise_single=exact,
                       launches={k: v for k, v in launches.items() if v},
                       tick_ms_in_turns={n: statistics.median(v) for n, v in times.items()})
            try:
                run = make_closed_loop(sharded, plant, SHARDED_TICKS, info_fn=info_fn)
                episode = run(sharded.init(), x0, c0)
                res["captured"] = True
                res["replayed_bitwise_eager"] = _bitwise(episode, got)
                single_run = make_closed_loop(single, plant, SHARDED_TICKS, info_fn=info_fn)
                single_run(single.init(), x0, c0)
                runs = {"single": [], "sharded": []}
                for _ in range(3):
                    for name, fn in (("single", single_run), ("sharded", run),
                                     ("sharded", run), ("single", single_run)):
                        solver = runners[name]
                        runs[name].append(synced_ms(torch, lambda fn=fn, solver=solver: fn(
                            solver.init(), x0, c0)) / SHARDED_TICKS)
                res["replayed_tick_ms_in_turns"] = {n: statistics.median(v)
                                                    for n, v in runs.items()}
                res["capture_s"] = run.episode.graph.capture_s
            except RuntimeError as err:
                res["captured"] = False
                res["capture_error"] = str(err)[-400:]
            res["checkpoint_bitwise"] = checkpoint_round_trips(torch, got[0], sharded.init())
            print(f"phase 14 sharded facade, {mode}, one-rank cpu:gloo,cuda:nccl group, T={T}, "
                  f"K={K}, {SHARDED_TICKS} ticks on {card}: {json.dumps(res)}", flush=True)
            want_kernels = (fused_kernels("racing", config) - {"racing_top_rollouts"}
                            | REFERENCE_ROWS | RACING_PLANT)
            if not (exact and set(res["launches"]) == want_kernels
                    and all(v == SHARDED_TICKS for v in res["launches"].values())
                    and res["captured"] and res["replayed_bitwise_eager"]
                    and all(v is True for v in res["checkpoint_bitwise"].values())):
                fail(f"sharded facade {mode}: bitwise {exact}, launches {res['launches']} "
                     f"(want {sorted(want_kernels)} {SHARDED_TICKS} times each), captured "
                     f"{res['captured']}, replayed {res.get('replayed_bitwise_eager')}, "
                     f"checkpoint {res['checkpoint_bitwise']}")
                return None
            out[mode] = res
        return out
    finally:
        dist.destroy_process_group()


def _gloo_rank(rank: int, port: int, out_dir: str) -> None:
    """One of two gloo ranks sharing the card: :func:`gloo_pair`'s body."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mppi_playground_tpu_torch.core.closed_loop import CAPTURABLE, make_closed_loop
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
    from mppi_playground_tpu_torch.models.racing_mpcc import make_racing_fused_task_from_env
    from mppi_playground_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        make_sharded_fused_solver,
    )
    from mppi_playground_tpu_torch.workloads import build_flagship

    initialize_distributed(f"localhost:{port}", 2, rank, device="cuda", backend="gloo")
    try:
        env = RacingEnv(device="cuda")
        _, single, _ = build_flagship(horizon=T, num_samples=K, env=env, device="cuda")
        sharded = make_sharded_fused_solver(single.config, make_racing_fused_task_from_env(env),
                                            env.dynamics, make_mesh(device_type="cuda"))
        info_fn, plant = flagship_closed_loop_fns(env)
        x0 = env.reset()
        c0 = torch.zeros((), dtype=torch.int64, device="cuda")
        eager_episode(torch, sharded, plant, 1, sharded.init(), x0, c0, info_fn)  # warm
        t0 = time.perf_counter()
        got = eager_episode(torch, sharded, plant, GLOO_TICKS, sharded.init(), x0, c0, info_fn)
        torch.cuda.synchronize()
        tick_ms = 1e3 * (time.perf_counter() - t0) / GLOO_TICKS
        want = eager_episode(torch, single, plant, GLOO_TICKS, single.init(), x0, c0, info_fn)
        res = dict(rank=rank, bitwise_single=_bitwise(got, want), tick_ms=tick_ms)
        try:
            make_closed_loop(sharded, plant, 3, info_fn=info_fn)(sharded.init(), x0, c0)
            res["capture"] = "captured"
        except RuntimeError as err:
            res["capture"] = "raised CAPTURABLE" if CAPTURABLE in str(err) else str(err)[-400:]
        (Path(out_dir) / f"gloo_rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def gloo_pair(torch, card):
    """Phase 14c: two gloo ranks sharing the card, five sharded flagship ticks each.

    Each rank's fixed-λ solve, its samples sharded over the two ranks and
    gathered through host memory (gloo's CUDA collectives), must be bit for
    bit the single solve on that rank; a capture of the sharded tick must
    raise ``closed_loop.CAPTURABLE`` (gloo's collectives cannot be captured).
    The tick time is gloo through host memory on one card, not a multi-GPU
    number.  Returns the ranks' results or None.
    """
    import tempfile

    import torch.multiprocessing as mp

    from mppi_playground_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR.parent) as d:
        mp.spawn(_gloo_rank, args=(free_port(), d), nprocs=2, join=True)
        ranks = [json.loads((Path(d) / f"gloo_rank{r}.json").read_text()) for r in range(2)]
    print(f"phase 14 two gloo ranks sharing {card} (collectives through host memory; not a "
          f"multi-GPU number), T={T}, K={K}, {GLOO_TICKS} ticks: {json.dumps(ranks)}",
          flush=True)
    if not all(r["bitwise_single"] and r["capture"] == "raised CAPTURABLE" for r in ranks):
        fail("two gloo ranks: a rank's sharded solve differs from the single solve, or its "
             "capture did not raise the CAPTURABLE message")
        return None
    return ranks


def drive_sharding(torch, np, env, card):
    """Phase 14: sample sharding on the card.

    (a) rows 1, 3 and 5 per shard (:func:`shard_rows`) at the flagship
    (racing, T=50, K=100,000, the inheritance threshold in a later shard)
    and on a B=8 fleet launch (T=25, K=4,096), D = 2, 4, 8, both noise
    modes; (b) :func:`sharded_facade`; (c) :func:`gloo_pair`.  Returns
    ``{"rows": ..., "facade": ..., "gloo": ..., "seconds": s}`` or None.
    """
    from mppi_playground_tpu_torch.core.config import tick_seed
    from mppi_playground_tpu_torch.ops import fused_solve as fs

    t0 = time.perf_counter()
    _, task, x0, xref5, prev, noise = flagship_inputs(torch, np)
    seed = device_seed(torch, tick_seed(42, 0))
    lam = torch.full((1,), 0.7, device="cuda")
    flagship = shard_rows(torch, fs, x0[None], prev[None], lam, seed.reshape(1), xref5[None],
                          task, K, SHARD_THRESHOLD, noise[None])
    del noise
    x0s, prevs, refs, fleet_noise = fleet_kernel_inputs(torch, np, env, FLEET_SHARD_B)
    seeds = torch.stack([device_seed(torch, tick_seed(42, b)) for b in range(FLEET_SHARD_B)])
    lams = torch.linspace(0.5, 2.0, FLEET_SHARD_B, device="cuda")
    fleet = shard_rows(torch, fs, x0s, prevs, lams, seeds.reshape(-1), refs, task, FLEET_K,
                       FLEET_SHARD_THRESHOLD, fleet_noise)
    rows = {f"flagship T={T} K={K}": flagship,
            f"fleet B={FLEET_SHARD_B} T={FLEET_T} K={FLEET_K}": fleet}
    print(f"phase 14 rows 1, 3, 5 per shard against the whole launch on {card}: "
          f"{json.dumps(rows)}", flush=True)
    bad = [f"{label} {case}" for label, cases in rows.items() for case, r in cases.items()
           if not (r["row1"] and r["row3"] and r["row5"] and r["padding"]
                   and r.get("twin_costs_bitwise", True) and r.get("twin_dump_bitwise", True)
                   and r.get("twin_block_max_bitwise", True)
                   and r.get("twin_partials_max_rel_err", 0.0) <= 1e-6
                   and r.get("twin_numer_max_abs_err", 0.0) <= 1e-3)]
    if bad:
        fail(f"shards of rows 1, 3, 5 differ from the whole launch or their twins: {bad}")
        return None
    facade = sharded_facade(torch, env, card)
    if facade is None:
        return None
    gloo = gloo_pair(torch, card)
    if gloo is None:
        return None
    return {"rows": rows, "facade": facade, "gloo": gloo, "seconds": time.perf_counter() - t0}


def sharding_alone() -> int:
    """Phase 14 alone, after the build: ``python3 -c 'import sys, chip_smoke;
    sys.exit(chip_smoke.sharding_alone())'``."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
    from mppi_playground_tpu_torch.ops import cuda_build

    card = card_line()
    print(card, flush=True)
    print(f"build: {cuda_build.build():.1f} s", flush=True)
    out = drive_sharding(torch, np, RacingEnv(device="cuda"), card)
    return 1 if out is None else 0


# --- phase 15: the examples on the card ------------------------------------------

UNFUSED_M1 = frozenset({"fused_regen_m1", "weighted_update_partials"})  # the draw, row 9
UNFUSED_M2 = frozenset({"fused_regen_m2", "weighted_update_partials"})
# (path label: the model first, as path_model reads it; script; main's keywords for the
# traced run; the kernels the device must run, no more and no fewer).  The fused routes:
# the pendulum and Navigation2D at K <= 10,000 take ESSPS's epilogue (row 4, then row 5),
# racing's fixed lambda the fused solve (row 1); each fused tick ends in its tail (row 2)
# and the scripts that draw the top samples regenerate them (row 6); every racing tick
# computes its reference rows (REFERENCE_ROWS) and steps the plant (RACING_PLANT).
EXAMPLE_RUNS = (
    ("pendulum example", "pendulum", dict(steps=10, use_gym=False), UNFUSED_M1),
    ("pendulum example --fused", "pendulum", dict(steps=10, use_gym=False, fused=True),
     {"pendulum_costs_dump_lambda", "fused_weighted", "pendulum_tick_tail"}),
    ("pendulum example --episode", "pendulum", dict(steps=10, episode=True), UNFUSED_M1),
    ("cartpole example", "cartpole", dict(steps=10, use_gym=False), UNFUSED_M1),
    ("cartpole example --episode", "cartpole", dict(steps=10, episode=True), UNFUSED_M1),
    ("mountain_car example", "mountaincar", dict(steps=10, use_gym=False), UNFUSED_M1),
    ("mountain_car example --episode", "mountaincar", dict(steps=10, episode=True), UNFUSED_M1),
    ("navigation example", "navigation2d", dict(max_steps=10, render=False), UNFUSED_M2),
    ("navigation example --fused", "navigation2d", dict(max_steps=10, render=False, fused=True),
     {"navigation_costs_dump_lambda", "fused_weighted", "navigation_tick_tail",
      "navigation_top_rollouts"}),
    ("navigation example --episode", "navigation2d",
     dict(max_steps=10, render=False, episode=True), UNFUSED_M2),
    ("danger_zone example", "goal_in_danger_zone", dict(max_steps=10, render=False), UNFUSED_M2),
    ("danger_zone example --episode", "goal_in_danger_zone",
     dict(max_steps=10, render=False, episode=True), UNFUSED_M2),
    ("racing example", "racing", dict(max_steps=10, render=False),
     UNFUSED_M2 | REFERENCE_ROWS | RACING_PLANT | MPCC_COST),
    ("racing example --fused", "racing", dict(max_steps=10, render=False, fused=True),
     {"racing_fused_solve", "racing_tick_tail", "racing_top_rollouts"} | REFERENCE_ROWS
     | RACING_PLANT),
    ("racing example --episode", "racing", dict(max_steps=10, render=False, episode=True),
     UNFUSED_M2 | REFERENCE_ROWS | RACING_PLANT | MPCC_COST),
    ("racing example --pipelined 2", "racing", dict(max_steps=10, render=False, pipelined=2),
     UNFUSED_M2 | REFERENCE_ROWS | RACING_PLANT | MPCC_COST),
    ("mujoco example", "mujoco_cartpole", dict(steps=10, render=False), UNFUSED_M1),
    ("make_media example --fast", "make_media", dict(argv=["--fast", "--out", None]), UNFUSED_M1),
)
# the keywords a run takes off for its timed pass: the script's own step count
TIMED_DEFAULTS = ("steps", "max_steps")
PENDULUM_EPISODE_THETA_BOUND = 0.04  # tests/test_torch_examples.py, from a CPU run
# (depth, compensate, ticks, |theta| bound, cost bound over strict): the JAX bounds of
# tests/test_pipelined_quality.py, as tests/test_torch_pipelined_quality.py holds them
PIPELINED_BOUNDS = ((0, True, 150, 0.15, None), (2, True, 300, 0.25, 1.6),
                    (2, False, 300, 0.25, 2.5), (4, True, 300, None, 6.0))


def _needs_gym(script: str):
    """Why ``script`` cannot run here (gymnasium, or mujoco's env, missing), or None."""
    import importlib.util

    if script not in ("mujoco_cartpole", "make_media"):
        return None
    if importlib.util.find_spec("gymnasium") is None:
        return "gymnasium is not installed"
    if script == "mujoco_cartpole":
        if importlib.util.find_spec("mujoco") is None:
            return "mujoco is not installed"
        try:
            import gymnasium

            gymnasium.make("InvertedPendulum-v4").close()
        except Exception as err:  # missing assets or GL stack
            return f"InvertedPendulum-v4 unavailable: {err}"
    return None


def _own_dynamics_ticks(torch, script: str, ticks: int = 5):
    """The solver(s) of ``script`` a few ticks against their own dynamics, in place of gym."""
    import importlib
    import math

    from mppi_playground_tpu_torch.models import cartpole, mountain_car, pendulum

    ex = importlib.import_module(f"mppi_playground_tpu_torch.examples.{script}")
    if script == "mujoco_cartpole":
        runs = [(ex.make_solver("cuda"), ex.dynamics, [0.0, 0.0, 0.05, 0.0])]
    else:
        models = {"pendulum": (pendulum, [math.pi, 0.0]), "cartpole": (cartpole, [0, 0, 0.05, 0]),
                  "mountaincar": (mountain_car, [-0.5, 0.0])}
        runs = [(ex.make_solver(name, "cuda"), models[name][0].dynamics, models[name][1])
                for name in ex.WORKLOADS]
    for solver, dynamics, x0 in runs:
        x = torch.tensor(x0, dtype=torch.float32, device="cuda")
        for _ in range(ticks):
            actions, _ = solver.forward(x)
            x = dynamics(x[None], actions[None, 0])[0]
        if not torch.isfinite(x).all():
            return f"{script}: non-finite state after {ticks} ticks"
    return None


def _run_main(script: str, kwargs: dict, out_dir: str) -> str:
    """``script``'s ``main`` on the card with ``kwargs``; returns what it printed."""
    import contextlib
    import importlib
    import io

    ex = importlib.import_module(f"mppi_playground_tpu_torch.examples.{script}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if "argv" in kwargs:
            ex.main([a if a is not None else out_dir for a in kwargs["argv"]] + ["--device",
                                                                               "cuda"])
        else:
            ex.main(**kwargs, device="cuda")
    return buf.getvalue()


def _solve_ms(text: str):
    """The solve time a script printed, in ms: the average, the pipelined step or an episode's
    tick; None where it printed none."""
    import re

    for pattern in (r"average solve time: ([0-9.eE+-]+)", r"avg step ([0-9.eE+-]+) ms",
                    r"\(([0-9.]+) ms(?:/tick| per budget tick)"):
        found = re.search(pattern, text)
        if found:
            return float(found.group(1))
    return None


def pipelined_quality(torch):
    """The pipelined-quality bounds on the card: ``{case: result}`` and whether all held.

    The pendulum swing-up (T=15, K=512, λ=1, seed 3) through
    ``make_pipelined_closed_loop`` at depth 0 (150 ticks), 2 with and without
    compensation and 4 (300 ticks), against the strict loop's 300-tick cost.
    """
    import math

    from mppi_playground_tpu_torch import MPPIConfig, make_solver
    from mppi_playground_tpu_torch.core.closed_loop import make_pipelined_closed_loop
    from mppi_playground_tpu_torch.models import pendulum
    from mppi_playground_tpu_torch.utils.angles import angle_normalize

    config = MPPIConfig(horizon=15, num_samples=512, dim_state=2, dim_control=1,
                        u_min=pendulum.U_MIN, u_max=pendulum.U_MAX, sigmas=(1.0,), lambda_=1.0,
                        store_rollouts=False)

    def plant(x, u):
        return pendulum.dynamics(x[None], u[None])[0]

    def run(depth, compensate, ticks):
        solver = make_solver(config, pendulum.dynamics, pendulum.cost, device="cuda")
        loop = make_pipelined_closed_loop(solver, plant, ticks, depth, compensate=compensate)
        _, xf, xs, _, _ = loop(solver.init(seed=3), torch.tensor([math.pi, 0.0], device="cuda"))
        cost = float(torch.sum(angle_normalize(xs[:, 0]) ** 2 + 0.1 * xs[:, 1] ** 2))
        return abs(float(angle_normalize(xf[0]))), cost, float(xs[:, 1].abs().max())

    strict = run(0, True, 300)[1]
    out, ok = {"strict cost (300 ticks)": strict}, True
    for depth, compensate, ticks, theta_bound, ratio_bound in PIPELINED_BOUNDS:
        theta, cost, omega = run(depth, compensate, ticks)
        res = dict(ticks=ticks, final_abs_theta=theta, cost=cost, cost_over_strict=cost / strict,
                   max_abs_omega=omega)
        held = ((theta_bound is None or theta < theta_bound)
                and (ratio_bound is None or cost < ratio_bound * strict)
                and (depth != 4 or omega <= 8.0))
        res["held"] = held
        ok = ok and held
        out[f"depth {depth} compensate={compensate}"] = res
    return out, ok


def drive_examples(torch, card):
    """Phase 15: every example script through its ``main`` on the card.

    Each run of :data:`EXAMPLE_RUNS` (headless, a few steps) goes under the
    device trace with every launch counter set to 0 before it: the kernels
    the device ran must be the route's, each counted by its wrapper at least
    once (an eager tick: the first of a facade's ticks or of an episode)
    and never more than the device ran.  Then each run that prints a solve
    time runs again untraced at the script's own step count, and its time
    is printed beside the card.  The mujoco script and ``make_media`` need
    gymnasium (and mujoco): without them the phase says so and drives their
    solvers against their own dynamics instead.  Last, the pendulum's
    ``--episode`` at its configuration (200 ticks) must end with |θ| below
    :data:`PENDULUM_EPISODE_THETA_BOUND`, and :func:`pipelined_quality`'s
    bounds must hold.  Returns ``{"runs": ..., "pendulum": ...,
    "pipelined": ..., "seconds": s}`` or None.
    """
    import re
    import tempfile

    from mppi_playground_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    runs = {}
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR.parent) as out_dir:
        for label, script, kwargs, want in EXAMPLE_RUNS:
            missing = _needs_gym(script)
            counted = zero_counters()
            if missing is None:
                text, trace = traced(torch, lambda: _run_main(script, kwargs, out_dir))
                ran = "main"
            else:
                print(f"phase 15 {label}: main did not run ({missing}); its solver instead, "
                      "against its own dynamics", flush=True)
                err, trace = traced(torch, lambda: _own_dynamics_ticks(torch, script))
                if err is not None:
                    fail(f"{label}: {err}")
                    return None
                text, ran = "", "solver against its own dynamics"
            device = {name: trace.launches.get(name, 0) for name in counted}
            wrappers = read_counters(counted)
            ran_kernels = {name for name, n in device.items() if n}
            uncounted = sorted(name for name in want if not wrappers[name])
            over = sorted(name for name in counted if wrappers[name] > device[name])
            if ran_kernels != set(want) or uncounted or over:
                fail(f"{label}: kernels run on the device {sorted(ran_kernels)}, expected "
                     f"{sorted(want)}; no wrapper count for {uncounted}, more counted than run "
                     f"for {over}")
                return None
            res = dict(ran=ran, launches={k: v for k, v in device.items() if v},
                       printed=[line for line in text.splitlines() if line.strip()][-3:])
            timed = _solve_ms(text) is not None and ran == "main"
            if timed and "episode" not in kwargs and "pipelined" not in kwargs:
                steps = {k: v for k, v in kwargs.items() if k not in TIMED_DEFAULTS}
                res["solve_ms"] = _solve_ms(_run_main(script, steps, out_dir))
                res["timed"] = "untraced, the script's own step count"
            elif timed:
                res["solve_ms"] = _solve_ms(text)
                res["timed"] = "the traced run"
            elif script == "goal_in_danger_zone":  # it prints no time: its host loop's step
                steps = {k: v for k, v in kwargs.items() if k not in TIMED_DEFAULTS}
                start = time.perf_counter()
                _run_main(script, steps, out_dir)
                res["step_ms"] = 1e3 * (time.perf_counter() - start) / 100  # 100 steps
                res["timed"] = ("untraced, the script's own 100 steps: solve, env.step and "
                                "the bookkeeping, host clock")
            runs[label] = res
            print(f"phase 15 {label} on {card}: {json.dumps(res)}", flush=True)
    text = _run_main("pendulum", dict(steps=200, episode=True), "")
    theta = float(re.search(r"final theta: (\S+)", text).group(1))
    pendulum = dict(final_theta=theta, bound=PENDULUM_EPISODE_THETA_BOUND, ms_a_tick=_solve_ms(text))
    print(f"phase 15 pendulum --episode at T=15, K=1000, ESSPS, 200 ticks on {card}: "
          f"{json.dumps(pendulum)}", flush=True)
    if not abs(theta) < PENDULUM_EPISODE_THETA_BOUND:
        fail(f"the pendulum example's episode ended at theta {theta!r}, not upright")
        return None
    pipelined, held = pipelined_quality(torch)
    print(f"phase 15 pipelined-quality bounds (pendulum, T=15, K=512) on {card}: "
          f"{json.dumps(pipelined)}", flush=True)
    if not held:
        fail("a pipelined-quality bound failed on the card")
        return None
    if any(m == "jax" or m.startswith(("jax.", "mppi_playground_tpu.")) for m in sys.modules):
        fail("an example imported jax or the JAX package")
        return None
    seconds = time.perf_counter() - t0
    print(f"phase 15 took {seconds:.1f} s on {card}", flush=True)
    return dict(runs=runs, pendulum=pendulum, pipelined=pipelined, seconds=seconds)


def examples_alone() -> int:
    """Phase 15 alone, after the build: ``python3 -c 'import sys, chip_smoke;
    sys.exit(chip_smoke.examples_alone())'``."""
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mppi_playground_tpu_torch.ops import cuda_build

    card = card_line()
    print(card, flush=True)
    print(f"build: {cuda_build.build():.1f} s", flush=True)
    return 1 if drive_examples(torch, card) is None else 0


# --- phase 16: a user's own model on the fused kernels ---------------------------
#
# The plugs below are the JAX package's own user-defined tasks (the linear task
# of tests/test_fused_config_sweep.py, the toy and quad tasks of
# tests/test_fused_solve.py, the speed-tracking bicycle of
# benchmarks/scaling.py), each as the CUDA source of one plug struct and its
# torch twins, operation for operation.  tests/test_torch_plugs.py and
# tests/test_torch_fused_config_sweep.py import them from here.

LINEAR_PLUG_SOURCE = """\
namespace plugs {{
// x_i' = x_i + 0.1 clamp(u_(i mod m), -1, 1) - 0.05 x_((i+1) mod n);
// cost sum_i (x_i - 0.5 i)^2 + 0.01 sum_j (u_j - pu_j)^2.
struct {struct} {{
  static constexpr int kN = {n}, kM = {m}, kRefWidth = 0, kPre = {pre};
  struct Args {{}};
  static Args make_args(const float*, const int*, const uint8_t*, const uint8_t*) {{
    return Args{{}};
  }}
  __device__ static __forceinline__ void prepare(const float (&u)[kM], float (&p)[kPre],
                                                 const Args&) {{
#pragma unroll
    for (int j = 0; j < kM; ++j) p[j] = devmath::clampf(u[j], -1.0f, 1.0f);
#pragma unroll
    for (int j = kM; j < kPre; ++j) p[j] = 0.0f;  // unused terms (kPre > kM)
  }}
  __device__ static __forceinline__ void step_prepared(float (&x)[kN], const float (&p)[kPre],
                                                       const Args&) {{
    float nx[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) nx[i] = x[i] + 0.1f * p[i % kM] - 0.05f * x[(i + 1) % kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) x[i] = nx[i];
  }}
  __device__ static __forceinline__ float stage_cost(const float (&x)[kN], const float (&u)[kM],
                                                     const float (&pu)[kM], const float*,
                                                     const Args&) {{
    float c = x[0] * x[0];
#pragma unroll
    for (int i = 1; i < kN; ++i) {{
      const float d = x[i] - 0.5f * static_cast<float>(i);
      c = c + d * d;
    }}
    float s = (u[0] - pu[0]) * (u[0] - pu[0]);
#pragma unroll
    for (int j = 1; j < kM; ++j) s = s + (u[j] - pu[j]) * (u[j] - pu[j]);
    return c + 0.01f * s;
  }}
}};
}}  // namespace plugs
"""

TOY_PLUG_SOURCE = """\
namespace plugs {
// A point mass with drag tracking a per-tick target (its reference row):
// v' = 0.9 v + 0.1 clamp(a, -1, 1), p' = p + 0.1 v';
// cost (p - target_t)^2 + 0.1 v^2 + 0.01 (a - pa)^2.
struct Toy {
  static constexpr int kN = 2, kM = 1, kRefWidth = 1, kPre = 1;
  struct Args {};
  static Args make_args(const float*, const int*, const uint8_t*, const uint8_t*) {
    return Args{};
  }
  __device__ static __forceinline__ void prepare(const float (&u)[kM], float (&p)[kPre],
                                                 const Args&) {
    p[0] = 0.1f * devmath::clampf(u[0], -1.0f, 1.0f);
  }
  __device__ static __forceinline__ void step_prepared(float (&x)[kN], const float (&p)[kPre],
                                                       const Args&) {
    const float v = 0.9f * x[1] + p[0];
    x[0] = x[0] + 0.1f * v;
    x[1] = v;
  }
  __device__ static __forceinline__ float stage_cost(const float (&x)[kN], const float (&u)[kM],
                                                     const float (&pu)[kM], const float* ref,
                                                     const Args&) {
    const float d = x[0] - ref[0];
    const float e = u[0] - pu[0];
    return d * d + 0.1f * x[1] * x[1] + 0.01f * (e * e);
  }
};
}  // namespace plugs
"""

QUAD_PLUG_SOURCE = """\
namespace plugs {
// Three states, four controls: v' = 0.95 v + 0.05 (ax - brake),
// x' = x + 0.1 (v' + ay), y' = y + 0.1 (v' + steer);
// cost (x - 1)^2 + (y + 0.5)^2 + 0.1 v^2 + 0.01 |u|^2.
struct Quad {
  static constexpr int kN = 3, kM = 4, kRefWidth = 0, kPre = 4;
  struct Args {};
  static Args make_args(const float*, const int*, const uint8_t*, const uint8_t*) {
    return Args{};
  }
  __device__ static __forceinline__ void prepare(const float (&u)[kM], float (&p)[kPre],
                                                 const Args&) {
#pragma unroll
    for (int j = 0; j < kM; ++j) p[j] = u[j];
  }
  __device__ static __forceinline__ void step_prepared(float (&x)[kN], const float (&p)[kPre],
                                                       const Args&) {
    const float v = 0.95f * x[2] + 0.05f * (p[0] - p[2]);
    x[0] = x[0] + 0.1f * (v + p[1]);
    x[1] = x[1] + 0.1f * (v + p[3]);
    x[2] = v;
  }
  __device__ static __forceinline__ float stage_cost(const float (&x)[kN], const float (&u)[kM],
                                                     const float (&)[kM], const float*,
                                                     const Args&) {
    const float a = x[0] - 1.0f;
    const float b = x[1] + 0.5f;
    return a * a + b * b + 0.1f * x[2] * x[2] +
           0.01f * (u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + u[3] * u[3]);
  }
};
}  // namespace plugs
"""

BICYCLE_PLUG_SOURCE = """\
#include "racing_model.cuh"

namespace plugs {
// The kinematic bicycle of racing_model.cuh (position clamped to the model
// floats x_lo, x_hi, y_lo, y_hi) tracking a speed of 5:
// cost (v - 5)^2 + 0.1 (a^2 + delta^2).
struct SpeedBicycle {
  static constexpr int kN = 4, kM = 2, kRefWidth = 0, kPre = 2;
  struct Args {
    devmath::Geometry geo;
  };
  static Args make_args(const float* f, const int*, const uint8_t*, const uint8_t*) {
    return Args{devmath::Geometry{f[0], f[1], f[2], f[3], 0.0f, 0.0f, 1.0f, 0, 0, 1.0f}};
  }
  __device__ static __forceinline__ void prepare(const float (&u)[kM], float (&p)[kPre],
                                                 const Args&) {
    racing::bicycle_terms(u[0], u[1], p[0], p[1]);
  }
  __device__ static __forceinline__ void step_prepared(float (&x)[kN], const float (&p)[kPre],
                                                       const Args& a) {
    racing::bicycle_step(x[0], x[1], x[2], x[3], p[0], p[1], a.geo);
  }
  __device__ static __forceinline__ float stage_cost(const float (&x)[kN], const float (&u)[kM],
                                                     const float (&)[kM], const float*,
                                                     const Args&) {
    const float dv = x[3] - 5.0f;
    return dv * dv + 0.1f * (u[0] * u[0] + u[1] * u[1]);
  }
};
}  // namespace plugs
"""


@dataclasses.dataclass(frozen=True)
class Plug:
    """A user's model on the fused kernels: its task (a ``ModelPlug`` and the torch twins),
    the array-of-structs dynamics and cost of the same model for the unfused solver and
    ``states_prediction``, its sampling bounds, and its operation count for the bounds."""

    task: object
    dynamics: object
    cost: object
    sigmas: tuple
    u_min: tuple
    u_max: tuple
    ops: ModelOps


def _plug(model_plug, dynamics_soa, cost_soa, sigmas, u_min, u_max, ops, floats=(),
          reference=None) -> Plug:
    """A :class:`Plug` of a ``ModelPlug`` and its SoA twins; the AoS forms wrap the twins."""
    import torch

    from mppi_playground_tpu_torch.ops.fused_solve import FusedTask

    task = FusedTask(model=model_plug, dynamics_soa=dynamics_soa, stage_cost_soa=cost_soa,
                     floats=floats, reference=reference)

    def dynamics(state, action):
        return torch.stack(dynamics_soa(tuple(state.unbind(1)), tuple(action.unbind(1))), dim=1)

    def cost(state, action, info):
        ref = None if reference is None else torch.as_tensor(reference(info))
        ctx = dict(t=info["t"], prev_us=tuple(info["prev_action"].unbind(1)), xref=ref)
        return cost_soa(tuple(state.unbind(1)), tuple(action.unbind(1)), ctx)

    return Plug(task, dynamics, cost, tuple(sigmas), tuple(u_min), tuple(u_max), ops)


def linear_plug(n: int, m: int, pre: int | None = None) -> Plug:
    """tests/test_fused_config_sweep.py's linear task at ``n`` states and ``m`` controls.

    ``pre`` (default ``m``) is its struct's ``kPre``; the terms past ``m`` are unused.
    """
    import torch

    from mppi_playground_tpu_torch.ops.fused_solve import ModelPlug

    pre = m if pre is None else pre
    struct = f"Linear_n{n}_m{m}" + (f"_pre{pre}" if pre != m else "")
    plug = ModelPlug(name=struct.lower(), struct=f"plugs::{struct}",
                     source=LINEAR_PLUG_SOURCE.format(struct=struct, n=n, m=m, pre=pre),
                     dim_state=n, dim_control=m)

    def dynamics_soa(xs, us):
        return tuple(xs[i] + 0.1 * torch.clamp(us[i % m], -1.0, 1.0) - 0.05 * xs[(i + 1) % n]
                     for i in range(n))

    def cost_soa(xs, us, ctx):
        prev = ctx["prev_us"]
        c = xs[0] * xs[0]
        for i in range(1, n):
            d = xs[i] - 0.5 * i
            c = c + d * d
        s = (us[0] - prev[0]) * (us[0] - prev[0])
        for j in range(1, m):
            s = s + (us[j] - prev[j]) * (us[j] - prev[j])
        return c + 0.01 * s

    # prepare 2m (the clamps); step 4n; cost 3n + 3m - 2 + 2, and the accumulation
    ops = ModelOps(n, m, 0, 2 * m + 4 * n, 3 * n + 3 * m + 1)
    return _plug(plug, dynamics_soa, cost_soa, [0.5 + 0.1 * j for j in range(m)], [-1.0] * m,
                 [1.0] * m, ops)


def toy_target_rows(info):
    """The toy plug's reference builder: ``info['target']`` ``[..., T, 1]`` (the JAX task's
    table, read at step t) -> ``[..., T+1, 1]``, its last row repeated for the T+1 rows."""
    import torch

    target = torch.as_tensor(info["target"], dtype=torch.float32)
    return torch.cat([target, target[..., -1:, :]], dim=-2)


def toy_plug() -> Plug:
    """tests/test_fused_solve.py's toy task: a point mass with drag and a per-tick target."""
    import torch

    from mppi_playground_tpu_torch.ops.fused_solve import ModelPlug

    plug = ModelPlug(name="toy", struct="plugs::Toy", source=TOY_PLUG_SOURCE, dim_state=2,
                     dim_control=1, reference_width=1)

    def dynamics_soa(xs, us):
        px, v = xs
        new_v = 0.9 * v + 0.1 * torch.clamp(us[0], -1.0, 1.0)
        return (px + 0.1 * new_v, new_v)

    def cost_soa(xs, us, ctx):
        px, v = xs
        d = px - ctx["xref"][ctx["t"], 0]
        e = us[0] - ctx["prev_us"][0]
        return d * d + 0.1 * v * v + 0.01 * (e * e)

    return _plug(plug, dynamics_soa, cost_soa, (0.7,), (-1.0,), (1.0,),
                 ModelOps(2, 1, 1, 7, 10), reference=toy_target_rows)


def quad_plug() -> Plug:
    """tests/test_fused_solve.py's quad task: three states, four controls."""
    from mppi_playground_tpu_torch.ops.fused_solve import ModelPlug

    plug = ModelPlug(name="quad", struct="plugs::Quad", source=QUAD_PLUG_SOURCE, dim_state=3,
                     dim_control=4)

    def dynamics_soa(xs, us):
        px, py, v = xs
        ax, ay, brake, steer = us
        new_v = 0.95 * v + 0.05 * (ax - brake)
        return (px + 0.1 * (new_v + ay), py + 0.1 * (new_v + steer), new_v)

    def cost_soa(xs, us, ctx):
        px, py, v = xs
        a, b = px - 1.0, py + 0.5
        return a * a + b * b + 0.1 * v * v + 0.01 * (
            us[0] * us[0] + us[1] * us[1] + us[2] * us[2] + us[3] * us[3])

    return _plug(plug, dynamics_soa, cost_soa, (0.5, 0.5, 0.3, 0.3), (-1.0,) * 4, (1.0,) * 4,
                 ModelOps(3, 4, 0, 10, 18))


BICYCLE_LIMITS = (-40.0, 40.0)  # benchmarks/scaling.py's position limits


def bicycle_plug() -> Plug:
    """benchmarks/scaling.py's task: the kinematic bicycle tracking a speed of 5."""
    from mppi_playground_tpu_torch.models import bicycle
    from mppi_playground_tpu_torch.ops.fused_solve import ModelPlug

    plug = ModelPlug(name="speed_bicycle", struct="plugs::SpeedBicycle",
                     source=BICYCLE_PLUG_SOURCE, dim_state=4, dim_control=2)

    def cost_soa(xs, us, ctx):
        dv = xs[3] - 5.0
        return dv * dv + 0.1 * (us[0] * us[0] + us[1] * us[1])

    return _plug(plug, bicycle.make_dynamics_soa(x_lim=BICYCLE_LIMITS, y_lim=BICYCLE_LIMITS),
                 cost_soa, (0.5, 0.1), bicycle.U_MIN, bicycle.U_MAX,
                 ModelOps(4, 2, 0, OPS_BICYCLE, 8), floats=BICYCLE_LIMITS * 2)


def every_plug() -> dict:
    """Phase 16's plugs by name: the linear task at n=3 and m=1-4, the toy, quad and bicycle."""
    plugs = [linear_plug(3, m) for m in (1, 2, 3, 4)] + [toy_plug(), quad_plug(), bicycle_plug()]
    return {p.task.name: p for p in plugs}


PLUG_T, PLUG_K = 50, 98_304  # benchmarks/scaling.py's bicycle task: T=50, K=96 tiles of 1,024
PLUG_TICKS = 5  # the full-width path's ticks, eager against the replayed graph
# the kernels of a plug's unit, by the function names ptxas reports
PLUG_KERNEL_FUNCTIONS = ("fused_solve_kernel", "costs_dump_lambda_kernel", "costs_dump_kernel",
                         "tick_tail_kernel", "reroll_kernel", "regen_rollout_kernel")
PLUG_SOURCES = {"linear": "LINEAR_PLUG_SOURCE", "toy": "TOY_PLUG_SOURCE",
                "quad": "QUAD_PLUG_SOURCE", "speed_bicycle": "BICYCLE_PLUG_SOURCE"}


def plug_inputs(torch, np, plug, horizon=PLUG_T, num_samples=PLUG_K) -> tuple:
    """``(x0, prev, noise, bounds, ref)`` of a plug at one configuration, from :data:`SEED`.

    The toy plug's reference rows are its target table, 2.0 at every step.
    """
    n, m = plug.task.dim_state, plug.task.dim_control
    rng = np.random.default_rng(SEED + 10 * n + m)
    sig = np.asarray(plug.sigmas)
    dev = torch.device("cuda")
    x0 = torch.tensor(np.linspace(-0.5, 0.5, n), dtype=torch.float32, device=dev)
    prev = torch.tensor(rng.standard_normal((horizon, m)) * sig, dtype=torch.float32, device=dev)
    noise = torch.tensor(rng.standard_normal((num_samples, horizon, m)) * sig,
                         dtype=torch.float32, device=dev)
    ref = plug.task.reference_rows({"target": torch.full((horizon, 1), 2.0, device=dev)}, None,
                                   dev)
    return x0, prev, noise, (plug.sigmas, plug.u_min, plug.u_max), ref


def plug_config(plug, lambda_, horizon=PLUG_T, num_samples=PLUG_K):
    from mppi_playground_tpu_torch.core.config import MPPIConfig

    return MPPIConfig(horizon=horizon, num_samples=num_samples, dim_state=plug.task.dim_state,
                      dim_control=plug.task.dim_control, u_min=plug.u_min, u_max=plug.u_max,
                      sigmas=plug.sigmas, lambda_=lambda_, store_rollouts=False)


def plug_info(torch, plug, horizon=PLUG_T):
    """The tick's ``info`` a plug's reference builder reads (the toy's target), else None."""
    if not plug.task.reference_width:
        return None
    return {"target": torch.full((horizon, 1), 2.0, device="cuda")}


def plug_routes(torch, plug, card):
    """Each plug's fused routes, two eager ticks each and ``get_top_samples(300)``, counted.

    Fixed λ (row 1), ESSPS standalone (rows 3, 7, 5) and LBPS on the
    epilogue (rows 4, 5), each with the tail (row 2) and the top rows (row
    6), through ``make_fused_solver`` at T=50, K=98,304.  Every counter is
    set to 0 before a route and read after; each wrapper must have counted
    each kernel of its route as the eager ticks launch it.  Returns ``{path:
    {"launches": ...}}`` or None.
    """
    from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver

    name = plug.task.name
    out = {}
    for route, lam, epilogue in (("fixed", 1.0, None), ("ESSPS standalone", "ESSPS", False),
                                 ("LBPS epilogue", "LBPS", True)):
        config = plug_config(plug, lam)
        loop = SolverLoop(make_fused_solver(config, plug.task, plug.dynamics, device="cuda",
                                            lambda_epilogue=epilogue))
        counted = zero_counters([plug.task.plug])
        x = torch.linspace(-0.5, 0.5, plug.task.dim_state, device="cuda")
        info = plug_info(torch, plug)
        for _ in range(2):
            result = loop.solver.solve(loop.state, x, info=info)
            loop.state, loop.aux = result.state, result.aux
            x = plug.dynamics(x[None], result.action_seq[:1])[0]
        states, weights = loop.get_top_samples(300)
        torch.cuda.synchronize()
        want = {kernel: 2 for kernel in fused_kernels(name, config, epilogue)}
        want[f"{name}_top_rollouts"] = 1
        got = read_counters(counted)
        label = f"{name} fused {route}"
        if ({k: v for k, v in got.items() if v} != want or not torch.isfinite(x).all()
                or states.shape != (300, PLUG_T + 1, plug.task.dim_state)):
            fail(f"{label}: launches {({k: v for k, v in got.items() if v})}, expected {want}; "
                 f"state finite {bool(torch.isfinite(x).all())}, top rows {tuple(states.shape)}")
            return None
        out[label] = dict(launches=got, lam=loop.lambda_)
    print(f"phase 16 {name}: fixed, ESSPS standalone and LBPS epilogue routes, 2 ticks and "
          f"get_top_samples(300) each, every kernel counted: "
          + json.dumps({label: run["lam"] for label, run in out.items()}), flush=True)
    return out


def bicycle_paths(torch, plug, card):
    """Phase 16's full-width path: the speed-tracking bicycle plug through ``MPPI``.

    ``benchmarks/scaling.py``'s task (T=50, K=98,304, σ=(0.5, 0.1), λ=1,
    positions ±40) through ``MPPI(kernel_backend="auto", fused_task=...)``
    at fixed λ, MPO and ESSPS (the standalone route at this K), and ESSPS on
    the λ epilogue through ``make_fused_solver``: :data:`PLUG_TICKS` ticks
    of ``forward`` and the plant (``MPPI``: the first eager with the capture,
    then replays) and ``get_top_samples(300)`` under the device trace, every
    counter set to 0 before, the actions bit for bit the solver's eager
    ticks; then a 50-tick ``make_closed_loop`` episode, traced twice (the
    second with any host sync an error), bit for bit 50 eager ticks, and
    timed.  Returns ``{path: result}`` or None.
    """
    from mppi_playground_tpu_torch.core.closed_loop import make_closed_loop
    from mppi_playground_tpu_torch.core.controller import MPPI
    from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver

    task, name = plug.task, plug.task.name
    x_start = torch.zeros(task.dim_state, device="cuda")

    def plant(x, u):
        return plug.dynamics(x[None], u[None])[0]

    out = {}
    for mode, lam, epilogue in (("fixed", 1.0, None), ("MPO", "MPO", None),
                                ("ESSPS", "ESSPS", None), ("ESSPS epilogue", "ESSPS", True)):
        config = plug_config(plug, lam)
        if epilogue:  # MPPI takes no λ route: the epilogue through make_fused_solver
            ctrl = SolverLoop(make_fused_solver(config, task, plug.dynamics, device="cuda",
                                                lambda_epilogue=True))
            solver = ctrl.solver
        else:
            ctrl = MPPI(horizon=PLUG_T, num_samples=PLUG_K, dim_state=task.dim_state,
                        dim_control=task.dim_control, dynamics=plug.dynamics,
                        cost_func=plug.cost, u_min=plug.u_min, u_max=plug.u_max,
                        sigmas=plug.sigmas, lambda_=lam, store_rollouts=False,
                        kernel_backend="auto", fused_task=task, device="cuda")
            solver = ctrl._solver
        label = f"{name} fused {mode}"
        if ctrl.solver_backend != "fused":
            fail(f"{label}: MPPI took the {ctrl.solver_backend} route")
            return None

        def ticks():
            x, seqs = x_start, []
            for _ in range(PLUG_TICKS):
                action_seq, _ = ctrl.forward(x)
                seqs.append(action_seq)
                x = plant(x, action_seq[0])
            return torch.stack(seqs), ctrl.get_top_samples(300)

        counted = zero_counters([task.plug])
        (seqs, (top_states, top_w)), trace = traced(torch, ticks, plugs=[task.plug])
        once = fused_kernels(name, config, epilogue) - {f"{name}_top_rollouts"}
        want = {kernel: PLUG_TICKS for kernel in once}
        want[f"{name}_top_rollouts"] = 1
        launches = path_launches(label, counted, [trace], want)
        if launches is None:
            return None
        state, x, eager = solver.init(), x_start, []
        for _ in range(PLUG_TICKS):
            r = solver.solve(state, x)
            eager.append(r.action_seq)
            state, x = r.state, plant(x, r.action_seq[0])
        ticks_bitwise = bool(torch.equal(seqs, torch.stack(eager)))

        run = make_closed_loop(solver, plant, EPISODE_TICKS)
        state0 = solver.init()
        counted = zero_counters([task.plug])
        first, first_trace = traced(torch, lambda: run(state0, x_start), plugs=[task.plug])
        try:
            second, second_trace = traced(torch, lambda: run(state0, x_start), no_sync=True,
                                          plugs=[task.plug])
        except RuntimeError as err:
            fail(f"{label} episode: the replays synchronized with the host: {err}")
            return None
        episode = path_launches(f"{label} episode", counted, [first_trace, second_trace],
                                {kernel: 2 * EPISODE_TICKS for kernel in once})
        if episode is None:
            return None
        eager_run = eager_episode(torch, solver, plant, EPISODE_TICKS, state0, x_start)
        runs = [synced_ms(torch, lambda: run(state0, x_start)) for _ in range(3)]
        ms = statistics.median(runs) / EPISODE_TICKS
        res = dict(ticks_replayed_bitwise_eager=ticks_bitwise,
                   episode_bitwise_eager=_bitwise(first, eager_run),
                   episode_replays_repeat=_bitwise(second, first),
                   lam=float(first[0].lam), speed=first[1][3].item(),
                   top_weights_descending=bool((top_w[1:] <= top_w[:-1]).all()),
                   top_states_finite=bool(torch.isfinite(top_states).all()),
                   amortized_tick_ms=ms, ticks_per_s=1e3 / ms,
                   capture_s=run.episode.graph.capture_s,
                   episode_device_busy_us=second_trace.busy_us,
                   busy_share_of_unprofiled_episode=second_trace.busy_us
                   / (1e3 * ms * EPISODE_TICKS))
        print(f"phase 16 {label} (T={PLUG_T}, K={PLUG_K}) on {card}: {json.dumps(res)}",
              flush=True)
        if not (ticks_bitwise and res["episode_bitwise_eager"] and res["episode_replays_repeat"]
                and res["top_weights_descending"] and res["top_states_finite"]
                and top_states.shape == (300, PLUG_T + 1, task.dim_state)
                and torch.isfinite(first[1]).all()):
            fail(f"{label}: replayed ticks bitwise the eager ones {ticks_bitwise}, episode "
                 f"bitwise {res['episode_bitwise_eager']}, repeat "
                 f"{res['episode_replays_repeat']}, top samples {tuple(top_states.shape)}")
            return None
        out[label] = dict(res, launches=launches)
        out[f"{label} episode"] = dict(launches=episode)
    return out


# a plug whose tail and re-roll hold their prepared terms past the default 48 KB of
# shared memory: the linear task at n=3, m=1 with kPre=48, at T=1024 (T*m at the
# envelope's edge) and K=2,048
WIDE_PRE, WIDE_PRE_T, WIDE_PRE_K = 48, 1024, 2048


def wide_prepare_tails(torch, np, card):
    """The tail and the re-roll of a plug whose ``kPre * T`` passes 48 KB, against their twins.

    ``linear_plug(3, 1, pre=WIDE_PRE)`` at T=1024: the re-roll takes
    ``4 kPre T`` bytes of shared memory and the tail that and ``4 (3T - 1 +
    1024)`` more, past the default limit, so each launch raises its kernel's
    limit first (``csrc/shared_memory.cuh``).  The re-roll bit for bit its
    twin, and the tail on every route (:func:`check_tails`).  Returns the
    result or None.
    """
    from mppi_playground_tpu_torch.core.config import tick_seed
    from mppi_playground_tpu_torch.ops import fused_solve as fs

    plug = linear_plug(3, 1, pre=WIDE_PRE)
    task, horizon, k = plug.task, WIDE_PRE_T, WIDE_PRE_K
    label = f"phase 16 {task.name} (kPre={WIDE_PRE}, T={horizon}, K={k})"
    x0, prev, noise, bounds, ref = plug_inputs(torch, np, plug, horizon, k)
    del noise
    got = fs.fused_reroll(x0, prev, task)
    reroll_bitwise = bool(torch.equal(got, fs.fused_reroll_plain(x0, prev, task)))
    routes = tail_routes(torch, fs, x0, prev, device_seed(torch, tick_seed(42, 1)), ref, task,
                         bounds, k, None)
    tails = check_tails(torch, fs, label, task, x0, routes)
    res = dict(reroll_shared_bytes=4 * WIDE_PRE * horizon,
               tail_shared_bytes=4 * (3 * horizon - 1 + WIDE_PRE * horizon + 1024),
               reroll_bitwise_twin=reroll_bitwise,
               tail_max_abs_err=None if tails is None else tails[0])
    print(f"{label} on {card}: {json.dumps(res)}", flush=True)
    if tails is None or not reroll_bitwise:
        fail(f"{label}: the re-roll and the tail bit for bit their twins past 48 KB of shared "
             "memory")
        return None
    return res


def drive_plugs(torch, np, card):
    """Phase 16: a user's own model on the fused kernels (:func:`every_plug`).

    Every plug's unit built at once (``nvcc`` in parallel, each build's
    seconds printed); each plug's kernels against their twins at T=50,
    K=98,304 (:func:`check_task_kernels`: rows 1, 3, 4 under ESSPS and LBPS,
    5, 6 and 2, both noise modes; at m=3 the fixed solve's regenerated slots
    and the top rows against phase 1's dump), timed by graph replay beside
    their bounds; rows 1 and 3 per action slot at m=1-4; each plug's routes
    (:func:`plug_routes`), the full-width bicycle path
    (:func:`bicycle_paths`), and the tail past 48 KB of shared memory
    (:func:`wide_prepare_tails`).  Returns ``{"plugs", "rows", "paths",
    "shared", "per_slot", "wide_prepare", "seconds"}`` or None.
    """
    from mppi_playground_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    plugs = every_plug()
    libraries = {name: plug.task.entry("fused_solve_batch")[0] for name, plug in plugs.items()}
    build_s = cuda_build.build(libraries.values())  # already built where phase 2 built them
    print(f"phase 16: {len(libraries)} plug units on {card}, each build's seconds from the start "
          "of the nvcc processes it was started with: " + json.dumps(
              {name: cuda_build.build_seconds.get(lib) for name, lib in libraries.items()}),
          flush=True)
    registers = {}
    for name in plugs:  # "lib:fn: Used N registers, ..." of each kernel of the plug's unit
        for line in ptxas_report({name: cuda_build.build_logs.get(libraries[name], "")}, ""):
            fn, report = line.split(":")[1], line.split(":", 2)[2]
            kernel = next((k for k in PLUG_KERNEL_FUNCTIONS if k in fn), fn)
            kernel += {"Lb0E": " ESSPS", "Lb1E": " LBPS"}.get(fn[fn.find("Lb"):][:4], "")
            if "registers" in report:
                registers.setdefault(name, {})[kernel] = int(report.split("Used ")[1].split()[0])
    print(f"ptxas, registers of the plug units' kernels: {json.dumps(registers)}", flush=True)
    rows, shared, per_slot = {}, {}, {}
    for name, plug in plugs.items():
        x0, prev, noise, bounds, ref = plug_inputs(torch, np, plug)
        checked = check_task_kernels(
            torch, f"plug {name} (T={PLUG_T}, K={PLUG_K})", plug.task, x0, prev, noise, bounds,
            ref, plug.ops, card, searches=("ESSPS", "LBPS"), source="fused_solve.cuh")
        del noise
        if checked is None:
            return None
        source = PLUG_SOURCES[name.split("_n")[0]]
        for key, row in checked.items():
            if key == "weighted":
                shared[("fused_weighted", name)] = (row["ms"], row["bound_ms"])
            elif not key.endswith("_regen"):  # fused_regen_m1/_m2: listed by phase 9
                rows[key] = dict(row, model_source=f"chip_smoke.py {source}")
        slots = PLUG_T * plug.task.dim_control
        per_slot[name] = {f"{kernel}_us_a_slot": 1e3 * checked[f"{name}_{kernel}"]["ms"] / slots
                          for kernel in ("fused_solve", "costs_dump")}
    print(f"phase 16 rows 1 and 3 per action slot at T={PLUG_T}, K={PLUG_K} on {card} (graph "
          f"replay): {json.dumps(per_slot)}", flush=True)
    paths = {}
    for name, plug in plugs.items():
        if name != "speed_bicycle":
            routes = plug_routes(torch, plug, card)
            if routes is None:
                return None
            paths.update(routes)
    bicycle = bicycle_paths(torch, plugs["speed_bicycle"], card)
    if bicycle is None:
        return None
    paths.update(bicycle)
    wide = wide_prepare_tails(torch, np, card)
    if wide is None:
        return None
    seconds = time.perf_counter() - t0
    print(f"phase 16: {seconds:.1f} s", flush=True)
    return dict(plugs=plugs, rows=rows, paths=paths, shared=shared, per_slot=per_slot,
                wide_prepare=wide, seconds=seconds, build_s=build_s)


def plugs_alone() -> int:
    """Phase 16 alone, after a build of ``csrc/``::

        python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.plugs_alone())'
    """
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mppi_playground_tpu_torch.ops import cuda_build

    card = card_line()
    print(card, flush=True)
    print(f"build: {cuda_build.build():.1f} s", flush=True)
    return 0 if drive_plugs(torch, np, card) is not None else 1


def flagship_inputs(torch, np) -> tuple:
    """``(env, task, x0, ref [T+1, 5], prev [T, 2], noise [K, T, 2])`` of the flagship, seeded."""
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory,
        extend_reference_path,
        make_racing_fused_task_from_env,
    )

    dev = torch.device("cuda")
    env = RacingEnv(device=dev)
    task = make_racing_fused_task_from_env(env)
    rng = np.random.default_rng(SEED)
    x0 = env.reset() + torch.tensor([0.0, 0.0, 0.0, 5.0], device=dev)
    xref, _ = calc_ref_trajectory(x0, env.racing_center_path, torch.tensor(0, device=dev), T)
    xref5 = extend_reference_path(xref).contiguous()
    sig = FLAGSHIP_BOUNDS[0]
    prev = torch.tensor(rng.standard_normal((T, 2)) * sig, dtype=torch.float32, device=dev)
    noise = torch.tensor(rng.standard_normal((K, T, 2)) * sig, dtype=torch.float32, device=dev)
    return env, task, x0, xref5, prev, noise


def main() -> int:
    if len(sys.argv) > 1:
        return fail(f"chip_smoke.py takes no arguments, got {sys.argv[1:]}")
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    repo = Path(__file__).resolve().parent
    if not (repo / "mppi_playground_tpu_torch" / "csrc").is_dir():
        return fail(f"the package mppi_playground_tpu_torch is not beside {__file__}")
    sys.path.insert(0, str(repo))

    import numpy as np

    from mppi_playground_tpu_torch.core.config import tick_seed
    from mppi_playground_tpu_torch.core.fused_solver import EPILOGUE_DEFAULT_MAX_SAMPLES
    from mppi_playground_tpu_torch.ops import cuda_build, fused_solve
    from mppi_playground_tpu_torch.ops.weighted_update import combine_partials
    from mppi_playground_tpu_torch.workloads import build_flagship

    import graft_entry_torch  # noqa: F401  (the graft entry: its imports checked here)

    if foreign_modules(sys.modules):
        return fail(f"the port imported jax or the JAX package: {foreign_modules(sys.modules)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)

    # --- phase 2: build --------------------------------------------------
    # csrc's sources and phase 16's plug units, one nvcc each, all started together
    plug_units = tuple(plug.task.entry("fused_solve_batch")[0] for plug in (
        *every_plug().values(), linear_plug(3, 1, pre=WIDE_PRE)))
    build_s = cuda_build.build(cuda_build.SOURCES + plug_units)
    regs = "; ".join(
        f"{name}: " + " | ".join(
            line.split(":", 1)[-1].strip()
            for line in log.splitlines() if "registers" in line or "spill" in line
        )
        for name, log in sorted(cuda_build.build_logs.items()) if name in cuda_build.SOURCES
    )  # the plug units' registers: phase 16
    print(f"build: {len(cuda_build.SOURCES)} sources and {len(plug_units)} plug units in "
          f"{build_s:.1f} s; ptxas: {regs}", flush=True)
    differ, inside = exact_sweep(torch, "angle_normalize_sweep", 2)
    print(f"angle_normalize against its fmodf form on all 2^32 float32 inputs: {differ} differ "
          f"({inside} with x + pi in (-4 pi, 4 pi), where fmodf is skipped)", flush=True)
    if differ:
        return fail("the angle_normalize shortcut is not bit for bit its fmodf form")
    radius = exact_sweep(torch, "radius_sweep", 3)
    print(f"Box-Muller radius sqrt_fast(-2 log_normal(u1)) against sqrtf(-2 logf(u1)) on all "
          f"{radius[2]} values of u1: {radius[0]} radii differ ({radius[1]} logarithms)",
          flush=True)
    if radius[0] or radius[1] or radius[2] != 1 << 24:
        return fail("the Box-Muller radius is not bit for bit sqrtf(-2 logf(u1))")
    keys = key_sweep(torch, np)
    print(f"device key advance against the host's tick_seed: {json.dumps(keys)}", flush=True)
    if keys["differ"]:
        return fail("the device tick_seed is not the host's word for word")
    from mppi_playground_tpu_torch.workloads import build_model_workload

    env, task, x0, xref5, prev, noise = flagship_inputs(torch, np)
    racing_geo = (task.floats, task.ints)
    nav_task = build_model_workload("navigation", device="cuda").task
    geometries = {"racing": racing_geo, "navigation": (nav_task.floats, nav_task.ints)}
    geometries.update({f"cell {c}": (racing_geo[0][:6] + (c,), racing_geo[1])
                       for c in OTHER_CELL_SIZES})
    cells = cell_sweeps(torch, geometries)
    print("cell index from the reciprocal against the IEEE division on all 2^32 float32 "
          "positions (cells that differ; quotients that differ, of positions from 2^-100 and "
          f"quotients below 2^100; positions on the grid): {json.dumps(cells)}", flush=True)
    if any(differ or quotients for differ, quotients, _ in cells.values()):
        return fail("the cell index from the reciprocal is not the IEEE division's")

    # --- phase 3: kernels against their twins at the flagship's shapes ----
    lam = torch.ones(1, device=dev)
    sig, u_min, u_max = FLAGSHIP_BOUNDS
    seed = device_seed(torch, tick_seed(42, 0))
    grid_bytes = sum(g.numel() for g in task.grids)

    def solve(fn, mode_noise):
        return fn(x0, prev, lam, seed, xref5, task, sig, u_min, u_max, K, K, mode_noise)

    checks, solved = {}, {}
    for mode, nz in (("noise", noise), ("seeded", None)):
        got = solve(fused_solve.fused_solve, nz)
        want = solve(fused_solve.fused_solve_plain, nz)
        torch.cuda.synchronize()
        gc, wc = got[0], want[0]
        if not torch.isfinite(gc).all():
            return fail(f"fused solve ({mode}): non-finite costs")
        g_upd, g_w, g_ess = combine_partials(*got, lam, T, 2)
        w_upd, w_w, w_ess = combine_partials(*want, lam, T, 2)
        rel = ((gc - wc).abs() / wc.abs()).max().item()
        res = dict(
            cost_max_abs_err=(gc - wc).abs().max().item(),
            cost_max_rel_err=rel,
            costs_bitwise_equal=float((gc == wc).float().mean().item()),
            weights_max_abs_err=(g_w - w_w).abs().max().item(),
            update_max_abs_err=(g_upd - w_upd).abs().max().item(),
            ess=(g_ess.item(), w_ess.item()),
        )
        checks[mode] = res
        solved[mode] = (gc, g_w)
        print(f"fused solve vs twin ({mode}, T={T}, K={K}): {json.dumps(res)}", flush=True)
        if not (rel <= 1e-5 and res["weights_max_abs_err"] <= 1e-5
                and res["update_max_abs_err"] <= 5e-3
                and abs(res["ess"][0] - res["ess"][1]) <= 1e-3 * abs(res["ess"][1])):
            return fail(f"fused solve ({mode}) off the bar: costs rtol 1e-5, weights "
                        "atol 1e-5, update atol 5e-3, ESS rtol 1e-3")

    seq = g_upd.contiguous()
    got_r = fused_solve.fused_reroll(x0, seq, task)
    want_r = fused_solve.fused_reroll_plain(x0, seq, task)
    torch.cuda.synchronize()
    reroll_err = (got_r - want_r).abs().max().item()
    print(f"re-roll vs twin (T={T}): max_abs_err={reroll_err!r} "
          f"bitwise={bool(torch.equal(got_r, want_r))}", flush=True)
    if not (got_r.shape == (T + 1, 4) and torch.isfinite(got_r).all()
            and torch.equal(got_r, want_r)):
        return fail("re-roll off the bar: states bitwise the twin's")
    routes = tail_routes(torch, fused_solve, x0, prev, seed, xref5, task, (sig, u_min, u_max), K,
                         None)
    tails = check_tails(torch, fused_solve, f"racing T={T} K={K}", task, x0, routes)
    if tails is None:
        return 1
    tail_err, tail_checks = tails
    t_tails = time_tails(torch, fused_solve, task, x0, routes["fixed"], T)
    fixed_args = (x0, *routes["fixed"][:3], routes["fixed"][3], task,
                  torch.zeros(T - 1, 2, device=dev))
    t_tail_plain = cuda_ms(torch, lambda: fused_solve.fused_tick_tail_plain(*fixed_args), 3,
                           warmup=1)
    b_tail, by_tail = tail_bound_ms(K, T)
    print(f"tick tail on {card} (graph replay; event loop in brackets): " + "; ".join(
        f"{key[:-3]} {value:.4f} ms ({t_tails[key[:-3] + '_launch_loop_ms']:.4f})"
        for key, value in t_tails.items() if not key.endswith("launch_loop_ms"))
        + f"; twin {t_tail_plain:.3f} ms; bound {b_tail:.6f} ms ({by_tail})", flush=True)

    # timings: kernel (graph replay, and the event loop beside it) and twin, on this card
    t_solve, t_solve_loop = device_ms(torch, lambda: solve(fused_solve.fused_solve, None), 20)
    t_solve_plain = cuda_ms(torch, lambda: solve(fused_solve.fused_solve_plain, None), 3,
                            warmup=1)
    t_solve_noise, _ = device_ms(torch, lambda: solve(fused_solve.fused_solve, noise), 20)
    t_reroll, t_reroll_loop = device_ms(torch, lambda: fused_solve.fused_reroll(x0, seq, task),
                                        50)
    t_reroll_plain = cuda_ms(torch, lambda: fused_solve.fused_reroll_plain(x0, seq, task), 5,
                             warmup=1)
    b_solve, by_solve = solve_bound_ms(K, T, True, grid_bytes)
    b_noise, _ = solve_bound_ms(K, T, False, grid_bytes)
    b_reroll, by_reroll = reroll_bound_ms(T)
    print(f"times on {card} (graph replay; event loop in brackets): fused solve {t_solve:.4f} "
          f"ms ({t_solve_loop:.4f}; noise mode {t_solve_noise:.4f} ms, bound {b_noise:.5f} ms), "
          f"twin {t_solve_plain:.3f} ms; re-roll {t_reroll:.4f} ms ({t_reroll_loop:.4f}), twin "
          f"{t_reroll_plain:.3f} ms", flush=True)

    # --- phase 4: the auto-lambda kernels against their twins -----------------
    auto = check_auto_kernels(torch, fused_solve, x0, prev, noise, xref5, task, seed, sig,
                              u_min, u_max, grid_bytes, card)
    if auto is None:
        return 1

    # --- phase 5: the weighted update (row 9) and regeneration (row 6) ---------
    noise_costs, noise_weights = solved["noise"]
    pert = fused_solve.fused_regen_plain(prev, seed, torch.arange(K, device=dev), sig, u_min,
                                          u_max, K, K, noise)
    dump_costs, dump = fused_solve.fused_costs_dump(x0, prev, seed, xref5, task, sig,
                                                           u_min, u_max, K, K, None)
    print("ptxas, the weighted update: "
          + "; ".join(ptxas_report(cuda_build.build_logs, "weighted_update")), flush=True)
    row9 = check_weighted_update(torch, fused_solve, pert, noise_costs, dump_costs, dump, card)
    if row9 is None:
        return 1
    row6 = check_regen(torch, fused_solve, x0, prev, noise, xref5, task, seed, sig, u_min, u_max,
                       noise_weights, card)
    if row6 is None:
        return 1
    del pert, dump
    ref_rows_row = check_reference_rows(torch, env, card)
    if ref_rows_row is None:
        return 1
    plant_row = check_racing_plant(torch, env, card)
    if plant_row is None:
        return 1
    cost_row = check_mpcc_cost(torch, env, card)
    if cost_row is None:
        return 1

    # --- phase 6: the flagship under each mode, counted ----------------------
    env, solver, tick = build_flagship(horizon=T, num_samples=K, env=env, device="cuda")
    modes = drive_modes(torch, fused_solve, env, mode_solvers(env, task, solver, tick), card)
    if modes is None:
        return 1
    for m in ("fixed", "ESSPS"):
        run = modes[m]

        def flagship_tick(run=run):
            action_seq, _, run["state"], run["cind"] = run["tick"](run["state"], run["cind"],
                                                                   run["x"])
            run["x"], _ = env.step(action_seq[0])

        print(f"{m}: " + profile_ticks(torch, flagship_tick, 10), flush=True)
    turns = ticks_in_turns(torch, env, {m: (run["tick"], run["init"])
                                        for m, run in modes.items()})
    print(f"median ticks in turns (10 windows x 10 ticks a mode) on {card}: fixed "
          f"{turns['fixed']:.3f} ms; " + "; ".join(
              f"{m} {turns[m]:.3f} ms "
              f"({100.0 * (turns[m] - turns['fixed']) / turns['fixed']:+.1f}%)"
              for m in AUTO_MODES + tuple(ROUTE_MODES)), flush=True)

    # --- phase 6b: the graft entry, graft_entry_torch.entry() -----------------
    entry_run = drive_entry(torch, tick, card)
    if entry_run is None:
        return 1

    # --- phase 7: the RacingController facade on both routes, counted -------
    facades = drive_facades(torch, env, card)
    if facades is None:
        return 1
    # --- phase 8: the MPPI facade on both routes, counted ---------------------
    mppi_runs = drive_mppi(torch, env, task, card)
    if mppi_runs is None:
        return 1

    # --- phase 9: every other model family's kernels against their twins ------
    model_rows, regen_rows = {}, {}
    # (kernel, model) -> (ms, bound ms) of the kernels every model's paths share
    p2_row = next(r for r in auto["kernels"] if r["name"] == "fused_weighted")
    shared = {("fused_weighted", "racing"): (p2_row["ms"], p2_row["bound_ms"])}
    for name in NEW_MODELS:
        rows = check_model_kernels(torch, np, name, card)
        if rows is None:
            return 1
        for key, row in rows.items():
            if key == "weighted":
                shared[("fused_weighted", name)] = (row["ms"], row["bound_ms"])
            elif key.endswith("_regen"):
                shared[(row["name"], name)] = (row["ms"], row["bound_ms"])
                regen_rows.setdefault(key, row)  # the first model of each m: pendulum's m=1
            else:
                model_rows[key] = row
    wide = check_model_kernels(torch, np, "navigation", card, num_samples=100_000)
    if wide is None:
        return 1
    for key, row in wide.items():
        if key in model_rows:
            model_rows[key].update({f"k100000_{f}": row[f] for f in ("ms", "plain_ms", "bound_ms",
                                                                     "bound_by", "max_abs_err")})

    # --- phase 10: row 4, the lambda epilogue against the standalone route ----
    print("ptxas, the lambda epilogue's kernels: "
          + "; ".join(ptxas_report(cuda_build.build_logs, "costs_dump_lambda")), flush=True)
    both = ("ESSPS", "LBPS")
    cases = []
    for k in ROUTE_SAMPLES:
        cases += [(f"racing T={T} K={k}", mode,
                   (x0, prev, seed, xref5, task, sig, u_min, u_max, k, k),
                   noise[:k].contiguous()) for mode in both]
    # Navigation2D over the same K and at the epilogue's gate; every other
    # family at its example's configuration
    model_cases = [("navigation", k, both) for k in ROUTE_SAMPLES]
    model_cases += [("navigation", 524_288, ("ESSPS",))]
    model_cases += [(name, None, both) for name in NEW_MODELS if name != "navigation"]
    for name, k, searches in model_cases:
        w, m_prev, m_noise, m_bounds = model_inputs(torch, np, name, k)
        k = w.mppi_kwargs["num_samples"]
        cases += [(f"{name} T={m_prev.shape[0]} K={k}", mode,
                   (w.x0, m_prev, seed, None, w.task, *m_bounds, k, k), m_noise)
                  for mode in searches]
    epilogue = check_epilogue(torch, fused_solve, cases, card)
    del cases
    if epilogue is None:
        return 1
    by_k = {}
    for label, res in epilogue.items():
        k = int(label.split("K=")[1].split()[0])
        by_k.setdefault(k, []).append(res["epilogue_ms"] <= res["standalone_ms"])
    print(f"lambda routes on {card}: the epilogue no slower than the standalone route in every "
          f"case at K = {[k for k, v in sorted(by_k.items()) if all(v)]}, slower in some at K = "
          f"{[k for k, v in sorted(by_k.items()) if not all(v)]}; the default route takes the "
          f"epilogue up to K = {EPILOGUE_DEFAULT_MAX_SAMPLES}", flush=True)
    from mppi_playground_tpu_torch.ops.lambda_search import LambdaSearch

    flag_args = (x0, prev, seed, xref5, task, sig, u_min, u_max, K, K, None)
    flag_search = LambdaSearch("ESSPS", 0.01, 10.0, K / 10.0, 40)
    t_epi_plain = cuda_ms(torch, lambda: fused_solve.fused_costs_dump_lambda_plain(
        *flag_args, flag_search), 2, warmup=1)
    b_epi = phase1_bound_ms(K, T, True, grid_bytes, RACING, search_ops(K, 40, OPS_ESSPS_EVAL, 2))
    flag_epi = epilogue[f"racing T={T} K={K} ESSPS"]
    racing_epilogue_row = kernel_row(
        "racing_costs_dump_lambda", "fused_racing.cu", f"{FUSED_SOLVE_PY}:783",
        max(r["max_abs_err"] for label, r in epilogue.items() if label.startswith("racing")),
        flag_epi["epilogue_ms"], t_epi_plain, *b_epi, search="ESSPS", horizon=T, num_samples=K,
        in_turns={label: {key: r[key] for key in r if key.endswith("_ms")}
                  for label, r in epilogue.items() if label.startswith("racing")})
    for name in NEW_MODELS:
        model_rows[f"{name}_costs_dump_lambda"]["in_turns"] = {
            label: {key: r[key] for key in r if key.endswith("_ms")}
            for label, r in epilogue.items() if label.startswith(f"{name} ")}

    # --- phase 11: the model families' closed loops through MPPI, counted -----
    model_paths = drive_model_paths(torch, card)
    if model_paths is None:
        return 1

    # --- phase 12: the closed loops on the card -------------------------------
    loops = drive_closed_loops(torch, env, card)
    if loops is None:
        return 1

    # --- phase 13: the fleet --------------------------------------------------
    fleet = drive_fleets(torch, np, env, card)
    if fleet is None:
        return 1

    # --- phase 14: sample sharding --------------------------------------------
    sharding = drive_sharding(torch, np, env, card)
    if sharding is None:
        return 1

    # --- phase 15: the examples on the card -----------------------------------
    examples = drive_examples(torch, card)
    if examples is None:
        return 1

    # --- phase 16: a user's own model on the fused kernels ----------------------
    plugs = drive_plugs(torch, np, card)
    if plugs is None:
        return 1
    shared.update(plugs["shared"])

    paths = {f"flagship {m}": run["launches"] for m, run in modes.items()}
    paths["graft entry"] = entry_run["launches"]
    paths.update({f"flagship episode {m}": run["launches"]
                  for m, run in loops["flagship"].items()})
    paths.update({label: run["launches"] for label, run in loops["episodes"].items()
                  if "launches" in run})
    paths.update({f"RacingController {r}": run["launches"] for r, run in facades.items()})
    paths.update(mppi_runs)
    paths.update({label: run["launches"] for label, run in model_paths.items()})
    paths.update({label: run["launches"] for label, run in
                  {**fleet["racing"], **fleet["models"]}.items()})
    paths.update({f"sharded flagship {m}": {name: run["launches"].get(name, 0)
                                            for name in launch_counters()}
                  for m, run in sharding["facade"].items()})
    paths.update({label: {name: run["launches"].get(name, 0) for name in launch_counters()}
                  for label, run in examples["runs"].items()})
    plug_models = [plug.task.plug for plug in plugs["plugs"].values()]
    paths.update({label: {name: run["launches"].get(name, 0)
                          for name in launch_counters(plug_models)}
                  for label, run in plugs["paths"].items()})

    def launches_of(name):
        by_path = {p: counts.get(name, 0) for p, counts in paths.items()}
        return sum(by_path.values()), by_path

    kernels = [
        {
            "name": "racing_fused_solve",
            "route": "cuda",
            "source": "mppi_playground_tpu_torch/csrc/fused_racing.cu",
            "replaces": "mppi_playground_tpu/ops/fused_solve.py:783",
            "max_abs_err": max(checks["seeded"]["cost_max_abs_err"],
                               checks["noise"]["cost_max_abs_err"]),
            "ms": t_solve,
            "launch_loop_ms": t_solve_loop,
            "plain_ms": t_solve_plain,
            "bound_ms": b_solve,
            "bound_by": by_solve,
            "library_ms": None,
            "noise_mode_ms": t_solve_noise,
            "noise_mode_bound_ms": b_noise,
        },
        {
            "name": "racing_reroll",
            "route": "cuda",
            "source": "mppi_playground_tpu_torch/csrc/reroll.cu",
            "replaces": "mppi_playground_tpu/ops/fused_solve.py:272",
            "max_abs_err": reroll_err,
            "ms": t_reroll,
            "launch_loop_ms": t_reroll_loop,
            "plain_ms": t_reroll_plain,
            "bound_ms": b_reroll,
            "bound_by": by_reroll,
            "library_ms": None,
        },
        {
            "name": "racing_tick_tail",
            "route": "cuda",
            "source": "mppi_playground_tpu_torch/csrc/reroll.cu",
            "replaces": "mppi_playground_tpu/ops/fused_solve.py:272",
            "max_abs_err": tail_err,
            "ms": t_tails["tail_ms"],
            "launch_loop_ms": t_tails["tail_launch_loop_ms"],
            "plain_ms": t_tail_plain,
            "bound_ms": b_tail,
            "bound_by": by_tail,
            "library_ms": None,
            "alternatives_ms": t_tails,
            "checks": tail_checks,
        },
    ] + auto["kernels"] + row6 + [row9, racing_epilogue_row] + list(model_rows.values()) + [
        regen_rows["m1_regen"]] + list(plugs["rows"].values()) + [ref_rows_row, plant_row,
                                                                     cost_row]
    sharded_rows = {"racing_fused_solve": "row1", "racing_costs_dump": "row3",
                    "fused_weighted": "row5"}
    for k in kernels:
        k["launches"], k["launches_by_path"] = launches_of(k["name"])
        k["row"] = tpu_row(k["name"])
        if k["name"] in sharded_rows:  # the shards' launches it was held on, bit for bit
            k["sharded"] = {label: {case: r[sharded_rows[k["name"]]] for case, r in cases.items()}
                            for label, cases in sharding["rows"].items()}
        if k["name"] in fleet["rows"]:  # its launch over a fleet, with the fleets' launches
            k["batched"] = dict(fleet["rows"][k["name"]], launches=sum(
                n for path, n in k["launches_by_path"].items() if is_fleet_path(path)))
    listed = [k["name"] for k in kernels]
    missing = sorted(set(launch_counters(plug_models)) - set(listed))
    off_paths = OFF_PATHS + tuple(f"{name}_reroll" for name in plugs["per_slot"])
    idle = [k["name"] for k in kernels if k["launches"] == 0 and k["name"] not in off_paths]
    for k in kernels:
        if k["name"] in off_paths:
            k["on_paths"] = False
    if missing or idle or len(set(listed)) != len(listed):
        return fail(f"kernels line: not listed {missing}; never launched on a path {idle}")
    if foreign_modules(sys.modules):  # a phase's import, after the check at the start
        return fail(f"a phase imported jax or the JAX package: {foreign_modules(sys.modules)}")
    print(f"launches x (ms - bound_ms) over this run's paths, by TPU kernel row, on {card}: "
          + json.dumps(row_products(kernels, shared, plug_models)), flush=True)
    print(json.dumps({"kernels": kernels, "card": card,
                      "median_tick_ms": modes["fixed"]["median_ms"],
                      "median_tick_ms_in_turns": turns,
                      "graft_entry": {k: v for k, v in entry_run.items() if k != "launches"},
                      "facade_median_ms": {r: {"update": run["tick_ms"],
                                               "get_top_samples": run["top_ms"]}
                                           for r, run in facades.items()},
                      "lambda_routes_in_turns": epilogue,
                      "closed_loops": {
                          "flagship": {m: {k: v for k, v in run.items()
                                           if k not in ("launches", "profile")}
                                       for m, run in loops["flagship"].items()},
                          "facades": loops["facades"], "seconds": loops["seconds"]},
                      "model_paths": {label: {k: v for k, v in run.items()
                                              if k not in ("launches", "profile")}
                                      for label, run in model_paths.items()},
                      "fleet": {"episodes": {label: {k: v for k, v in run.items()
                                                     if k != "launches"}
                                             for label, run in {**fleet["racing"],
                                                                **fleet["models"]}.items()},
                                "epilogue_against_standalone": fleet["epilogue"],
                                "utils": fleet["utils"], "seconds": fleet["seconds"]},
                      "sharding": {"facade": {m: {k: v for k, v in run.items() if k != "launches"}
                                              for m, run in sharding["facade"].items()},
                                   "gloo": sharding["gloo"], "seconds": sharding["seconds"]},
                      "examples": {"runs": {label: {k: v for k, v in run.items()
                                                    if k != "launches"}
                                            for label, run in examples["runs"].items()},
                                   "pendulum_episode": examples["pendulum"],
                                   "pipelined_quality": examples["pipelined"],
                                   "seconds": examples["seconds"]},
                      "plugs": {"paths": {label: {k: v for k, v in run.items()
                                                  if k != "launches"}
                                          for label, run in plugs["paths"].items()},
                                "per_slot": plugs["per_slot"], "build_s": plugs["build_s"],
                                "seconds": plugs["seconds"]}}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
