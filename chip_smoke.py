#!/usr/bin/env python3
"""Drive the port's racing paths on one NVIDIA GPU and check its eight CUDA kernels.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of ``mppi_playground_tpu_torch/csrc`` with ``nvcc``
   (one process per source, started together);
3. hold each kernel against its plain PyTorch twin on the card, at the
   flagship's shapes (T=50, K=100,000): the fused solve with injected noise
   and with its seeded Philox stream, and the re-roll; then time each
   kernel and twin with CUDA events;
4. the auto-lambda kernels against their twins at the same shapes: phase 1
   (costs and perturbation dump, both noise modes), the ESSPS and LBPS
   searches (on the flagship's costs and on vectors that reach each ESSPS
   clamp and the interior), phase 2 at lambda* and, at lambda=1, against
   the fixed solve's partials; each timed with CUDA events;
5. the weighted update (D=100 at lambda 1 and 10 on the unfused route's
   perturbations and costs, D=100 and D=2,000 under spread costs) against
   its twin, the block partials and the combined output each held to a bar,
   and against phase 2 on the
   same perturbations (one reduction body: bitwise); regeneration of all K
   rows, seeded and in noise mode, against phase 1's dump (bitwise) and of
   the top 300 rows against those rows; each timed, the weighted update
   beside ``torch.softmax`` then ``torch.mv``;
6. drive the flagship, ``build_flagship(device="cuda")``, at its fixed
   lambda and under ESSPS, LBPS and MPO for 50 closed-loop ticks of
   ``RacingEnv.step`` each, all eight launch counters set to 0 just before
   each mode and read just after: each kernel of the mode's path launched
   once a tick and every other kernel never, lambda in bounds, actions in
   bounds, progress, and one solve per mode with no host sync
   (``torch.cuda.set_sync_debug_mode("error")``); then a profile and the
   four modes' ticks timed in turns;
7. drive ``RacingController(env)`` on its unfused route (the default) and
   its fused route (``store_rollouts=False``) at T=25, K=4,000 and at T=50,
   K=100,000: 50 ticks each of ``update``, ``env.step`` and
   ``get_top_samples(300)``, counted as in phase 6 (unfused: the weighted
   update once a tick; fused: the solve, the re-roll and regeneration once
   a tick), one tick with no host sync, the median update and
   ``get_top_samples`` times and a profile;
8. drive ``MPPI`` on both routes at a fixed lambda and under ESSPS with the
   SG filter: 10
   ``forward`` calls with the racing dynamics and the MPCC cost, then
   ``get_top_samples(50)`` and ``get_samples_from_posterior``, counted.

It prints a ``kernels`` JSON line before the last, and as its last line
``{"ok": true, "device": {...}}``.  Without a card, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

T, K = 50, 100_000
TICKS = 50
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 non-tensor FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# Float operations per call of each device function in csrc/racing_model.cuh,
# counted from the source (+, -, *, /, min, max, fmod, rint, sqrt, log; sign
# flips, compares and selects not counted; Philox's integer work not counted).
OPS_ANGLE_NORMALIZE = 4
OPS_SINCOS = 20
OPS_TAN = 8
OPS_BICYCLE = 2 * OPS_ANGLE_NORMALIZE + 4 + OPS_SINCOS + 5 + 5 + OPS_TAN + 4 + 4
OPS_MAP_PAIR = 11
OPS_STAGE_COST = 33 + OPS_MAP_PAIR + 1  # + the accumulation
OPS_NORMAL_PAIR = 10 + OPS_SINCOS
OPS_PERTURB = 6  # mean + z and the clamp, per step (2 slots)
OPS_SCALE = 2  # z * sigma, per step, seeded mode only
# Per cost and evaluation of csrc/lambda_search.cu: ESSPS d * inv, exp, two
# adds, e * e; LBPS c * a, - shift, exp, three adds, e * e, e * c.  Plus the
# min (and max) pass and, for ESSPS, d = min - c once.
OPS_ESSPS_EVAL, OPS_LBPS_EVAL = 5, 8
AUTO_MODES = ("ESSPS", "LBPS", "MPO")


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def solve_bound_ms(num_samples: int, horizon: int, seeded: bool, grid_bytes: int) -> tuple:
    """Least time of one fused solve: (ms, 'bytes' | 'operations').

    Bytes: each input read once, each output written once.  Operations: the
    rollout with its costs, the draws, and e * pert summed into the
    numerator, once per sample (the kernel regenerates the perturbations a
    second time; that is its design, not the function's work).
    """
    blocks = -(-num_samples // 256)
    in_bytes = 4 * (4 + 2 * horizon + 1 + 5 * (horizon + 1)) + grid_bytes
    if not seeded:
        in_bytes += 4 * num_samples * horizon * 2
    out_bytes = 4 * (num_samples + 3 * blocks + 2 * horizon * blocks)
    per_step = OPS_PERTURB + OPS_STAGE_COST + OPS_BICYCLE
    if seeded:
        per_step += OPS_NORMAL_PAIR + OPS_SCALE
    per_sample = horizon * per_step + OPS_STAGE_COST + 4 + 2 * 2 * horizon
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S
    t_ops = num_samples * per_sample / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _bound(in_bytes: float, out_bytes: float, ops: float) -> tuple:
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase1_bound_ms(num_samples: int, horizon: int, seeded: bool, grid_bytes: int) -> tuple:
    """Least time of auto-lambda phase 1: the rollout and costs, and the dump written."""
    in_bytes = 4 * (4 + 2 * horizon + 5 * (horizon + 1)) + grid_bytes
    if not seeded:
        in_bytes += 4 * num_samples * horizon * 2
    out_bytes = 4 * num_samples * (1 + 2 * horizon)
    per_step = OPS_PERTURB + OPS_STAGE_COST + OPS_BICYCLE
    if seeded:
        per_step += OPS_NORMAL_PAIR + OPS_SCALE
    return _bound(in_bytes, out_bytes, num_samples * (horizon * per_step + OPS_STAGE_COST))


def phase2_bound_ms(num_samples: int, horizon: int) -> tuple:
    """Least time of auto-lambda phase 2: costs and dump read, the partials written.

    Operations per sample: -c / lambda, the max, the shift, exp, e * e and
    two sums, and e * pert summed into each of the 2T slots.
    """
    blocks = -(-num_samples // 256)
    in_bytes = 4 * (num_samples * (1 + 2 * horizon) + 1)
    out_bytes = 4 * blocks * (3 + 2 * horizon)
    return _bound(in_bytes, out_bytes, num_samples * (7 + 2 * 2 * horizon))


def search_bound_ms(num_samples: int, iters: int, per_eval: int, per_cost: int) -> tuple:
    """Least time of one lambda search: the costs read once, 2 + iters evaluations."""
    return _bound(4 * num_samples, 4, num_samples * (per_cost + per_eval * (2 + iters)))


def reroll_bound_ms(horizon: int) -> tuple:
    t_bytes = 4 * (4 + 2 * horizon + 4 * (horizon + 1)) / PEAK_BYTES_PER_S
    t_ops = horizon * OPS_BICYCLE / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time per call over ``reps`` calls, by CUDA events."""
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


def profile_ticks(torch, run_tick, ticks: int, what: str = "with env.step") -> str:
    """Where a tick's time goes: device busy share and kernels by device time.

    ``torch.profiler`` over ``ticks`` calls of ``run_tick()``, one closed-loop
    tick each; the device time is the sum of the kernels' durations on the
    one stream.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            run_tick()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
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
        costs, dump = phase1(fused_solve.fused_racing_costs_dump, nz)
        w_costs, w_dump = phase1(fused_solve.fused_racing_costs_dump_plain, nz)
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

    got = fused_solve.racing_weighted(costs, dump, lam_star)
    want = fused_solve.racing_weighted_plain(costs, dump, lam_star)
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
    fixed = fused_solve.fused_racing_solve(x0, prev, one, seed, xref5, task, sig, u_min, u_max,
                                           K, K, None)
    stats, numer = fused_solve.racing_weighted(costs, dump, one)
    same = all(torch.equal(a, b) for a, b in ((fixed[0], costs), (fixed[1], stats),
                                               (fixed[2], numer)))
    print(f"phase 1 + phase 2 at lambda=1 vs the fixed solve: bitwise={same}", flush=True)
    if not same:
        fail("phase 1 + phase 2 at lambda=1 differ from the fixed solve's costs and partials")
        return None

    # timings: kernel and twin, on this card
    flag = vectors["flagship"]
    t_p1 = cuda_ms(torch, lambda: phase1(fused_solve.fused_racing_costs_dump, None), 20)
    t_p1_noise = cuda_ms(torch, lambda: phase1(fused_solve.fused_racing_costs_dump, noise), 20)
    t_p1_plain = cuda_ms(torch, lambda: phase1(fused_solve.fused_racing_costs_dump_plain, None),
                         3, warmup=1)
    t_es = cuda_ms(torch, lambda: lambda_search.essps_lambda_fused(flag, target, lam_min,
                                                                   lam_max), 50)
    t_es_plain = cuda_ms(torch, lambda: lambda_search.essps_lambda_plain(flag, target, lam_min,
                                                                         lam_max), 3, warmup=1)
    t_lb = cuda_ms(torch, lambda: lambda_search.lbps_lambda_fused(flag, delta, lam_min,
                                                                  lam_max), 50)
    t_lb_plain = cuda_ms(torch, lambda: lambda_search.lbps_lambda_plain(flag, delta, lam_min,
                                                                        lam_max), 3, warmup=1)
    t_p2 = cuda_ms(torch, lambda: fused_solve.racing_weighted(costs, dump, lam_star), 50)
    t_p2_plain = cuda_ms(torch, lambda: fused_solve.racing_weighted_plain(costs, dump, lam_star),
                         5, warmup=1)
    b_p1, by_p1 = phase1_bound_ms(K, T, True, grid_bytes)
    b_p1_noise, _ = phase1_bound_ms(K, T, False, grid_bytes)
    b_es, by_es = search_bound_ms(K, 40, OPS_ESSPS_EVAL, 2)
    b_lb, by_lb = search_bound_ms(K, 32, OPS_LBPS_EVAL, 2)
    b_p2, by_p2 = phase2_bound_ms(K, T)
    print(f"times on {card}: phase 1 {t_p1:.4f} ms (noise mode {t_p1_noise:.4f} ms, bound "
          f"{b_p1:.5f} / {b_p1_noise:.5f} ms), twin {t_p1_plain:.3f} ms; ESSPS search "
          f"{t_es:.4f} ms (bound {b_es:.5f} ms), twin {t_es_plain:.3f} ms; LBPS search "
          f"{t_lb:.4f} ms (bound {b_lb:.5f} ms), twin {t_lb_plain:.3f} ms; phase 2 {t_p2:.4f} ms "
          f"(bound {b_p2:.5f} ms), twin {t_p2_plain:.3f} ms", flush=True)

    def row(name, source, replaces, err, ms, plain, bound, by, **extra):
        return dict(name=name, route="cuda", source=f"mppi_playground_tpu_torch/csrc/{source}",
                    replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                    bound_by=by, library_ms=None, **extra)

    return {"kernels": [
        row("fused_racing_costs_dump", "fused_solve.cu",
            "mppi_playground_tpu/ops/fused_solve.py:783", p1_err, t_p1, t_p1_plain, b_p1, by_p1,
            noise_mode_ms=t_p1_noise, noise_mode_bound_ms=b_p1_noise),
        row("essps_lambda_fused", "lambda_search.cu",
            "mppi_playground_tpu/ops/lambda_search.py:354", search_err["essps"], t_es,
            t_es_plain, b_es, by_es),
        row("lbps_lambda_fused", "lambda_search.cu",
            "mppi_playground_tpu/ops/lambda_search.py:394", search_err["lbps"], t_lb,
            t_lb_plain, b_lb, by_lb),
        row("racing_weighted", "fused_solve.cu", "mppi_playground_tpu/ops/fused_solve.py:887",
            p2_err, t_p2, t_p2_plain, b_p2, by_p2),
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
    for mode in AUTO_MODES:
        cfg = dataclasses.replace(flagship_solver.config, lambda_=mode)
        solver = make_fused_solver(cfg, task, env.dynamics, device="cuda")

        def tick(state, cind, x, solver=solver, horizon=cfg.horizon):
            xref, new_cind = calc_ref_trajectory(x, path, cind, horizon)
            result = solver.solve(state, x, info={"reference_path": xref})
            return result.action_seq, result.state_seq, result.state, new_cind

        solvers[mode] = (solver, tick)
    return solvers


def launch_counters() -> dict:
    """The eight kernel wrappers, by name: each counts its launches in ``launches``."""
    from mppi_playground_tpu_torch.ops import fused_solve, lambda_search, weighted_update

    return {
        "fused_racing_solve": fused_solve.fused_racing_solve,
        "racing_reroll": fused_solve.racing_reroll,
        "fused_racing_costs_dump": fused_solve.fused_racing_costs_dump,
        "racing_weighted": fused_solve.racing_weighted,
        "essps_lambda_fused": lambda_search.essps_lambda_fused,
        "lbps_lambda_fused": lambda_search.lbps_lambda_fused,
        "racing_regen": fused_solve.racing_regen,
        "weighted_update_partials": weighted_update.weighted_update_partials,
    }


def zero_counters() -> dict:
    counted = launch_counters()
    for fn in counted.values():
        fn.launches = 0
    return counted


def drive_modes(torch, fused_solve, env, solvers, card):
    """Phase 6: 50 closed-loop flagship ticks under each mode, every kernel counted.

    ``solvers`` is :func:`mode_solvers`'s.  Before each mode all eight launch
    counters are set to 0, and they are read after its last tick.  Returns
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
        launches = {name: fn.launches for name, fn in counted.items()}
        once = ({"fused_racing_solve", "racing_reroll"} if mode in ("fixed", "MPO") else
                {"fused_racing_costs_dump", "racing_weighted", "racing_reroll",
                 f"{mode.lower()}_lambda_fused"})
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


def weighted_update_bound_ms(num_samples: int, slots: int) -> tuple:
    """Least time of the weighted update: costs and samples read, partials written.

    Operations per sample: -c / lambda, the max, the shift, exp, e * e and
    two sums, and e * sample summed into each of the D slots.
    """
    blocks = -(-num_samples // 256)
    in_bytes = 4 * (num_samples * (slots + 1) + 1)
    out_bytes = 4 * blocks * (3 + slots)
    return _bound(in_bytes, out_bytes, num_samples * (7 + 2 * slots))


def regen_bound_ms(rows: int, horizon: int, seeded: bool) -> tuple:
    """Least time of regenerating ``rows`` samples: [rows, T, 2] written.

    Reads the warm start and the row indices, and in noise mode those rows'
    noise; per step one normal pair (seeded), the scale and the perturb.
    """
    in_bytes = 4 * 2 * horizon + 8 * rows + (0 if seeded else 4 * rows * 2 * horizon)
    per_step = OPS_PERTURB + (OPS_NORMAL_PAIR + OPS_SCALE if seeded else 0)
    return _bound(in_bytes, 4 * rows * 2 * horizon, rows * horizon * per_step)


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


def check_weighted_update(torch, fused_solve, pert, costs, dump_costs, dump, card):
    """Row 9 at the flagship's shapes: the kernel against its twin, phase 2's shared body.

    ``pert [K, T, 2]`` are the unfused route's clamped perturbations and
    ``costs`` theirs; ``dump_costs``/``dump`` phase 1's seeded outputs.
    The flagship's costs (about 1e5) leave a few rows with weight, so the
    perturbations also run under spread costs (uniform in [0, 100)), where
    many rows carry weight.  Returns the kernels-line row, or None after a
    failure.
    """
    from mppi_playground_tpu_torch.ops import weighted_update as wu

    dev = costs.device
    flat = pert.reshape(K, 2 * T).contiguous()
    rng = torch.Generator(device=dev).manual_seed(SEED + 9)
    wide = torch.randn(K, 2000, generator=rng, device=dev)
    spread = torch.rand(K, generator=rng, device=dev) * 100.0
    err, bitwise = 0.0, True
    for name, c, samples, lam in (("D=100, lambda=1", costs, flat, 1.0),
                                  ("D=100, lambda=10", costs, flat, 10.0),
                                  ("D=100, spread costs, lambda=1", spread, flat, 1.0),
                                  ("D=2000, spread costs, lambda=1", spread, wide, 1.0)):
        lam_t = torch.full((1,), lam, device=dev)
        got = wu.weighted_update_partials(c, samples, lam_t)
        want = wu.block_partials_plain(c, samples, lam_t)
        slots = samples.shape[1]
        g = wu.combine_partials(c, *got, lam_t, slots // 2, 2)
        w = wu.combine_partials(c, *want, lam_t, slots // 2, 2)
        torch.cuda.synchronize()
        res = dict(partials_max_abs_err=max((got[0] - want[0]).abs().max().item(),
                                            (got[1] - want[1]).abs().max().item()),
                   partials_bitwise_equal=all(torch.equal(a, b) for a, b in zip(got, want)),
                   partials=partials_errors(torch, got, want, c, samples, lam_t),
                   weights_max_abs_err=(g[1] - w[1]).abs().max().item(),
                   update_max_abs_err=(g[0] - w[0]).abs().max().item(),
                   ess=(g[2].item(), w[2].item()))
        print(f"weighted update vs twin ({name}, K={K}): {json.dumps(res)}", flush=True)
        err = max(err, res["partials_max_abs_err"])
        bitwise = bitwise and res["partials_bitwise_equal"]
        if not (res["partials"]["ok"] and res["weights_max_abs_err"] <= 1e-5
                and res["update_max_abs_err"] <= 5e-3
                and abs(res["ess"][0] - res["ess"][1]) <= 1e-3 * abs(res["ess"][1])):
            fail(f"weighted update ({name}) off the bar: partials {PARTIALS_BAR}; weights atol "
                 "1e-5, update atol 5e-3, ESS rtol 1e-3")
            return None
    # phase 2 and row 9 share one reduction body: the same partials, bit for bit
    for lam in (1.0, 10.0):
        lam_t = torch.full((1,), lam, device=dev)
        p2 = fused_solve.racing_weighted(dump_costs, dump, lam_t)
        r9 = wu.weighted_update_partials(dump_costs, dump.t().contiguous(), lam_t)
        same = all(torch.equal(a, b) for a, b in zip(p2, r9))
        print(f"phase 2 vs the weighted update on the transposed dump (lambda={lam}): "
              f"bitwise={same}", flush=True)
        if not same:
            fail("phase 2 and the weighted update differ on the same perturbations")
            return None

    one = torch.ones(1, device=dev)
    t_k = cuda_ms(torch, lambda: wu.weighted_update_partials(costs, flat, one), 50)
    t_plain = cuda_ms(torch, lambda: wu.block_partials_plain(costs, flat, one), 5, warmup=1)
    t_lib = cuda_ms(torch, lambda: torch.mv(flat.t(), torch.softmax(-costs / one, dim=0)), 50)
    t_wide = cuda_ms(torch, lambda: wu.weighted_update_partials(spread, wide, one), 20)
    t_wide_plain = cuda_ms(torch, lambda: wu.block_partials_plain(spread, wide, one), 3,
                           warmup=1)
    t_wide_lib = cuda_ms(torch, lambda: torch.mv(wide.t(), torch.softmax(-spread / one, dim=0)),
                         20)
    bound, by = weighted_update_bound_ms(K, 2 * T)
    b_wide, _ = weighted_update_bound_ms(K, 2000)
    print(f"times on {card}: weighted update D=100 {t_k:.4f} ms (bound {bound:.5f} ms), twin "
          f"{t_plain:.3f} ms, softmax + mv (two calls) {t_lib:.4f} ms; D=2000 {t_wide:.4f} ms "
          f"(bound {b_wide:.5f} ms), twin {t_wide_plain:.3f} ms, softmax + mv {t_wide_lib:.4f} "
          "ms", flush=True)
    return dict(name="weighted_update_partials", route="cuda",
                source="mppi_playground_tpu_torch/csrc/weighted_update.cu",
                replaces="mppi_playground_tpu/ops/pallas_kernels.py:142", max_abs_err=err,
                bitwise_equal_to_twin=bitwise, ms=t_k, plain_ms=t_plain, bound_ms=bound,
                bound_by=by, library_ms=t_lib, library_calls="torch.softmax then torch.mv (2)",
                d2000_ms=t_wide, d2000_plain_ms=t_wide_plain, d2000_bound_ms=b_wide,
                d2000_library_ms=t_wide_lib)


def check_regen(torch, fused_solve, x0, prev, noise, xref5, task, seed, sig, u_min, u_max,
                weights, card):
    """Row 6 at T=50, K=100,000: all K rows against phase 1's dump, the top 300 against them.

    Returns the kernels-line row, or None after a failure.
    """
    from mppi_playground_tpu_torch.core.diagnostics import top_indices

    dev = x0.device
    threshold = int(0.8 * K)  # both sides of the inherit split
    rows = torch.arange(K, device=dev)
    top = top_indices(weights, 300)[1]
    err = 0.0
    for mode, nz in (("seeded", None), ("noise", noise)):
        args = (sig, u_min, u_max, K, threshold, nz)
        _, dump = fused_solve.fused_racing_costs_dump(x0, prev, seed, xref5, task, *args)
        full = fused_solve.racing_regen(prev, seed, rows, *args)
        twin = fused_solve.racing_regen_plain(prev, seed, rows, *args)
        sub = fused_solve.racing_regen(prev, seed, top, *args)
        torch.cuda.synchronize()
        res = dict(all_rows_vs_phase1_dump=bool(torch.equal(full, dump.t().reshape(K, T, 2))),
                   all_rows_vs_twin=bool(torch.equal(full, twin)),
                   max_abs_err=(full - twin).abs().max().item(),
                   top300_vs_all_rows=bool(torch.equal(sub, full[top])))
        print(f"regeneration ({mode}, T={T}, K={K}): {json.dumps(res)}", flush=True)
        err = max(err, res["max_abs_err"])
        if not all(v for k, v in res.items() if k != "max_abs_err"):
            fail(f"regeneration ({mode}) is not bit for bit the solve's perturbations")
            return None
    args = (sig, u_min, u_max, K, threshold)
    t_all = cuda_ms(torch, lambda: fused_solve.racing_regen(prev, seed, rows, *args), 20)
    t_top = cuda_ms(torch, lambda: fused_solve.racing_regen(prev, seed, top, *args), 50)
    t_noise = cuda_ms(torch, lambda: fused_solve.racing_regen(prev, seed, rows, *args, noise), 20)
    t_plain = cuda_ms(torch, lambda: fused_solve.racing_regen_plain(prev, seed, rows, *args), 3,
                      warmup=1)
    t_top_plain = cuda_ms(torch, lambda: fused_solve.racing_regen_plain(prev, seed, top, *args),
                          3, warmup=1)
    b_all, by_all = regen_bound_ms(K, T, True)
    b_top, by_top = regen_bound_ms(300, T, True)
    b_noise, _ = regen_bound_ms(K, T, False)
    print(f"times on {card}: regeneration of all {K} rows {t_all:.4f} ms (bound {b_all:.5f} ms, "
          f"{by_all}; noise mode {t_noise:.4f} ms, bound {b_noise:.5f} ms), twin {t_plain:.3f} "
          f"ms; of the top 300 {t_top:.4f} ms (bound {b_top:.6f} ms, {by_top}), twin "
          f"{t_top_plain:.3f} ms", flush=True)
    return dict(name="racing_regen", route="cuda",
                source="mppi_playground_tpu_torch/csrc/fused_solve.cu",
                replaces="mppi_playground_tpu/ops/fused_solve.py:937", max_abs_err=err,
                ms=t_top, plain_ms=t_top_plain, bound_ms=b_top, bound_by=by_top,
                library_ms=None, rows=300, all_rows_ms=t_all, all_rows_plain_ms=t_plain,
                all_rows_bound_ms=b_all, all_rows_noise_mode_ms=t_noise,
                all_rows_noise_mode_bound_ms=b_noise)


FACADE_ROUTES = (
    ("T=25 K=4000 unfused", dict()),
    ("T=25 K=4000 fused", dict(store_rollouts=False)),
    ("T=50 K=100000 unfused", dict(horizon=50, num_samples=100_000)),
    ("T=50 K=100000 fused", dict(horizon=50, num_samples=100_000, store_rollouts=False)),
)


def drive_facades(torch, env, card):
    """Phase 7: ``RacingController`` on both routes at two widths, 50 ticks each.

    Each tick is ``update``, ``env.step`` and ``get_top_samples(300)``, as
    the racing example runs them.  One tick of each route (without
    ``env.step``) runs under ``set_sync_debug_mode("error")``; all eight
    counters are set to 0 before a route's ticks and read after.  Returns
    ``{route: {"launches", "tick_ms", "top_ms", "profile"}}`` or None.
    """
    from mppi_playground_tpu_torch.envs import RacingController

    out = {}
    for route, kw in FACADE_ROUTES:
        ctrl = RacingController(env, **kw)
        fused = "store_rollouts" in kw
        if ctrl.solver_backend != ("fused" if fused else "xla"):
            fail(f"{route}: RacingController took the {ctrl.solver_backend} route")
            return None
        x = env.reset()
        ctrl.update(x)  # builds the kernels' libraries and the lookahead table
        ctrl.get_top_samples(300)
        ctrl.reset()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ctrl.update(x)
            ctrl.get_top_samples(300)
        except RuntimeError as err:
            fail(f"{route}: a tick synchronized with the host: {err}")
            return None
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()

        ctrl.reset()
        counted = zero_counters()
        x = env.reset()
        tick_ms, top_ms = [], []
        for _ in range(TICKS):
            t0 = time.perf_counter()
            action_seq, state_seq = ctrl.update(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            x, _ = env.step(action_seq[0])
            t2 = time.perf_counter()
            seqs, weights = ctrl.get_top_samples(300)
            torch.cuda.synchronize()
            tick_ms.append(1e3 * (t1 - t0))
            top_ms.append(1e3 * (time.perf_counter() - t2))
            excess = torch.maximum(env.u_min - action_seq, action_seq - env.u_max).max().item()
            if not (torch.isfinite(action_seq).all() and torch.isfinite(state_seq).all()
                    and torch.isfinite(seqs).all() and excess <= 1e-5
                    and seqs.shape == (300, ctrl.config.horizon + 1, 4)
                    and bool((weights[:-1] >= weights[1:]).all())):
                fail(f"{route}: non-finite output, actions out of bounds by {excess!r}, or top "
                     "samples not in descending weight order")
                return None
        launches = {name: fn.launches for name, fn in counted.items()}
        once = ({"fused_racing_solve", "racing_reroll", "racing_regen"} if fused
                else {"weighted_update_partials"})
        want = {name: (TICKS if name in once else 0) for name in counted}
        progress = int(ctrl.current_path_index)
        if launches != want or progress <= 0:
            fail(f"{route}: launches {launches}, expected {want}; track index {progress}")
            return None

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
              f"{res['top_ms']:.3f} ms (host clock, synchronized); track index {progress}; "
              f"launches {launches}; {prof}", flush=True)
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
            launches = {name: fn.launches for name, fn in counted.items()}
            if route == "xla":
                want_once = {"weighted_update_partials": calls}
            elif mode == 1.0:
                want_once = {"fused_racing_solve": calls, "racing_reroll": calls,
                             "racing_regen": 1}
            else:
                want_once = {"fused_racing_costs_dump": calls, "essps_lambda_fused": calls,
                             "racing_weighted": calls, "racing_reroll": calls, "racing_regen": 1}
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
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory,
        extend_reference_path,
        make_racing_fused_task_from_env,
    )
    from mppi_playground_tpu_torch.ops import cuda_build, fused_solve
    from mppi_playground_tpu_torch.ops.weighted_update import combine_partials
    from mppi_playground_tpu_torch.workloads import build_flagship

    if any(m == "jax" or m.startswith(("jax.", "mppi_playground_tpu.")) for m in sys.modules):
        return fail("the port imported jax or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)

    # --- phase 2: build --------------------------------------------------
    build_s = cuda_build.build()
    regs = "; ".join(
        f"{name}: " + " | ".join(
            line.split(":", 1)[-1].strip()
            for line in log.splitlines() if "registers" in line or "spill" in line
        )
        for name, log in sorted(cuda_build.build_logs.items())
    )
    print(f"build: {len(cuda_build.SOURCES)} sources in {build_s:.1f} s; ptxas: {regs}",
          flush=True)

    # --- phase 3: kernels against their twins at the flagship's shapes ----
    env = RacingEnv(device=dev)
    task = make_racing_fused_task_from_env(env)
    rng = np.random.default_rng(SEED)
    x0 = env.reset() + torch.tensor([0.0, 0.0, 0.0, 5.0], device=dev)
    xref, _ = calc_ref_trajectory(x0, env.racing_center_path, torch.tensor(0, device=dev), T)
    xref5 = extend_reference_path(xref).contiguous()
    prev = torch.tensor(rng.standard_normal((T, 2)) * (0.5, 0.1), dtype=torch.float32,
                        device=dev)
    noise = torch.tensor(rng.standard_normal((K, T, 2)) * (0.5, 0.1), dtype=torch.float32,
                         device=dev)
    lam = torch.ones(1, device=dev)
    sig, u_min, u_max = (0.5, 0.1), (-2.0, -0.25), (2.0, 0.25)
    seed = tick_seed(42, 0)
    grid_bytes = task.obstacle_grid.numel() + task.lane_grid.numel()

    def solve(fn, mode_noise):
        return fn(x0, prev, lam, seed, xref5, task, sig, u_min, u_max, K, K, mode_noise)

    checks, solved = {}, {}
    for mode, nz in (("noise", noise), ("seeded", None)):
        got = solve(fused_solve.fused_racing_solve, nz)
        want = solve(fused_solve.fused_racing_solve_plain, nz)
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
    got_r = fused_solve.racing_reroll(x0, seq, task.x_lim, task.y_lim)
    want_r = fused_solve.racing_reroll_plain(x0, seq, task.x_lim, task.y_lim)
    torch.cuda.synchronize()
    reroll_err = (got_r - want_r).abs().max().item()
    print(f"re-roll vs twin (T={T}): max_abs_err={reroll_err!r} "
          f"bitwise={bool(torch.equal(got_r, want_r))}", flush=True)
    if not (got_r.shape == (T + 1, 4) and torch.isfinite(got_r).all() and reroll_err <= 5e-3):
        return fail("re-roll off the bar: states atol 5e-3")

    # timings: kernel and twin, turn about, on this card
    t_solve = cuda_ms(torch, lambda: solve(fused_solve.fused_racing_solve, None), 20)
    t_solve_plain = cuda_ms(torch, lambda: solve(fused_solve.fused_racing_solve_plain, None), 3,
                            warmup=1)
    t_solve_noise = cuda_ms(torch, lambda: solve(fused_solve.fused_racing_solve, noise), 20)
    t_reroll = cuda_ms(torch, lambda: fused_solve.racing_reroll(x0, seq, task.x_lim,
                                                                task.y_lim), 50)
    t_reroll_plain = cuda_ms(torch, lambda: fused_solve.racing_reroll_plain(
        x0, seq, task.x_lim, task.y_lim), 5, warmup=1)
    b_solve, by_solve = solve_bound_ms(K, T, True, grid_bytes)
    b_noise, _ = solve_bound_ms(K, T, False, grid_bytes)
    b_reroll, by_reroll = reroll_bound_ms(T)
    print(f"times on {card}: fused solve {t_solve:.4f} ms (noise mode {t_solve_noise:.4f} ms, "
          f"bound {b_noise:.5f} ms), twin {t_solve_plain:.3f} ms; re-roll {t_reroll:.4f} ms, "
          f"twin {t_reroll_plain:.3f} ms", flush=True)

    # --- phase 4: the auto-lambda kernels against their twins -----------------
    auto = check_auto_kernels(torch, fused_solve, x0, prev, noise, xref5, task, seed, sig,
                              u_min, u_max, grid_bytes, card)
    if auto is None:
        return 1

    # --- phase 5: the weighted update (row 9) and regeneration (row 6) ---------
    noise_costs, noise_weights = solved["noise"]
    pert = fused_solve.racing_regen_plain(prev, seed, torch.arange(K, device=dev), sig, u_min,
                                          u_max, K, K, noise)
    dump_costs, dump = fused_solve.fused_racing_costs_dump(x0, prev, seed, xref5, task, sig,
                                                           u_min, u_max, K, K, None)
    row9 = check_weighted_update(torch, fused_solve, pert, noise_costs, dump_costs, dump, card)
    if row9 is None:
        return 1
    row6 = check_regen(torch, fused_solve, x0, prev, noise, xref5, task, seed, sig, u_min, u_max,
                       noise_weights, card)
    if row6 is None:
        return 1
    del pert, dump

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
              for m in AUTO_MODES), flush=True)

    # --- phase 7: the RacingController facade on both routes, counted -------
    facades = drive_facades(torch, env, card)
    if facades is None:
        return 1
    # --- phase 8: the MPPI facade on both routes, counted ---------------------
    mppi_runs = drive_mppi(torch, env, task, card)
    if mppi_runs is None:
        return 1

    paths = {f"flagship {m}": run["launches"] for m, run in modes.items()}
    paths.update({f"RacingController {r}": run["launches"] for r, run in facades.items()})
    paths.update(mppi_runs)

    def launches_of(name):
        by_path = {p: counts[name] for p, counts in paths.items()}
        return sum(by_path.values()), by_path

    kernels = [
        {
            "name": "fused_racing_solve",
            "route": "cuda",
            "source": "mppi_playground_tpu_torch/csrc/fused_solve.cu",
            "replaces": "mppi_playground_tpu/ops/fused_solve.py:783",
            "max_abs_err": max(checks["seeded"]["cost_max_abs_err"],
                               checks["noise"]["cost_max_abs_err"]),
            "ms": t_solve,
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
            "plain_ms": t_reroll_plain,
            "bound_ms": b_reroll,
            "bound_by": by_reroll,
            "library_ms": None,
        },
    ] + auto["kernels"] + [row6, row9]
    for k in kernels:
        k["launches"], k["launches_by_path"] = launches_of(k["name"])
    print(json.dumps({"kernels": kernels, "card": card,
                      "median_tick_ms": modes["fixed"]["median_ms"],
                      "median_tick_ms_in_turns": turns,
                      "facade_median_ms": {r: {"update": run["tick_ms"],
                                               "get_top_samples": run["top_ms"]}
                                           for r, run in facades.items()}}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
