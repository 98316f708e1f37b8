#!/usr/bin/env python3
"""Drive the port's flagship racing tick on one NVIDIA GPU and check its CUDA kernels.

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
4. drive the flagship, ``build_flagship(device="cuda")``, for 50 closed-loop
   ticks of ``RacingEnv.step`` with every launch counter set to 0 just
   before; check the actions and that both kernels ran on that path.

It prints a ``kernels`` JSON line before the last, and as its last line
``{"ok": true, "device": {...}}``.  Without a card, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

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


def profile_ticks(torch, tick, env, state, cind, x, ticks: int) -> str:
    """Where a tick's time goes: device busy share and kernels by device time.

    ``torch.profiler`` over ``ticks`` closed-loop ticks; the device time is the
    sum of the kernels' durations on the one stream.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            action_seq, _, state, cind = tick(state, cind, x)
            x, _ = env.step(action_seq[0])
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
        f"profile ({ticks} ticks with env.step): wall {wall_us / ticks:.1f} us/tick, device "
        f"busy {busy_us / ticks:.1f} us/tick ({100 * busy_us / wall_us:.1f}%), "
        f"{len(activities) / ticks:.1f} device activities/tick; by self device time: "
        + "; ".join(f"{e.key[:48]} {e.self_device_time_total / ticks:.1f} us x{e.count / ticks:g}"
                    for e in ops)
    )


def main() -> int:
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

    checks = {}
    for mode, nz in (("noise", noise), ("seeded", None)):
        got = solve(fused_solve.fused_racing_solve, nz)
        want = solve(fused_solve.fused_racing_solve_plain, nz)
        torch.cuda.synchronize()
        gc, wc = got[0], want[0]
        if not torch.isfinite(gc).all():
            return fail(f"fused solve ({mode}): non-finite costs")
        g_upd, g_w, g_ess = fused_solve.combine_partials(*got, lam, T, 2)
        w_upd, w_w, w_ess = fused_solve.combine_partials(*want, lam, T, 2)
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

    # --- phase 4: the main path, counted -----------------------------------
    env, solver, tick = build_flagship(horizon=T, num_samples=K, env=env, device="cuda")
    fused_solve.fused_racing_solve.launches = 0
    fused_solve.racing_reroll.launches = 0
    state = solver.init()
    x = env.reset()
    cind = torch.tensor(0, device=dev)
    tick_ms = []
    for _ in range(TICKS):
        t0 = time.perf_counter()
        action_seq, state_seq, state, cind = tick(state, cind, x)
        torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t0))
        a = action_seq[0]
        if not (torch.isfinite(action_seq).all() and torch.isfinite(state_seq).all()):
            return fail("a tick returned non-finite actions or states")
        # a weighted mean of clamped samples, rounded in float32: a few ulp over
        excess = torch.maximum(env.u_min - action_seq, action_seq - env.u_max).max().item()
        if excess > 1e-5:
            return fail(f"a tick returned actions outside [u_min, u_max] by {excess!r}")
        x, _ = env.step(a)
    launches = {
        "fused_racing_solve": fused_solve.fused_racing_solve.launches,
        "racing_reroll": fused_solve.racing_reroll.launches,
    }
    progress = int(cind)
    if launches["fused_racing_solve"] != TICKS or launches["racing_reroll"] != TICKS:
        return fail(f"the main path did not launch each kernel once a tick: {launches}")
    if progress <= 0 or not torch.isfinite(x).all():
        return fail(f"the car made no progress along the track (index {progress})")
    median_tick = statistics.median(tick_ms)
    print(f"flagship: {TICKS} ticks at T={T}, K={K} on {card}: median tick "
          f"{median_tick:.3f} ms (host clock, synchronized), min {min(tick_ms):.3f} ms; "
          f"fused solve {t_solve:.4f} ms, re-roll {t_reroll:.4f} ms (CUDA events); "
          f"track index {progress}; launches {launches}", flush=True)
    print(profile_ticks(torch, tick, env, state, cind, x, 10), flush=True)

    kernels = [
        {
            "name": "fused_racing_solve",
            "route": "cuda",
            "source": "mppi_playground_tpu_torch/csrc/fused_solve.cu",
            "replaces": "mppi_playground_tpu/ops/fused_solve.py:373",
            "launches": launches["fused_racing_solve"],
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
            "replaces": "mppi_playground_tpu/ops/fused_solve.py:249",
            "launches": launches["racing_reroll"],
            "max_abs_err": reroll_err,
            "ms": t_reroll,
            "plain_ms": t_reroll_plain,
            "bound_ms": b_reroll,
            "bound_by": by_reroll,
            "library_ms": None,
        },
    ]
    print(json.dumps({"kernels": kernels, "card": card, "median_tick_ms": median_tick}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
