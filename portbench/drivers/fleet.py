"""A simulation farm: B racing episodes as one fleet, replayed back to back.

``make_fleet_closed_loop`` over ``make_batched_fused_solver`` on one card:
each run is one episode of ``episode_ticks`` ticks for all ``batch``
scenarios, one CUDA graph of the fleet's tick replayed.  Episode e starts
the scenarios at rest on the path points ``o_e + b * (N // B)`` (staggered
along the circuit, ``o_e`` drawn from the seed), their path indices there,
and the solver states the previous episode ended with.  The set-up builds
the scene, the fleet and the kernels and runs ``warmup_episodes`` episodes
(the first captures).  The window runs whole episodes for ``--seconds``;
``solves_per_s`` is B x ticks x episodes over the time from the window's
start to the synchronize after its last episode.

Checked: the first episode (the start, from the initial states) and every
``check_every``-th episode of the window from an offset drawn from the
seed, all B scenarios each (see :func:`gaps`).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import harness, tracing
from portbench.reference import maps
from portbench.reference.racing import Racing, key_words, scenario_seed, tick_seed


class Farm:
    """The fleet, its episode starts, and the episodes kept for the reference."""

    def __init__(self, job, device):
        import torch
        from mppi_playground_tpu_torch.core.closed_loop import make_fleet_closed_loop
        from mppi_playground_tpu_torch.core.config import MPPIConfig
        from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
        from mppi_playground_tpu_torch.models.racing_mpcc import (
            calc_ref_trajectory_batch,
            make_racing_fused_task_from_env,
        )
        from mppi_playground_tpu_torch.parallel import make_batched_fused_solver

        s, scene = job.solver, job.cell.config["scene"]
        self.torch, self.job, self.device = torch, job, device
        env = RacingEnv(seed=job.seed % 2**32, circuit_seed=int(scene["circuit_seed"]),
                        device=device)
        horizon, ref = int(s["horizon"]), s["reference"]
        config = MPPIConfig(
            horizon=horizon, num_samples=int(s["num_samples"]), dim_state=4, dim_control=2,
            u_min=tuple(s["u_min"]), u_max=tuple(s["u_max"]), sigmas=tuple(s["sigmas"]),
            lambda_=s["lambda_"], dtype=getattr(torch, s["dtype"]),
            seed=harness.solver_seed(job.seed), store_rollouts=bool(s["store_rollouts"]),
        )
        self.batch = int(job.param("batch"))
        self.ticks = int(job.param("episode_ticks"))
        batched = make_batched_fused_solver(config, make_racing_fused_task_from_env(env),
                                            env.dynamics, device, self.batch)
        path = env.racing_center_path

        def info_fn(cinds, xs):
            xrefs, new = calc_ref_trajectory_batch(
                xs, path, cinds, horizon, lookahead_distance=float(ref["lookahead_distance"]),
                reference_path_interval=float(ref["reference_path_interval"]))
            return {"reference_path": xrefs}, new

        self.run_episode = make_fleet_closed_loop(batched, env.dynamics, self.ticks,
                                                  info_fn=info_fn)
        self.states = batched.init_batch(seed=harness.solver_seed(job.seed))
        stride = len(path) // self.batch
        rng = np.random.default_rng([job.seed, 2])
        offsets = rng.integers(0, stride, size=(4096, 1))
        self.starts = torch.as_tensor(offsets + stride * np.arange(self.batch), device=device)
        self.path = path
        self.check_every = int(job.param("check_every"))
        self.check_phase = int(rng.integers(0, self.check_every))
        self.episode = 0
        self.kept = []
        self.nonfinite = torch.zeros((), dtype=torch.int64, device=device)

    def step(self, check: bool) -> None:
        """One episode of the fleet; ``check`` keeps its inputs and outputs."""
        torch = self.torch
        idx = self.starts[self.episode % self.starts.shape[0]]
        pose = self.path[idx]
        x0s = torch.cat([pose, torch.zeros_like(pose[:, :1])], dim=1)
        states = self.states
        out = self.run_episode(states, x0s, idx)
        self.nonfinite += (~torch.isfinite(out[3])).any(dim=-1).sum()
        if check:
            self.kept.append(dict(episode=self.episode, states=states, x0s=x0s, cinds=idx,
                                  out=out))
        self.states = out[0]
        self.episode += 1

    def due(self) -> bool:
        return (self.episode + self.check_phase) % self.check_every == 0


def run(job) -> harness.Outcome:
    import torch

    device = job.device
    phases = harness.Phases(job.started)
    if device == "cuda":
        from mppi_playground_tpu_torch.ops import cuda_build

        cuda_build.build()
    phases.mark("build")
    farm = Farm(job, device)
    phases.mark("scene and fleet")
    farm.step(check=True)  # the start: the first episode, from the initial states
    phases.mark("first episode and capture")
    for _ in range(int(job.param("warmup_episodes")) - 1):
        farm.step(check=False)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = phases.mark("warm-up episodes")
    harness.settle()
    farm.nonfinite.zero_()

    reading, traced_s, traced_episodes = None, 0.0, 0
    w0 = time.perf_counter()
    first = farm.episode
    trace_at = w0 + 0.25 * job.seconds
    while time.perf_counter() - w0 - traced_s < job.seconds:
        if job.trace and reading is None and time.perf_counter() >= trace_at and device == "cuda":
            t0 = time.perf_counter()
            reading = _traced(job, farm, torch)
            traced_s, traced_episodes = time.perf_counter() - t0, reading.slice.ticks // farm.ticks
            continue
        farm.step(check=farm.due())
    if device == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - w0 - traced_s
    episodes = farm.episode - first - traced_episodes
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    solves = farm.batch * farm.ticks * episodes
    e2e = {"solves_per_s": solves / elapsed, "setup_s": setup_s}
    kept, failed = farm.kept, int(farm.nonfinite)
    del farm
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gaps = compare(job, kept, device)
    print(f"portbench: {len(kept)} episodes checked in {time.perf_counter() - t0:.2f} s",
          file=sys.stderr, flush=True)
    return harness.Outcome(e2e, solves, failed, gaps, memory_peak, reading,
                           extra={"records": kept} if job.overrides.get("keep") else {})


def _traced(job, farm, torch):
    episodes = int(job.param("trace_episodes"))

    def body():
        for _ in range(episodes):
            farm.step(check=False)
        return episodes * farm.ticks, {}

    sl = tracing.profile_slice(torch, body)
    return tracing.Reading(sl, job.solver, job.cell.config["scene"], job.cell.traffic,
                           harness.card())


def compare(job, kept, device) -> dict:
    import torch

    scene = maps.scene(job.cell.config, job.seed % 2**32)
    return gaps(job, Racing(scene, job.solver, torch.float32, device), kept)


def gaps(job, ref, kept) -> dict:
    """Gaps of the kept episodes against ``ref`` (a :class:`Racing`, float32 or lower).

    An episode's first tick starts from the fleet's own state (the warm
    starts and keys the previous episode left) and is worked out again for
    every scenario (``first_tick_gap``, its first action).  Later ticks start
    from warm starts the fleet keeps on the device, and a reference chaining
    its own parts from them within the episode (a closed loop of MPPI
    amplifies a last-bit difference), so they are checked where they do not
    depend on it: the plant's step from every recorded state and action, the
    path index chained over the recorded states, and each scenario's key
    after the episode.
    """
    import torch

    seed = harness.solver_seed(job.seed)
    span = torch.tensor(ref.u_max) - torch.tensor(ref.u_min)
    first_gap = plant_gap = 0.0
    keys_off = index_off = 0
    for k in kept:
        st0, x0s, cinds = k["states"], k["x0s"], k["cinds"]
        st, xf, xs, us, cf = k["out"][:5]
        batch, ticks = x0s.shape[0], xs.shape[0]
        seeds = [scenario_seed(seed, b) for b in range(batch)]
        first_tick = k["episode"] * ticks
        for when, keys in ((first_tick, st0.key), (first_tick + ticks, st.key)):
            want = torch.tensor([key_words(s, when) for s in seeds], dtype=torch.int32)
            keys_off += int((keys.cpu() != want).any(dim=1).sum())
        out = ref.tick(xs[0], st0.previous_action_seq, cinds,
                       [tick_seed(s, first_tick) for s in seeds])
        first = ((us[0].cpu() - out["plan"][:, 0].float().cpu()).abs() / span).max()
        first_gap = max(first_gap, float(first))
        cind = cinds.to(ref.device)
        for t in range(ticks):
            cind = ref.reference_rows(xs[t].to(ref.device, ref.dtype), cind)[1]
            nxt = xs[t + 1] if t + 1 < ticks else xf
            stepped = ref.plant(xs[t].to(ref.device, ref.dtype), us[t].to(ref.device, ref.dtype))
            plant_gap = max(plant_gap, float((nxt.cpu() - stepped.float().cpu()).abs().max()))
        index_off += int((cf.cpu() != cind.cpu()).sum())
    return {"first_tick_gap": first_gap, "plant_gap": plant_gap,
            "key_mismatches": float(keys_off), "index_mismatches": float(index_off),
            "missing_checks": float(max(0, harness.MIN_CHECKED - len(kept)))}


def substitute(job, low, kept) -> list:
    """The kept episodes as ``low`` (a lower-precision :class:`Racing`) would have run them
    from the same starts and states, its own plant included: the control in the fleet's
    place."""
    import dataclasses

    import torch

    seed, out = harness.solver_seed(job.seed), []
    for k in kept:
        st0, x0s, cinds = k["states"], k["x0s"], k["cinds"]
        ticks = k["out"][2].shape[0]
        seeds = [scenario_seed(seed, b) for b in range(x0s.shape[0])]
        first_tick = k["episode"] * ticks
        x, warm, cind, xs, us = x0s.to(low.device, low.dtype), st0.previous_action_seq, cinds, [], []
        for t in range(ticks):
            got = low.tick(x, warm, cind, [tick_seed(s, first_tick + t) for s in seeds])
            xs.append(x.float())
            us.append(got["plan"][:, 0].float())
            x = low.plant(x, got["plan"][:, 0])
            warm, cind = got["plan"], got["cind"]
        keys = torch.tensor([key_words(s, first_tick + ticks) for s in seeds], dtype=torch.int32)
        st = dataclasses.replace(k["out"][0], previous_action_seq=warm.float(), key=keys)
        out.append(dict(k, out=(st, x.float(), torch.stack(xs), torch.stack(us), cind)))
    return out
