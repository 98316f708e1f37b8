"""Upstream's Navigation2D loop through ``MPPI.forward``, synced to the host every tick.

The solver is the port's example's (``examples/navigation2d.make_solver(env,
fused=True)``: T=30, K=3,000, ESSPS, the fused route, which searches λ in
phase 1's launch at this K, and upstream's seed, 42) over ``Navigation2DEnv``.
Each tick runs upstream's loop (``example/navigation2d.py``): solve,
step, collision check, the top samples.  The clock covers what upstream's
own clock covers: it runs from handing ``forward`` the plant state, a host
tensor, to holding the plan's first action on the host.  The rest of the
tick runs off the clock and has finished before the next tick's clock
starts: the plant's step on the device (``env.dynamics``) read back, the
collision check of the predicted states read back, and
``get_top_samples(top_samples)`` with both its outputs read to the host, as
a renderer reads them.

Episodes start at the configuration's start moved by up to ``start_jitter``
m (uniform in the disk, drawn from the seed) to a free cell, heading toward
the goal, and end at the goal (within ``goal_threshold`` m) or after
``episode_ticks`` ticks; then ``reset()`` runs, off the clock.  The set-up
builds the scene, the solver and the kernels and runs ``warmup_ticks`` ticks
over an episode boundary: the first captures the tick's graph, the rest
replay it.  Then the window runs ticks for ``--seconds``.

Checked: the first tick of the run and every ``check_every``-th tick of the
window from an offset drawn from the seed.  Around a checked tick the
solver's state is copied before and after, off the clock.  Once the window
has closed the reference (``portbench/reference/navigation.py``) works each
checked tick out again from its inputs (the plant state, the warm start and
the tick's count; ESSPS carries no state from tick to tick) and the gaps are
taken.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

from portbench import harness, tracing
from portbench.reference.navigation import Navigation, scene
from portbench.reference.racing import key_words, tick_seed

# where the reference's weights of a program's top row and of the reference's row at the
# same place differ by less than this share, the two rows are taken as tied
TIE = 1e-3


def _solver(job, device):
    from mppi_playground_tpu_torch.envs import Navigation2DEnv
    from mppi_playground_tpu_torch.examples.navigation2d import make_solver

    env = Navigation2DEnv(seed=int(job.cell.config["scene"]["obstacle_seed"]), device=device)
    solver = make_solver(env, fused=True)
    c, s = solver.config, job.solver
    built = dict(seed=c.seed, horizon=c.horizon, num_samples=c.num_samples,
                 sigmas=list(c.sigmas), lambda_=c.lambda_, lambda_min=c.lambda_min, lambda_max=c.lambda_max,
                 essps_iters=c.essps_iters, essps_target_ess=c.essps_target_ess,
                 u_min=list(c.u_min), u_max=list(c.u_max), store_rollouts=c.store_rollouts,
                 dtype=str(c.dtype).split(".")[-1])
    differ = {k: (v, s[k]) for k, v in built.items() if v != s[k]}
    if differ or solver.solver_backend != "fused":
        raise SystemExit(f"portbench: the example's solver is not the configuration's: "
                         f"{differ}, route {solver.solver_backend}")
    return env, solver


class Loop:
    """The closed loop's host side: the plant state, the tick count, the checked ticks."""

    def __init__(self, job, env, solver, device):
        import torch

        self.torch, self.job, self.env, self.solver, self.device = torch, job, env, solver, device
        sc = job.cell.config["scene"]
        self.goal = np.asarray(sc["goal"], dtype=np.float64)
        self.goal_threshold = float(job.param("goal_threshold"))
        self.episode_ticks = int(job.param("episode_ticks"))
        self.top = int(job.param("top_samples"))
        self.check_every = int(job.param("check_every"))
        rng = np.random.default_rng([job.seed, 1])
        self.check_phase = int(rng.integers(0, self.check_every))
        self.starts = self._starts(rng, np.asarray(sc["start"], dtype=np.float64),
                                   float(job.param("start_jitter")))
        self.tick = 0  # ticks run, the solver's tick count
        self.episode = -1
        self.checked = []
        self.lat, self.enqueue = [], []
        self.failed = 0
        self._start_episode()

    def _starts(self, rng, start, jitter, count=4096):
        """``count`` plant states at ``start`` moved by up to ``jitter`` m to a free cell,
        heading toward the goal."""
        grid, origin = self.env.obstacle_map.grid, self.env.obstacle_map.origin
        cell = self.env.obstacle_map.cell_size
        out = []
        while len(out) < count:
            r, a = jitter * math.sqrt(rng.random()), 2.0 * math.pi * rng.random()
            p = start + r * np.array([math.cos(a), math.sin(a)])
            ix, iy = (int(v) for v in np.round(p / cell + origin))
            if not (0 <= ix < grid.shape[0] and 0 <= iy < grid.shape[1]) or grid[ix, iy]:
                continue
            heading = math.atan2(self.goal[1] - p[1], self.goal[0] - p[0])
            out.append((p[0], p[1], heading))
        return np.asarray(out, dtype=np.float32)

    def _start_episode(self):
        torch = self.torch
        self.episode += 1
        if self.episode:
            self.solver.reset()
        self.x_dev = torch.as_tensor(self.starts[self.episode % len(self.starts)],
                                     device=self.device)
        self.x_host = self.x_dev.cpu()
        self.in_episode = 0

    def _snapshot(self):
        st = self.solver.solver_state
        return dict(warm=st.previous_action_seq.clone(), key=st.key.clone(), lam=st.lam.clone())

    def step(self, check: bool, spans: bool = False):
        """One tick; ``check`` keeps its inputs and outputs for the reference; ``spans``
        records the facade's enqueue time."""
        torch = self.torch
        if self.in_episode == self.episode_ticks:
            self._start_episode()
        before = None
        if check:
            before = self._snapshot()
            before.update(x=self.x_host.clone(), tick=self.tick)
            if self.device != "cpu":
                torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            plan, states = self.solver.forward(self.x_host)
            t_enq = time.perf_counter()
            u = plan[0].cpu()
            t1 = time.perf_counter()
            ok = bool(torch.isfinite(u).all())
        except (RuntimeError, ValueError) as err:
            print(f"portbench: tick {self.tick} raised {err!r}", file=sys.stderr, flush=True)
            self.failed += 1
            self.tick += 1
            self._start_episode()
            return
        self.lat.append(t1 - t0)
        if spans:
            self.enqueue.append(t_enq - t0)
        self.tick += 1
        self.in_episode += 1
        if not ok:
            self.failed += 1
        # off the clock: the rest of upstream's tick, finished before the next one starts
        self.x_dev = self.env.dynamics(self.x_dev[None], plan[:1])[0]
        self.x_host = self.x_dev.cpu()
        self.env.collision_check(states[None]).cpu()
        top_states, top_weights = self.solver.get_top_samples(self.top)
        top_states, top_weights = top_states.cpu(), top_weights.cpu()
        if math.hypot(*(self.x_host[:2].double().numpy() - self.goal)) < self.goal_threshold:
            self.in_episode = self.episode_ticks  # at the goal: the next tick starts anew
        if check:
            self.checked.append(dict(before=before, after=self._snapshot(), plan=plan.clone(),
                                     states=states.clone(), x_next=self.x_host.clone(),
                                     top_states=top_states, top_weights=top_weights))

    def due(self) -> bool:
        return (self.tick + self.check_phase) % self.check_every == 0


def run(job) -> harness.Outcome:
    import torch

    device = job.device
    phases = harness.Phases(job.started)
    if device == "cuda":
        from mppi_playground_tpu_torch.ops import cuda_build

        cuda_build.build()
    phases.mark("build")
    env, solver = _solver(job, device)
    loop = Loop(job, env, solver, device)
    phases.mark("scene and solver")
    loop.step(check=True)  # the start: the first tick, from the initial state
    phases.mark("first tick and capture")
    for _ in range(int(job.param("warmup_ticks")) - 1):
        if loop.in_episode == 3:  # an episode boundary inside the warm-up
            loop.in_episode = loop.episode_ticks
        loop.step(check=False)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = phases.mark("warm-up ticks")
    harness.settle()
    loop.lat, loop.failed = [], 0
    attempted_before = loop.tick

    reading, traced_s = None, 0.0
    w0 = time.perf_counter()
    trace_at = w0 + 0.25 * job.seconds
    while time.perf_counter() - w0 - traced_s < job.seconds:
        if job.trace and reading is None and time.perf_counter() >= trace_at and device == "cuda":
            t0 = time.perf_counter()
            reading = _traced(job, loop, torch)
            traced_s = time.perf_counter() - t0
            loop.enqueue = []
            continue
        loop.step(check=loop.due(), spans=job.trace)
    attempted = loop.tick - attempted_before
    if reading is not None:  # host spans of the window's untraced ticks
        reading.slice.spans["facade_enqueue_us"] = [1e6 * t for t in loop.enqueue]
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    lat_ms = np.asarray(loop.lat) * 1e3
    e2e = {"tick_p50_ms": float(np.percentile(lat_ms, 50)) if len(lat_ms) else float("nan"),
           "tick_p95_ms": float(np.percentile(lat_ms, 95)) if len(lat_ms) else float("nan"),
           "setup_s": setup_s}
    checked, failed, episodes = loop.checked, loop.failed, loop.episode
    del loop, solver, env
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gaps = compare(job, checked, device)
    print(f"portbench: {len(checked)} ticks checked in {time.perf_counter() - t0:.2f} s; "
          f"{episodes} episodes begun after the first", file=sys.stderr, flush=True)
    return harness.Outcome(e2e, attempted, failed, gaps, memory_peak, reading,
                           extra={"records": checked} if job.overrides.get("keep") else {})


def _traced(job, loop, torch):
    ticks = int(job.param("trace_ticks"))

    def body():
        for _ in range(ticks):
            loop.step(check=False)
        return ticks, {}

    sl = tracing.profile_slice(torch, body)
    return tracing.Reading(sl, job.solver, job.cell.config["scene"], job.cell.traffic,
                           harness.card())


def reference(job, dtype, device) -> Navigation:
    """The reference of ``job``'s cell in ``dtype`` on ``device``."""
    return Navigation(scene(job.cell.config), job.solver, dtype, device)


def compare(job, checked, device) -> dict:
    """The gaps between the checked ticks and the reference's ticks from the same inputs."""
    import torch

    return gaps(job, reference(job, torch.float32, device), checked)


def _top_gaps(got_states, got_weights, want) -> tuple:
    """``(gap, index mismatches)`` of a tick's top rows against the reference's tick.

    Each of the program's rows is taken as the sample whose reference rollout lies nearest
    it (max norm); the gap is the larger of that distance over the rows and of the sorted
    weights' difference over the reference's top weight.  An index mismatch is a place in
    the prefix of non-zero reference weights where the program's sample is another than the
    reference's, and the reference weighs the two apart by more than ``TIE`` (two samples
    weighed alike may come in either order; samples that hit an obstacle weigh 0 and tie).
    """
    import torch

    rollouts, weights = want["rollouts"], want["weights"]
    rows, top_w = want["top_rows"], want["top_weights"]
    got = got_states.to(rollouts.device, torch.float32).flatten(1)
    distance = torch.cdist(got, rollouts.float().flatten(1), p=float("inf"))
    nearest, found = distance.min(dim=1)
    got_w = got_weights.to(top_w.device, torch.float32)
    w_gap = float((got_w - top_w.float()).abs().max() / top_w[0].float())
    prefix = top_w > 0
    apart = (weights[found].float() - top_w.float()).abs() > TIE * top_w.float()
    mismatches = int((prefix & (found != rows) & apart).sum())
    return max(float(nearest.max()), w_gap), mismatches


def gaps(job, ref, checked, chunk: int = 4) -> dict:
    """Gaps of the checked ticks against ``ref`` (a :class:`Navigation`, float32 or lower)."""
    import torch

    seed = int(job.solver["seed"])
    span = torch.tensor(ref.u_max) - torch.tensor(ref.u_min)
    top = int(job.param("top_samples"))
    plan_gap = rollout_gap = lambda_gap = plant_gap = top_gap = 0.0
    keys_off = top_off = 0
    for i in range(0, len(checked), chunk):
        part = checked[i:i + chunk]
        ticks = [c["before"]["tick"] for c in part]
        out = ref.tick(torch.stack([c["before"]["x"] for c in part]),
                       torch.stack([c["before"]["warm"].cpu() for c in part]),
                       [tick_seed(seed, t) for t in ticks], top)
        plan, states = out["plan"].float().cpu(), out["states"].float().cpu()
        for j, c in enumerate(part):
            t = ticks[j]
            want_before = torch.tensor(key_words(seed, t), dtype=torch.int32)
            want_after = torch.tensor(key_words(seed, t + 1), dtype=torch.int32)
            keys_off += int(not torch.equal(c["before"]["key"].cpu(), want_before))
            keys_off += int(not torch.equal(c["after"]["key"].cpu(), want_after))
            for got in (c["plan"].cpu(), c["after"]["warm"].cpu()):
                plan_gap = max(plan_gap, float(((got - plan[j]).abs() / span).max()))
            rollout_gap = max(rollout_gap, float((c["states"].cpu() - states[j]).abs().max()))
            lam_ref = float(out["lam"][j])
            lambda_gap = max(lambda_gap, abs(float(c["after"]["lam"]) - lam_ref) / lam_ref)
            gap, off = _top_gaps(c["top_states"], c["top_weights"],
                                 {k: out[k][j] for k in ("rollouts", "weights", "top_rows",
                                                         "top_weights")})
            top_gap, top_off = max(top_gap, gap), top_off + off
            stepped = ref.plant(c["before"]["x"][None].to(ref.device, ref.dtype),
                                c["plan"][:1].to(ref.device, ref.dtype)).float().cpu()[0]
            plant_gap = max(plant_gap, float((c["x_next"] - stepped).abs().max()))
    return {"plan_gap": plan_gap, "rollout_gap": rollout_gap, "lambda_gap": lambda_gap,
            "top_gap": top_gap, "top_index_mismatches": float(top_off),
            "plant_gap": plant_gap, "key_mismatches": float(keys_off),
            "missing_checks": float(max(0, harness.MIN_CHECKED - len(checked)))}


def substitute(job, low, checked, chunk: int = 4) -> list:
    """The checked ticks as ``low`` (a lower-precision :class:`Navigation`) would have
    answered them from the same inputs: the control put in the program's place."""
    import torch

    seed, out = int(job.solver["seed"]), []
    top = int(job.param("top_samples"))
    for i in range(0, len(checked), chunk):
        part = checked[i:i + chunk]
        ticks = [c["before"]["tick"] for c in part]
        got = low.tick(torch.stack([c["before"]["x"] for c in part]),
                       torch.stack([c["before"]["warm"].cpu() for c in part]),
                       [tick_seed(seed, t) for t in ticks], top)
        for j, c in enumerate(part):
            plan = got["plan"][j].float()
            x_next = low.plant(c["before"]["x"][None].to(low.device, low.dtype),
                               got["plan"][j:j + 1, 0]).float().cpu()[0]
            after = dict(warm=plan, lam=got["lam"][j].float(),
                         key=torch.tensor(key_words(seed, ticks[j] + 1), dtype=torch.int32))
            out.append(dict(before=c["before"], after=after, plan=plan,
                            states=got["states"][j].float(), x_next=x_next,
                            top_states=got["rollouts"][j][got["top_rows"][j]].float(),
                            top_weights=got["top_weights"][j].float()))
    return out
