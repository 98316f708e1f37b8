"""Upstream's mountain-car loop through ``MPPI.forward`` with the user's own torch model.

The solver is the port's example's (``examples/mountaincar.make_solver``:
T=100, K=1,000, sigma 1, λ 0.1 fixed, ``mountain_car.dynamics`` and
``mountain_car.cost`` as the user's callables, on the default unfused route
with stored rollouts, and upstream's seed, 42).  Each tick runs upstream's
loop (``example/mountaincar.py``): solve, then step the plant.  The clock
covers what upstream's own clock covers: it runs from handing ``forward``
the plant state, a host tensor, to holding the plan's first action on the
host.  Off the clock, and finished before the next tick's clock starts, the
plant steps on the device (``mountain_car.dynamics``, which repeats
gymnasium's physics, as the example's ``--no-gym`` path steps it) and is
read back.

Episodes start at gymnasium's reset (position uniform in ``start_position``
from the seed, velocity 0) and end at ``goal_position`` or after
``episode_ticks`` ticks (the env's ``max_episode_steps``); then ``reset()``
runs, off the clock.  The set-up builds the solver and the kernels and runs
``warmup_ticks`` ticks over an episode boundary: the first captures the
tick's graph, the rest replay it.  Then the window runs ticks for
``--seconds``.

Checked: the first tick of the run and every ``check_every``-th tick of the
window from an offset drawn from the seed.  Around a checked tick the
solver's state is copied before and after, off the clock.  Once the window
has closed the reference (``portbench/reference/mountaincar.py``) works each
checked tick out again from its inputs (the plant state, the warm start and
the tick's count) and the gaps are taken.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import harness, tracing
from portbench.reference.mountaincar import MountainCar
from portbench.reference.racing import key_words, tick_seed


def _solver(job, device):
    from mppi_playground_tpu_torch.examples.mountaincar import make_solver

    solver = make_solver(device)
    c, s = solver.config, job.solver
    built = dict(seed=c.seed, horizon=c.horizon, num_samples=c.num_samples,
                 sigmas=list(c.sigmas), lambda_=c.lambda_, u_min=list(c.u_min),
                 u_max=list(c.u_max), store_rollouts=c.store_rollouts,
                 dtype=str(c.dtype).split(".")[-1])
    differ = {k: (v, s[k]) for k, v in built.items() if v != s[k]}
    if differ or solver.solver_backend != "xla":
        raise SystemExit(f"portbench: the example's solver is not the configuration's: "
                         f"{differ}, route {solver.solver_backend}")
    return solver


class Loop:
    """The closed loop's host side: the plant state, the tick count, the checked ticks."""

    def __init__(self, job, solver, device):
        import torch

        from mppi_playground_tpu_torch.models import mountain_car

        self.torch, self.job, self.solver, self.device = torch, job, solver, device
        self.plant = mountain_car.dynamics
        self.goal = float(job.param("goal_position"))
        self.episode_ticks = int(job.param("episode_ticks"))
        self.check_every = int(job.param("check_every"))
        rng = np.random.default_rng([job.seed, 1])
        self.check_phase = int(rng.integers(0, self.check_every))
        low, high = (float(v) for v in job.param("start_position"))
        self.starts = rng.uniform(low, high, size=4096).astype(np.float32)
        self.tick = 0  # ticks run, the solver's tick count
        self.episode = -1
        self.checked = []
        self.lat, self.enqueue = [], []
        self.failed = 0
        self._start_episode()

    def _start_episode(self):
        torch = self.torch
        self.episode += 1
        if self.episode:
            self.solver.reset()
        start = float(self.starts[self.episode % len(self.starts)])
        self.x_dev = torch.tensor([start, 0.0], dtype=torch.float32, device=self.device)
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
        # off the clock: the plant's step, read back before the next tick starts
        self.x_dev = self.plant(self.x_dev[None], plan[:1])[0]
        self.x_host = self.x_dev.cpu()
        if float(self.x_host[0]) >= self.goal:
            self.in_episode = self.episode_ticks  # at the goal: the next tick starts anew
        if check:
            self.checked.append(dict(before=before, after=self._snapshot(), plan=plan.clone(),
                                     states=states.clone(), x_next=self.x_host.clone()))

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
    solver = _solver(job, device)
    loop = Loop(job, solver, device)
    phases.mark("solver")
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
    del loop, solver
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
    return tracing.Reading(sl, job.solver, {}, job.cell.traffic, harness.card())


def reference(job, dtype, device) -> MountainCar:
    """The reference of ``job``'s cell in ``dtype`` on ``device``."""
    return MountainCar(job.solver, dtype, device)


def compare(job, checked, device) -> dict:
    """The gaps between the checked ticks and the reference's ticks from the same inputs."""
    import torch

    return gaps(job, reference(job, torch.float32, device), checked)


def gaps(job, ref, checked, chunk: int = 4) -> dict:
    """Gaps of the checked ticks against ``ref`` (a :class:`MountainCar`, float32 or lower)."""
    import torch

    seed = int(job.solver["seed"])
    span = torch.tensor(ref.u_max) - torch.tensor(ref.u_min)
    plan_gap = rollout_gap = plant_gap = 0.0
    keys_off = 0
    for i in range(0, len(checked), chunk):
        part = checked[i:i + chunk]
        ticks = [c["before"]["tick"] for c in part]
        out = ref.tick(torch.stack([c["before"]["x"] for c in part]),
                       torch.stack([c["before"]["warm"].cpu() for c in part]),
                       [tick_seed(seed, t) for t in ticks])
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
            stepped = ref.plant(c["before"]["x"][None].to(ref.device, ref.dtype),
                                c["plan"][:1].to(ref.device, ref.dtype)).float().cpu()[0]
            plant_gap = max(plant_gap, float((c["x_next"] - stepped).abs().max()))
    return {"plan_gap": plan_gap, "rollout_gap": rollout_gap, "plant_gap": plant_gap,
            "key_mismatches": float(keys_off),
            "missing_checks": float(max(0, harness.MIN_CHECKED - len(checked)))}


def substitute(job, low, checked, chunk: int = 4) -> list:
    """The checked ticks as ``low`` (a lower-precision :class:`MountainCar`) would have
    answered them from the same inputs: the control put in the program's place."""
    import torch

    seed, out = int(job.solver["seed"]), []
    for i in range(0, len(checked), chunk):
        part = checked[i:i + chunk]
        ticks = [c["before"]["tick"] for c in part]
        got = low.tick(torch.stack([c["before"]["x"] for c in part]),
                       torch.stack([c["before"]["warm"].cpu() for c in part]),
                       [tick_seed(seed, t) for t in ticks])
        for j, c in enumerate(part):
            plan = got["plan"][j].float()
            x_next = low.plant(c["before"]["x"][None].to(low.device, low.dtype),
                               got["plan"][j:j + 1, 0]).float().cpu()[0]
            after = dict(warm=plan, lam=torch.tensor(low.lambda_),
                         key=torch.tensor(key_words(seed, ticks[j] + 1), dtype=torch.int32))
            out.append(dict(before=c["before"], after=after, plan=plan,
                            states=got["states"][j].float(), x_next=x_next))
    return out
