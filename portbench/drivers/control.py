"""A real-time control loop through ``RacingController.update``, synced to the host every tick.

Each tick hands the plant state, a host tensor, to ``update``, reads the
plan's first action back to the host (the tick's latency runs from the call
to that read), steps the plant (``RacingEnv.dynamics`` on the device) and
reads the new plant state back.  Episodes of ``episode_ticks`` ticks start
at rest on path points drawn from the seed; at an episode's start the
controller's path index is set to the start's.  The set-up builds the
scene, the controller and the kernels, and runs ``warmup_ticks`` ticks over
an episode boundary: the first captures the tick's graph, the rest replay
it.  Then the window runs ticks for ``--seconds``.

Checked: the first tick of the run (the start, from the solver's initial
state), and every ``check_every``-th tick of the window from an offset drawn
from the seed.  Around a checked tick the controller's state is copied
before and after, outside the tick's latency.  Once the window has closed
the reference works each checked tick out again from its inputs (the plant
state, the warm start and path index it was handed, and the tick's count)
and the gaps are taken.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import harness, tracing
from portbench.reference import maps
from portbench.reference.racing import Racing, key_words, start_states, tick_seed


def _controller(job, device):
    import torch
    from mppi_playground_tpu_torch.envs.racing_controller import RacingController
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv

    s, scene = job.solver, job.cell.config["scene"]
    env = RacingEnv(seed=job.seed % 2**32, circuit_seed=int(scene["circuit_seed"]), device=device)
    ref = s["reference"]
    ctrl = RacingController(
        env, horizon=int(s["horizon"]), num_samples=int(s["num_samples"]),
        sigmas=tuple(s["sigmas"]), lambda_=s["lambda_"],
        lookahead_distance=float(ref["lookahead_distance"]),
        reference_path_interval=float(ref["reference_path_interval"]),
        dtype=getattr(torch, s["dtype"]), seed=harness.solver_seed(job.seed),
        store_rollouts=bool(s["store_rollouts"]),
    )
    return env, ctrl


class Loop:
    """The closed loop's host side: the plant state, the tick count, the checked ticks."""

    def __init__(self, job, env, ctrl, device):
        import torch

        self.torch, self.job, self.env, self.ctrl, self.device = torch, job, env, ctrl, device
        path = env.racing_center_path.cpu().numpy()
        rng = np.random.default_rng([job.seed, 1])
        span = max(1, int(len(path) * float(job.param("start_span"))))
        self.starts = rng.integers(0, span, size=4096)
        self.start_xs = start_states(path, self.starts)
        self.episode_ticks = int(job.param("episode_ticks"))
        self.check_every = int(job.param("check_every"))
        self.check_phase = int(rng.integers(0, self.check_every))
        self.tick = 0  # ticks run, the solver's tick count
        self.episode = -1
        self.checked = []
        self.lat, self.enqueue = [], []
        self.failed = 0
        self._start_episode()

    def _start_episode(self):
        torch = self.torch
        self.episode += 1
        e = self.episode % len(self.starts)
        self.ctrl.current_path_index = int(self.starts[e])
        self.x_dev = torch.as_tensor(self.start_xs[e], device=self.device)
        self.x_host = self.x_dev.cpu()
        self.in_episode = 0

    def _snapshot(self):
        st = self.ctrl.solver_state
        return dict(warm=st.previous_action_seq.clone(), key=st.key.clone(), lam=st.lam.clone(),
                    cind=self.ctrl.current_path_index.clone())

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
            plan, states = self.ctrl.update(self.x_host)
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
        self.x_dev = self.env.dynamics(self.x_dev[None], plan[:1])[0]
        self.x_host = self.x_dev.cpu()
        if check:
            after = self._snapshot()
            self.checked.append(dict(before=before, after=after, plan=plan.clone(),
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
    env, ctrl = _controller(job, device)
    loop = Loop(job, env, ctrl, device)
    phases.mark("scene and controller")
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
    checked, failed = loop.checked, loop.failed
    del loop, ctrl, env
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gaps = compare(job, checked, device)
    print(f"portbench: {len(checked)} ticks checked in {time.perf_counter() - t0:.2f} s",
          file=sys.stderr, flush=True)
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


def compare(job, checked, device) -> dict:
    """The gaps between the checked ticks and the reference's ticks from the same inputs."""
    import torch

    s = job.solver
    scene = maps.scene(job.cell.config, job.seed % 2**32)
    ref = Racing(scene, s, torch.float32, device)
    return gaps(job, ref, checked)


def gaps(job, ref, checked, chunk: int = 4) -> dict:
    """Gaps of the checked ticks against ``ref`` (a :class:`Racing`, float32 or lower)."""
    import torch

    seed = harness.solver_seed(job.seed)
    span = torch.tensor(ref.u_max) - torch.tensor(ref.u_min)
    plan_gap = rollout_gap = lambda_gap = plant_gap = 0.0
    keys_off = index_off = 0
    for i in range(0, len(checked), chunk):
        part = checked[i:i + chunk]
        ticks = [c["before"]["tick"] for c in part]
        x0 = torch.stack([c["before"]["x"] for c in part])
        warm = torch.stack([c["before"]["warm"].cpu() for c in part])
        cind = torch.stack([c["before"]["cind"].cpu() for c in part])
        out = ref.tick(x0, warm, cind, [tick_seed(seed, t) for t in ticks])
        plan, states = out["plan"].float().cpu(), out["states"].float().cpu()
        for j, c in enumerate(part):
            t = ticks[j]
            want_before = torch.tensor(key_words(seed, t), dtype=torch.int32)
            want_after = torch.tensor(key_words(seed, t + 1), dtype=torch.int32)
            keys_off += int(not torch.equal(c["before"]["key"].cpu(), want_before))
            keys_off += int(not torch.equal(c["after"]["key"].cpu(), want_after))
            index_off += int(int(c["after"]["cind"]) != int(out["cind"][j]))
            for got in (c["plan"].cpu(), c["after"]["warm"].cpu()):
                plan_gap = max(plan_gap, float(((got - plan[j]).abs() / span).max()))
            rollout_gap = max(rollout_gap, float((c["states"].cpu() - states[j]).abs().max()))
            lam_ref = float(out["lam"][j])
            lambda_gap = max(lambda_gap, abs(float(c["after"]["lam"]) - lam_ref) / lam_ref)
            stepped = ref.plant(c["before"]["x"][None].to(ref.device, ref.dtype),
                                c["plan"][:1].to(ref.device, ref.dtype)).float().cpu()[0]
            plant_gap = max(plant_gap, float((c["x_next"] - stepped).abs().max()))
    return {"plan_gap": plan_gap, "rollout_gap": rollout_gap, "lambda_gap": lambda_gap,
            "plant_gap": plant_gap, "key_mismatches": float(keys_off),
            "index_mismatches": float(index_off),
            "missing_checks": float(max(0, harness.MIN_CHECKED - len(checked)))}


def substitute(job, low, checked, chunk: int = 4) -> list:
    """The checked ticks as ``low`` (a lower-precision :class:`Racing`) would have answered
    them from the same inputs: the control put in the program's place."""
    import torch

    seed, out = harness.solver_seed(job.seed), []
    for i in range(0, len(checked), chunk):
        part = checked[i:i + chunk]
        ticks = [c["before"]["tick"] for c in part]
        got = low.tick(torch.stack([c["before"]["x"] for c in part]),
                       torch.stack([c["before"]["warm"] for c in part]),
                       torch.stack([c["before"]["cind"] for c in part]),
                       [tick_seed(seed, t) for t in ticks])
        for j, c in enumerate(part):
            plan = got["plan"][j].float()
            x_next = low.plant(c["before"]["x"][None].to(low.device, low.dtype),
                               got["plan"][j:j + 1, 0]).float().cpu()[0]
            after = dict(warm=plan, lam=got["lam"][j].float(), cind=got["cind"][j],
                         key=torch.tensor(key_words(seed, ticks[j] + 1), dtype=torch.int32))
            out.append(dict(before=c["before"], after=after, plan=plan,
                            states=got["states"][j].float(), x_next=x_next))
    return out
