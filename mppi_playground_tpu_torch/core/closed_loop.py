"""Closed loops of N control ticks, and the tick as a CUDA graph replayed on the card.

Counterpart of ``mppi_playground_tpu/core/closed_loop.py``, which scans
[solve -> apply the first action -> plant step] for a static number of
ticks inside one jitted program.  Here the same tick body (the ``info_fn``
reference, the solve, the plant, the ``done_fn`` freeze and the writes of
``xs[t]`` and ``us[t]`` at a device index) is captured once into a CUDA
graph over buffers that live as long as the runner, and replayed
``num_ticks`` times back to back: no host work and no host sync between
ticks, and capture time and memory do not grow with N.  A tick can be
captured because a solve reads its draws from the state's device key and
moves that key on on the device (``core/config.make_key``), and nothing in
it reads a device value on the host.  A runner's first run runs tick 0
eagerly (which builds the kernels and the tables a solver makes at its
first call), captures the body, and replays the other ticks; later runs
replay every tick.  The outputs are copies: the next run overwrites the
runner's buffers, never what it returned.  On the CPU the same body runs
eagerly, on the kernels' twins.

The solver's dynamics and cost, the plant, ``info_fn`` and ``done_fn``
must be capturable as well (:data:`CAPTURABLE`); a capture that fails
raises with that requirement named, and nothing falls back to eager ticks.
The carry's tensors ride the loop; anything else in it is fixed at capture.

Each kernel wrapper counts the launches that run where it makes them; a
capture runs nothing and is not counted, and a replay's launches are seen
only on the device (``chip_smoke.py`` counts them in a profiler's trace).

:class:`PipelinedRunner` is the real-time serving loop with ``depth``
solves in flight, their plans copied to pinned host memory behind CUDA
events; :func:`make_pipelined_closed_loop` is its schedule as a replayed
closed loop, for measuring what the staleness costs.
:func:`make_fleet_closed_loop` is the simulation farm: B episodes of a
batched solver (``parallel/sharded.py``) in one replayed tick body.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from mppi_playground_tpu_torch.core.config import MPPIState, batch_key
from mppi_playground_tpu_torch.core.solver import state_key

# ---------------------------------------------------------------------------
# Trees of tensors: the loop's state, a solver state, an info_fn carry
# ---------------------------------------------------------------------------


def _map(fn, first, *rest):
    """``fn`` over the tensor leaves of trees of one structure; other leaves are ``first``'s.

    Trees are tensors, tuples (named too), lists, dicts and dataclasses
    (:class:`MPPIState`); anything else is a fixed leaf.
    """
    if isinstance(first, torch.Tensor):
        return fn(first, *rest)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: _map(fn, getattr(first, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(first)})
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_map(fn, *leaves) for leaves in zip(first, *rest)))
    if isinstance(first, (tuple, list)):
        return type(first)(_map(fn, *leaves) for leaves in zip(first, *rest))
    if isinstance(first, dict):
        return {k: _map(fn, first[k], *(r[k] for r in rest)) for k in first}
    return first


def _tensors(tree) -> list:
    """The tensor leaves of ``tree``, in :func:`_map`'s order."""
    leaves = []
    _map(lambda t: leaves.append(t), tree)
    return leaves


def bitwise_equal(a, b) -> bool:
    """Two trees of tensors equal leaf by leaf: the same shapes, types and values."""
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(ta, tb))


def result_leaves(result) -> list:
    """What two solves must share to be the same solve: the sequences, the costs, weights,
    λ and ESS, and the next solver state."""
    aux = result.aux
    return _tensors((result.action_seq, result.state_seq, aux.costs, aux.weights, aux.lam,
                     aux.ess, result.state))


def _structure(tree):
    """What a captured body depends on: the containers, each tensor's shape and type, the
    fixed leaves' values; a dataclass's host numbers (a state's seed and tick) excepted."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree), tuple(_structure(getattr(tree, f.name))
                                  for f in dataclasses.fields(tree)
                                  if not isinstance(getattr(tree, f.name), (int, float))))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_structure(leaf) for leaf in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _structure(v)) for k, v in tree.items()))
    return (type(tree), repr(tree))


def _clone(tree):
    return _map(lambda t: t.clone(), tree)


def _copy_into(dst, src) -> None:
    """Copy ``src``'s tensor leaves into ``dst``'s, as if all at once.

    A source that shares memory with another destination leaf is copied
    aside first, so that no leaf is read after it was overwritten.
    """
    pairs = [(d, s) for d, s in zip(_tensors(dst), _tensors(src)) if d is not s]
    storages = {d.untyped_storage().data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in storages else s)
             for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)


def _skeleton(tree):
    """``tree``'s containers, every leaf (a tensor, a bool, any other value) one mark."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree), tuple((f.name, _skeleton(getattr(tree, f.name)))
                                  for f in dataclasses.fields(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_skeleton(leaf) for leaf in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _skeleton(tree[k])) for k in sorted(tree)))
    return "*"


def _map_spec(fn, spec, old, new):
    """``fn(s, o, n)`` at every leaf of ``spec``, a tree of ``new``'s structure."""
    if spec is None:
        return new
    if dataclasses.is_dataclass(spec) and not isinstance(spec, type):
        return dataclasses.replace(new, **{
            f.name: _map_spec(fn, getattr(spec, f.name), getattr(old, f.name),
                              getattr(new, f.name)) for f in dataclasses.fields(spec)})
    if isinstance(spec, tuple) and hasattr(spec, "_fields"):
        return type(new)(*(_map_spec(fn, *leaves) for leaves in zip(spec, old, new)))
    if isinstance(spec, (tuple, list)):
        return type(new)(_map_spec(fn, *leaves) for leaves in zip(spec, old, new))
    if isinstance(spec, dict):
        return {k: _map_spec(fn, spec[k], old[k], new[k]) for k in new}
    return fn(spec, old, new)


def _freeze(done, old_tree, new_tree, spec=None):
    """Select ``old_tree`` where ``done`` (broadcast from the left), the JAX ``_freeze``.

    Without ``spec``, the per-episode test is purely structural: leaves
    whose leading shape is ``done``'s freeze row-wise, every other leaf (e.g.
    a fleet ``info_fn`` carry shared by all episodes) passes through as
    ``new``, as do fixed leaves (the host tick).  A *shared* carry leaf whose
    leading dimension happens to equal the batch size B is indistinguishable
    from a per-episode leaf under that heuristic: pass ``spec``, a tree of
    bools of ``new_tree``'s structure (True = per-episode, freeze row-wise;
    False = shared, pass through), to say so (``carry_freeze`` on
    :func:`make_fleet_closed_loop`).
    """

    def row_freeze(o, n):
        return torch.where(done.reshape(done.shape + (1,) * (n.dim() - done.dim())), o, n)

    def per_episode(n) -> bool:
        return (isinstance(n, torch.Tensor) and n.dim() >= done.dim()
                and tuple(n.shape[:done.dim()]) == tuple(done.shape))

    if spec is not None:
        spec_def, new_def = _skeleton(spec), _skeleton(new_tree)
        if spec_def != new_def:
            raise ValueError(
                f"carry_freeze must be a pytree of bools with the same structure as the "
                f"info_fn carry: got {spec_def}, carry is {new_def}"
            )

        def pick_spec(s, o, n):
            if not s:
                return n
            if not per_episode(n):
                raise ValueError(
                    f"carry_freeze marks a leaf of shape {tuple(getattr(n, 'shape', ()))} as "
                    f"per-episode, but its leading shape is not {tuple(done.shape)}"
                )
            return row_freeze(o, n)

        return _map_spec(pick_spec, spec, old_tree, new_tree)

    return _map(lambda n, o: row_freeze(o, n) if per_episode(n) else n, new_tree, old_tree)


class RunnerCache:
    """Bounded LRU cache of episode runners.

    Keys embed ``id()``s of user callables; each cached runner closes over
    those callables, which keeps them alive, so a live entry's ids cannot be
    recycled into stale hits.  A hit refreshes recency; at capacity the
    least-recently-used entry is evicted (each runner owns a CUDA graph and
    its buffers, so unbounded growth is a leak).
    """

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._entries: dict = {}
        self._capacity = capacity

    def get_or_build(self, key, build):
        run = self._entries.pop(key, None)
        if run is None:
            # build() before evicting: if it raises (bad user callable), the
            # still-valid LRU entry must survive
            run = build()
            if len(self._entries) >= self._capacity:
                self._entries.pop(next(iter(self._entries)))
        self._entries[key] = run  # (re-)insertion at the end = most recent
        return run


# ---------------------------------------------------------------------------
# A tick body over buffers it owns: eager once, then a replayed CUDA graph
# ---------------------------------------------------------------------------

CAPTURABLE = (
    "the solver's dynamics and cost, and a closed loop's plant, info_fn and done_fn, must be "
    "torch operations on the tensors they are given: no reads of device values on the host "
    "(float(x), x.item(), `if x > 0`), no tensors made from host data, no host state that "
    "changes between ticks (a replay repeats what the capture saw)"
)


def _end_generator_capture(device: torch.device) -> None:
    """Take torch's CUDA generator out of capture mode after a capture that failed.

    A failed capture ends before the generator's epilogue, and every later
    draw from it raises ("Offset increment outside graph capture"); the
    next capture that succeeds ends it, so one of a single fill follows.
    """
    with torch.cuda.device(device):
        scratch = torch.empty(1, device=device)
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            scratch.zero_()


class TickGraph:
    """``body()`` captured once in a CUDA graph; :meth:`replay` launches it.

    ``body`` must read and write only tensors that outlive the graph, and
    must have run eagerly once before (kernels built, first-call tables
    made).  ``out`` is what the capture returned: tensors the next replay
    overwrites.  ``capture_s`` is the capture's wall time.  The kernel
    wrappers do not count what a capture records (``ops/cuda_build.launched``),
    and nothing counts a replay's launches on the host.
    """

    def __init__(self, body: Callable[[], Any], device: torch.device):
        self.graph = torch.cuda.CUDAGraph()
        # A graph the collector frees while this one captures (one left in a
        # reference cycle) is destroyed mid-capture, which invalidates the
        # capture: collect first, and hold the collector off until it ends.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with torch.cuda.device(device), torch.cuda.graph(self.graph):
                self.out = body()
        except RuntimeError as err:
            _end_generator_capture(device)
            raise RuntimeError(f"capturing the control tick in a CUDA graph failed; "
                               f"{CAPTURABLE}. The capture raised: {err}") from err
        finally:
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()


class _Captured:
    """A tick ``body`` over buffers of a tree of tensors: eagerly the first time, then captured.

    :meth:`_hold` puts a tree into the buffers (new buffers, and no graph,
    where its structure differs from the captured one); :meth:`_run` runs
    the body once: a replay when captured, else eagerly and then the capture.
    """

    graph: Optional[TickGraph] = None
    structure = None
    loop = None

    def _hold(self, loop) -> None:
        structure = _structure(loop)
        if self.graph is not None and structure == self.structure:
            _copy_into(self.loop, loop)
        else:
            self.graph, self.structure, self.loop = None, structure, _clone(loop)

    def _run(self, body: Callable[[], Any], device: torch.device):
        if self.graph is not None:
            self.graph.replay()
            return self.graph.out
        out = body()
        self.graph = TickGraph(body, device)
        return out


class _Episode(_Captured):
    """``num_ticks`` of ``tick(loop, t) -> (loop_next, x, u)``, recording x and u.

    ``loop`` is a tree of tensors (the solver state, the plant state, the
    carry, ...), ``t`` the tick's index as a 0-dim int64 tensor.  Returns
    ``(loop_final, xs [N, ...], us [N, ...])``.
    """

    def __init__(self, tick, num_ticks: int):
        if num_ticks < 0:
            raise ValueError(f"num_ticks must be >= 0, got {num_ticks}")
        self.tick = tick
        self.num_ticks = num_ticks

    def __call__(self, loop, x_like: torch.Tensor, u_like: torch.Tensor):
        n = self.num_ticks
        dev = x_like.device
        if n == 0:
            return loop, x_like.new_empty((0, *x_like.shape)), u_like.new_empty((0, *u_like.shape))
        if dev.type != "cuda":
            xs, us = [], []
            for t in range(n):
                loop, x, u = self.tick(loop, torch.tensor(t, device=dev))
                xs.append(x)
                us.append(u)
            return loop, torch.stack(xs), torch.stack(us)
        self._hold(loop)
        if self.graph is None:
            self.t = torch.zeros((), dtype=torch.int64, device=dev)
            self.xs = x_like.new_empty((n, *x_like.shape))
            self.us = u_like.new_empty((n, *u_like.shape))
        self.t.zero_()
        self._run(self._body, dev)  # tick 0
        for _ in range(n - 1):
            self.graph.replay()
        return _clone(self.loop), self.xs.clone(), self.us.clone()

    def _body(self) -> None:
        loop_next, x, u = self.tick(self.loop, self.t)
        row = self.t.reshape(1)
        self.xs.index_copy_(0, row, x.unsqueeze(0))
        self.us.index_copy_(0, row, u.unsqueeze(0))
        self.t.add_(1)
        _copy_into(self.loop, loop_next)


def _with_key(state: MPPIState, device) -> MPPIState:
    """``state`` with its device key made where it has none."""
    return state if state.key is not None else dataclasses.replace(
        state, key=state_key(state, device))


def _x0(solver, x0) -> torch.Tensor:
    return torch.as_tensor(x0, dtype=solver.config.dtype, device=solver.device)


def make_closed_loop(
    solver,
    plant_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    num_ticks: int,
    info_fn: Optional[Callable[[Any, torch.Tensor], Any]] = None,
    done_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Build ``run(state, x0, carry=None) -> (state, x_final, xs, us, carry[, episode])``.

    Args:
        solver: an ``MPPISolver`` (unfused or fused).
        plant_fn: ``(x [n], u [m]) -> x_next [n]``, the simulated plant (may
            differ from the solver's internal model).
        num_ticks: the episode's length.
        info_fn: optional ``(carry, x) -> (info, new_carry)``, the tick's
            cost context (e.g. the racing reference and its monotone path
            index).
        done_fn: optional ``(x [n]) -> bool tensor`` on the post-step state,
            the reference loops' ``break`` on goal or collision.  Once done,
            the episode freezes: the solver state (its device key too), the
            plant state and the ``info_fn`` carry stop changing and the
            recorded actions are zero.  Every tick still runs (a graph
            cannot shrink), so this buys the semantics, not the compute.

    Returns ``run``, whose outputs are the final solver state (its host
    ``tick`` moved on by ``num_ticks``, the ticks the loop ran; its device
    key, which decides every later draw, frozen where ``done_fn`` fired, so
    that after a fire ``make_key(seed, tick)`` no longer names it), the final
    plant state, ``xs [num_ticks, n]`` the visited states, ``us
    [num_ticks, m]`` the applied actions and the final carry (None without
    ``info_fn``); with ``done_fn`` also ``episode``, a dict of ``done`` (a
    bool tensor: terminated within the budget, a first fire on the last
    post-step state included) and ``ticks`` (int32, the ticks run before
    termination, ``num_ticks`` if never done).  On the card the first run
    captures the tick (see the module docstring); nothing waits on the
    device until the caller reads an output.
    """

    def tick(loop, t):
        st, x, c, done, ticks = loop
        info, c_next = info_fn(c, x) if info_fn is not None else (None, c)
        result = solver.solve(st, x, info=info)
        u = result.action_seq[0]
        if done_fn is None:
            return (result.state, plant_fn(x, u), c_next, None, None), x, u
        u = torch.where(done, torch.zeros_like(u), u)
        x_next = torch.where(done, x, plant_fn(x, u))
        st_next = _freeze(done, st, result.state)
        if info_fn is not None:
            c_next = _freeze(done, c, c_next)
        ticks = ticks + (~done).to(torch.int32)
        done = done | torch.as_tensor(done_fn(x_next), device=x.device).reshape(()).bool()
        return (st_next, x_next, c_next, done, ticks), x, u

    episode = _Episode(tick, num_ticks)
    u_like = torch.empty(solver.config.dim_control, dtype=solver.config.dtype,
                         device=solver.device)

    def run(state: MPPIState, x0, carry: Any = None):
        x0 = _x0(solver, x0)
        flags = (None, None)
        if done_fn is not None:
            flags = (torch.zeros((), dtype=torch.bool, device=x0.device),
                     torch.zeros((), dtype=torch.int32, device=x0.device))
        loop = (_with_key(state, solver.device), x0, carry, *flags)
        (st, xf, c, done, ticks), xs, us = episode(loop, x0, u_like)
        st = dataclasses.replace(st, tick=state.tick + num_ticks)
        if done_fn is None:
            return st, xf, xs, us, c
        return st, xf, xs, us, c, {"done": done, "ticks": ticks}

    run.episode = episode
    return run


def make_pipelined_closed_loop(
    solver,
    plant_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    num_ticks: int,
    depth: int,
    compensate: bool = True,
    info_fn: Optional[Callable[[Any, torch.Tensor], Any]] = None,
):
    """Closed loop with :class:`PipelinedRunner`'s staleness, its queue of plans on the device.

    Bit for bit the action schedule of a ``PipelinedRunner(solver, depth,
    compensate)`` host loop: tick ``t`` solves from the current plant state,
    but applies the plan of tick ``t - depth``, its row ``min(depth, T-1)``
    with ``compensate`` (the stale plan's action for the current tick) and
    row 0 without; the first ``depth`` ticks apply the newest plan's row 0
    (the pipeline's fill).  The solver state still chains solve to solve.
    ``depth=0`` is the strict loop.  The evaluation harness for the
    pipelined serving mode: it runs the schedule at replayed-graph speed,
    so that what a depth costs in control quality can be measured.

    Returns ``run(state, x0, carry=None) -> (state, x_final, xs [N, n], us
    [N, m], carry)``.
    """
    if depth < 0:
        raise ValueError(f"depth must be >= 0, got {depth}")
    horizon, dim_control = solver.config.horizon, solver.config.dim_control
    row = min(depth, horizon - 1) if compensate else 0

    def tick(loop, t):
        st, x, c, queue = loop
        info, c_next = info_fn(c, x) if info_fn is not None else (None, c)
        result = solver.solve(st, x, info=info)
        plan = result.action_seq
        if depth == 0:
            u, queue_next = plan[0], queue
        else:
            # queue[0] is the plan of tick t - depth once the pipeline is full
            u = torch.where(t < depth, plan[0], queue[0, row])
            queue_next = torch.cat([queue[1:], plan[None]])
        return (result.state, plant_fn(x, u), c_next, queue_next), x, u

    episode = _Episode(tick, num_ticks)
    u_like = torch.empty(dim_control, dtype=solver.config.dtype, device=solver.device)

    def run(state: MPPIState, x0, carry: Any = None):
        x0 = _x0(solver, x0)
        queue = torch.zeros(max(depth, 1), horizon, dim_control, dtype=solver.config.dtype,
                            device=x0.device)
        (st, xf, c, _), xs, us = episode((_with_key(state, solver.device), x0, carry, queue),
                                         x0, u_like)
        return dataclasses.replace(st, tick=state.tick + num_ticks), xf, xs, us, c

    run.episode = episode
    return run


def make_fleet_closed_loop(
    batched_solver,
    plant_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    num_ticks: int,
    info_fn: Optional[Callable[[Any, torch.Tensor], Any]] = None,
    done_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    carry_freeze: Any = None,
):
    """A fleet of independent episodes as one replayed tick body.

    The simulation-farm mode: the ``batch_size`` control problems of
    ``batched_solver`` (``parallel.make_batched_fused_solver`` /
    ``make_batched_solver``), each stepped for ``num_ticks`` ticks.  As in
    :func:`make_closed_loop`, tick 0 runs eagerly on the card, the fleet's
    tick body is captured once and replayed ``num_ticks - 1`` times, with
    nothing on the host between ticks; on the CPU the body runs eagerly.

    Args:
        plant_fn: batched plant ``(xs [B, n], us [B, m]) -> [B, n]``.
        info_fn: optional ``(carry, xs [B, n]) -> (batched_info, carry)``
            where ``batched_info`` is a dict of ``[B, ...]`` tensors, the
            per-scenario cost context (e.g. each episode's reference
            trajectory, ``models/racing_mpcc.calc_ref_trajectory_batch``),
            passed as ``solve_batch(batched_info=...)``.
        done_fn: optional batched termination predicate ``(xs [B, n]) ->
            bool [B]`` on the post-step states.  Episodes that report done
            freeze one by one (solver state, device key included, plant
            state, and the ``info_fn`` carry leaves whose leading axis is
            ``B``, or as ``carry_freeze`` says); the fleet runs to the tick
            budget.  Without ``carry_freeze``, "per-episode" is decided by
            shape alone: a shared carry leaf whose leading dimension happens
            to equal ``B`` freezes row-wise.
        carry_freeze: optional tree of bools of the ``info_fn`` carry's
            structure in place of that test: ``True`` leaves freeze row-wise
            when their episode is done (their leading shape must be ``[B]``),
            ``False`` leaves are shared and always pass through.  It needs
            both ``info_fn`` and ``done_fn``.

    Returns ``run(states, x0s, carry=None) -> (states, xs_final, xs
    [num_ticks, B, n], us [num_ticks, B, m], final_carry[, episode])`` where
    ``episode`` (with ``done_fn`` only) holds ``done [B]`` and ``ticks
    [B]`` int32, the ticks run by each episode.  The states' host ``tick``
    moves on by ``num_ticks``.
    """
    if carry_freeze is not None and (done_fn is None or info_fn is None):
        # the spec only ever applies to the info_fn carry of a done_fn loop:
        # dropping it quietly would hide a mis-wired call
        raise ValueError(
            "carry_freeze requires both info_fn (it describes the info_fn "
            "carry) and done_fn (freezing only happens on termination)"
        )
    config = batched_solver.config

    def tick(loop, t):
        sts, xs, c, done, ticks = loop
        binfo, c_next = info_fn(c, xs) if info_fn is not None else (None, c)
        result = batched_solver.solve_batch(sts, xs, batched_info=binfo)
        us = result.action_seq[:, 0]
        if done_fn is None:
            return (result.state, plant_fn(xs, us), c_next, None, None), xs, us
        us = torch.where(done[:, None], torch.zeros_like(us), us)
        xs_next = torch.where(done[:, None], xs, plant_fn(xs, us))
        sts_next = _freeze(done, sts, result.state)
        if info_fn is not None:
            c_next = _freeze(done, c, c_next, spec=carry_freeze)
        ticks = ticks + (~done).to(torch.int32)
        done = done | torch.as_tensor(done_fn(xs_next), device=xs.device).reshape(done.shape).bool()
        return (sts_next, xs_next, c_next, done, ticks), xs, us

    episode = _Episode(tick, num_ticks)

    def run(states: MPPIState, x0s, carry: Any = None):
        x0s = torch.as_tensor(x0s, dtype=config.dtype, device=batched_solver.device)
        batch = x0s.shape[0]
        u_like = x0s.new_empty(batch, config.dim_control)
        flags = (None, None)
        if done_fn is not None:
            flags = (torch.zeros(batch, dtype=torch.bool, device=x0s.device),
                     torch.zeros(batch, dtype=torch.int32, device=x0s.device))
        states = dataclasses.replace(states, key=batch_key(states, batch, x0s.device))
        (st, xf, c, done, ticks), xs, us = episode((states, x0s, carry, *flags), x0s, u_like)
        st = dataclasses.replace(st, tick=states.tick + num_ticks)
        if done_fn is None:
            return st, xf, xs, us, c
        return st, xf, xs, us, c, {"done": done, "ticks": ticks}

    run.episode = episode
    return run


class PipelinedRunner:
    """Delay-compensated real-time serving: keep ``depth`` solves in flight.

    A strict host-in-the-loop controller waits for every solve (solve ->
    read the action -> act).  This runner double-buffers: ``step(x)``
    dispatches a solve from the current state, starts the copy of its plan
    to pinned host memory (``non_blocking=True``, behind a CUDA event), and
    returns the action of the solve issued ``depth`` calls earlier, whose
    copy has had ``depth`` solves' time to land.

    **Staleness contract.**  The returned action comes from a solve that saw
    the state ``depth`` ticks ago.  With ``compensate=True`` (the default)
    it is that plan's row ``min(depth, T-1)``, the stale plan's action for
    the current tick; with ``compensate=False`` its row 0.  The warm start
    is unaffected either way: the solves chain their own state on the
    device.  During the fill (the first ``depth`` calls) the newest plan's
    row 0 is returned, which waits for that solve, once.

    Measure a depth's cost in control quality on your own plant with
    :func:`make_pipelined_closed_loop` (its schedule, bit for bit) before
    serving it: the JAX package's measurements found depth 1-2 benign on
    navigation and the pendulum and depth 4 harmful on all its workloads.
    """

    def __init__(self, solver, depth: int = 2, compensate: bool = True):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._solver = solver
        self._depth = depth
        self._row = min(depth, solver.config.horizon - 1) if compensate else 0
        self._state = solver.init()
        self._queue: collections.deque = collections.deque()

    @property
    def state(self) -> MPPIState:
        """The warm-start state after the newest dispatched solve."""
        return self._state

    def _copy_to_host(self, seq: torch.Tensor):
        if seq.device.type != "cuda":
            return seq.clone(), None
        host = torch.empty(seq.shape, dtype=seq.dtype, pin_memory=True)
        host.copy_(seq, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(seq.device))
        return host, ready

    @staticmethod
    def _read(entry) -> np.ndarray:
        host, ready = entry
        if ready is not None:
            ready.synchronize()
        return host.numpy()

    def step(self, x, info: Optional[dict] = None) -> np.ndarray:
        """Dispatch a solve from ``x``; return a numpy action (see the class docstring)."""
        result = self._solver.solve(self._state, _x0(self._solver, x), info=info)
        self._state = result.state
        self._queue.append(self._copy_to_host(result.action_seq))
        if len(self._queue) <= self._depth:
            return self._read(self._queue[-1])[0]  # the fill: newest plan, row 0
        return self._read(self._queue.popleft())[self._row]

    def flush(self) -> list:
        """Drain the solves in flight; their action sequences as numpy arrays, oldest first."""
        out = [self._read(entry) for entry in self._queue]
        self._queue.clear()
        return out

    def reset(self, seed: Optional[int] = None) -> None:
        """Drop the solves in flight and start the warm-start state afresh."""
        self._queue.clear()
        self._state = self._solver.init() if seed is None else self._solver.init(seed)


class ReplayedTick(_Captured):
    """A facade's tick and the state it carries across ticks; on the card, a replayed graph.

    ``tick(state, x, carry, **kw) -> (SolveResult, carry_next, extra)``, the
    facade's tick from the solver state, the plant state and a carry (the
    racing path index, or None).  The runner owns the state and the carry
    between ticks; :attr:`state` and :attr:`carry` read them (copies while
    they live in the graph's buffers) and set them.

    :meth:`step` with ``graph=True`` on the card runs the first tick
    eagerly over buffers the runner owns (which builds the kernels and the
    tables a solver makes at its first call), captures it, and replays the
    capture at every later tick of the same structure.  With ``graph=False``
    (injected noise, an ``info``), and on the CPU, the tick runs eagerly.
    """

    def __init__(self, tick, state: MPPIState, carry: Any = None):
        self.tick = tick
        self._state, self._carry = state, carry
        self._held = False  # whether _state and _carry are the graph's buffers

    @property
    def state(self) -> MPPIState:
        return _clone(self._state) if self._held else self._state

    @state.setter
    def state(self, value: MPPIState) -> None:
        self._release()
        self._state = value

    @property
    def carry(self) -> Any:
        return _clone(self._carry) if self._held else self._carry

    @carry.setter
    def carry(self, value: Any) -> None:
        self._release()
        self._carry = value

    def _release(self) -> None:
        """Take the state and the carry out of the graph's buffers."""
        if self._held:
            self._state, self._carry, self._held = self.state, self.carry, False

    def step(self, x: torch.Tensor, graph: bool = True, **kw):
        """One tick from ``x`` -> ``(action_seq, state_seq, aux, extra)``.

        ``kw`` (``info``, ``noise``) reach the tick only with ``graph=False``.
        The sequences and ``extra`` are the caller's own; ``aux`` describes
        this tick until the next one (it holds copies of the warm start and
        the seed word it was drawn from, so that ``top_samples`` replays it).
        """
        if not graph or x.device.type != "cuda":
            self._release()
            result, self._carry, extra = self.tick(self._state, x, self._carry, **kw)
            self._state = result.state
            return result.action_seq, result.state_seq, result.aux, extra
        tick = self._state.tick
        if self._held:
            self.loop[2].copy_(x)
        else:
            self._hold((_with_key(self._state, x.device), self._carry, x))
        action_seq, state_seq, aux, extra = self._run(self._body, x.device)
        state, self._carry, _ = self.loop
        self._state, self._held = dataclasses.replace(state, tick=tick + 1), True
        return action_seq.clone(), state_seq.clone(), aux, _clone(extra)

    def _body(self):
        state, carry, x = self.loop
        result, carry_next, extra = self.tick(state, x, carry)
        aux = result.aux
        if aux.prev_action_seq is not None:  # the buffers move on below
            aux = aux._replace(prev_action_seq=aux.prev_action_seq.clone(),
                               seed=aux.seed.clone())
        _copy_into((state, carry), (result.state, carry_next))
        return result.action_seq, result.state_seq, aux, extra
