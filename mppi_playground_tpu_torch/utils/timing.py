"""Solve-time measurement, profiling hooks, and the port's spans and counters.

Counterpart of ``mppi_playground_tpu/utils/timing.py``.  The reference
controller's examples measure wall-clock around the solve and print an
average; these do the same with the clock stopped only once the device has
finished: where the JAX
package calls ``jax.block_until_ready``, :func:`block_until_ready` waits on
the device of every CUDA tensor of the result (``torch.cuda.synchronize``),
and does nothing for CPU tensors.  :func:`profile_trace` records a
``torch.profiler`` trace of a block (the card's kernels too, where there is
one) and writes it as a Chrome trace, with the spans recorded meanwhile
beside it.

**Spans.**  A :class:`Span` marks a layer boundary of the port (the table
below).  Each span records its name, its start and end, its parent and the
tick it belongs to (the solver state's ``tick``, given at the outermost span
of a tick and inherited by the spans inside) into a ring of the last
:data:`RING_SIZE` spans opened, preallocated and always on: a column of ints
a field, which a span writes its integers into, building no object.  With no
profiler running a span costs a clock read at each end and its slot's
writes: no lock, no device synchronisation.  While a ``torch.profiler``
collects, each span also opens a profiler range of its name (a host
operation, as ``record_function`` opens, but not a user annotation, which
the trace would also lay over the device's timeline), so that the trace
shows the port's layers on the clock of its host events; :func:`spans` gives
the ring on that clock (the Unix epoch in ns, ``time.time_ns``:
``perf_counter_ns`` plus one offset measured at import).  The spans are one
thread's: the control thread's.

========  ===========================  ==============================================
layer     span                         where
========  ===========================  ==============================================
facade    ``facade.update``            ``RacingController.update``
facade    ``facade.forward``           ``MPPI.forward``
facade    ``facade.episode``           the ``run`` of a closed loop (plain, pipelined,
                                       fleet)
facade    ``facade.rebuild``           a map change rebuilds the racing solver
tick      ``tick.copy_in``             the inputs into the tick's buffers
tick      ``tick.replay``              a CUDA graph's replay
tick      ``tick.copy_out``            the copies a replayed tick returns
tick      ``tick.eager``               a tick body run outside a graph
tick      ``tick.capture``             a tick body captured in a graph
solver    ``solver.reference_rows``    the racing reference rows
solver    ``solver.solve``             a solve (one scenario or a fleet)
solver    ``solver.rollout``           the unfused torch rollout and its costs
solver    ``solver.dynamics``          a call of the user's ``dynamics`` in the unfused
                                       rollout or the nominal re-roll
solver    ``solver.cost``              a call of the user's ``cost_func`` in the unfused
                                       rollout, the terminal call included
solver    ``solver.lambda``            the λ search (rows 3, 4, 7, 5) or MPO's step
solver    ``solver.tail``              the tail and the state advance (the key moves on)
solver    ``solver.top_samples``       ``get_top_samples``: the fused route's top rows, or
                                       the stored rollouts read
solver    ``solver.top_indices``       the top n samples by weight (a stable sort)
solver    ``solver.top_rollouts``      the fused route's top rows regenerated and rolled
                                       out (row 6)
kernels   ``kernel.<symbol>``          every hand kernel's launch (``ops/cuda_build``)
plant     ``env.dynamics``             ``RacingEnv.dynamics`` (inside ``solver.dynamics``
                                       on the unfused route)
========  ===========================  ==============================================

**The capture map.**  A replayed CUDA graph runs its kernels with no host
code around them, so a span inside a tick body exists only when the body
runs eagerly or is captured.  While ``core/closed_loop.TickGraph`` captures
(:func:`mapping`), every span that opens or closes reads how many nodes the
graph has so far (libcuda's ``cuStreamGetCaptureInfo`` and
``cuGraphGetNodes``, through ``ctypes``); at the end the graph's nodes are
listed in the order the capture made them, each with its span path, its kind
and its kernel's name (:class:`SpanMap`).  The maps of the graphs captured in
the process stay in a bounded registry (:func:`graph_maps`), and
:func:`attribute` charges the device activities of a trace's replays to
their spans.

**Counters** (:func:`counter`, :func:`counters`): ``tick.replays``,
``tick.eager``, ``tick.captures``, ``solver.rebuilds``, ``kernels.built``
(``nvcc`` ran for a library), ``kernels.loaded`` (a library was found built
and loaded), ``solver.top_samples`` (the calls of ``get_top_samples``), and
``kernel.launches`` by kernel symbol (:func:`launches`): the eager launches,
and for each replay what its graph captured.  The kernel
wrappers' ``launches`` are views of the eager counts (:class:`LaunchCounts`,
:class:`CountedLaunches`).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import itertools
import json
import os
import tempfile
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _profiler

from torch._C._profiler import _RecordFunctionFast


def block_until_ready(tree):
    """Wait until the devices of ``tree``'s CUDA tensors have finished; returns ``tree``."""
    from mppi_playground_tpu_torch.core.closed_loop import _tensors

    for device in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)
    return tree


class SolveTimer:
    """Running average of solve latency (reference-style reporting)."""

    def __init__(self) -> None:
        self.times = []

    @contextlib.contextmanager
    def measure(self, result_fn: Optional[Callable] = None):
        """Time a block; pass ``result_fn`` returning the block's output so
        that the device finishes it before the clock stops."""
        start = time.perf_counter()
        yield
        if result_fn is not None:
            block_until_ready(result_fn())
        self.times.append(time.perf_counter() - start)

    def add(self, seconds: float) -> None:
        self.times.append(seconds)

    @property
    def average_ms(self) -> float:
        return 1000.0 * float(np.mean(self.times)) if self.times else 0.0

    def summary(self) -> str:
        return f"average solve time: {self.average_ms:.3f} ms"


def time_fn(fn: Callable, *args, warmup: int = 3, iters: int = 20, **kwargs) -> Dict:
    """Steady-state latency of ``fn(*args, **kwargs)``, each call waited for on the device.

    Returns a dict with the mean, median and 95th percentile seconds and
    calls/s, on the host clock.
    """
    for _ in range(warmup):
        block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - start)
    times = np.asarray(times)
    return {
        "mean_s": float(times.mean()),
        "p50_s": float(np.percentile(times, 50)),
        "p95_s": float(np.percentile(times, 95)),
        "per_s": float(1.0 / times.mean()),
    }


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Record a ``torch.profiler`` trace around a block into ``log_dir/trace.json``.

    The host's operations, and the card's kernels where CUDA is available;
    open the file with Perfetto or ``chrome://tracing``.  The port's spans
    recorded meanwhile are ranges of the trace, and also go to
    ``log_dir/spans.json`` (:func:`dump_spans`).  ``log_dir`` defaults to
    ``torch-trace`` in the temporary directory.  Yields the directory.
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    first = _state.opened
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    dump_spans(os.path.join(log_dir, "spans.json"), since=first)


# ---------------------------------------------------------------------------
# Spans: a ring of the last RING_SIZE spans opened, in columns of integers
# ---------------------------------------------------------------------------

RING_SIZE = 1 << 16
MAX_DEPTH = 64  # spans nested deeper are not recorded
_MASK = RING_SIZE - 1
# perf_counter_ns plus this is the Unix-epoch clock the profiler stamps host events with
CLOCK_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
ROOT = "tick.capture"  # the span path of the nodes a capture made outside any inner span

_clock = time.perf_counter_ns
_names: List[str] = []
_codes: Dict[str, int] = {}


# The ring: slot n & _MASK holds the n-th span opened, one column a field: its parent's
# number (-1 for none), its name's code (plus _RANGED where a profiler range was opened for
# it), its tick (-1 for none), and its start and end on perf_counter_ns; an end before the
# start is an older span's, and marks the span open.  Lists of ints: a slot's write builds no
# object, and the fastest such write in CPython.
_parent, _code_of, _tick, _start, _end = ([-1] * RING_SIZE for _ in range(5))
_RANGED = 1 << 32
# the open spans, innermost last: their numbers, their ticks, their profiler ranges
_open, _open_tick = [0] * MAX_DEPTH, [0] * MAX_DEPTH
_ranges: list = [None] * MAX_DEPTH


class _State:
    __slots__ = ("depth", "opened", "profiled", "capture")


_state = _State()
_state.depth = _state.opened = 0
_state.profiled = 0  # 1 + the number of the last span opened while a profiler collected
_state.capture = None  # the _Capture under way, if a TickGraph is capturing


def _code(name: str) -> int:
    code = _codes.get(name)
    if code is None:
        code = _codes[name] = len(_names)
        _names.append(name)
    return code


def open_span(code: int, tick: Optional[int] = None) -> None:
    """Open the span of name code ``code`` (:attr:`Span.code`); ``tick`` (a host int) starts a
    tick, None takes the enclosing span's.  Close it with :func:`close_span`."""
    st = _state
    d = st.depth
    st.depth = d + 1
    if d >= MAX_DEPTH:
        return
    n = st.opened
    st.opened = n + 1
    i = n & _MASK
    if d:
        _parent[i] = _open[d - 1]
        _tick[i] = _open_tick[d] = _open_tick[d - 1] if tick is None else tick
    else:
        _parent[i] = -1
        _tick[i] = _open_tick[d] = -1 if tick is None else tick
    _open[d] = n
    if _profiler._is_profiler_enabled:
        st.profiled = n + 1
        _code_of[i] = code | _RANGED
        _ranges[d] = _range(code)
    else:
        _code_of[i] = code
    if st.capture is not None:
        st.capture.mark(True, code)
    _start[i] = _clock()


def close_span() -> None:
    """Close the innermost open span."""
    end = _clock()
    st = _state
    d = st.depth - 1
    if d < 0:
        return
    st.depth = d
    if d >= MAX_DEPTH:
        return
    n = _open[d]
    rf = _ranges[d]
    if rf is not None:
        _ranges[d] = None
        rf.__exit__(None, None, None)
    if st.capture is not None:
        st.capture.mark(False)
    if st.opened - n <= RING_SIZE:  # else its slot holds a newer span
        _end[n & _MASK] = end


_pending: list = []  # the profiler ranges begin() opened, innermost last


def begin(code: int) -> int:
    """The start of span ``code``, which :func:`write` records once it has ended: a clock read.

    For the replayed tick's leaf spans, whose bookkeeping waits until the
    graph has been launched: :func:`begin` and :func:`end` at the
    boundaries, :func:`write` after the launch.  While a profiler collects,
    the span's range opens here.
    """
    if _profiler._is_profiler_enabled:
        _pending.append(_range(code))
    return _clock()


def end() -> int:
    """The end of the span :func:`begin` started last: a clock read; its range closes."""
    t = _clock()
    if _pending:
        _pending.pop().__exit__(None, None, None)
    return t


def write(code: int, start: int, end: int) -> None:
    """Record span ``code`` from ``start`` to ``end`` (:func:`begin`, :func:`end`) as a
    closed child of the innermost open span, with no span inside it.

    It takes its number when written, after any span opened meanwhile.  A
    capture's map does not see it: not for a span inside a capture.
    """
    st = _state
    d = st.depth
    if d > MAX_DEPTH:
        return
    n = st.opened
    st.opened = n + 1
    i = n & _MASK
    if d:
        _parent[i] = _open[d - 1]
        _tick[i] = _open_tick[d - 1]
    else:
        _parent[i] = _tick[i] = -1
    if _profiler._is_profiler_enabled:
        st.profiled = n + 1
        code |= _RANGED
    _code_of[i] = code
    _start[i] = start
    _end[i] = end


def _range(code: int):
    """A profiler range of the span's name, opened: a host operation of the trace (not a
    user annotation, which the trace would also lay over the device's timeline)."""
    rf = _RecordFunctionFast(_names[code])
    rf.__enter__()
    return rf


class Span:
    """A named span: ``with span:``, or ``with span(tick):`` at a tick's outermost span.

    Make one per name, once (a module constant; :func:`kernel_span` for a
    kernel's), and enter it as often as the boundary is crossed; the hottest
    boundaries call :func:`open_span` with its :attr:`code` and
    :func:`close_span` instead, which skips the ``with`` protocol's cost,
    or, for a leaf span, :func:`begin`, :func:`end` and :func:`write`.
    """

    __slots__ = ("name", "code")

    def __init__(self, name: str):
        self.name = name
        self.code = _code(name)

    def __call__(self, tick: int) -> "_At":
        """This span, opened at tick ``tick`` (a host int)."""
        return _At(self.code, tick)

    def __enter__(self) -> "Span":
        open_span(self.code)
        return self

    def __exit__(self, *exc) -> bool:
        close_span()
        return False


class _At:
    __slots__ = ("code", "tick")

    def __init__(self, code: int, tick: int):
        self.code, self.tick = code, tick

    def __enter__(self) -> "_At":
        open_span(self.code, self.tick)
        return self

    def __exit__(self, *exc) -> bool:
        close_span()
        return False


_kernel_spans: Dict[str, Span] = {}


def kernel_span(symbol: str) -> Span:
    """The span ``kernel.<symbol>`` of a hand kernel's launch."""
    span = _kernel_spans.get(symbol)
    if span is None:
        span = _kernel_spans[symbol] = Span("kernel." + symbol)
    return span


class SpanRecord(NamedTuple):
    """A closed span: its times in ns on the Unix-epoch clock (:data:`CLOCK_OFFSET_NS`)."""

    id: int  # its number: the spans opened before it
    parent: int  # the enclosing span's id, -1 for none
    name: str
    tick: int  # the tick it belongs to, -1 for none
    start_ns: int
    end_ns: int
    profiled: bool  # a torch.profiler collected when it opened

    @property
    def us(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-3


def spans(since: int = 0) -> List[SpanRecord]:
    """The ring's closed spans by number (the order they opened or were written), oldest
    first; ``since`` a span's number (:func:`opened`) before which to leave spans out."""
    out = []
    last = _state.opened
    for n in range(max(last - RING_SIZE, since, 0), last):
        i = n & _MASK
        if _end[i] >= _start[i]:
            code = _code_of[i]
            out.append(SpanRecord(n, _parent[i], _names[code & ~_RANGED], _tick[i],
                                  _start[i] + CLOCK_OFFSET_NS, _end[i] + CLOCK_OFFSET_NS,
                                  code >= _RANGED))
    return out


def opened() -> int:
    """The spans opened or written since the process started: the next span's number."""
    return _state.opened


def after_profiling() -> Optional[List[SpanRecord]]:
    """The ring's spans opened after the last one a profiler saw, as far as the ring still
    holds them; None where no span was opened while a profiler collected."""
    return spans(since=_state.profiled) if _state.profiled else None


def children(records: Iterable[SpanRecord]) -> Dict[int, List[SpanRecord]]:
    """The records by their parent's id."""
    out: Dict[int, List[SpanRecord]] = collections.defaultdict(list)
    for r in records:
        out[r.parent].append(r)
    return out


def dump_spans(path: str, since: int = 0) -> None:
    """Write the ring's spans (:func:`spans`) to ``path``, one JSON object a line."""
    with open(path, "w") as f:
        for r in spans(since):
            f.write(json.dumps(r._asdict()) + "\n")


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

COUNTERS = ("tick.replays", "tick.eager", "tick.captures", "solver.rebuilds", "kernels.built",
            "kernels.loaded", "solver.top_samples")
_counts: Dict[str, int] = dict.fromkeys(COUNTERS[1:], 0)  # tick.replays: the maps count them
_eager_launches: Dict[str, int] = collections.defaultdict(int)


def count(name: str, n: int = 1) -> None:
    """Move counter ``name`` (one of :data:`COUNTERS`) on by ``n``."""
    _counts[name] += n


def counter(name: str) -> int:
    """Counter ``name`` now; ``tick.replays`` is the replays the capture maps counted."""
    if name == "tick.replays":
        return _retired_replays + sum(m.replays for m in _maps.values())
    return _counts[name]


def count_launch(symbol: str, ran: int) -> None:
    """A launch of kernel ``symbol`` was made: it ran (``ran`` 1), or a capture recorded it
    (0), which counts it once for each replay of the graph."""
    if ran:
        _eager_launches[symbol] += 1
    elif _state.capture is not None:
        _state.capture.map.launches[symbol] += 1


def launches() -> Dict[str, int]:
    """``kernel.launches``: every kernel's launches by symbol, eager and replayed."""
    out = collections.Counter(_eager_launches)
    out.update(_retired_launches)
    for m in _maps.values():
        for symbol, n in m.launches.items():
            out[symbol] += n * m.replays
    return dict(out)


def counters() -> Dict[str, object]:
    """Every counter now, ``kernel.launches`` as a dict by symbol."""
    return {**{name: counter(name) for name in COUNTERS}, "kernel.launches": launches()}


class LaunchCounts:
    """A kernel wrapper's ``launches``: its kernels' eager launches by the names it counts
    them under, a view of the registry.

    ``view[name]`` reads the launches of the symbols ``name`` and
    ``name + "_batch"`` (a single-scenario wrapper counts its batched form's
    too), 0 for a name the wrapper does not hold (``holds(name)`` false);
    :meth:`clear` makes every count read 0 from now on.
    """

    def __init__(self, holds: Callable[[str], bool]):
        self._holds = holds
        self._base: Dict[str, int] = {}

    def _read(self, symbol: str) -> int:
        return _eager_launches.get(symbol, 0) - self._base.get(symbol, 0)

    def __getitem__(self, name: str) -> int:
        if not self._holds(name):
            return 0
        return self._read(name) + self._read(name + "_batch")

    def clear(self) -> None:
        self._base = dict(_eager_launches)


class CountedLaunches:
    """A kernel wrapper whose ``launches`` is an int: the eager launches of ``symbols``,
    read from the registry; setting it sets what it reads now (``wrapper.launches = 0``)."""

    def __init__(self, fn: Callable, symbols: Sequence[str]):
        functools.update_wrapper(self, fn)
        self._symbols = tuple(symbols)
        self._base = 0

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    @property
    def launches(self) -> int:
        return sum(_eager_launches.get(s, 0) for s in self._symbols) - self._base

    @launches.setter
    def launches(self, value: int) -> None:
        self._base = sum(_eager_launches.get(s, 0) for s in self._symbols) - int(value)


def counted_launches(*symbols: str):
    """Decorate a kernel wrapper whose launches of ``symbols`` count in an int ``launches``."""
    return lambda fn: CountedLaunches(fn, symbols)


# ---------------------------------------------------------------------------
# The capture map: a graph's nodes by span
# ---------------------------------------------------------------------------

KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}  # CUgraphNodeType; any other is "other"


@dataclasses.dataclass(frozen=True)
class MapNode:
    """A node of a captured graph: the span path it was captured under (``tick.capture`` for
    none), its kind, libcuda's (mangled) kernel name and the function's own name in it."""

    span: str
    kind: str
    name: Optional[str] = None
    base: Optional[str] = None


@dataclasses.dataclass
class SpanMap:
    """The nodes of a captured graph in the order the capture made them (the order a replay
    runs them: the tick's work is captured on one stream), the launches of each hand kernel
    it captured, and the replays run so far."""

    nodes: List[MapNode] = dataclasses.field(default_factory=list)
    launches: Dict[str, int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))
    replays: int = 0

    def visible(self) -> List[MapNode]:
        """The nodes a device trace shows an activity for: kernels, copies and fills."""
        return [n for n in self.nodes if n.kind != "other"]


MAX_MAPS = 64
_maps: "collections.OrderedDict[int, SpanMap]" = collections.OrderedDict()
_retired_launches: Dict[str, int] = collections.defaultdict(int)
_retired_replays = 0
_map_ids = itertools.count()


def register(span_map: SpanMap) -> SpanMap:
    """Keep ``span_map`` in the registry; the oldest leaves past :data:`MAX_MAPS`, its replays
    and replayed launches kept in ``tick.replays`` and ``kernel.launches``."""
    global _retired_replays
    _maps[next(_map_ids)] = span_map
    while len(_maps) > MAX_MAPS:
        _, old = _maps.popitem(last=False)
        _retired_replays += old.replays
        for symbol, n in old.launches.items():
            _retired_launches[symbol] += n * old.replays
    return span_map


def graph_maps() -> List[SpanMap]:
    """The maps of the graphs captured in the process (the last :data:`MAX_MAPS`), oldest
    first."""
    return list(_maps.values())


def base_name(symbol: Optional[str]) -> Optional[str]:
    """The function's own name in a mangled kernel name, as its demangled form holds it.

    ``_ZN5fused18fused_solve_kernelIN6racing5ModelEEEv...`` gives
    ``fused_solve_kernel``; an unmangled name is itself; None where the name
    cannot be read.
    """
    if not symbol:
        return None
    if not symbol.startswith("_Z"):
        return symbol
    s, i, last = symbol, 2, None
    if s.startswith("L", i):
        i += 1
    nested = s.startswith("N", i)
    if nested:
        i += 1
        while i < len(s) and s[i] in "rVKRO":
            i += 1
    while i < len(s):
        if s[i].isdigit():
            j = i
            while j < len(s) and s[j].isdigit():
                j += 1
            n = int(s[i:j])
            last, i = s[j:j + n], j + n
            if not nested:
                break
        elif s.startswith("St", i):
            i += 2
        elif s[i] == "S":
            j = s.find("_", i)
            if j < 0:
                return None
            i = j + 1
        else:
            break
    return last or None


class _Libcuda:
    """The libcuda calls the capture map makes, through ``ctypes``."""

    class _KernelParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p)] + [
            (f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx", "by", "bz", "smem")] + [
            ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
            ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    _P = ctypes.POINTER
    # each call's argument types; every one returns a CUresult
    SYMBOLS = {
        "cuStreamGetCaptureInfo_v2": [ctypes.c_void_p, _P(ctypes.c_int), _P(ctypes.c_uint64),
                                      _P(ctypes.c_void_p), _P(ctypes.c_void_p),
                                      _P(ctypes.c_size_t)],
        "cuGraphGetNodes": [ctypes.c_void_p, ctypes.c_void_p, _P(ctypes.c_size_t)],
        "cuGraphNodeGetType": [ctypes.c_void_p, _P(ctypes.c_int)],
        "cuGraphKernelNodeGetParams_v2": [ctypes.c_void_p, _P(_KernelParams)],
        "cuKernelGetFunction": [_P(ctypes.c_void_p), ctypes.c_void_p],
        "cuFuncGetName": [_P(ctypes.c_char_p), ctypes.c_void_p],
    }

    def __init__(self, lib=None):
        lib = ctypes.CDLL("libcuda.so.1") if lib is None else lib
        for symbol, argtypes in self.SYMBOLS.items():
            try:
                fn = getattr(lib, symbol)
            except AttributeError:
                raise RuntimeError(f"libcuda has no {symbol}, which the capture map reads; "
                                   f"a driver of CUDA 12.0 or later has it") from None
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            setattr(self, symbol, fn)

    def _check(self, err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    def capture_graph(self, stream: int) -> int:
        """The graph a stream is capturing into."""
        status, cid, graph = ctypes.c_int(), ctypes.c_uint64(), ctypes.c_void_p()
        deps, ndeps = ctypes.c_void_p(), ctypes.c_size_t()
        self._check(self.cuStreamGetCaptureInfo_v2(
            ctypes.c_void_p(stream), ctypes.byref(status), ctypes.byref(cid),
            ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(ndeps)),
            "cuStreamGetCaptureInfo")
        if status.value != 1 or not graph.value:
            raise RuntimeError("the stream is not capturing")
        return graph.value

    def node_count(self, graph: int) -> int:
        n = ctypes.c_size_t(0)
        self._check(self.cuGraphGetNodes(ctypes.c_void_p(graph), None, ctypes.byref(n)),
                    "cuGraphGetNodes")
        return n.value

    def nodes(self, graph: int) -> List[Tuple[str, Optional[str]]]:
        """``(kind, kernel name or None)`` of every node, in libcuda's order."""
        n = ctypes.c_size_t(self.node_count(graph))
        handles = (ctypes.c_void_p * n.value)()
        self._check(self.cuGraphGetNodes(ctypes.c_void_p(graph), handles, ctypes.byref(n)),
                    "cuGraphGetNodes")
        out = []
        for h in handles[:n.value]:
            kind = ctypes.c_int()
            self._check(self.cuGraphNodeGetType(ctypes.c_void_p(h), ctypes.byref(kind)),
                        "cuGraphNodeGetType")
            kind = KINDS.get(kind.value, "other")
            out.append((kind, self._kernel_name(h) if kind == "kernel" else None))
        return out

    def _kernel_name(self, node) -> Optional[str]:
        params = self._KernelParams()
        if self.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)):
            return None
        func = params.func
        if not func and params.kern:
            f = ctypes.c_void_p()
            if self.cuKernelGetFunction(ctypes.byref(f), ctypes.c_void_p(params.kern)):
                return None
            func = f.value
        name = ctypes.c_char_p()
        if not func or self.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)):
            return None
        return name.value.decode() if name.value else None


_libcuda: Optional[_Libcuda] = None


def libcuda() -> _Libcuda:
    """libcuda's calls for the capture map, resolved at the first call: make it before a
    capture, so that a driver that lacks one fails outside it."""
    global _libcuda
    if _libcuda is None:
        _libcuda = _Libcuda()
    return _libcuda


class _Capture:
    """A capture under way: the node count at each span boundary inside it."""

    def __init__(self, api, graph: int):
        self.api, self.graph = api, graph
        self.marks: List[Tuple[int, bool, int]] = []  # (nodes so far, opening, span code)
        self.map = SpanMap()

    def mark(self, opening: bool, code: int = -1) -> None:
        self.marks.append((self.api.node_count(self.graph), opening, code))

    def finish(self) -> None:
        listed = self.api.nodes(self.graph)
        stack: List[str] = []
        path, made = ROOT, 0
        for upto, opening, code in self.marks + [(len(listed), None, -1)]:
            for kind, name in listed[made:upto]:
                self.map.nodes.append(MapNode(path, kind, name, base_name(name)))
            made = max(made, upto)
            if opening is None:
                break
            if opening:
                stack.append(_names[code])
            elif stack:
                stack.pop()
            path = "/".join(stack) or ROOT


@contextlib.contextmanager
def mapping(stream: int, api=None):
    """Inside a CUDA graph's capture on ``stream`` (a ``cudaStream_t``): yields the
    :class:`SpanMap` the capture fills, registered once the block ends without raising.

    ``api`` stands in for libcuda's calls (``capture_graph``,
    ``node_count``, ``nodes``); None is the card's (:func:`libcuda`).
    """
    api = libcuda() if api is None else api
    cap = _Capture(api, api.capture_graph(stream))
    if _state.capture is not None:
        raise RuntimeError("a capture map is already being made")
    _state.capture = cap
    try:
        yield cap.map
        cap.finish()
    finally:
        _state.capture = None
    register(cap.map)


# ---------------------------------------------------------------------------
# Device time by span: a trace's replays matched against the capture maps
# ---------------------------------------------------------------------------

Activity = Tuple[str, float, float]  # name, start us, end us


def activity_kind(name: str) -> str:
    """What graph node an activity of a device trace comes from: a copy (``Memcpy ...``, or
    the ``memcpy32_post`` kernel a graph's copy runs as), a fill, or a kernel."""
    low = name[:6].lower()
    return "memcpy" if low == "memcpy" else "memset" if low == "memset" else "kernel"


def _fits(node: MapNode, activity: Activity) -> bool:
    if activity_kind(activity[0]) != node.kind:
        return False
    return node.kind != "kernel" or node.base is None or node.base in activity[0]


def attribute(activities: Sequence[Activity], maps: Optional[Sequence[SpanMap]] = None
              ) -> Optional[dict]:
    """Charge a device trace's activities to the port's spans through the capture maps.

    A replay is a run of ``activities``, in start order, that matches a
    map's whole visible node sequence by kind, and a kernel node by its
    function's name where the map has it; every activity of a match is
    charged to its node's span path.  What matches no map whole is
    unattributed.  ``maps`` defaults to the registry's.  Returns ``us_per_tick``
    (device us by span path over the replays matched), ``replays``,
    ``attributed_share`` (of the activities' device time) and the totals; None
    for no activities.
    """
    if not activities:
        return None
    maps = graph_maps() if maps is None else maps
    seqs = sorted((m.visible() for m in maps), key=len, reverse=True)
    seqs = [s for s in seqs if s]
    acts = sorted(activities, key=lambda a: a[1])
    total = sum(e - s for _, s, e in acts)
    by_span: Dict[str, float] = collections.defaultdict(float)
    replays, attributed, i = 0, 0.0, 0
    while i < len(acts):
        for seq in seqs:
            if i + len(seq) <= len(acts) and all(
                    _fits(node, acts[i + j]) for j, node in enumerate(seq)):
                for j, node in enumerate(seq):
                    us = acts[i + j][2] - acts[i + j][1]
                    by_span[node.span] += us
                    attributed += us
                replays += 1
                i += len(seq)
                break
        else:
            i += 1
    per_tick = {k: v / replays for k, v in sorted(by_span.items())} if replays else {}
    return {"us_per_tick": per_tick, "replays": replays,
            "attributed_share": attributed / total if total > 0 else 0.0,
            "attributed_us": attributed, "device_us": total}


def under(us_per_tick: Dict[str, float], span: str) -> float:
    """The device us a tick of every path that passes through ``span``."""
    return sum(v for k, v in us_per_tick.items() if span in k.split("/"))
