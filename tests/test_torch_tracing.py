"""The port's spans, counters and capture map (``utils/timing``), and the metrics reading them.

CPU tests, in seconds: spans nest with their parent and tick, and the ring
wraps without growing; under a CPU ``torch.profiler`` every span is a range
of its name on the profiler's clock; each counter moves once per event; the
capture map assigns each node to the span it was captured under (a stand-in
for libcuda); the attribution of a device trace to spans is exact on synthetic
activities and charges nothing it cannot match; each ``portbench`` metric
that reads the spans gives a number on a synthetic reading and None where
its data is missing.  The test marked ``cuda`` runs on the card::

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -q

It holds the flagship tick's capture map against libcuda's own node list
and a profiled replay, and the launch counts against the map.
"""

import ctypes
import time
import types

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch.core.closed_loop import make_closed_loop
from mppi_playground_tpu_torch.core.config import MPPIConfig
from mppi_playground_tpu_torch.core.solver import make_solver
from mppi_playground_tpu_torch.models import pendulum
from mppi_playground_tpu_torch.ops import fused_solve, lambda_search, weighted_update
from mppi_playground_tpu_torch.utils import timing
from portbench import harness
from portbench.tracing import Reading, Slice

OUTER, INNER = timing.Span("test.outer"), timing.Span("test.inner")
LEAF = timing.Span("test.leaf")


def _names(records):
    return [r.name for r in records]


class Clock:
    """A stand-in for the spans' clock: it reads what the test set."""

    t = 0

    def __call__(self):
        return self.t


@pytest.fixture
def ring(monkeypatch):
    """An empty ring of the test's own, on a clock the test sets."""
    for column in ("_parent", "_code_of", "_tick", "_start", "_end"):
        monkeypatch.setattr(timing, column, [-1] * timing.RING_SIZE)
    state = timing._State()
    state.depth = state.opened = state.profiled = 0
    state.capture = None
    monkeypatch.setattr(timing, "_state", state)
    clock = Clock()
    monkeypatch.setattr(timing, "_clock", clock)
    return clock


def _write(clock, name, start, end, tick=None, inner=()):
    """The span ``name`` from ``start`` to ``end`` (ns on the clock), ``inner`` inside it."""
    clock.t = start
    timing.open_span(timing.Span(name).code, tick)
    for span in inner:
        _write(clock, *span)
    clock.t = end
    timing.close_span()


def test_spans_nest_with_their_parent_and_tick():
    first = timing.opened()
    with OUTER(41):
        with INNER:
            with LEAF:
                pass
        with LEAF:
            pass
    with INNER:
        pass
    got = timing.spans(since=first)
    assert _names(got) == ["test.outer", "test.inner", "test.leaf", "test.leaf", "test.inner"]
    outer, inner, leaf, leaf2, alone = got
    assert outer.parent == -1 and inner.parent == outer.id and leaf.parent == inner.id
    assert leaf2.parent == outer.id and alone.parent == -1
    assert [r.id for r in got] == list(range(first, first + 5))
    assert [r.tick for r in got] == [41, 41, 41, 41, -1]
    assert outer.start_ns <= inner.start_ns <= leaf.start_ns <= leaf.end_ns <= inner.end_ns
    assert inner.end_ns <= leaf2.start_ns <= leaf2.end_ns <= outer.end_ns <= alone.start_ns
    assert not any(r.profiled for r in got)
    assert abs(outer.start_ns - time.time_ns()) < 10**9  # the Unix-epoch clock


def test_an_open_span_is_not_listed_until_it_closes(ring):
    ring.t = 100
    timing.open_span(OUTER.code, 3)
    _write(ring, "test.inner", 150, 250)
    assert _names(timing.spans()) == ["test.inner"]
    ring.t = 300
    timing.close_span()
    assert [(r.name, r.start_ns - timing.CLOCK_OFFSET_NS, r.end_ns - timing.CLOCK_OFFSET_NS)
            for r in timing.spans()] == [("test.outer", 100, 300), ("test.inner", 150, 250)]
    timing.close_span()  # one close too many records nothing
    assert timing.opened() == 2 and timing._state.depth == 0


def test_a_written_span_is_a_leaf_of_the_open_span(ring):
    ring.t = 100
    timing.open_span(OUTER.code, 9)
    ring.t = 110
    start = timing.begin(INNER.code)
    ring.t = 120
    end = timing.end()
    _write(ring, "test.leaf", 130, 140)
    timing.write(INNER.code, start, end)  # after the launch it waited for
    ring.t = 200
    timing.close_span()
    timing.write(LEAF.code, 210, 220)  # outside any span
    got = timing.spans()
    assert _names(got) == ["test.outer", "test.leaf", "test.inner", "test.leaf"]
    outer, leaf, inner, alone = got
    assert inner.parent == leaf.parent == outer.id and (inner.tick, leaf.tick) == (9, 9)
    assert (inner.start_ns - outer.start_ns, inner.us) == (10, 0.01)
    assert alone.parent == alone.tick == -1 and not any(r.profiled for r in got)


def test_the_ring_wraps_without_growing(ring):
    for i in range(timing.RING_SIZE + 10):
        ring.t += 10
        with OUTER(i):
            ring.t += 5
    got = timing.spans()
    assert len(got) == timing.RING_SIZE
    assert all(len(getattr(timing, c)) == timing.RING_SIZE
               for c in ("_parent", "_code_of", "_tick", "_start", "_end"))
    assert got[0].tick == 10 and got[-1].tick == timing.RING_SIZE + 9
    assert all(r.us == pytest.approx(0.005) for r in got)
    assert timing.opened() == timing.RING_SIZE + 10


def test_a_span_the_ring_overwrote_while_open_records_nothing(ring):
    timing.open_span(OUTER.code, 1)
    for _ in range(timing.RING_SIZE):
        _write(ring, "test.inner", ring.t + 1, ring.t + 2)
    ring.t += 10
    timing.close_span()  # its slot holds the last inner span, which keeps its end
    got = timing.spans()
    assert len(got) == timing.RING_SIZE and "test.outer" not in _names(got)
    assert all(r.name == "test.inner" and r.tick == 1 and r.us == 0.001 for r in got)


def test_the_spans_after_a_profiled_slice_outlive_the_ring_wrapping(ring):
    from torch.profiler import ProfilerActivity, profile

    assert timing.after_profiling() is None  # nothing was profiled
    with profile(activities=[ProfilerActivity.CPU]):
        with OUTER(0):
            pass
    assert timing.after_profiling() == []
    for i in range(timing.RING_SIZE + 10):
        with INNER(i + 1):
            pass
    got = timing.after_profiling()
    assert len(got) == timing.RING_SIZE and not any(r.profiled for r in got)
    assert got[-1].tick == timing.RING_SIZE + 10


def test_spans_are_ranges_of_a_cpu_profiler_on_its_clock():
    from torch.profiler import ProfilerActivity, profile

    first = timing.opened()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with OUTER:  # a first call, not held to the clock
            pass
        for i in range(5):
            with INNER(i):
                if i % 2:
                    with LEAF:
                        pass
                else:
                    start = timing.begin(LEAF.code)
                    timing.write(LEAF.code, start, timing.end())
    ours = sorted((r for r in timing.spans(since=first) if r.tick >= 0),
                  key=lambda r: r.start_ns)
    assert len(ours) == 10 and all(r.profiled for r in ours)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in ("test.inner", "test.leaf")]
    # host operations, not user annotations (which a trace lays over the device's timeline too)
    assert {e.activity_type() for e in events} == {"cpu_op"}
    theirs = sorted((e.start_ns(), e.name()) for e in events)
    assert [n for _, n in theirs] == _names(ours)
    for (start, _), r in zip(theirs, ours):
        assert abs(start - r.start_ns) < 200_000, (start, r)
    # with the profiler gone, spans are plain again
    with OUTER:
        pass
    assert not timing.spans(since=timing.opened() - 1)[0].profiled


def test_profile_trace_writes_the_spans_beside_the_trace(tmp_path):
    with timing.profile_trace(str(tmp_path)):
        with OUTER(7):
            pass
    lines = (tmp_path / "spans.json").read_text().splitlines()
    assert (tmp_path / "trace.json").exists() and any('"test.outer"' in x for x in lines)


def test_tick_eager_counts_once_per_eager_tick():
    config = MPPIConfig(horizon=5, num_samples=64, dim_state=2, dim_control=1, u_min=(-2.0,),
                        u_max=(2.0,), sigmas=(1.0,), lambda_=1.0, store_rollouts=False)
    solver = make_solver(config, pendulum.dynamics, pendulum.cost, device="cpu")
    run = make_closed_loop(solver, lambda x, u: pendulum.dynamics(x[None], u[None])[0], 3)
    before, first = timing.counter("tick.eager"), timing.opened()
    run(solver.init(), torch.tensor([3.0, 0.0]))
    assert timing.counter("tick.eager") == before + 3
    got = timing.spans(since=first)
    episode = [r for r in got if r.name == "facade.episode"]
    assert len(episode) == 1 and episode[0].tick == 0
    eager = [r for r in got if r.name == "tick.eager"]
    assert len(eager) == 3 and all(r.parent == episode[0].id for r in eager)
    solves = [r for r in got if r.name == "solver.solve"]
    assert len(solves) == 3 and {r.parent for r in solves} == {r.id for r in eager}
    assert {r.name for r in got} >= {"solver.rollout", "solver.tail"}


def test_a_map_change_counts_one_rebuild():
    from mppi_playground_tpu_torch.envs import RacingController, RacingEnv

    env = RacingEnv(device="cpu")
    ctrl = RacingController(env, horizon=5, num_samples=64)
    x = env.reset()
    ctrl.update(x)
    before, first = timing.counter("solver.rebuilds"), timing.opened()
    ctrl.update(x)
    assert timing.counter("solver.rebuilds") == before
    env.obstacle_map.add_circle_obstacle(np.array([30.0, 30.0]), 1.0)
    ctrl.update(x)
    assert timing.counter("solver.rebuilds") == before + 1
    got = timing.spans(since=first)
    updates = [r for r in got if r.name == "facade.update"]
    assert [r.tick for r in updates] == [1, 2]
    rebuild = [r for r in got if r.name == "facade.rebuild"]
    assert len(rebuild) == 1 and rebuild[0].parent == updates[1].id
    rows = [r for r in got if r.name == "solver.reference_rows"]
    assert len(rows) == 2 and all(r.tick in (1, 2) for r in rows)


def test_a_launch_counts_once_in_the_registry_and_in_the_wrappers_views():
    symbol = "racing_fused_solve_batch"
    solve_before = fused_solve.fused_solve.launches["racing_fused_solve"]
    eager_before = timing.launches().get(symbol, 0)
    timing.count_launch(symbol, 1)
    assert timing.launches()[symbol] == eager_before + 1
    assert fused_solve.fused_solve.launches["racing_fused_solve"] == solve_before + 1
    assert fused_solve.fused_tick_tail.launches["racing_fused_solve"] == 0  # not its kernel
    fused_solve.fused_solve.launches.clear()
    assert fused_solve.fused_solve.launches["racing_fused_solve"] == 0
    assert timing.launches()[symbol] == eager_before + 1  # the registry is not cleared
    for wrapper, symbol in ((lambda_search.essps_lambda_fused, "essps_search_batch"),
                            (weighted_update.weighted_update_partials, "weighted_update_batch")):
        before = wrapper.launches
        timing.count_launch(symbol, 1)
        assert wrapper.launches == before + 1
        wrapper.launches = 0
        assert wrapper.launches == 0
    assert lambda_search.essps_lambda_fused.__name__ == "essps_lambda_fused"


class FakeLibcuda:
    """libcuda's capture calls over a list the test adds nodes to."""

    def __init__(self):
        self.listed = []

    def capture_graph(self, stream):
        return 1

    def node_count(self, graph):
        return len(self.listed)

    def nodes(self, graph):
        return list(self.listed)


def test_the_capture_map_puts_each_node_under_its_span_and_counts_captured_launches():
    drv = FakeLibcuda()
    solve, kernel = timing.Span("solver.solve"), timing.kernel_span("racing_fused_solve_batch")
    before = len(timing.graph_maps())
    with timing.mapping(0, api=drv) as span_map:
        drv.listed.append(("memcpy", None))
        with solve:
            drv.listed.append(("kernel", "_ZN2at6native18elementwise_kernelILi128EEEvi"))
            with kernel:
                drv.listed.append(("kernel", "_ZN5fused18fused_solve_kernelIN6racing5ModelEEEvv"))
                timing.count_launch("racing_fused_solve_batch", 0)
            drv.listed.append(("other", None))
        drv.listed.append(("kernel", "_ZN2at6native29vectorized_elementwise_kernelILi4EEEvi"))
    assert [(n.span, n.kind, n.base) for n in span_map.nodes] == [
        ("tick.capture", "memcpy", None),
        ("solver.solve", "kernel", "elementwise_kernel"),
        ("solver.solve/kernel.racing_fused_solve_batch", "kernel", "fused_solve_kernel"),
        ("solver.solve", "other", None),
        ("tick.capture", "kernel", "vectorized_elementwise_kernel")]
    assert dict(span_map.launches) == {"racing_fused_solve_batch": 1}
    assert len(span_map.visible()) == 4
    assert len(timing.graph_maps()) == before + 1 and timing.graph_maps()[-1] is span_map
    eager = timing.launches().get("racing_fused_solve_batch", 0)
    span_map.replays += 3
    assert timing.launches()["racing_fused_solve_batch"] == eager + 3


class FakeDriver:
    """libcuda's six calls as C callbacks over a graph of three nodes: a kernel named through
    its function, a copy, and a kernel named through its library kernel."""

    NAMES = {0x10: ctypes.c_char_p(b"_ZN5fused18fused_solve_kernelIN6racing5ModelEEEvv"),
             0x30: ctypes.c_char_p(b"memcpy32_post")}

    def __init__(self):
        args = timing._Libcuda.SYMBOLS
        for name, impl in (("cuStreamGetCaptureInfo_v2", self.capture_info),
                           ("cuGraphGetNodes", self.get_nodes),
                           ("cuGraphNodeGetType", self.node_type),
                           ("cuGraphKernelNodeGetParams_v2", self.kernel_params),
                           ("cuKernelGetFunction", self.kernel_function),
                           ("cuFuncGetName", self.func_name)):
            setattr(self, name, ctypes.CFUNCTYPE(ctypes.c_int, *args[name])(impl))

    def capture_info(self, stream, status, cid, graph, deps, ndeps):
        status[0], graph[0] = 1, 0x1234
        return 0

    def get_nodes(self, graph, nodes, n):
        if nodes:
            out = ctypes.cast(nodes, ctypes.POINTER(ctypes.c_void_p))
            for i in range(3):
                out[i] = i + 1
        n[0] = 3
        return 0

    def node_type(self, node, kind):
        kind[0] = 1 if node == 2 else 0
        return 0

    def kernel_params(self, node, params):
        params[0].func, params[0].kern = (0x10, None) if node == 1 else (None, 0x20)
        return 0

    def kernel_function(self, func, kernel):
        func[0] = 0x30 if kernel == 0x20 else 0
        return 0

    def func_name(self, name, func):
        name[0] = self.NAMES[func]
        return 0


def test_the_capture_maps_driver_calls_pass_their_declared_arguments():
    api = timing._Libcuda(FakeDriver())
    graph = api.capture_graph(7)
    assert graph == 0x1234 and api.node_count(graph) == 3
    assert api.nodes(graph) == [("kernel", "_ZN5fused18fused_solve_kernelIN6racing5ModelEEEvv"),
                                ("memcpy", None), ("kernel", "memcpy32_post")]
    with pytest.raises(RuntimeError, match="libcuda has no cuFuncGetName"):
        timing._Libcuda(types.SimpleNamespace(**{
            k: v for k, v in vars(FakeDriver()).items() if k != "cuFuncGetName"}))


@pytest.mark.parametrize("mangled, demangled", [
    ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_15CUDAFunctor_addIfEESt5arrayIPcLm3"
     "EEEEviT0_T1_", "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor"
     "_add<float>, std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>"),
    ("_ZN2at6native40_GLOBAL__N__0f1a8107_8_Shape_cu_49f7391c35CatArrayBatchedCopy_alignedK_contig"
     "INS1_10OpaqueTypeILj4EEEjLi1ELi128ELi1ELi16EEEvPT_", "void at::native::(anonymous namespace)"
     "::CatArrayBatchedCopy_alignedK_contig<at::native::(anonymous namespace)::OpaqueType<4u>"),
    ("_ZN2at6native24index_elementwise_kernelILi128ELi4EZNS0_22index_copy_kernel_implINS0_10"
     "OpaqueTypeILi4EEEEEvRNS_14TensorIteratorElllEUliE_EEvlT1_", "void at::native::index_"
     "elementwise_kernel<128, 4, at::native::index_copy_kernel_impl<at::native::OpaqueType<4> >"),
    ("_ZN5fused18fused_solve_kernelIN6racing5ModelEEEvNS_6ParamsIT_EEi",
     "void fused::fused_solve_kernel<racing::Model>(fused::Params<racing::Model>, int)"),
    ("_ZN12_GLOBAL__N_113search_kernelILb0EEEvPKfifffiPf", "void (anonymous namespace)::"
     "search_kernel<false>(float const*, int, float, float, float, int, float*)"),
    ("_ZN12_GLOBAL__N_115weighted_kernelEPKfS1_S1_iiPfS2_", "(anonymous namespace)::weighted_"
     "kernel(float const*, float const*, float const*, int, int, float*, float*)"),
    ("memcpy32_post", "memcpy32_post"),
])
def test_a_kernel_names_base_is_in_its_demangled_name(mangled, demangled):
    base = timing.base_name(mangled)
    assert base and base in demangled


def _fake_map():
    return timing.SpanMap(nodes=[
        timing.MapNode("solver.reference_rows", "kernel", "x", "reduce_kernel"),
        timing.MapNode("solver.reference_rows", "kernel", "x", "index_kernel"),
        timing.MapNode("solver.solve", "other"),
        timing.MapNode("solver.solve/kernel.racing_fused_solve_batch", "kernel", "x",
                       "fused_solve_kernel"),
        timing.MapNode("tick.capture", "memcpy"),
    ])


def _replay(t0, gap=0.0):
    return [("void at::native::reduce_kernel<512>(...)", t0, t0 + 2.0),
            ("void at::native::index_kernel<4>(...)", t0 + 2.0 + gap, t0 + 5.0 + gap),
            ("void fused::fused_solve_kernel<racing::Model>(...)", t0 + 5.0 + gap, t0 + 85.0),
            ("memcpy32_post", t0 + 85.0, t0 + 86.0)]


def test_attribution_charges_three_replays_among_foreign_activities_exactly():
    foreign = [("Memcpy HtoD (Pageable -> Device)", 0.0, 1.0),
               ("void at::native::reduce_kernel<512>(...)", 200.0, 203.0),
               ("void at::native::elementwise_kernel<128>(...)", 400.0, 410.0)]
    acts = foreign + _replay(100.0) + _replay(300.0) + _replay(500.0)
    got = timing.attribute(list(reversed(acts)), [_fake_map()])
    assert got["replays"] == 3
    assert got["us_per_tick"] == {"solver.reference_rows": 5.0,
                                  "solver.solve/kernel.racing_fused_solve_batch": 80.0,
                                  "tick.capture": 1.0}
    assert got["attributed_us"] == 258.0 and got["device_us"] == 272.0
    assert got["attributed_share"] == pytest.approx(258.0 / 272.0)
    assert timing.under(got["us_per_tick"], "solver.reference_rows") == 5.0
    assert timing.under(got["us_per_tick"], "solver.solve") == 80.0


def test_a_replay_missing_a_node_is_left_unattributed():
    broken = [a for i, a in enumerate(_replay(300.0)) if i != 1]
    got = timing.attribute(_replay(100.0) + broken, [_fake_map()])
    assert got["replays"] == 1 and got["attributed_us"] == 86.0
    assert got["device_us"] == 86.0 + 83.0
    renamed = [(("void at::native::other_kernel<512>(...)" if i == 0 else a[0]), a[1], a[2])
               for i, a in enumerate(_replay(300.0))]
    assert timing.attribute(renamed, [_fake_map()])["replays"] == 0


def test_attribution_of_nothing_is_none():
    assert timing.attribute([], [_fake_map()]) is None
    assert timing.attribute(_replay(0.0), [])["replays"] == 0


def _reading(device=(), ticks=3):
    sl = Slice(device=list(device), host=[], start=0.0, end=1000.0, ticks=ticks, spans={})
    return Reading(sl, solver={}, scene={}, traffic={}, card={})


def _window(clock):
    """A profiled tick, then two window ticks: one replayed, one captured."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        _write(clock, "facade.update", 0, 100_000, 5, [("tick.replay", 10_000, 20_000)])
    _write(clock, "facade.update", 200_000, 260_000, 6, [
        ("tick.copy_in", 205_000, 210_000), ("tick.replay", 210_000, 240_000),
        ("tick.copy_out", 240_000, 250_000)])
    _write(clock, "env.dynamics", 270_000, 290_000)
    _write(clock, "facade.update", 300_000, 400_000, 7, [
        ("tick.copy_in", 305_000, 310_000), ("tick.capture", 310_000, 380_000)])


@pytest.mark.parametrize("metric, want", [
    ("graph_launch_us.control", 30.0),  # the one window replay
    ("facade_self_us.control", (15.0 + 25.0) / 2),
    ("graph_misses.control", 50.0),
])
def test_span_metrics_read_the_window_after_the_profiled_slice(metric, want, ring):
    read = harness.reader(metric)
    assert read(_reading()) is None  # no spans
    _write(ring, "facade.update", 0, 10_000, 4)
    assert read(_reading()) is None  # spans, but no profiled slice
    _window(ring)
    got = read(_reading())
    assert got["value"] == pytest.approx(want)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _write(ring, "facade.update", 500_000, 510_000, 8)
    assert read(_reading()) is None  # nothing after the slice


@pytest.mark.parametrize("metric", ["ref_rows_us.control", "ref_rows_us.fleet"])
def test_the_reference_rows_metrics_read_the_capture_maps(metric, monkeypatch):
    read = harness.reader(metric)
    monkeypatch.setattr(timing, "_maps", {0: _fake_map()})
    got = read(_reading(_replay(100.0) + _replay(300.0), ticks=2))
    assert got["value"] == 5.0 and got["replays_matched"] == 2 and got["ticks_in_slice"] == 2
    assert got["us_per_tick"]["solver.solve/kernel.racing_fused_solve_batch"] == 80.0
    assert got["attributed_share"] == 1.0
    assert read(_reading([("void at::native::other_kernel<1>(...)", 0.0, 1.0)])) is None
    monkeypatch.setattr(timing, "_maps", {})
    assert read(_reading(_replay(100.0))) is None


@pytest.mark.cuda
def test_the_flagship_ticks_capture_map_is_the_graph_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; portbench's traced runs read the map there")
    from torch.profiler import ProfilerActivity, profile

    from mppi_playground_tpu_torch.envs import RacingController, RacingEnv

    env = RacingEnv(device="cuda")
    ctrl = RacingController(env, horizon=50, num_samples=100_000, store_rollouts=False)
    x = env.reset()
    ctrl.update(x)  # eager, then the capture
    graph = ctrl._ticks.graph
    span_map = graph.span_map
    n = ctypes.c_size_t(0)
    lib = ctypes.CDLL("libcuda.so.1")
    assert lib.cuGraphGetNodes(ctypes.c_void_p(graph.graph.raw_cuda_graph()), None,
                               ctypes.byref(n)) == 0
    assert len(span_map.nodes) == n.value > 0
    leaves = {node.span for node in span_map.nodes}  # one path a node: its leaf, or the root
    assert all(all(part in timing._codes for part in path.split("/")) for path in leaves)
    assert any("solver.reference_rows" in p.split("/") for p in leaves)
    assert "solver.solve/kernel.racing_fused_solve_batch" in leaves
    assert dict(span_map.launches) == {"reference_rows": 1, "racing_fused_solve_batch": 1,
                                       "racing_tick_tail_batch": 1}
    assert "solver.reference_rows/kernel.reference_rows" in leaves
    before = timing.launches()
    replays = 5
    for _ in range(replays):
        ctrl.update(x)
    torch.cuda.synchronize()
    after = timing.launches()
    for symbol, captured in span_map.launches.items():
        assert after[symbol] - before[symbol] == replays * captured
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(200):  # the trace drops its first device activities: prime it
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(0.2)
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    acts = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == cuda and "sleep" not in e.name and "spin_kernel" not in e.name]
    got = timing.attribute(acts, [span_map])  # the map's order is the order a replay runs
    assert got["replays"] == 3 and got["attributed_share"] == 1.0
