"""The unfused route's MPCC stage cost: the kernel's wrapper, the route, its vmap rule, and the
kernel on the card.

On the CPU: ``make_mpcc_cost`` takes the torch ops of ``make_mpcc_cost_plain``
for states on the CPU, float32 and float64 alike and with feature maps, and
launches nothing; under ``torch.func.vmap`` the route's rule folds the vmapped
dimension into groups, bit for bit a loop over the batch (batched, broadcast
or expanded states, a batched reference and previous action, another
dimension vmapped, vmaps nested, the columns of a sequence of actions);
states that report themselves on a card take the kernel's wrapper once a call
and no other route, under vmap too, with the groups and each group's
reference row read where they lie; and ``ops/mpcc_cost.mpcc_cost`` raises on
what the kernel does not take (a CPU tensor, a wrong dtype or shape, columns
that are not contiguous, a map it cannot read) and counts no launch.

On the card (marker ``cuda``; no jax, so run them with ``--noconftest``)::

    python -m pytest tests/test_torch_mpcc_cost.py -m cuda --noconftest -q

the kernel is bit for bit the torch ops on the same CUDA tensors, NaN where
they give NaN (``chip_smoke.mpcc_cost_inputs``: each map's first and last
cells, half-cell boundaries, positions far off the maps, NaN and infinite
entries), one launch a call: at R = 1, 32 and 4,000; each edge row alone; on
two maps of other origins, cell sizes and strides; from an expanded state and
each column of a sequence of actions; vmapped at B=8 x K=4,096, each scenario
against its own reference path; captured in a CUDA graph and replayed with
new inputs.  A float64 state on a card raises.  The launch counter reads T+1
a replayed unfused controller tick and none a fused one.
"""

import types

import pytest
import torch

import chip_smoke
from mppi_playground_tpu_torch.envs import RacingEnv
from mppi_playground_tpu_torch.maps.grid_cost import GridMapData
from mppi_playground_tpu_torch.models.racing_mpcc import (
    QC,
    QDIN,
    QIN,
    QL,
    QO,
    QV,
    make_mpcc_cost,
    make_mpcc_cost_plain,
)
from mppi_playground_tpu_torch.ops import mpcc_cost as cost_module
from mppi_playground_tpu_torch.ops.mpcc_cost import mpcc_cost
from mppi_playground_tpu_torch.utils import timing

WEIGHTS = (QC, QL, QV, QO, QIN, QDIN)


@pytest.fixture(scope="module")
def cpu_env():
    return RacingEnv(device="cpu")


def _maps(env):
    return env.obstacle_cost_map, env.lane_cost_map


def _geometry(env):
    return (tuple(env.obstacle_map.x_lim), tuple(env.obstacle_map.y_lim),
            float(env.obstacle_cost_map.cell_size))


def _inputs(env, rows, seed, dtype=torch.float32, device="cpu"):
    return tuple(t.to(device, dtype) for t in chip_smoke.mpcc_cost_inputs(
        torch, rows, seed, *_geometry(env)))


def _path(env, rows, seed, dtype=torch.float32, device="cpu"):
    x_lim, y_lim, _ = _geometry(env)
    return chip_smoke.mpcc_reference_path(torch, rows, seed, x_lim, y_lim).to(device, dtype)


def _info(path, t, prev):
    return {"reference_path": path, "t": t, "prev_action": prev}


def _launches():
    return timing.launches().get("mpcc_cost", 0)


def _same(got, want):
    assert chip_smoke.same_steps(torch, got, want), (got, want)


# ---------------------------------------------------------------------------
# CPU: the route, the vmap rule, the wrapper's checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype, form", [(torch.float32, "grid"), (torch.float64, "grid"),
                                         (torch.float32, "feature")])
def test_the_route_keeps_the_torch_ops_off_the_card(cpu_env, dtype, form, monkeypatch):
    def no_kernel(*args):
        raise AssertionError("the kernel's wrapper was called for states on the CPU")

    monkeypatch.setattr(cost_module, "mpcc_cost", no_kernel)
    if form == "grid":
        maps = _maps(cpu_env)
        maps = tuple(GridMapData(m.grid.to(dtype), m.origin.to(dtype), m.cell_size) for m in maps)
    else:
        maps = (cpu_env.obstacle_map.feature_map, cpu_env.lane_map.feature_map)
    xs, us, ps = _inputs(cpu_env, 256, seed=1, dtype=dtype)
    path = _path(cpu_env, 6, seed=1, dtype=dtype)
    before = _launches()
    for t in (0, 3, 5):
        got = make_mpcc_cost(*maps)(xs, us, _info(path, t, ps))
        _same(got, make_mpcc_cost_plain(*maps)(xs, us, ps, path[t]))
        assert got.dtype == dtype
    assert _launches() == before


def _loop(fn, args, in_dims):
    batch = next(a.shape[d] for a, d in zip(args, in_dims) if d is not None)
    return torch.stack([fn(*(a if d is None else a.select(d, b) for a, d in zip(args, in_dims)))
                        for b in range(batch)])


@pytest.mark.parametrize("case", ["all", "states_broadcast", "reference_broadcast",
                                  "prev_broadcast", "actions_dim_1", "expanded_state",
                                  "action_columns", "nested"])
def test_the_vmap_rule_is_a_loop_over_the_batch(cpu_env, case):
    """The rule on the CPU: the groups folded, the torch ops on each, unfolded."""
    batch, rows, horizon = 3, 40, 5
    xs, us, ps = (t.reshape(batch, rows, -1) for t in _inputs(cpu_env, batch * rows, seed=2))
    paths = torch.stack([_path(cpu_env, horizon + 1, seed=3 + b) for b in range(batch)])
    _, seqs, _ = _inputs(cpu_env, batch * rows * horizon, seed=4)
    seqs = seqs.reshape(batch, rows, horizon, 2)
    cost = make_mpcc_cost(*_maps(cpu_env))

    def fn(x, u, p, path):
        return cost(x, u, _info(path, 2, p))

    before = _launches()
    if case == "nested":
        grid = xs[:, :, None].expand(batch, rows, 2, 4).transpose(1, 2).contiguous()
        acts = torch.stack([us, us.flip(1)], dim=1)
        nested_paths = torch.stack([paths, paths.flip(0)], dim=1)
        got = torch.func.vmap(torch.func.vmap(fn, in_dims=(0, 0, None, 0)),
                              in_dims=(0, 0, 0, 0))(grid, acts, ps, nested_paths)
        want = torch.stack([_loop(fn, (grid[b], acts[b], ps[b], nested_paths[b]),
                                  (0, 0, None, 0)) for b in range(batch)])
    else:
        call, args, in_dims = {
            "all": (fn, (xs, us, ps, paths), (0, 0, 0, 0)),
            "states_broadcast": (fn, (xs[0], us, ps, paths), (None, 0, 0, 0)),
            "reference_broadcast": (fn, (xs, us, ps, paths[0]), (0, 0, 0, None)),
            "prev_broadcast": (fn, (xs, us, ps[0], paths), (0, 0, None, 0)),
            "actions_dim_1": (fn, (xs, us.transpose(0, 1), ps, paths), (0, 1, 0, 0)),
            "expanded_state": (lambda x0, u, p, path: fn(x0.expand(rows, 4), u, p, path),
                               (xs[:, 0], us, ps, paths), (0, 0, 0, 0)),
            "action_columns": (lambda x0, seq, path: cost(
                x0.expand(rows, 4), seq[:, horizon - 1], _info(path, horizon - 1,
                                                                seq[:, horizon - 2])),
                (xs[:, 0], seqs, paths), (0, 0, 0)),
        }[case]
        got = torch.func.vmap(call, in_dims=in_dims)(*args)
        want = _loop(call, args, in_dims)
    _same(got, want)
    assert _launches() == before


class _OnACard(torch.Tensor):
    """A CPU tensor that reports itself on a CUDA device, so the route takes the kernel."""

    @property
    def is_cuda(self):
        return True


def _fake_kernel(calls, env):
    """The torch ops standing in for the kernel's wrapper, group by group, recording what the
    route gives it."""
    plain = make_mpcc_cost_plain(*_maps(env))

    def kernel(states, actions, prev_actions, reference, obstacle_map, lane_map, weights):
        calls.append((tuple(states.shape), states.stride(), actions.stride(),
                      prev_actions.stride(), tuple(reference.shape), reference.stride(),
                      obstacle_map, lane_map, weights))
        args = [t.as_subclass(torch.Tensor) for t in (states, actions, prev_actions, reference)]
        if states.dim() == 2:
            return plain(*args)
        return torch.stack([plain(*(t[g] for t in args)) for g in range(states.shape[0])])

    return kernel


def test_states_on_a_card_take_the_kernel_once_a_call(cpu_env, monkeypatch):
    """The route on a card, with the torch ops standing in for the kernel: one call of the
    wrapper a cost, the strided and expanded inputs handed over as they lie."""
    calls = []
    monkeypatch.setattr(cost_module, "mpcc_cost", _fake_kernel(calls, cpu_env))
    xs, _, _ = _inputs(cpu_env, 40, seed=5)
    _, seqs, _ = _inputs(cpu_env, 40 * 6, seed=6)
    seqs = seqs.reshape(40, 6, 2)
    path = _path(cpu_env, 7, seed=5)
    x0 = xs[0].as_subclass(_OnACard)
    got = make_mpcc_cost(*_maps(cpu_env))(x0.expand(40, 4), seqs[:, 2], _info(path, 4, seqs[:, 1]))
    _same(got, make_mpcc_cost_plain(*_maps(cpu_env))(xs[0].expand(40, 4), seqs[:, 2],
                                                      seqs[:, 1], path[4]))
    assert calls == [((40, 4), (0, 1), (12, 1), (12, 1), (4,), (1,), *_maps(cpu_env), WEIGHTS)]


def test_the_vmap_rule_hands_a_card_the_groups_as_they_lie(cpu_env, monkeypatch):
    """The rule as ``torch.func.vmap`` calls it on a card (the physical tensors, their vmapped
    dimensions): one call of the kernel for the B groups, an expanded state's, a column of
    actions' and the reference rows' strides kept."""
    calls = []
    monkeypatch.setattr(cost_module, "mpcc_cost", _fake_kernel(calls, cpu_env))
    batch, rows, horizon = 3, 16, 4
    xs, _, _ = _inputs(cpu_env, batch, seed=7)
    _, seqs, _ = _inputs(cpu_env, batch * rows * horizon, seed=8)
    seqs = seqs.reshape(batch, rows, horizon, 2)
    paths = torch.stack([_path(cpu_env, horizon + 1, seed=9 + b) for b in range(batch)])
    plain = make_mpcc_cost_plain(*_maps(cpu_env))
    states = xs.as_subclass(_OnACard)[:, None].expand(batch, rows, 4)
    info = types.SimpleNamespace(batch_size=batch, randomness="error")
    got, out_dim = cost_module._StageCost.vmap(
        info, (0, 1, 0, 0), states, seqs[:, :, 1].transpose(0, 1), seqs[:, :, 0], paths[:, 2],
        plain, *_maps(cpu_env), WEIGHTS)
    assert out_dim == 0
    _same(got, torch.stack([plain(xs[b].expand(rows, 4), seqs[b, :, 1], seqs[b, :, 0],
                                  paths[b, 2]) for b in range(batch)]))
    step = (rows * horizon * 2, horizon * 2, 1)
    assert calls == [((batch, rows, 4), (4, 0, 1), step, step, (batch, 4),
                      ((horizon + 1) * 4, 1), *_maps(cpu_env), WEIGHTS)]
    calls.clear()  # a broadcast reference row: batch stride 0
    got, _ = cost_module._StageCost.vmap(info, (0, 0, None, None), states, seqs[:, :, 1],
                                         seqs[0, :, 0], paths[0, 2], plain, *_maps(cpu_env),
                                         WEIGHTS)
    _same(got, torch.stack([plain(xs[b].expand(rows, 4), seqs[b, :, 1], seqs[0, :, 0],
                                  paths[0, 2]) for b in range(batch)]))
    assert calls[0][3] == (0, horizon * 2, 1) and calls[0][5] == (0, 1)


@pytest.mark.parametrize("dtype, match", [(torch.float32, "CUDA device"),
                                          (torch.float64, "states must be torch.float32")])
def test_states_on_a_card_take_the_kernel_and_no_other_route(cpu_env, dtype, match):
    """No fallback to the torch ops on a card: what the kernel does not take raises."""
    xs, us, ps = _inputs(cpu_env, 8, seed=10, dtype=dtype)
    path = _path(cpu_env, 3, seed=10, dtype=dtype)
    before = _launches()
    with pytest.raises(ValueError, match=match):
        make_mpcc_cost(*_maps(cpu_env))(xs.as_subclass(_OnACard), us, _info(path, 1, ps))
    assert _launches() == before


def _wrapper_args():
    grid = GridMapData(torch.zeros(8, 6), torch.tensor([4.0, 3.0]), 0.5)
    return [torch.zeros(6, 4), torch.zeros(6, 2), torch.zeros(6, 2), torch.zeros(4), grid, grid]


@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA device"),
    ("states_dtype", "states must be torch.float32"),
    ("actions_dtype", "actions must be torch.float32"),
    ("prev_dtype", "prev_actions must be torch.float32"),
    ("reference_dtype", "reference must be torch.float32"),
    ("states_shape", r"states must be \[R, 4\] or \[B, K, 4\]"),
    ("states_rank", r"states must be \[R, 4\] or \[B, K, 4\]"),
    ("actions_shape", r"actions must be \[6, 2\]"),
    ("prev_rows", r"prev_actions must be \[6, 2\]"),
    ("groups_shape", r"actions must be \[2, 3, 2\]"),
    ("reference_shape", r"reference must be \[4\]"),
    ("groups_reference", r"reference must be \[2, 4\]"),
    ("no_rows", "the rows must number 1"),
    ("states_columns", "states must have contiguous columns"),
    ("prev_columns", "prev_actions must have contiguous columns"),
    ("reference_columns", "reference must have contiguous columns"),
    ("grid_dtype", "the obstacle map's grid must be torch.float32"),
    ("origin_dtype", "the lane map's origin must be torch.float32"),
    ("grid_shape", r"the lane map's grid must be a non-empty \[W, H\]"),
    ("grid_empty", r"the obstacle map's grid must be a non-empty \[W, H\]"),
    ("origin_shape", r"the obstacle map's origin must be \[2\]"),
])
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(case, match):
    args = _wrapper_args()
    grid = args[4]
    if case == "states_dtype":
        args[0] = args[0].double()
    elif case == "actions_dtype":
        args[1] = args[1].half()
    elif case == "prev_dtype":
        args[2] = args[2].double()
    elif case == "reference_dtype":
        args[3] = args[3].double()
    elif case == "states_shape":
        args[0] = torch.zeros(6, 3)
    elif case == "states_rank":
        args[0] = torch.zeros(1, 2, 6, 4)
    elif case == "actions_shape":
        args[1] = torch.zeros(6, 4)
    elif case == "prev_rows":
        args[2] = torch.zeros(1, 2).expand(5, 2)
    elif case == "groups_shape":
        args[:3] = [torch.zeros(2, 3, 4), torch.zeros(2, 4, 2), torch.zeros(2, 3, 2)]
    elif case == "reference_shape":
        args[3] = torch.zeros(5)
    elif case == "groups_reference":
        args[:4] = [torch.zeros(2, 3, 4), torch.zeros(2, 3, 2), torch.zeros(2, 3, 2),
                    torch.zeros(4)]
    elif case == "no_rows":
        args[:3] = [torch.zeros(0, 4), torch.zeros(0, 2), torch.zeros(0, 2)]
    elif case == "states_columns":
        args[0] = torch.zeros(4, 6).t()
    elif case == "prev_columns":
        args[2] = torch.zeros(2, 6).t()
    elif case == "reference_columns":
        args[3] = torch.zeros(4, 2)[:, 0]
    elif case == "grid_dtype":
        args[4] = GridMapData(grid.grid.double(), grid.origin, grid.cell_size)
    elif case == "origin_dtype":
        args[5] = GridMapData(grid.grid, grid.origin.to(torch.int64), grid.cell_size)
    elif case == "grid_shape":
        args[5] = GridMapData(torch.zeros(8, 6, 1), grid.origin, grid.cell_size)
    elif case == "grid_empty":
        args[4] = GridMapData(torch.zeros(0, 6), grid.origin, grid.cell_size)
    elif case == "origin_shape":
        args[4] = GridMapData(grid.grid, torch.zeros(3), grid.cell_size)
    before = _launches()
    with pytest.raises(ValueError, match=match):
        mpcc_cost(*args, WEIGHTS)
    assert _launches() == before


def test_the_wrappers_launches_read_the_registry():
    """``mpcc_cost.launches``: the eager launches of the symbol, set to 0 at will."""
    mpcc_cost.launches = 0
    assert mpcc_cost.launches == 0
    before = _launches()
    for _ in range(4):
        timing.count_launch("mpcc_cost", 1)
    assert mpcc_cost.launches == 4 and _launches() == before + 4
    mpcc_cost.launches = 0
    assert mpcc_cost.launches == 0 and _launches() == before + 4


def test_the_smokes_inputs_reach_every_edge_of_the_maps_and_a_nan(cpu_env):
    """``chip_smoke.mpcc_cost_inputs`` (the card tests' and the smoke's): rows read each map's
    first and last cells, rows fall off each edge, some onto cell 0 by rounding, and NaN and
    infinite costs come out besides finite ones."""
    from mppi_playground_tpu_torch.maps.grid_cost import cell_divisor

    xs, us, ps = _inputs(cpu_env, 4000, seed=11)
    om = cpu_env.obstacle_cost_map
    w, h = om.grid.shape
    cells = torch.round(xs[:, :2] / cell_divisor(om.cell_size, xs) + om.origin)
    finite = torch.isfinite(cells).all(1)
    ix, iy = cells[finite, 0], cells[finite, 1]
    for axis, size in ((ix, w), (iy, h)):
        for cell in (-1, 0, size - 1, size):
            assert int((axis == cell).sum()) >= 2, (cell, size)
    half = xs[:, :2] / cell_divisor(om.cell_size, xs) + om.origin
    assert bool(((half - half.floor() - 0.5).abs() < 1e-3).any())
    out = make_mpcc_cost_plain(*_maps(cpu_env))(xs, us, ps, _path(cpu_env, 1, seed=11)[0])
    assert 8 <= int(torch.isnan(out).sum()) < 30 and bool(torch.isinf(out).any())
    assert int(torch.isfinite(out).sum()) > 3900


def test_the_other_rasters_differ_from_the_racing_maps_and_each_other(cpu_env):
    first, second = chip_smoke.other_rasters(torch, 0, "cpu")
    racing = cpu_env.obstacle_cost_map
    shapes = {tuple(m.grid.shape) for m in (first, second, racing)}
    cells = {m.cell_size for m in (first, second, racing)}
    assert len(shapes) == 3 and len(cells) == 3 and not second.grid.is_contiguous()
    assert not torch.equal(first.origin, second.origin)


def test_the_smokes_bound_reads_each_row_once_and_writes_it():
    ms, by = chip_smoke.mpcc_cost_bound_ms(4000)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (44 * 4000 + 16) / chip_smoke.PEAK_BYTES_PER_S)


def test_the_smokes_row_ports_no_tpu_kernel_and_counts_t_plus_1_an_unfused_solve():
    assert chip_smoke.tpu_row("mpcc_cost") is None
    assert chip_smoke.counter_of(
        "(anonymous namespace)::mpcc_cost_kernel(float const*, long, long, float const*, long, "
        "long, float const*, long, long, float const*, long, (anonymous namespace)::Map, "
        "(anonymous namespace)::Map, (anonymous namespace)::Weights, int, int, float*)"
    ) == "mpcc_cost"
    assert chip_smoke.mpcc_cost_launches(10, 25, True) == 260
    assert chip_smoke.mpcc_cost_launches(10, 25, False) == 0


# ---------------------------------------------------------------------------
# On the card: the kernel against the torch ops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return RacingEnv(device="cuda")


def _plain_and_kernel(maps, xs, us, ps, path, t, launches=1):
    before = _launches()
    got = make_mpcc_cost(*maps)(xs, us, _info(path, t, ps))
    assert _launches() == before + launches
    return make_mpcc_cost_plain(*maps)(xs, us, ps, path[t]), got


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 32, 4000])
@pytest.mark.parametrize("rasters", ["racing", "other"])
def test_the_kernel_is_the_torch_ops(card_env, rows, rasters):
    maps = (_maps(card_env) if rasters == "racing"
            else chip_smoke.other_rasters(torch, rows, "cuda"))
    for seed in range(3):
        xs, us, ps = _inputs(card_env, rows, seed, device="cuda")
        path = _path(card_env, 26, seed, device="cuda")
        for t in (0, 11, 25):
            want, got = _plain_and_kernel(maps, xs, us, ps, path, t)
            _same(got, want)
            assert got.is_contiguous()


@pytest.mark.cuda
def test_the_edge_rows_one_at_a_time(card_env):
    """Each edge row of the smoke's inputs alone (R=1): each map's first and last cells, the
    half-cell boundaries, far off-map positions, NaN and infinite entries; on both rasters."""
    x_lim, y_lim, cell = _geometry(card_env)
    count = len(chip_smoke.mpcc_cost_edges(x_lim, y_lim, cell))
    xs, us, ps = _inputs(card_env, count, seed=0, device="cuda")
    path = _path(card_env, 4, seed=0, device="cuda")
    for maps in (_maps(card_env), chip_smoke.other_rasters(torch, 1, "cuda")):
        for r in range(count):
            want, got = _plain_and_kernel(maps, xs[r:r + 1], us[r:r + 1], ps[r:r + 1], path, 1)
            _same(got, want)


@pytest.mark.cuda
def test_a_reference_row_with_a_nan_or_an_infinite_yaw(card_env):
    xs, us, ps = _inputs(card_env, 64, seed=1, device="cuda")
    for yaw in (float("nan"), float("inf"), -float("inf"), 1e30):
        path = _path(card_env, 2, seed=1, device="cuda")
        path[1, 2] = yaw
        _same(*_plain_and_kernel(_maps(card_env), xs, us, ps, path, 1)[::-1])


@pytest.mark.cuda
def test_an_expanded_state_and_the_columns_of_a_sequence(card_env):
    """The unfused rollout's calls: ``x0.expand(K, 4)`` (row stride 0), each column of the
    sequence (row stride T m) after the one before, and the terminal cost on zeros."""
    rows, horizon = 4000, 25
    xs, _, _ = _inputs(card_env, rows, seed=1, device="cuda")
    _, seqs, _ = _inputs(card_env, rows * horizon, seed=2, device="cuda")
    seqs = seqs.reshape(rows, horizon, 2)
    path = _path(card_env, horizon + 1, seed=2, device="cuda")
    x = xs[-1].expand(rows, 4)
    for t in range(horizon):
        _same(*_plain_and_kernel(_maps(card_env), x, seqs[:, t], seqs[:, max(t - 1, 0)], path,
                                 t)[::-1])
    _same(*_plain_and_kernel(_maps(card_env), xs, torch.zeros_like(seqs[:, 0]),
                             seqs[:, horizon - 2], path, horizon - 1)[::-1])


@pytest.mark.cuda
def test_vmapped_groups_are_one_launch(card_env):
    batch, rows, horizon = 8, 4096, 25
    xs, us, ps = (t.reshape(batch, rows, -1)
                  for t in _inputs(card_env, batch * rows, seed=3, device="cuda"))
    paths = torch.stack([_path(card_env, horizon + 1, seed=4 + b, device="cuda")
                         for b in range(batch)])
    cost, plain = make_mpcc_cost(*_maps(card_env)), make_mpcc_cost_plain(*_maps(card_env))
    before = _launches()
    got = torch.func.vmap(lambda x, u, p, path: cost(x, u, _info(path, 5, p)))(xs, us, ps, paths)
    assert _launches() == before + 1
    _same(got, torch.stack([plain(xs[b], us[b], ps[b], paths[b, 5]) for b in range(batch)]))
    _, seqs, _ = _inputs(card_env, batch * rows * horizon, seed=5, device="cuda")
    seqs = seqs.reshape(batch, rows, horizon, 2)
    for t in (0, 7, horizon - 1):
        before = _launches()
        got = torch.func.vmap(lambda x0, seq, path: cost(
            x0.expand(rows, 4), seq[:, t], _info(path, t, seq[:, max(t - 1, 0)])))(
            xs[:, 0], seqs, paths)
        assert _launches() == before + 1
        _same(got, torch.stack([plain(xs[b, 0].expand(rows, 4), seqs[b, :, t],
                                      seqs[b, :, max(t - 1, 0)], paths[b, t])
                                for b in range(batch)]))
    before = _launches()  # a path shared by the scenarios
    got = torch.func.vmap(lambda x, u, p: cost(x, u, _info(paths[2], 9, p)))(xs, us, ps)
    assert _launches() == before + 1
    _same(got, torch.stack([plain(xs[b], us[b], ps[b], paths[2, 9]) for b in range(batch)]))


@pytest.mark.cuda
def test_a_captured_call_replays_with_new_inputs(card_env):
    rows, horizon = 32, 25
    static_x = torch.zeros(rows, 4, device="cuda")
    static_u = torch.zeros(rows, horizon, 2, device="cuda")
    static_path = torch.zeros(horizon + 1, 4, device="cuda")
    cost = make_mpcc_cost(*_maps(card_env))

    def call():
        return cost(static_x, static_u[:, 5], _info(static_path, 5, static_u[:, 4]))

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()  # built and loaded
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for seed in range(1, 5):
        xs, us, _ = _inputs(card_env, rows * (horizon + 1), seed, device="cuda")
        static_x.copy_(xs[:rows])
        static_u.copy_(us[:rows * horizon].reshape(rows, horizon, 2))
        static_path.copy_(_path(card_env, horizon + 1, seed, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        _same(out, make_mpcc_cost_plain(*_maps(card_env))(static_x, static_u[:, 5],
                                                           static_u[:, 4], static_path[5]))


@pytest.mark.cuda
def test_a_float64_state_on_a_card_raises(card_env):
    xs, us, ps = _inputs(card_env, 16, seed=6, dtype=torch.float64, device="cuda")
    path = _path(card_env, 3, seed=6, dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError, match="states must be torch.float32"):
        make_mpcc_cost(*_maps(card_env))(xs, us, _info(path, 1, ps))


@pytest.mark.cuda
@pytest.mark.parametrize("store_rollouts", [False, True])
def test_the_controllers_replayed_ticks_launch_t_plus_1_unfused_and_none_fused(card_env,
                                                                              store_rollouts):
    from mppi_playground_tpu_torch.envs import RacingController

    ctrl = RacingController(card_env, horizon=25, num_samples=4000,
                            store_rollouts=store_rollouts)
    x = card_env.reset()
    mpcc_cost.launches = 0
    ctrl.update(x)  # the eager tick
    assert mpcc_cost.launches == (26 if store_rollouts else 0)
    ctrl.update(x)  # the capture
    torch.cuda.synchronize()
    before = _launches()
    ticks = 5
    for _ in range(ticks):
        ctrl.update(x)
    torch.cuda.synchronize()
    assert _launches() == before + ticks * (26 if store_rollouts else 0)
