"""The racing reference rows: the kernel's wrapper, the route, and the kernel on the card.

On the CPU: ``ops/reference_rows.reference_rows`` raises on what the kernel
does not take (a CPU tensor, a wrong dtype, shape or layout) and counts no
launch, and ``calc_ref_trajectory(_batch)`` keep the torch ops for a path on
the CPU, float32 and float64 alike.  The single call's route on a card (the
batch kernel at a batch of one, over views) is held against the plain single
call, a path that reports itself on a card taking the route and the plain
batch standing in for the kernel.

On the card (marker ``cuda``; no jax, so run them with ``--noconftest``)::

    python -m pytest tests/test_torch_reference_rows.py -m cuda --noconftest -q

the kernel is bit for bit the torch ops (``calc_ref_trajectory_plain``,
``calc_ref_trajectory_batch_plain`` on the same CUDA tensors), rows and
indices: random states over the circuit at B = 1, 8, 32, 128 and T = 25, 50;
exact ties of the distance (the first index wins) and states at the midpoint
of two path points; a progress index ahead of the nearest point and near the
path's end (clamped rows, the velocity column zeroed); a NaN state; a call
captured in a CUDA graph and replayed with new inputs; each row of the batch
against the single call.  The racing controller's replayed ticks and a
fleet's replayed episode launch the kernel once a tick.
"""

import pytest
import torch

from mppi_playground_tpu_torch.models import racing_mpcc
from mppi_playground_tpu_torch.models.racing_mpcc import (
    calc_ref_trajectory,
    calc_ref_trajectory_batch,
    calc_ref_trajectory_batch_plain,
    calc_ref_trajectory_plain,
)
from mppi_playground_tpu_torch.ops.reference_rows import reference_rows
from mppi_playground_tpu_torch.utils import timing


def _circuit(device):
    from mppi_playground_tpu_torch.envs import RacingEnv

    return RacingEnv(device=device).racing_center_path


def _states(path, batch, seed):
    """``[batch, 4]`` states scattered around random points of the path."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    idx = torch.randint(0, path.shape[0], (batch,), generator=g)
    near = path.cpu()[idx]
    xs = torch.empty(batch, 4, dtype=path.dtype)
    xs[:, :2] = near[:, :2] + 1.5 * torch.randn(batch, 2, generator=g)
    xs[:, 2] = near[:, 2] + 0.3 * torch.randn(batch, generator=g)
    xs[:, 3] = 5.0 * torch.rand(batch, generator=g)
    return xs.to(path.device)


def _cinds(path, batch, seed):
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    c = torch.randint(0, path.shape[0], (batch,), generator=g)
    c[::2] = 0  # half the fleet behind its nearest point
    return c.to(path.device)


def _launches():
    return timing.launches().get("reference_rows", 0)


# ---------------------------------------------------------------------------
# CPU: the wrapper's checks and the route
# ---------------------------------------------------------------------------

def _wrapper_args(device="cpu"):
    return (torch.zeros(2, 4, device=device), torch.zeros(10, 3, device=device),
            torch.zeros(2, dtype=torch.int64, device=device),
            torch.arange(5, dtype=torch.int64, device=device))


@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA device"),
    ("states_dtype", "states must be torch.float32"),
    ("path_dtype", "path must be torch.float32"),
    ("cinds_dtype", "cinds must be torch.int64"),
    ("dinds_dtype", "dinds must be torch.int64"),
    ("states_shape", r"states must be \[B, 4\]"),
    ("path_shape", r"path must be \[N, 3\]"),
    ("cinds_shape", r"cinds must be \[2\]"),
    ("dinds_shape", r"dinds must be \[R\]"),
    ("empty_path", r"path must be \[N, 3\]"),
    ("states_layout", "states must be contiguous"),
    ("path_layout", "path must be contiguous"),
])
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(case, match):
    states, path, cinds, dinds = _wrapper_args()
    if case == "states_dtype":
        states = states.double()
    elif case == "path_dtype":
        path = path.half()
    elif case == "cinds_dtype":
        cinds = cinds.int()
    elif case == "dinds_dtype":
        dinds = dinds.float()
    elif case == "states_shape":
        states = torch.zeros(2, 3)
    elif case == "path_shape":
        path = torch.zeros(10, 4)
    elif case == "cinds_shape":
        cinds = torch.zeros(3, dtype=torch.int64)
    elif case == "dinds_shape":
        dinds = torch.zeros(2, 3, dtype=torch.int64)
    elif case == "empty_path":
        path = torch.zeros(0, 3)
    elif case == "states_layout":
        states = torch.zeros(4, 2).t()
    elif case == "path_layout":
        path = torch.zeros(3, 10).t()
    before = _launches()
    with pytest.raises(ValueError, match=match):
        reference_rows(states, path, cinds, dinds, 7.0)
    assert _launches() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_route_keeps_the_torch_ops_off_the_card(dtype):
    path = _circuit("cpu").to(dtype)
    xs = _states(path, 5, seed=3)
    cinds = _cinds(path, 5, seed=3)
    before = _launches()
    xrefs, new = calc_ref_trajectory_batch(xs, path, cinds, 25)
    want, want_new = calc_ref_trajectory_batch_plain(xs, path, cinds, 25)
    assert torch.equal(xrefs, want) and torch.equal(new, want_new)
    assert xrefs.dtype == dtype and new.dtype == torch.int64
    for b in range(5):
        xref, ind = calc_ref_trajectory(xs[b], path, cinds[b], 25)
        one, one_ind = calc_ref_trajectory_plain(xs[b], path, cinds[b], 25)
        assert torch.equal(xref, one) and torch.equal(ind, one_ind)
        assert torch.equal(xref, xrefs[b]) and torch.equal(ind, new[b])
    assert _launches() == before


class _OnACard(torch.Tensor):
    """A CPU tensor that reports itself on a CUDA device, so the route takes the kernel."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("horizon", [8, 25])
def test_the_single_call_is_the_batch_route_at_a_batch_of_one(horizon, monkeypatch):
    """The single call's kernel route, with the plain batch standing in for the kernel: the
    state and index go in as a batch of one, and row 0 comes back as ``[T+1, 4]`` and a 0-dim
    index."""
    path = _circuit("cpu").as_subclass(_OnACard)
    assert path.is_cuda
    calls = []

    def kernel(states, path_, cinds, dinds, v_max):
        calls.append((tuple(states.shape), tuple(cinds.shape), tuple(dinds.shape)))
        assert states.is_contiguous() and cinds.dtype == torch.int64
        return calc_ref_trajectory_batch_plain(states, path_, cinds, horizon, v_max=v_max)

    monkeypatch.setattr(racing_mpcc, "reference_rows", kernel)
    xs = _states(path, 4, seed=9)
    xs_strided = torch.stack([xs, xs], dim=2)[:, :, 0]  # rows that are not contiguous
    assert not xs_strided[0].is_contiguous()
    for b, cind in enumerate([0, 300, path.shape[0] - 3, 7]):
        got, ind = calc_ref_trajectory(xs_strided[b], path, torch.tensor(cind), horizon)
        want, want_ind = calc_ref_trajectory_plain(xs[b], path, torch.tensor(cind), horizon)
        assert got.shape == (horizon + 1, 4) and ind.shape == ()
        assert torch.equal(got, want) and torch.equal(ind, want_ind)
    assert calls == [((1, 4), (1,), (horizon + 1,))] * 4


@pytest.mark.parametrize("dtype, match", [(torch.float32, "CUDA device"),
                                          (torch.float64, "states must be torch.float32")])
def test_a_path_on_a_card_takes_the_kernel_and_no_other_route(dtype, match):
    """No fallback to the torch ops on a card: what the kernel does not take raises."""
    path = _circuit("cpu").to(dtype).as_subclass(_OnACard)
    xs = _states(path, 3, seed=1)
    cinds = _cinds(path, 3, seed=1)
    before = _launches()
    with pytest.raises(ValueError, match=match):
        calc_ref_trajectory_batch(xs, path, cinds, 25)
    with pytest.raises(ValueError, match=match):
        calc_ref_trajectory(xs[0], path, cinds[0], 25)
    assert _launches() == before


def test_the_wrappers_launches_read_the_registry():
    """``reference_rows.launches``: the eager launches of the symbol, set to 0 at will."""
    reference_rows.launches = 0
    assert reference_rows.launches == 0
    before = _launches()
    for _ in range(3):
        timing.count_launch("reference_rows", 1)
    assert reference_rows.launches == 3 and _launches() == before + 3
    reference_rows.launches = 0
    assert reference_rows.launches == 0 and _launches() == before + 3


def test_the_plain_rows_clamp_and_zero_the_velocity_at_the_path_end():
    path = _circuit("cpu")
    n = path.shape[0]
    x = path[n - 2, :2].clone()
    state = torch.tensor([x[0], x[1], 0.0, 1.0])
    xref, ind = calc_ref_trajectory(state, path, torch.tensor(n - 10), 25)
    assert int(ind) == n - 2  # the nearest point is ahead of the index
    assert torch.equal(xref[:, 3], torch.zeros(26))
    assert torch.equal(xref[-1, :3], path[n - 1])


def test_the_smokes_bound_reads_the_path_once_and_writes_the_rows():
    import chip_smoke

    ms, by = chip_smoke.reference_rows_bound_ms(32, 1622, 26)
    moved = 12 * 1622 + 32 * (16 + 8) + 8 * 26 + 32 * (16 * 26 + 8)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * moved / chip_smoke.PEAK_BYTES_PER_S)


def test_the_smokes_row_ports_no_tpu_kernel_and_adds_to_no_rows_product():
    import chip_smoke

    row = dict(name="reference_rows", row=chip_smoke.tpu_row("reference_rows"), ms=0.003,
               bound_ms=0.0, launches_by_path={"flagship fixed": 50, "racing fleet B=32": 50},
               batched=dict(ms=0.003, bound_ms=0.0))
    assert row["row"] is None
    assert chip_smoke.row_products([row], {}) == {}


@pytest.mark.parametrize("horizon", [25, 50])
def test_the_smokes_inputs_clamp_some_rows_and_not_all(horizon):
    """The smoke's states and indices reach the path's end in some scenarios: their rows clamp
    and their velocity column is zeroed."""
    import chip_smoke

    path = _circuit("cpu")
    xs, cinds = chip_smoke.reference_rows_inputs(torch, path, 32, seed=horizon)
    assert xs.shape == (32, 4) and cinds.dtype == torch.int64
    xrefs, new = calc_ref_trajectory_batch(xs, path, cinds, horizon)
    zeroed = int((xrefs[:, 0, 3] == 0).sum())
    assert 0 < zeroed < 32
    assert bool((new >= cinds).all())


# ---------------------------------------------------------------------------
# On the card: the kernel against the torch ops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_path():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return _circuit("cuda")


def _plain_and_kernel(xs, path, cinds, horizon):
    before = _launches()
    got = calc_ref_trajectory_batch(xs, path, cinds, horizon)
    assert _launches() == before + 1
    return calc_ref_trajectory_batch_plain(xs, path, cinds, horizon), got


def _assert_same(want, got):
    (wx, wi), (gx, gi) = want, got
    assert gx.shape == wx.shape and gx.dtype == wx.dtype and gi.dtype == wi.dtype
    assert torch.equal(gi, wi), (gi, wi)
    assert torch.equal(gx, wx)


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [25, 50])
@pytest.mark.parametrize("batch", [1, 8, 32, 128])
def test_the_kernel_is_the_torch_ops_over_the_circuit(card_path, batch, horizon):
    for seed in range(3):
        xs = _states(card_path, batch, seed)
        cinds = _cinds(card_path, batch, seed)
        _assert_same(*_plain_and_kernel(xs, card_path, cinds, horizon))


@pytest.mark.cuda
@pytest.mark.parametrize("points", [3, 600, 3999, 4000, 4001, 9000])
def test_paths_of_other_lengths(card_path, points):
    """Paths shorter than a block, and longer than one round of a block's loads (2,048
    points): the circuit resampled at ``points`` points."""
    pos = torch.linspace(0, card_path.shape[0] - 1, points, device="cuda")
    lo = pos.floor().long().clamp(max=card_path.shape[0] - 2)
    frac = (pos - lo)[:, None]
    path = (card_path[lo] * (1 - frac) + card_path[lo + 1] * frac).contiguous()
    for horizon in (25, 50):
        xs = _states(path, 32, seed=points)
        cinds = _cinds(path, 32, seed=points)
        _assert_same(*_plain_and_kernel(xs, path, cinds, horizon))


@pytest.mark.cuda
def test_an_exact_tie_goes_to_the_first_index(card_path):
    """Distances equal to the bit at indices spread over threads and warps."""
    n = 1622
    path = torch.zeros(n, 3)
    path[:, 0] = 100.0 + torch.arange(n, dtype=torch.float32)  # far from the origin
    ties = [1100, 5, 517, 1029]  # the same thread (5, 517, 1029: 512 apart), another warp
    for k, i in enumerate(ties):
        path[i, 0] = (-3.0, 3.0)[k % 2]
        path[i, 1] = 4.0 if k < 2 else -4.0  # every one at 5 m of the origin
    path = path.cuda()
    xs = torch.zeros(2, 4, device="cuda")
    cinds = torch.zeros(2, dtype=torch.int64, device="cuda")
    want, got = _plain_and_kernel(xs, path, cinds, 25)
    _assert_same(want, got)
    assert got[1].tolist() == [5, 5]


@pytest.mark.cuda
def test_a_state_at_the_midpoint_of_two_points(card_path):
    idx = torch.arange(0, card_path.shape[0] - 1, 13, device="cuda")
    xs = torch.zeros(idx.shape[0], 4, device="cuda")
    xs[:, :2] = (card_path[idx, :2] + card_path[idx + 1, :2]) / 2
    xs[:, 3] = 2.0
    cinds = torch.zeros(idx.shape[0], dtype=torch.int64, device="cuda")
    for horizon in (25, 50):
        _assert_same(*_plain_and_kernel(xs, card_path, cinds, horizon))


@pytest.mark.cuda
def test_an_index_ahead_of_the_nearest_point_and_near_the_end(card_path):
    n = card_path.shape[0]
    xs = _states(card_path, 16, seed=5)
    _, nearest = calc_ref_trajectory_batch_plain(xs, card_path, torch.zeros(
        16, dtype=torch.int64, device="cuda"), 25)
    ahead = nearest + torch.arange(1, 17, device="cuda") * 7
    want, got = _plain_and_kernel(xs, card_path, ahead, 25)
    _assert_same(want, got)
    assert torch.equal(got[1], ahead)
    end = torch.full((16,), n - 5, dtype=torch.int64, device="cuda")
    end[::4] = n + 40  # past the end
    for horizon in (25, 50):
        want, got = _plain_and_kernel(xs, card_path, end, horizon)
        _assert_same(want, got)
        assert torch.equal(got[0][..., 3], torch.zeros_like(got[0][..., 3]))
        assert torch.equal(got[0][:, -1, :3], card_path[-1].expand(16, 3))


@pytest.mark.cuda
def test_a_nan_state(card_path):
    xs = _states(card_path, 6, seed=2)
    xs[1, 0] = float("nan")
    xs[3] = float("nan")
    xs[5, 1] = float("nan")
    cinds = torch.tensor([0, 0, 0, 40, 0, 0], device="cuda")
    want, got = _plain_and_kernel(xs, card_path, cinds, 25)
    _assert_same(want, got)
    assert got[1][[1, 3, 5]].tolist() == [0, 40, 0]


@pytest.mark.cuda
def test_a_captured_call_replays_with_new_inputs(card_path):
    batch, horizon = 32, 25
    static_x = _states(card_path, batch, seed=0)
    static_c = _cinds(card_path, batch, seed=0)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        calc_ref_trajectory_batch(static_x, card_path, static_c, horizon)  # the table, cached
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_x, out_i = calc_ref_trajectory_batch(static_x, card_path, static_c, horizon)
    for seed in range(1, 5):
        xs, cinds = _states(card_path, batch, seed), _cinds(card_path, batch, seed)
        static_x.copy_(xs)
        static_c.copy_(cinds)
        graph.replay()
        torch.cuda.synchronize()
        _assert_same(calc_ref_trajectory_batch(xs, card_path, cinds, horizon), (out_x, out_i))
        _assert_same(calc_ref_trajectory_batch_plain(xs, card_path, cinds, horizon),
                     (out_x, out_i))


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [25, 50])
def test_each_row_of_the_batch_is_the_single_call(card_path, horizon):
    xs = _states(card_path, 32, seed=7)
    cinds = _cinds(card_path, 32, seed=7)
    xrefs, new = calc_ref_trajectory_batch(xs, card_path, cinds, horizon)
    for b in range(32):
        before = _launches()
        xref, ind = calc_ref_trajectory(xs[b], card_path, cinds[b], horizon)
        assert _launches() == before + 1
        assert xref.shape == (horizon + 1, 4) and ind.shape == ()
        assert torch.equal(xref, xrefs[b]) and torch.equal(ind, new[b])
        one, one_ind = calc_ref_trajectory_plain(xs[b], card_path, cinds[b], horizon)
        assert torch.equal(xref, one) and torch.equal(ind, one_ind)


@pytest.mark.cuda
@pytest.mark.parametrize("store_rollouts", [False, True])
def test_the_controllers_replayed_ticks_launch_the_kernel_once_a_tick(card_path, store_rollouts):
    from mppi_playground_tpu_torch.envs import RacingController, RacingEnv

    env = RacingEnv(device="cuda")
    ctrl = RacingController(env, horizon=25, num_samples=4096, store_rollouts=store_rollouts)
    x = env.reset()
    for _ in range(2):  # eager, then the capture
        ctrl.update(x)
    torch.cuda.synchronize()
    before = _launches()
    ticks = 7
    for _ in range(ticks):
        ctrl.update(x)
    torch.cuda.synchronize()
    assert _launches() == before + ticks


@pytest.mark.cuda
def test_a_fleets_replayed_episode_launches_the_kernel_once_a_tick(card_path):
    from mppi_playground_tpu_torch.core.closed_loop import make_fleet_closed_loop
    from mppi_playground_tpu_torch.core.config import MPPIConfig
    from mppi_playground_tpu_torch.envs import RacingEnv
    from mppi_playground_tpu_torch.parallel import make_batched_fused_solver

    env = RacingEnv(device="cuda")
    batch, ticks = 8, 6
    config = MPPIConfig(horizon=25, num_samples=4096, dim_state=4, dim_control=2,
                        u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1),
                        lambda_=1.0, store_rollouts=False)
    fleet = make_batched_fused_solver(config, racing_mpcc.make_racing_fused_task_from_env(env),
                                      env.dynamics, "cuda", batch)

    def info_fn(cinds, xs):
        xrefs, new = calc_ref_trajectory_batch(xs, card_path, cinds, 25)
        return {"reference_path": xrefs}, new

    run = make_fleet_closed_loop(fleet, env.dynamics, ticks, info_fn=info_fn)
    states = fleet.init_batch(seed=3)
    x0s = _states(card_path, batch, seed=4)
    c0 = torch.zeros(batch, dtype=torch.int64, device="cuda")
    first = run(states, x0s, c0)
    torch.cuda.synchronize()
    before = _launches()
    second = run(states, x0s, c0)  # every tick replayed
    torch.cuda.synchronize()
    assert _launches() == before + ticks
    assert all(torch.equal(a, b) for a, b in zip(first[1:4], second[1:4]))
