"""The racing plant's step: the kernel's wrapper, the route, its vmap rule, and the kernel on the card.

On the CPU: ``RacingEnv.dynamics`` takes the torch ops of
``models/bicycle.make_dynamics`` for states on the CPU, float32 and float64
alike, and launches nothing; under ``torch.func.vmap`` the route's rule folds
the vmapped dimension into the rows, bit for bit a loop over the batch
(batched or broadcast arguments, another dimension vmapped, vmaps nested, an
expanded state, the columns of a sequence of actions); states that report
themselves on a card take the kernel's wrapper and no other route, under vmap
too, with the groups read where they lie; and ``ops/racing_plant.racing_plant``
raises on what the kernel does not take (a CPU tensor, a wrong dtype or shape,
columns that are not contiguous) and counts no launch.

On the card (marker ``cuda``; no jax, so run them with ``--noconftest``)::

    python -m pytest tests/test_torch_racing_plant.py -m cuda --noconftest -q

the kernel is bit for bit the torch ops on the same CUDA tensors, NaN where
they give NaN (``chip_smoke.racing_plant_inputs``: rows at and beyond each map
edge, headings at and beyond +-pi, speeds at and beyond +-V_MAX, actions beyond
their clamps, NaN and infinite entries), one launch a call: at R = 1, 32 and
4,000; from an expanded state and from each column of a sequence of actions;
vmapped at B=8 x K=4,096, from expanded states and action columns too; captured
in a CUDA graph and replayed with new inputs.  The launch counter reads one a
plant step, 2T a replayed unfused controller tick, none a fused one, one a
replayed fleet tick.
"""

import types

import pytest
import torch

import chip_smoke
from mppi_playground_tpu_torch.envs import RacingEnv
from mppi_playground_tpu_torch.models import bicycle
from mppi_playground_tpu_torch.ops import racing_plant as plant_module
from mppi_playground_tpu_torch.ops.racing_plant import racing_plant
from mppi_playground_tpu_torch.utils import timing


@pytest.fixture(scope="module")
def cpu_env():
    return RacingEnv(device="cpu")


def _limits(env):
    return tuple(env.obstacle_map.x_lim), tuple(env.obstacle_map.y_lim)


def _plain(env):
    return bicycle.make_dynamics(*_limits(env))


def _inputs(env, rows, seed, dtype=torch.float32, device="cpu"):
    xs, us = chip_smoke.racing_plant_inputs(torch, rows, seed, *_limits(env))
    return xs.to(device, dtype), us.to(device, dtype)


def _launches():
    return timing.launches().get("racing_plant", 0)


def _same(got, want):
    assert chip_smoke.same_steps(torch, got, want), (got, want)


# ---------------------------------------------------------------------------
# CPU: the route, the vmap rule, the wrapper's checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_route_keeps_the_torch_ops_off_the_card(cpu_env, dtype, monkeypatch):
    def no_kernel(*args):
        raise AssertionError("the kernel's wrapper was called for states on the CPU")

    monkeypatch.setattr(plant_module, "racing_plant", no_kernel)
    xs, us = _inputs(cpu_env, 64, seed=1, dtype=dtype)
    before = _launches()
    got = cpu_env.dynamics(xs, us)
    _same(got, _plain(cpu_env)(xs, us))
    assert got.dtype == dtype and _launches() == before
    x = cpu_env.reset()
    state, _ = cpu_env.step(torch.tensor([1.0, 0.1]))
    _same(state, _plain(cpu_env)(x[None], torch.tensor([[1.0, 0.1]]))[0])


def _loop(fn, args, in_dims):
    batch = next(a.shape[d] for a, d in zip(args, in_dims) if d is not None)
    return torch.stack([fn(*(a if d is None else a.select(d, b) for a, d in zip(args, in_dims)))
                        for b in range(batch)])


@pytest.mark.parametrize("case", ["both", "states_broadcast", "actions_broadcast",
                                  "actions_dim_1", "expanded_state", "action_columns",
                                  "single_states", "nested"])
def test_the_vmap_rule_is_a_loop_over_the_batch(cpu_env, case):
    """The rule on the CPU: the groups folded into rows, the torch ops on them, unfolded."""
    batch, rows, horizon = 3, 40, 5
    xs, us = _inputs(cpu_env, batch * rows, seed=2)
    xs, us = xs.reshape(batch, rows, 4), us.reshape(batch, rows, 2)
    _, seqs = _inputs(cpu_env, batch * rows * horizon, seed=3)
    seqs = seqs.reshape(batch, rows, horizon, 2)
    dyn = cpu_env.dynamics
    before = _launches()
    if case == "nested":
        grid = xs[:, :, None].expand(batch, rows, 2, 4).transpose(1, 2).contiguous()
        acts = torch.stack([us, us.flip(1)], dim=1)
        got = torch.func.vmap(torch.func.vmap(dyn))(grid, acts)
        want = torch.stack([_loop(dyn, (grid[b], acts[b]), (0, 0)) for b in range(batch)])
    else:
        fn, args, in_dims = {
            "both": (dyn, (xs, us), (0, 0)),
            "states_broadcast": (dyn, (xs[0], us), (None, 0)),
            "actions_broadcast": (dyn, (xs, us[0]), (0, None)),
            "actions_dim_1": (dyn, (xs, us.transpose(0, 1)), (0, 1)),
            "expanded_state": (lambda x0, u: dyn(x0.expand(rows, 4), u), (xs[:, 0], us), (0, 0)),
            "action_columns": (lambda x0, seq: dyn(x0.expand(rows, 4), seq[:, horizon - 2]),
                               (xs[:, 0], seqs), (0, 0)),
            "single_states": (lambda x, u: dyn(x[None], u[None])[0], (xs[:, 0], us[:, 0]),
                              (0, 0)),
        }[case]
        got = torch.func.vmap(fn, in_dims=in_dims)(*args)
        want = _loop(fn, args, in_dims)
    _same(got, want)
    assert _launches() == before


class _OnACard(torch.Tensor):
    """A CPU tensor that reports itself on a CUDA device, so the route takes the kernel."""

    @property
    def is_cuda(self):
        return True


def _fake_kernel(calls, env):
    """The torch ops standing in for the kernel's wrapper, recording what the route gives it."""
    plain = _plain(env)

    def kernel(states, actions, x_lim, y_lim):
        calls.append((tuple(states.shape), states.stride(), actions.stride(), x_lim, y_lim))
        return plain(states, actions).as_subclass(torch.Tensor)

    return kernel


def test_states_on_a_card_take_the_kernel_once_a_call(cpu_env, monkeypatch):
    """The route on a card, with the torch ops standing in for the kernel: one call of the
    wrapper a step, the strided and expanded inputs handed over as they lie."""
    calls = []
    monkeypatch.setattr(plant_module, "racing_plant", _fake_kernel(calls, cpu_env))
    xs, us = _inputs(cpu_env, 40, seed=4)
    _, seqs = _inputs(cpu_env, 40 * 6, seed=5)
    seqs = seqs.reshape(40, 6, 2)
    x0 = xs[0].as_subclass(_OnACard)
    got = cpu_env.dynamics(x0.expand(40, 4), seqs[:, 2])
    _same(got, _plain(cpu_env)(xs[0].expand(40, 4), seqs[:, 2]))
    lims = _limits(cpu_env)
    assert calls == [((40, 4), (0, 1), (12, 1), *lims)]


def test_the_vmap_rule_hands_a_card_the_groups_as_they_lie(cpu_env, monkeypatch):
    """The rule as ``torch.func.vmap`` calls it on a card (the physical tensors, their vmapped
    dimensions): one call of the kernel for the B groups, an expanded state's and a column
    of actions' strides kept."""
    calls = []
    monkeypatch.setattr(plant_module, "racing_plant", _fake_kernel(calls, cpu_env))
    batch, rows, horizon = 3, 16, 4
    xs, _ = _inputs(cpu_env, batch, seed=6)
    _, seqs = _inputs(cpu_env, batch * rows * horizon, seed=7)
    seqs = seqs.reshape(batch, rows, horizon, 2)
    states = xs.as_subclass(_OnACard)[:, None].expand(batch, rows, 4)
    info = types.SimpleNamespace(batch_size=batch, randomness="error")
    got, out_dim = plant_module._BicycleStep.vmap(info, (0, 1), states,
                                                  seqs[:, :, 1].transpose(0, 1), _plain(cpu_env),
                                                  *_limits(cpu_env))
    assert out_dim == 0
    _same(got, torch.stack([_plain(cpu_env)(xs[b].expand(rows, 4), seqs[b, :, 1])
                            for b in range(batch)]))
    assert calls == [((batch, rows, 4), (4, 0, 1), (rows * horizon * 2, horizon * 2, 1),
                      *_limits(cpu_env))]


@pytest.mark.parametrize("dtype, match", [(torch.float32, "CUDA device"),
                                          (torch.float64, "states must be torch.float32")])
def test_states_on_a_card_take_the_kernel_and_no_other_route(cpu_env, dtype, match):
    """No fallback to the torch ops on a card: what the kernel does not take raises."""
    xs, us = _inputs(cpu_env, 8, seed=8, dtype=dtype)
    before = _launches()
    with pytest.raises(ValueError, match=match):
        cpu_env.dynamics(xs.as_subclass(_OnACard), us)
    assert _launches() == before


def _wrapper_args():
    return torch.zeros(6, 4), torch.zeros(6, 2)


@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA device"),
    ("states_dtype", "states must be torch.float32"),
    ("actions_dtype", "actions must be torch.float32"),
    ("states_shape", r"states must be \[R, 4\] or \[B, K, 4\]"),
    ("states_rank", r"states must be \[R, 4\] or \[B, K, 4\]"),
    ("actions_shape", r"actions must be \[6, 2\]"),
    ("actions_rows", r"actions must be \[6, 2\]"),
    ("groups_shape", r"actions must be \[2, 3, 2\]"),
    ("no_rows", "the rows must number 1"),
    ("states_columns", "states must have contiguous columns"),
    ("actions_columns", "actions must have contiguous columns"),
])
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(case, match):
    states, actions = _wrapper_args()
    if case == "states_dtype":
        states = states.double()
    elif case == "actions_dtype":
        actions = actions.half()
    elif case == "states_shape":
        states = torch.zeros(6, 3)
    elif case == "states_rank":
        states = torch.zeros(1, 2, 6, 4)
    elif case == "actions_shape":
        actions = torch.zeros(6, 4)
    elif case == "actions_rows":
        actions = torch.zeros(1, 2).expand(5, 2)
    elif case == "groups_shape":
        states = torch.zeros(2, 3, 4)
        actions = torch.zeros(2, 4, 2)
    elif case == "no_rows":
        states, actions = torch.zeros(0, 4), torch.zeros(0, 2)
    elif case == "states_columns":
        states = torch.zeros(4, 6).t()
    elif case == "actions_columns":
        actions = torch.zeros(2, 6).t()
    before = _launches()
    with pytest.raises(ValueError, match=match):
        racing_plant(states, actions, (-40.0, 40.0), (-40.0, 40.0))
    assert _launches() == before


def test_the_wrappers_launches_read_the_registry():
    """``racing_plant.launches``: the eager launches of the symbol, set to 0 at will."""
    racing_plant.launches = 0
    assert racing_plant.launches == 0
    before = _launches()
    for _ in range(4):
        timing.count_launch("racing_plant", 1)
    assert racing_plant.launches == 4 and _launches() == before + 4
    racing_plant.launches = 0
    assert racing_plant.launches == 0 and _launches() == before + 4


def test_the_smokes_inputs_reach_every_clamp_and_a_nan(cpu_env):
    """``chip_smoke.racing_plant_inputs`` (the card tests' and the smoke's): the torch ops
    clamp some rows at each map edge and at each speed bound, wrap headings, and give NaN."""
    xs, us = _inputs(cpu_env, 4000, seed=9)
    out = _plain(cpu_env)(xs, us)
    (x_lo, x_hi), (y_lo, y_hi) = _limits(cpu_env)
    for column, bound in ((0, x_lo), (0, x_hi), (1, y_lo), (1, y_hi), (3, -bicycle.V_MAX),
                          (3, bicycle.V_MAX)):
        assert int((out[:, column] == bound).sum()) > 1, (column, bound)
    finite = torch.isfinite(xs).all(1) & torch.isfinite(us).all(1)
    assert bool(((xs[:, 2].abs() > torch.pi) & finite).any())
    assert bool((us[:, 0].abs() > 2.0).any() and (us[:, 1].abs() > 0.25).any())
    nan_rows = torch.isnan(out).any(1)
    assert 8 <= int(nan_rows.sum()) < 20 and not bool(torch.isnan(out[finite]).any())


def test_the_smokes_bound_reads_each_row_once_and_writes_it():
    ms, by = chip_smoke.racing_plant_bound_ms(4000)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * 40 * 4000 / chip_smoke.PEAK_BYTES_PER_S)


def test_the_smokes_row_ports_no_tpu_kernel_and_counts_2t_an_unfused_tick():
    assert chip_smoke.tpu_row("racing_plant") is None
    assert chip_smoke.counter_of("(anonymous namespace)::racing_plant_kernel(float const*, long, "
                                 "long, float const*, long, long, int, int, float, float, float, "
                                 "float, float*)") == "racing_plant"
    assert chip_smoke.racing_plant_launches(10, 25, True, 10) == 510
    assert chip_smoke.racing_plant_launches(10, 25, False, 10) == 10


# ---------------------------------------------------------------------------
# On the card: the kernel against the torch ops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return RacingEnv(device="cuda")


def _plain_and_kernel(env, xs, us, launches=1):
    before = _launches()
    got = env.dynamics(xs, us)
    assert _launches() == before + launches
    return _plain(env)(xs, us), got


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 32, 4000])
def test_the_kernel_is_the_torch_ops(card_env, rows):
    for seed in range(3):
        xs, us = _inputs(card_env, rows, seed, device="cuda")
        _same(*_plain_and_kernel(card_env, xs, us)[::-1])


@pytest.mark.cuda
def test_the_edge_rows_one_at_a_time(card_env):
    """Each edge row of the smoke's inputs alone (R=1): the map's edges, the wraps, the
    speed and action clamps, NaN and infinite entries."""
    xs, us = _inputs(card_env, len(chip_smoke.racing_plant_edges(*_limits(card_env))), seed=0,
                     device="cuda")
    for r in range(xs.shape[0]):
        want, got = _plain_and_kernel(card_env, xs[r:r + 1], us[r:r + 1])
        _same(got, want)


@pytest.mark.cuda
def test_an_expanded_state_and_the_columns_of_a_sequence(card_env):
    rows, horizon = 4000, 25
    xs, _ = _inputs(card_env, rows, seed=1, device="cuda")
    _, seqs = _inputs(card_env, rows * horizon, seed=2, device="cuda")
    seqs = seqs.reshape(rows, horizon, 2)
    x0 = xs[-1]
    for t in range(horizon):
        want, got = _plain_and_kernel(card_env, x0.expand(rows, 4), seqs[:, t])
        _same(got, want)
        assert got.is_contiguous()


@pytest.mark.cuda
def test_vmapped_groups_are_one_launch(card_env):
    batch, rows, horizon = 8, 4096, 25
    xs, us = _inputs(card_env, batch * rows, seed=3, device="cuda")
    xs, us = xs.reshape(batch, rows, 4), us.reshape(batch, rows, 2)
    plain = _plain(card_env)
    before = _launches()
    got = torch.func.vmap(card_env.dynamics)(xs, us)
    assert _launches() == before + 1
    _same(got, plain(xs.reshape(-1, 4), us.reshape(-1, 2)).reshape(batch, rows, 4))
    _, seqs = _inputs(card_env, batch * rows * horizon, seed=4, device="cuda")
    seqs = seqs.reshape(batch, rows, horizon, 2)
    for t in (0, 7, horizon - 1):
        before = _launches()
        got = torch.func.vmap(lambda x0, seq: card_env.dynamics(x0.expand(rows, 4), seq[:, t]))(
            xs[:, 0], seqs)
        assert _launches() == before + 1
        _same(got, torch.stack([plain(xs[b, 0].expand(rows, 4), seqs[b, :, t])
                                for b in range(batch)]))


@pytest.mark.cuda
def test_a_captured_call_replays_with_new_inputs(card_env):
    rows, horizon = 32, 25
    static_x = torch.zeros(rows, 4, device="cuda")
    static_u = torch.zeros(rows, horizon, 2, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        card_env.dynamics(static_x, static_u[:, 5])  # built and loaded
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = card_env.dynamics(static_x, static_u[:, 5])
    for seed in range(1, 5):
        xs, us = _inputs(card_env, rows * (horizon + 1), seed, device="cuda")
        static_x.copy_(xs[:rows])
        static_u.copy_(us[:rows * horizon].reshape(rows, horizon, 2))
        graph.replay()
        torch.cuda.synchronize()
        _same(out, _plain(card_env)(static_x, static_u[:, 5]))


@pytest.mark.cuda
def test_a_float64_env_on_a_card_raises(card_env):
    env = RacingEnv(dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError, match="states must be torch.float32"):
        env.step(torch.zeros(2, dtype=torch.float64))


@pytest.mark.cuda
def test_an_eager_plant_step_is_one_launch(card_env):
    card_env.reset()
    racing_plant.launches = 0
    before = _launches()
    for _ in range(3):
        card_env.step(torch.tensor([1.0, 0.1], device="cuda"))
    assert racing_plant.launches == 3 and _launches() == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("store_rollouts", [False, True])
def test_the_controllers_replayed_ticks_launch_2t_unfused_and_none_fused(card_env,
                                                                        store_rollouts):
    from mppi_playground_tpu_torch.envs import RacingController

    ctrl = RacingController(card_env, horizon=25, num_samples=4096,
                            store_rollouts=store_rollouts)
    x = card_env.reset()
    for _ in range(2):  # eager, then the capture
        ctrl.update(x)
    torch.cuda.synchronize()
    before = _launches()
    ticks = 5
    for _ in range(ticks):
        ctrl.update(x)
    torch.cuda.synchronize()
    assert _launches() == before + ticks * (2 * 25 if store_rollouts else 0)


@pytest.mark.cuda
def test_a_fleets_replayed_episode_launches_the_kernel_once_a_tick(card_env):
    from mppi_playground_tpu_torch.core.closed_loop import make_fleet_closed_loop
    from mppi_playground_tpu_torch.core.config import MPPIConfig
    from mppi_playground_tpu_torch.models import racing_mpcc
    from mppi_playground_tpu_torch.parallel import make_batched_fused_solver

    batch, ticks = 8, 6
    path = card_env.racing_center_path
    config = MPPIConfig(horizon=25, num_samples=4096, dim_state=4, dim_control=2,
                        u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1),
                        lambda_=1.0, store_rollouts=False)
    fleet = make_batched_fused_solver(config, racing_mpcc.make_racing_fused_task_from_env(
        card_env), card_env.dynamics, "cuda", batch)

    def info_fn(cinds, xs):
        xrefs, new = racing_mpcc.calc_ref_trajectory_batch(xs, path, cinds, 25)
        return {"reference_path": xrefs}, new

    run = make_fleet_closed_loop(fleet, card_env.dynamics, ticks, info_fn=info_fn)
    states = fleet.init_batch(seed=3)
    x0s = card_env.reset().repeat(batch, 1)
    x0s[:, :3] = path[::100][:batch]
    c0 = torch.arange(batch, dtype=torch.int64, device="cuda") * 100
    first = run(states, x0s, c0)
    torch.cuda.synchronize()
    before = _launches()
    second = run(states, x0s, c0)  # every tick replayed
    torch.cuda.synchronize()
    assert _launches() == before + ticks
    assert all(torch.equal(a, b) for a, b in zip(first[1:4], second[1:4]))
