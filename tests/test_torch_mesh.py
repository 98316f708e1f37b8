"""The process group, the mesh's device and two API counterparts, on the CPU.

* **The directory checkpoint in any process group.**  On a one-rank group
  with no CPU backend (``cuda:gloo``, as an NCCL-only group is on the
  card), ``save_state_orbax`` with and without ``wait`` then
  ``load_state_orbax`` restore a solver's state bit for bit.
* **``cuda_backend``** reads the backend that serves CUDA tensors from a
  plain or a mixed backend string, and from a live group.
* **``initialize_distributed`` makes its device current**: ``"cuda:1"``, or
  ``LOCAL_RANK``'s card under torchrun, with ``torch.cuda.set_device`` and
  ``current_device`` patched (no card here); a CUDA device gets the mixed
  ``"cpu:gloo,cuda:nccl"`` group.
* **``Navigation2DEnv.obstacle_cost_map``** answers as the JAX property's
  map does at the same points.
* **``make_batched_solver(..., sample_axis=...)``** on 2 and 4 spawned gloo
  ranks with a ``(scenario, samples)`` mesh: every scenario's results bit for
  bit its single unfused solve, seeded and on injected noise; on a sample
  axis of one rank and on a 1-D mesh, the scenario-by-scenario solver.
"""

import math
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mppi_playground_tpu_torch.core.closed_loop import _tensors
from mppi_playground_tpu_torch.core.config import MPPIConfig, scenario_seed
from mppi_playground_tpu_torch.core.solver import make_solver
from mppi_playground_tpu_torch.models import pendulum
from mppi_playground_tpu_torch.parallel import (
    SAMPLE_AXIS,
    cuda_backend,
    initialize_distributed,
    make_batched_solver,
    make_mesh,
)
from mppi_playground_tpu_torch.parallel.mesh import mesh_device, run_on_ranks
from mppi_playground_tpu_torch.utils.checkpoint import (
    load_state_orbax,
    save_state_orbax,
    wait_until_saved,
)

PEND_T, PEND_K = 10, 1000  # K ragged: a shard's last rows are padding
TICKS = 2


def _config(lam):
    return MPPIConfig(horizon=PEND_T, num_samples=PEND_K, dim_state=2, dim_control=1,
                      u_min=pendulum.U_MIN, u_max=pendulum.U_MAX, sigmas=(1.0,), lambda_=lam)


def _bitwise(a, b) -> bool:
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(x.shape == y.shape and x.dtype == y.dtype
                                      and torch.equal(x, y) for x, y in zip(ta, tb))


# ---------------------------------------------------------------------------
# The directory checkpoint on a group without a CPU backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wait", [True, False])
def test_directory_checkpoint_on_a_group_without_a_cpu_backend(tmp_path, wait):
    solver = make_solver(_config("ESSPS"), pendulum.dynamics, pendulum.cost, device="cpu")
    state = solver.init(seed=0)
    for _ in range(3):
        state = solver.solve(state, torch.tensor([math.pi, 0.0])).state
    dist.init_process_group("cuda:gloo", init_method=f"file://{tmp_path}/init", world_size=1,
                            rank=0)
    try:
        assert cuda_backend() == "gloo"
        path = save_state_orbax(str(tmp_path / "ckpt"), state, wait=wait)
        wait_until_saved()
        restored = load_state_orbax(path, solver.init())
    finally:
        dist.destroy_process_group()
    assert _bitwise(restored, state)
    assert (restored.seed, restored.tick) == (state.seed, state.tick)


# ---------------------------------------------------------------------------
# cuda_backend and initialize_distributed's device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec, want", [
    ("nccl", "nccl"), ("gloo", "gloo"), ("cpu:gloo,cuda:nccl", "nccl"),
    ("cuda:nccl,cpu:gloo", "nccl"), ("cuda:gloo", "gloo"), ("cpu:gloo", None),
])
def test_cuda_backend_reads_a_backend_string(spec, want):
    assert cuda_backend(backend=spec) == want


@pytest.fixture
def fake_card(monkeypatch):
    """A card that is not there: the current device and the group's arguments, recorded."""
    calls = {"current": 0, "init": []}

    def set_device(index):
        calls["current"] = torch.device(index).index if not isinstance(index, int) else index

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: calls["current"])
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls["init"].append((backend, kw)))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    return calls


@pytest.mark.parametrize("device, local_rank, want", [
    ("cuda:1", None, 1), ("cuda:2", "0", 2), (None, "3", 3), ("cuda", "1", 1), (None, None, 0),
])
def test_initialize_distributed_makes_its_device_current(fake_card, monkeypatch, device,
                                                         local_rank, want):
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    initialize_distributed("localhost:1234", 4, 1, device=device)
    (backend, kw), = fake_card["init"]
    assert backend == "cpu:gloo,cuda:nccl"
    assert kw == dict(init_method="tcp://localhost:1234", world_size=4, rank=1)
    assert mesh_device(types.SimpleNamespace(device_type="cuda")) == torch.device("cuda", want)


def test_initialize_distributed_on_the_cpu_leaves_the_card_alone(fake_card):
    fake_card["current"] = 5
    initialize_distributed("localhost:1234", 2, 0, device="cpu")
    assert fake_card["init"][0][0] == "gloo" and fake_card["current"] == 5
    initialize_distributed("localhost:1234", 2, 0, device="cuda:0", backend="gloo")
    assert fake_card["init"][1][0] == "gloo" and fake_card["current"] == 0


# ---------------------------------------------------------------------------
# Navigation2DEnv.obstacle_cost_map
# ---------------------------------------------------------------------------

def test_navigation_obstacle_cost_map_answers_as_the_jax_map():
    import jax.numpy as jnp

    from mppi_playground_tpu.envs import Navigation2DEnv as JaxEnv
    from mppi_playground_tpu.maps.grid_cost import map_query as jax_query
    from mppi_playground_tpu_torch.envs import Navigation2DEnv
    from mppi_playground_tpu_torch.maps.grid_cost import map_query

    env = Navigation2DEnv(device="cpu")
    rng = np.random.default_rng(0)
    points = rng.uniform(-10.5, 10.5, (20_000, 2)).astype(np.float32)
    # and the cell centres and edges of the whole grid
    cells = np.arange(-10.0, 10.0, 0.05, dtype=np.float32)
    grid = np.stack(np.meshgrid(cells, cells, indexing="ij"), -1).reshape(-1, 2)
    points = np.concatenate([points, grid])
    got = map_query(env.obstacle_cost_map, torch.from_numpy(points)).numpy()
    want = np.asarray(jax_query(JaxEnv().obstacle_cost_map, jnp.asarray(points)))
    assert 0 < got.sum() < len(points)
    np.testing.assert_array_equal(got, want)
    # cost_function is built from it: goal distance + the weighted occupancy
    states = torch.from_numpy(np.c_[points, np.zeros(len(points))].astype(np.float32))
    d = states[:, :2] - env.goal_pos
    goal = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    assert torch.equal(env.cost_function(states, None, {}),
                       goal + 10000.0 * torch.from_numpy(got))


# ---------------------------------------------------------------------------
# The unfused fleet with each scenario's samples sharded
# ---------------------------------------------------------------------------

BATCH = 4
MESHES = {2: {"samples": (1, 2), "scenarios": (2, 1), "1-D": None}, 4: {"grid": (2, 2)}}
CASES = [(world, mesh, lam, mode) for world, meshes in MESHES.items() for mesh in meshes
         for lam in (1.0, "ESSPS") for mode in ("seeded", "noise")]


def _starts(batch):
    return torch.tensor([[math.pi, 0.0], [2.5, -1.0], [-2.0, 0.5], [0.5, 3.0]][:batch])


def _noise(batch):
    rng = np.random.default_rng(17)
    return torch.from_numpy(rng.standard_normal((TICKS, batch, PEND_K, PEND_T, 1))
                            .astype(np.float32))


def _fleet_run(batched, batch, mode) -> dict:
    """``{scenario b: [tick leaves]}`` of this rank's scenarios."""
    rows = slice(batched.first, batched.first + batched.batch_size)
    x0s, noise = _starts(batch)[rows], _noise(batch)[:, rows]
    states, out = batched.init_batch(seed=5), {b: [] for b in range(rows.start, rows.stop)}
    for tick in range(TICKS):
        r = batched.solve_batch(states, x0s, noise=noise[tick] if mode == "noise" else None)
        for i, b in enumerate(out):
            out[b].append(_tensors((r.action_seq[i], r.state_seq[i], r.aux.costs[i],
                                    r.aux.weights[i], r.aux.lam[i], r.aux.ess[i]))
                          + [t[i] for t in _tensors(r.state)])
        states = r.state
    return out


def _single_run(lam, batch, mode) -> dict:
    solver = make_solver(_config(lam), pendulum.dynamics, pendulum.cost, device="cpu")
    x0s, noise, out = _starts(batch), _noise(batch), {}
    for b in range(batch):
        state, ticks = solver.init(seed=scenario_seed(5, b)), []
        for tick in range(TICKS):
            r = solver.solve(state, x0s[b], noise=noise[tick, b] if mode == "noise" else None)
            ticks.append(_tensors((r.action_seq, r.state_seq, r.aux.costs, r.aux.weights,
                                   r.aux.lam, r.aux.ess)) + _tensors(r.state))
            state = r.state
        out[b] = ticks
    return out


def _rank_main(rank: int, world: int) -> dict:
    """Every case of ``world`` ranks on one spawned gloo rank (``parallel/mesh.run_on_ranks``)."""
    from torch.distributed.device_mesh import DeviceMesh

    results = {}
    for name, shape in MESHES[world].items():
        mesh = (DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("scenario",))
                if shape is None else make_mesh(mesh_shape=shape))
        for lam in (1.0, "ESSPS"):
            batched = make_batched_solver(_config(lam), pendulum.dynamics, pendulum.cost,
                                          mesh, BATCH, sample_axis=SAMPLE_AXIS)
            for mode in ("seeded", "noise"):
                results[f"{world} {name} {lam} {mode}"] = (
                    type(batched.solver).__name__, _fleet_run(batched, BATCH, mode))
    return results


@pytest.fixture(scope="module")
def spawned():
    """``{case: [each rank's (solver type, {scenario: tick leaves})]}``."""
    out = {}
    for world in MESHES:
        for results in run_on_ranks(_rank_main, world, device="cpu"):
            for case, res in results.items():
                out.setdefault(case, []).append(res)
    return out


@pytest.mark.parametrize("world, mesh, lam, mode", CASES)
def test_batched_solver_with_a_sample_axis_is_each_scenarios_single_solve(
        spawned, world, mesh, lam, mode):
    want = _single_run(lam, BATCH, mode)
    ranks = spawned[f"{world} {mesh} {lam} {mode}"]
    sharded = MESHES[world][mesh] is not None and MESHES[world][mesh][1] > 1
    seen = set()
    for kind, scenarios in ranks:
        assert kind == ("ShardedMPPISolver" if sharded else "MPPISolver")
        for b, ticks in scenarios.items():
            seen.add(b)
            for got, ref in zip(ticks, want[b]):
                assert len(got) == len(ref) and all(
                    torch.equal(x, y) for x, y in zip(got, ref)), (b, kind)
    assert seen == set(range(BATCH))
