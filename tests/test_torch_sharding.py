"""The port's sample sharding on the CPU: shards against the whole, over spawned gloo ranks.

* **Rows 1, 3 and 5 per shard, in process.**  The twins of the fused solve,
  phase 1 and phase 2, each shard at its ``sample_offset`` (D = 2, 4, 8),
  concatenated and sliced to K costs and ``ceil(K / 256)`` blocks, against
  the whole twin bit for bit: K a multiple of 256·8 and the ragged
  K = 1,500 (whose last shards straddle K or are all padding), the
  inheritance threshold inside a later shard, seeded and on injected noise.
* **Spawned gloo ranks.**  One spawn of 2 ranks and one of 4
  (``parallel/mesh.run_on_ranks``), each running every
  case once; each test asserts its own case on every rank:
  - ``make_sharded_fused_solver`` against ``make_fused_solver`` for three
    warm-started ticks, racing at T=6 and the ragged K=1,500, fixed λ, MPO,
    ESSPS and LBPS, seeded and on injected noise, ``top_samples`` included:
    every output, the next state and key, bit for bit;
  - ``make_sharded_solver`` (pendulum, as ``tests/test_sharding.py``) against
    the single unfused solver with the weighted-update kernel, bit for bit;
  - the 2-D fleet (4 ranks, scenarios × samples 2 × 2, B = 4) against the
    single fused solves of each scenario, bit for bit.
* **Against the JAX package** on its 8 virtual CPU devices, at the JAX bar
  (costs rtol 1e-5, weights atol 1e-5, actions and states atol 5e-3, ESS
  rtol 1e-3): the JAX ``make_sharded_fused_solver`` (integrator, fixed λ and
  ESSPS, and the padded flagship K = 100,000 at T = 4) and
  ``make_sharded_solver`` (pendulum, on the noise the JAX solver draws, saved
  and injected here) against the port's on 2 ranks, and the JAX 2-D fleet
  (``make_batched_fused_solver`` on a (2, 2) mesh with ``sample_axis``)
  against the port's on 4 ranks.
* **The mesh functions**: ``make_mesh`` shapes and its error, the placements,
  ``initialize_distributed``'s redundant call and its propagated error.

Every comparison here held bit for bit on this CPU: no case is held at the
JAX bar in place of bitwise equality.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mppi_playground_tpu_torch.core.closed_loop import _tensors
from mppi_playground_tpu_torch.core.config import MPPIConfig, scenario_seed
from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
from mppi_playground_tpu_torch.core.solver import make_solver
from mppi_playground_tpu_torch.ops import fused_solve as fs
from mppi_playground_tpu_torch.parallel import (
    SAMPLE_AXIS,
    SCENARIO_AXIS,
    initialize_distributed,
    make_batched_fused_solver,
    make_mesh,
    make_sharded_fused_solver,
    make_sharded_solver,
    replicated,
    sample_sharding,
)
from mppi_playground_tpu_torch.parallel.mesh import run_on_ranks
from mppi_playground_tpu_torch.parallel.sharded import shard_size

T = 6
RACING_K = 1500
# threshold K * (1 - 0.3) = 1,050: inside rank 1 of 2 ([768, 1536)) and rank 2 of 4
EXPLORATION = 0.3
TICKS = 3
TOP = 8
MODES = (1.0, "MPO", "ESSPS", "LBPS")
FUSED_CASES = [f"fused {lam} {mode}" for lam in MODES for mode in ("seeded", "noise")]
UNFUSED_CASES = ["unfused 1.0", "unfused ESSPS"]
FLEET_CASES = ["fleet 1.0", "fleet ESSPS"]
FLEET_B, FLEET_TICKS = 4, 2
SIGMAS, U_MIN, U_MAX = (0.5, 0.1), (-2.0, -0.25), (2.0, 0.25)
PEND_T, PEND_K = 10, 1000
JAX_T, JAX_K, FLAGSHIP_T, FLAGSHIP_K = 6, 1500, 4, 100_000
JAX_SIGMAS = (0.5, 0.5)
JAX_FLEET_X0S = ((0.3, -0.1), (-0.5, 0.2), (1.0, 1.0), (0.0, -1.5))  # one a scenario


def _racing_config(lam, k=RACING_K):
    return MPPIConfig(horizon=T, num_samples=k, dim_state=4, dim_control=2, u_min=U_MIN,
                      u_max=U_MAX, sigmas=SIGMAS, lambda_=lam, store_rollouts=False,
                      exploration=EXPLORATION)


def _pendulum_config(lam):
    from mppi_playground_tpu_torch.models import pendulum

    return MPPIConfig(horizon=PEND_T, num_samples=PEND_K, dim_state=2, dim_control=1,
                      u_min=pendulum.U_MIN, u_max=pendulum.U_MAX, sigmas=(1.0,), lambda_=lam)


def _integrator_config(lam, k=JAX_K, horizon=JAX_T):
    from mppi_playground_tpu_torch.models import integrator

    return MPPIConfig(horizon=horizon, num_samples=k, dim_state=2, dim_control=2,
                      u_min=integrator.U_MIN, u_max=integrator.U_MAX, sigmas=JAX_SIGMAS,
                      lambda_=lam, store_rollouts=False)


def _racing():
    """The racing env, its task, the start and the tick's info (one reference, every tick)."""
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory,
        make_racing_fused_task_from_env,
    )

    env = RacingEnv(device="cpu")
    x0 = env.reset()
    xref, _ = calc_ref_trajectory(x0, env.racing_center_path, torch.tensor(0), T)
    return env, make_racing_fused_task_from_env(env), x0, {"reference_path": xref}


def _noise(name, shape, sigmas):
    seeds = {"racing": 41, "fleet": 42, "integrator": 43, "flagship": 44, "jax fleet": 45}
    rng = np.random.default_rng(seeds[name])
    return torch.from_numpy((rng.standard_normal(shape) * sigmas).astype(np.float32))


def _leaves(result, top=None) -> list:
    """A solve's outputs, its next state (key included) and its top samples, as tensors."""
    leaves = _tensors((result.action_seq, result.state_seq, result.aux.costs,
                       result.aux.weights, result.aux.lam, result.aux.ess, result.state))
    return leaves + ([] if top is None else list(top))


def _fused_run(solver, mode) -> list:
    """Three warm-started racing ticks of ``solver`` (fused), each with its top samples."""
    env, task, x0, info = _racing()
    table = _noise("racing", (TICKS, RACING_K, T, 2), SIGMAS)
    state, out = solver.init(seed=7), []
    for tick in range(TICKS):
        noise = table[tick] if mode == "noise" else None
        r = solver.solve(state, x0, info=info, noise=noise)
        out.append(_leaves(r, solver.top_samples(r.aux, TOP, noise=noise)))
        state = r.state
    return out


def _unfused_run(solver) -> list:
    x0, state, out = torch.tensor([np.pi, 0.0]), solver.init(seed=3), []
    for _ in range(TICKS):
        r = solver.solve(state, x0)
        out.append(_leaves(r))
        state = r.state
    return out


def _fleet_info(env, first, count):
    from mppi_playground_tpu_torch.models.racing_mpcc import calc_ref_trajectory_batch

    path = env.racing_center_path
    x0s = env.reset().repeat(FLEET_B, 1)
    x0s[:, :3] = path[torch.arange(FLEET_B) * 300]
    xrefs, _ = calc_ref_trajectory_batch(x0s, path, torch.zeros(FLEET_B, dtype=torch.int64), T)
    return x0s[first:first + count].contiguous(), xrefs[first:first + count]


def _fleet_run(batched, env) -> list:
    x0s, xrefs = _fleet_info(env, batched.first, batched.batch_size)
    states, out = batched.init_batch(seed=5), []
    for _ in range(FLEET_TICKS):
        r = batched.solve_batch(states, x0s, batched_info={"reference_path": xrefs})
        out.append(_leaves(r))
        states = r.state
    return out


def _fleet_single(lam, env, task) -> dict:
    """Each fleet scenario's single fused solves: ``{b: [tick leaves]}``."""
    solver = make_fused_solver(_racing_config(lam), task, env.dynamics, device="cpu")
    x0s, xrefs = _fleet_info(env, 0, FLEET_B)
    want = {}
    for b in range(FLEET_B):
        state, ticks = solver.init(seed=scenario_seed(5, b)), []
        for _ in range(FLEET_TICKS):
            r = solver.solve(state, x0s[b], info={"reference_path": xrefs[b]})
            ticks.append(_leaves(r))
            state = r.state
        want[b] = ticks
    return want


# ---------------------------------------------------------------------------
# The spawned ranks
# ---------------------------------------------------------------------------

def _jax_cases(mesh) -> dict:
    """The port's sharded solvers on the noise of the JAX references (2 ranks)."""
    from mppi_playground_tpu_torch.models import integrator

    out = {}
    for lam in (1.0, "ESSPS"):
        solver = make_sharded_fused_solver(_integrator_config(lam), integrator.fused_task(),
                                           integrator.dynamics, mesh)
        noise = _noise("integrator", (JAX_K, JAX_T, 2), JAX_SIGMAS)
        out[f"jax fused {lam}"] = _leaves(solver.solve(solver.init(), torch.tensor([0.3, -0.1]),
                                                       noise=noise))
    solver = make_sharded_fused_solver(_integrator_config(1.0, FLAGSHIP_K, FLAGSHIP_T),
                                       integrator.fused_task(), integrator.dynamics, mesh)
    noise = _noise("flagship", (FLAGSHIP_K, FLAGSHIP_T, 2), JAX_SIGMAS)
    out["jax flagship"] = _leaves(solver.solve(solver.init(), torch.tensor([0.3, -0.1]),
                                               noise=noise))
    return out


def _jax_fleet_case(grid) -> tuple:
    """The port's 2-D integrator fleet (2 x 2) on the noise of the JAX reference."""
    from mppi_playground_tpu_torch.models import integrator

    batched = make_batched_fused_solver(_integrator_config(1.0), integrator.fused_task(),
                                        integrator.dynamics, grid, FLEET_B,
                                        sample_axis=SAMPLE_AXIS)
    rows = slice(batched.first, batched.first + batched.batch_size)
    noise = _noise("jax fleet", (FLEET_B, JAX_K, JAX_T, 2), JAX_SIGMAS)[rows]
    x0s = torch.tensor(JAX_FLEET_X0S)[rows]
    r = batched.solve_batch(batched.init_batch(seed=0), x0s, noise=noise)
    return batched.first, _leaves(r)


def _rank_main(rank: int, world: int, jax_noise: str) -> dict:
    """Every case on one spawned gloo rank (``parallel/mesh.run_on_ranks``)."""
    from mppi_playground_tpu_torch.models import pendulum

    env, task, _, _ = _racing()
    mesh = make_mesh()
    results = {"mesh shape": tuple(mesh.shape)}
    for lam in MODES:
        solver = make_sharded_fused_solver(_racing_config(lam), task, env.dynamics, mesh)
        for mode in ("seeded", "noise"):
            results[f"fused {lam} {mode}"] = _fused_run(solver, mode)
    for lam in (1.0, "ESSPS"):
        solver = make_sharded_solver(_pendulum_config(lam), pendulum.dynamics,
                                     pendulum.cost, mesh)
        results[f"unfused {lam}"] = _unfused_run(solver)
    if world == 4:
        grid = make_mesh(mesh_shape=(2, 2))
        results["grid shape"] = tuple(grid.shape)
        for lam in (1.0, "ESSPS"):
            batched = make_batched_fused_solver(_racing_config(lam), task, env.dynamics,
                                                grid, FLEET_B, sample_axis=SAMPLE_AXIS)
            results[f"fleet {lam}"] = (batched.first, _fleet_run(batched, env))
        try:
            make_batched_fused_solver(_racing_config(1.0), task, env.dynamics, grid, 3)
        except ValueError as err:
            results["odd batch"] = str(err)
        results["jax fleet"] = _jax_fleet_case(grid)
    if world == 2:
        results.update(_jax_cases(mesh))
        with np.load(jax_noise) as data:
            noise = {k: torch.from_numpy(data[k]) for k in data.files if k.startswith("noise")}
        for lam in (1.0, "ESSPS"):
            solver = make_sharded_solver(_pendulum_config(lam), pendulum.dynamics,
                                         pendulum.cost, mesh)
            r = solver.solve(solver.init(), torch.tensor([np.pi, 0.0]),
                             noise=noise[f"noise_{lam}"])
            results[f"jax unfused {lam}"] = _leaves(r)
    return results


def jax_sharded_reference(out_path: str) -> None:
    """Subprocess body: the JAX sharded solvers on 8 virtual CPU devices."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    import jax.numpy as jnp

    from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
    from mppi_playground_tpu.models import integrator, pendulum
    from mppi_playground_tpu.parallel import make_mesh as jax_mesh
    from mppi_playground_tpu.parallel import make_sharded_fused_solver as jax_sharded_fused
    from mppi_playground_tpu.parallel import make_sharded_solver as jax_sharded

    mesh = jax_mesh(mesh_shape=(1, 8))
    out = {}

    def save(prefix, r):
        for key, v in dict(costs=r.aux.costs, weights=r.aux.weights, actions=r.action_seq,
                           states=r.state_seq, ess=r.aux.ess, lam=r.aux.lam).items():
            out[f"{prefix}_{key}"] = np.asarray(v)

    def integ(lam, k, horizon):
        return JaxConfig(horizon=horizon, num_samples=k, dim_state=2, dim_control=2,
                         u_min=integrator.U_MIN, u_max=integrator.U_MAX, sigmas=JAX_SIGMAS,
                         lambda_=lam, store_rollouts=False)

    x0 = jnp.asarray([0.3, -0.1], jnp.float32)
    for lam in (1.0, "ESSPS"):
        solver = jax_sharded_fused(integ(lam, JAX_K, JAX_T), integrator.fused_task(),
                                   integrator.dynamics, mesh, interpret=True)
        noise = jnp.asarray(_noise("integrator", (JAX_K, JAX_T, 2), JAX_SIGMAS).numpy())
        save(f"fused_{lam}", solver.solve(solver.init(), x0, info={}, noise=noise))
    solver = jax_sharded_fused(integ(1.0, FLAGSHIP_K, FLAGSHIP_T), integrator.fused_task(),
                               integrator.dynamics, mesh, interpret=True)
    noise = jnp.asarray(_noise("flagship", (FLAGSHIP_K, FLAGSHIP_T, 2), JAX_SIGMAS).numpy())
    save("flagship", solver.solve(solver.init(), x0, info={}, noise=noise))
    from mppi_playground_tpu.parallel.sharded import make_batched_fused_solver as jax_batched

    fleet = jax_batched(integ(1.0, JAX_K, JAX_T), integrator.fused_task(), integrator.dynamics,
                        jax_mesh(mesh_shape=(2, 2), devices=jax.devices()[:4]), FLEET_B,
                        sample_axis="samples", donate_state=False, interpret=True)
    noise = jnp.asarray(_noise("jax fleet", (FLEET_B, JAX_K, JAX_T, 2), JAX_SIGMAS).numpy())
    save("fleet", fleet.solve_batch(fleet.init_batch(seed=0), jnp.asarray(JAX_FLEET_X0S),
                                    noise=noise))
    for lam in (1.0, "ESSPS"):
        config = JaxConfig(horizon=PEND_T, num_samples=PEND_K, dim_state=2, dim_control=1,
                           u_min=pendulum.U_MIN, u_max=pendulum.U_MAX, sigmas=(1.0,),
                           lambda_=lam)
        solver = jax_sharded(config, pendulum.dynamics, pendulum.cost, mesh,
                             donate_state=False)
        state = solver.init()
        # the noise the sharded solve draws (parallel/sharded.py), injected on the port's side
        _, noise_key = jax.random.split(state.key)
        noise = jax.random.normal(noise_key, (PEND_K, PEND_T, 1), jnp.float32) * 1.0
        out[f"noise_{lam}"] = np.asarray(noise)
        save(f"unfused_{lam}", solver.solve(state, jnp.asarray([np.pi, 0.0], jnp.float32)))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    from tests.test_torch_fused_solve import run_jax_references

    return run_jax_references("tests.test_torch_sharding", ["jax_sharded_reference"],
                              tmp_path_factory.mktemp("jax_sharded"))["jax_sharded_reference"]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, jax_ref):
    """``{world: [rank results]}`` of one spawn of 2 gloo ranks and one of 4."""
    jax_noise = tmp_path_factory.mktemp("jax_noise") / "noise.npz"
    np.savez(jax_noise, **{k: v for k, v in jax_ref.items() if k.startswith("noise")})
    return {world: run_on_ranks(_rank_main, world, (str(jax_noise),), device="cpu")
            for world in (2, 4)}


@pytest.fixture(scope="module")
def single():
    """The single solvers' runs of every spawned case, on this process."""
    from mppi_playground_tpu_torch.models import pendulum

    env, task, _, _ = _racing()
    want = {}
    for lam in MODES:
        solver = make_fused_solver(_racing_config(lam), task, env.dynamics, device="cpu")
        for mode in ("seeded", "noise"):
            want[f"fused {lam} {mode}"] = _fused_run(solver, mode)
    for lam in (1.0, "ESSPS"):
        solver = make_solver(_pendulum_config(lam), pendulum.dynamics, pendulum.cost,
                             device="cpu")
        want[f"unfused {lam}"] = _unfused_run(solver)
        want[f"fleet {lam}"] = _fleet_single(lam, env, task)
    return want


def _bitwise(got, want) -> bool:
    return len(got) == len(want) and all(
        a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# Rows 1, 3 and 5 per shard (the twins, in process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["seeded", "noise"])
@pytest.mark.parametrize("k", [2048, RACING_K])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_shards_of_rows_1_3_5_are_the_whole_launch(shards, k, mode):
    env, task, x0, info = _racing()
    from mppi_playground_tpu_torch.models.racing_mpcc import extend_reference_path

    ref = extend_reference_path(info["reference_path"]).contiguous()
    rng = np.random.default_rng(3)
    prev = torch.from_numpy((rng.standard_normal((T, 2)) * 0.1).astype(np.float32))
    lam = torch.tensor([0.7])
    threshold = 1100  # in a later shard at every D
    noise = _noise("racing", (k, T, 2), SIGMAS) if mode == "noise" else None
    bounds = (SIGMAS, U_MIN, U_MAX)
    whole = fs.fused_solve_plain(x0, prev, lam, 1234, ref, task, *bounds, k, threshold, noise)
    w_costs, w_dump = fs.fused_costs_dump_plain(x0, prev, 1234, ref, task, *bounds, k,
                                                threshold, noise)
    w_p2 = fs.fused_weighted_plain(w_costs, w_dump, lam)
    local, blocks = shard_size(k, shards), -(-k // 256)
    assert local % 256 == 0 and local * shards >= k
    rows1, rows3, rows5 = [], [], []
    for rank in range(shards):
        offset, rows = rank * local, None
        if noise is not None:
            rows = noise[offset:offset + local]
            rows = torch.cat([rows, rows.new_zeros(local - rows.shape[0], T, 2)])
        rows1.append(fs.fused_solve_plain(x0, prev, lam, 1234, ref, task, *bounds, local,
                                          threshold, rows, offset, k))
        phase1 = fs.fused_costs_dump_plain(x0, prev, 1234, ref, task, *bounds, local,
                                           threshold, rows, offset, k)
        rows3.append(phase1)
        rows5.append(fs.fused_weighted_plain(*phase1, lam, offset, k))
        past = torch.arange(offset, offset + local) >= k  # a shard's samples past K
        assert torch.all(phase1[0][past] == 1e30) and torch.all(phase1[1][:, past] == 0)
    assert torch.equal(torch.cat([r[0] for r in rows1])[:k], whole[0])
    assert torch.equal(torch.cat([r[1] for r in rows1])[:blocks], whole[1])
    assert torch.equal(torch.cat([r[2] for r in rows1])[:blocks], whole[2])
    assert torch.equal(torch.cat([r[0] for r in rows3])[:k], w_costs)
    assert torch.equal(torch.cat([r[1] for r in rows3], dim=1)[:, :k], w_dump)
    assert torch.equal(torch.cat([r[0] for r in rows5])[:blocks], w_p2[0])
    assert torch.equal(torch.cat([r[1] for r in rows5])[:blocks], w_p2[1])


def test_seeded_normals_of_a_shard_are_its_rows_of_the_stream():
    whole = fs.seeded_normals(99, 1024, T, "cpu", 2)
    assert torch.equal(fs.seeded_normals(99, 256, T, "cpu", 2, sample_offset=512), whole[512:768])


def test_a_shard_past_k_draws_no_rows_and_moves_the_key_on():
    """An unfused shard whose rows all lie past K (K=1,000 over 8 ranks: ranks 4-7)."""
    from mppi_playground_tpu_torch.core.config import advance_key_plain, make_key
    from mppi_playground_tpu_torch.core.solver import make_perturbations

    config = _pendulum_config(1.0)
    key = make_key(3, 0, "cpu")
    rows, key_out = make_perturbations(config, torch.device("cpu"))(
        key, torch.zeros(PEND_T, 1), None, PEND_K, 0)
    assert rows.shape == (0, PEND_T, 1) and torch.equal(key_out, advance_key_plain(key))


def test_a_shard_offset_must_be_whole_blocks():
    with pytest.raises(ValueError, match="multiple of 256"):
        fs._shard(256, 100, 1000)


# ---------------------------------------------------------------------------
# Spawned gloo ranks against the single solvers, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_sharded_fused_solver_is_the_single_solver(spawned, single, world, case):
    for rank, results in enumerate(spawned[world]):
        for tick, (got, want) in enumerate(zip(results[case], single[case])):
            assert _bitwise(got, want), f"rank {rank} of {world}, tick {tick}"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", UNFUSED_CASES)
def test_sharded_unfused_solver_is_the_single_solver(spawned, single, world, case):
    for rank, results in enumerate(spawned[world]):
        for tick, (got, want) in enumerate(zip(results[case], single[case])):
            assert _bitwise(got, want), f"rank {rank} of {world}, tick {tick}"


@pytest.mark.parametrize("case", FLEET_CASES)
def test_two_d_fleet_is_the_independent_solves(spawned, single, case):
    """Scenarios × samples 2 × 2: each rank's two scenarios, its sample shard gathered."""
    firsts = set()
    for rank, results in enumerate(spawned[4]):
        first, ticks = results[case]
        firsts.add(first)
        for tick, leaves in enumerate(ticks):
            for b in range(FLEET_B // 2):
                want = single[case][first + b][tick]
                assert _bitwise([leaf[b] for leaf in leaves], want), (
                    f"rank {rank}, scenario {first + b}, tick {tick}")
    assert firsts == {0, 2}


def test_meshes_of_the_spawned_ranks(spawned):
    assert [r["mesh shape"] for r in spawned[2]] == [(1, 2)] * 2
    assert [r["mesh shape"] for r in spawned[4]] == [(1, 4)] * 4
    assert [r["grid shape"] for r in spawned[4]] == [(2, 2)] * 4


def test_a_batch_that_does_not_divide_raises(spawned):
    for r in spawned[4]:
        assert r["odd batch"] == "batch_size (3) must divide over 2 scenario shards"


# ---------------------------------------------------------------------------
# Against the JAX package's sharded solvers, at the JAX bar
# ---------------------------------------------------------------------------

def _meets_jax(got, jax_ref, prefix):
    actions, states, costs, weights, lam, ess = (got[0], got[1], got[2], got[3], got[4], got[5])
    np.testing.assert_allclose(costs.numpy(), jax_ref[f"{prefix}_costs"], rtol=1e-5)
    np.testing.assert_allclose(weights.numpy(), jax_ref[f"{prefix}_weights"], atol=1e-5)
    np.testing.assert_allclose(actions.numpy(), jax_ref[f"{prefix}_actions"], atol=5e-3)
    np.testing.assert_allclose(states.numpy(), jax_ref[f"{prefix}_states"], atol=5e-3)
    np.testing.assert_allclose(float(ess), float(jax_ref[f"{prefix}_ess"]), rtol=1e-3)
    np.testing.assert_allclose(float(lam), float(jax_ref[f"{prefix}_lam"]), rtol=1e-3)


def test_two_d_fleet_meets_jax(spawned, jax_ref):
    """The 2 x 2 fleet of 4 ranks against the JAX one on a (2, 2) mesh, scenario by scenario."""
    for results in spawned[4]:
        first, got = results["jax fleet"]
        for b in range(FLEET_B // 2):
            rows = {key[len("fleet_"):]: v[first + b] for key, v in jax_ref.items()
                    if key.startswith("fleet_")}
            _meets_jax([leaf[b] for leaf in got], {f"one_{k}": v for k, v in rows.items()},
                       "one")


@pytest.mark.parametrize("case", ["fused 1.0", "fused ESSPS", "flagship", "unfused 1.0",
                                  "unfused ESSPS"])
def test_sharded_solvers_meet_jax(spawned, jax_ref, case):
    key = {"flagship": "jax flagship"}.get(case, f"jax {case}")
    prefix = case.replace(" ", "_")
    for results in spawned[2]:
        _meets_jax(results[key], jax_ref, prefix)
    if case == "flagship":
        assert spawned[2][0][key][2].shape == (FLAGSHIP_K,)


# ---------------------------------------------------------------------------
# The mesh functions
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    initialize_distributed(f"file://{tmp_path / 'init'}", 1, 0, device="cpu")
    yield
    dist.destroy_process_group()


def test_make_mesh_shapes_and_its_error(one_rank):
    mesh = make_mesh()
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == (SCENARIO_AXIS, SAMPLE_AXIS)
    with pytest.raises(ValueError, match=r"mesh_shape \(2, 1\) does not match 1 devices"):
        make_mesh(mesh_shape=(2, 1))


def test_placements(one_rank):
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_mesh()
    assert sample_sharding(mesh, 3) == (Replicate(), Shard(0))
    assert sample_sharding(mesh, 1, axis=SCENARIO_AXIS) == (Shard(0), Replicate())
    assert replicated(mesh) == (Replicate(), Replicate())


def test_initialize_distributed_leaves_a_group_as_it_is(one_rank, tmp_path):
    group = dist.group.WORLD
    initialize_distributed(f"file://{tmp_path / 'other'}", 2, 1, device="cpu")
    assert dist.group.WORLD is group and dist.get_world_size() == 1


def test_initialize_distributed_propagates_other_errors(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    initialize_distributed(single_host=True)  # the explicit no-op
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        initialize_distributed(device="cpu")
    assert not dist.is_initialized()
