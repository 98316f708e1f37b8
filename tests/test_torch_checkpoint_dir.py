"""The port's directory checkpoint (``torch.distributed.checkpoint``) on the CPU.

Mirrors the Orbax tests of ``tests/test_checkpoint.py``: a round trip
resumes bit for bit (the unfused ESSPS pendulum and a fused MPO racing
state, whose host seed, tick and device key ride along), a mismatched
template is rejected with the JAX message, an asynchronous save is readable
after ``wait_until_saved``, and a fleet's state sharded over the scenario
axis of two spawned gloo ranks (DTensors, ``Shard(0)`` on the scenario
axis) comes back with the template's placements, each rank holding only its
own scenarios' rows.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mppi_playground_tpu_torch.core.config import MPPIConfig
from mppi_playground_tpu_torch.core.solver import make_init, make_solver
from mppi_playground_tpu_torch.models import pendulum
from mppi_playground_tpu_torch.utils.checkpoint import (
    load_state_orbax,
    save_state_orbax,
    wait_until_saved,
)

FLEET_B = 4


def _solver(lambda_):
    config = MPPIConfig(horizon=8, num_samples=128, dim_state=2, dim_control=1,
                        u_min=pendulum.U_MIN, u_max=pendulum.U_MAX, sigmas=(1.0,),
                        lambda_=lambda_)
    return make_solver(config, pendulum.dynamics, pendulum.cost, device="cpu")


def _bitwise(a, b) -> bool:
    from mppi_playground_tpu_torch.core.closed_loop import _tensors

    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def test_directory_roundtrip_resumes_identically(tmp_path):
    solver = _solver("ESSPS")
    state = solver.init(seed=0)
    x = torch.tensor([np.pi, 0.0])
    for _ in range(3):
        state = solver.solve(state, x).state

    path = save_state_orbax(str(tmp_path / "dir_ckpt"), state)
    restored = load_state_orbax(path, solver.init())
    assert (restored.seed, restored.tick) == (state.seed, state.tick)
    assert torch.equal(restored.key, state.key)

    direct, again = solver.solve(state, x), solver.solve(restored, x)
    assert torch.equal(direct.action_seq, again.action_seq)
    assert torch.equal(direct.state.lam, again.state.lam)


def test_a_fused_mpo_state_roundtrips(tmp_path):
    from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
    from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
    from mppi_playground_tpu_torch.models.racing_mpcc import (
        calc_ref_trajectory,
        make_racing_fused_task_from_env,
    )

    env = RacingEnv(device="cpu")
    config = MPPIConfig(horizon=6, num_samples=512, dim_state=4, dim_control=2,
                        u_min=(-2.0, -0.25), u_max=(2.0, 0.25), sigmas=(0.5, 0.1),
                        lambda_="MPO", store_rollouts=False)
    solver = make_fused_solver(config, make_racing_fused_task_from_env(env), env.dynamics,
                               device="cpu")
    x = env.reset()
    info = {"reference_path": calc_ref_trajectory(x, env.racing_center_path,
                                                  torch.tensor(0), 6)[0]}
    state = solver.init(seed=2**40 + 5)  # a seed past 32 bits rides along as host JSON
    for _ in range(2):
        state = solver.solve(state, x, info=info).state
    restored = load_state_orbax(save_state_orbax(str(tmp_path / "mpo"), state), solver.init())
    assert _bitwise(restored, state) and restored.seed == state.seed
    assert _bitwise(solver.solve(restored, x, info=info), solver.solve(state, x, info=info))


def test_directory_mismatched_template_rejected(tmp_path):
    def cfg(horizon):
        return MPPIConfig(horizon=horizon, num_samples=64, dim_state=2, dim_control=2,
                          u_min=(-1.0, -1.0), u_max=(1.0, 1.0), sigmas=(1.0, 1.0), lambda_=1.0)

    path = save_state_orbax(str(tmp_path / "st"), make_init(cfg(4), torch.device("cpu"))())
    with pytest.raises(ValueError, match="solver config"):
        load_state_orbax(path, make_init(cfg(8), torch.device("cpu"))())
    mpo = dict(lambda_="MPO")  # more leaves (the Adam state) than the checkpoint holds
    with pytest.raises(ValueError, match="solver config"):
        load_state_orbax(path, make_init(MPPIConfig(**{**cfg(4).__dict__, **mpo}),
                                         torch.device("cpu"))())


def test_directory_async_save_commits_after_wait(tmp_path):
    state = {"a": torch.arange(8.0), "b": torch.full((2, 3), 7.0)}
    path = save_state_orbax(str(tmp_path / "async_ck"), state, wait=False)
    wait_until_saved()  # join the background write
    restored = load_state_orbax(path, {"a": torch.zeros(8), "b": torch.zeros(2, 3)})
    assert torch.equal(restored["a"], torch.arange(8.0))
    assert torch.equal(restored["b"], torch.full((2, 3), 7.0))


# ---------------------------------------------------------------------------
# A fleet state sharded over the scenario axis of two gloo ranks
# ---------------------------------------------------------------------------

def _fleet_state():
    from mppi_playground_tpu_torch.parallel import make_batched_solver

    return make_batched_solver(_solver(1.0).config, pendulum.dynamics, pendulum.cost, "cpu",
                               FLEET_B).init_batch(seed=11)


def _sharded_rank(rank: int, init_file: str, out_dir: str) -> None:
    from mppi_playground_tpu_torch.core.closed_loop import _map, _tensors
    from mppi_playground_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    initialize_distributed(f"file://{init_file}", 2, rank, device="cpu")
    try:
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        mesh = make_mesh(mesh_shape=(2, 1))  # two scenario shards
        spec = (Shard(0), Replicate())
        full = _fleet_state()
        sharded = _map(lambda t: distribute_tensor(t, mesh, spec), full)
        path = save_state_orbax(str(Path(out_dir) / "fleet"), sharded)
        template = _map(lambda t: distribute_tensor(torch.zeros_like(t), mesh, spec), full)
        restored = load_state_orbax(path, template)
        leaves, want = _tensors(restored), _tensors(full)
        res = dict(
            placements=all(t.placements == spec and t.device_mesh == mesh for t in leaves),
            local_rows=[t.to_local().shape[0] for t in leaves],
            local_is_own=all(torch.equal(t.to_local(), w[2 * rank:2 * rank + 2])
                             for t, w in zip(leaves, want)),
            values=all(torch.equal(t.full_tensor(), w) for t, w in zip(leaves, want)),
            host=(restored.seed, restored.tick) == (full.seed, full.tick),
            template_untouched=all(bool((t.to_local() == 0).all()) for t in _tensors(template)),
        )
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded_restore(tmp_path_factory):
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("dcp_fleet")
    mp.spawn(_sharded_rank, args=(str(d / "init"), str(d)), nprocs=2, join=True)
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(2)]


def test_sharded_fleet_state_restores_with_the_template_placements(sharded_restore):
    for res in sharded_restore:
        assert res["placements"] and res["values"] and res["host"]
        assert res["template_untouched"]


def test_each_rank_reads_only_its_own_scenarios(sharded_restore):
    for res in sharded_restore:
        assert res["local_is_own"] and set(res["local_rows"]) == {FLEET_B // 2}
