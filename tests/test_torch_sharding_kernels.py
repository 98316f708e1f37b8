"""Sample sharding on the card: rows 1, 3 and 5 per shard, and the sharded solver on one rank.

These need an NVIDIA GPU with ``nvcc``; they skip without a card (marker
``cuda``), and ``chip_smoke.py`` phase 14 runs the same checks at the
flagship's size.  At T=25, K=4,096 (a full last block) and K=1,500 (a ragged
one) for B=3 scenarios, D = 2, 4, 8, both noise modes: each shard's launch at
its sample offset, concatenated and sliced, is the whole launch bit for bit,
and a shard's launch equals its twin's costs and dump bit for bit.  On a
one-rank NCCL group, ``make_sharded_fused_solver`` gives the single fused
solver's three ticks bit for bit.
"""

import pytest
import torch

from mppi_playground_tpu_torch.envs import RacingEnv
from mppi_playground_tpu_torch.models.racing_mpcc import (
    calc_ref_trajectory_batch,
    extend_reference_path,
    make_racing_fused_task_from_env,
)
from mppi_playground_tpu_torch.ops import fused_solve as fs
from mppi_playground_tpu_torch.parallel.sharded import shard_size

pytestmark = pytest.mark.cuda

B, T = 3, 25
BOUNDS = ((0.5, 0.1), (-2.0, -0.25), (2.0, 0.25))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py phase 14 runs these on the card")
    return RacingEnv(device="cuda")


def _inputs(env, k):
    g = torch.Generator(device="cpu").manual_seed(1)
    path = env.racing_center_path
    x0s = env.reset().repeat(B, 1)
    x0s[:, :3] = path[torch.tensor([0, 400, 900], device=path.device)]
    xrefs, _ = calc_ref_trajectory_batch(x0s, path, torch.zeros(B, dtype=torch.int64,
                                                               device="cuda"), T)
    prevs = (torch.randn(B, T, 2, generator=g) * 0.3).cuda()
    noise = (torch.randn(B, k, T, 2, generator=g) * torch.tensor(BOUNDS[0])).cuda()
    return x0s.contiguous(), prevs, extend_reference_path(xrefs).contiguous(), noise


@pytest.mark.parametrize("mode", ["seeded", "noise"])
@pytest.mark.parametrize("k", [4096, 1500])
def test_shard_launches_are_the_whole_launch(card, k, mode):
    task = make_racing_fused_task_from_env(card)
    x0s, prevs, refs, noise = _inputs(card, k)
    nz = noise if mode == "noise" else None
    lams = torch.tensor([0.5, 1.0, 2.0], device="cuda")
    seeds = [11, 12, 13]
    threshold, blocks = k * 3 // 4, -(-k // 256)
    args = (x0s, prevs)
    whole1 = fs.fused_solve_batch(*args, lams, seeds, refs, task, *BOUNDS, k, threshold, nz)
    whole3 = fs.fused_costs_dump_batch(*args, seeds, refs, task, *BOUNDS, k, threshold, nz)
    whole5 = fs.fused_weighted_batch(*whole3, lams)
    for shards in (2, 4, 8):
        local = shard_size(k, shards)
        parts = []
        for rank in range(shards):
            off, rows = rank * local, None
            if nz is not None:
                rows = nz[:, off:off + local]
                rows = torch.cat([rows, rows.new_zeros(B, local - rows.shape[1], T, 2)], 1)
            sampling = (*BOUNDS, local, threshold, rows, off, k)
            p1 = fs.fused_solve_batch(*args, lams, seeds, refs, task, *sampling)
            p3 = fs.fused_costs_dump_batch(*args, seeds, refs, task, *sampling)
            p5 = fs.fused_weighted_batch(*p3, lams, off, k)
            twin = fs.fused_costs_dump_batch_plain(*args, seeds, refs, task, *sampling)
            assert torch.equal(p3[0], twin[0]) and torch.equal(p3[1], twin[1])
            parts.append((p1, p3, p5))
        assert torch.equal(torch.cat([p[0][0] for p in parts], 1)[:, :k], whole1[0])
        for i in (1, 2):
            assert torch.equal(torch.cat([p[0][i] for p in parts], 1)[:, :blocks], whole1[i])
            assert torch.equal(torch.cat([p[2][i - 1] for p in parts], 1)[:, :blocks],
                               whole5[i - 1])
        assert torch.equal(torch.cat([p[1][0] for p in parts], 1)[:, :k], whole3[0])
        assert torch.equal(torch.cat([p[1][1] for p in parts], 2)[:, :, :k], whole3[1])


def test_sharded_solver_on_one_nccl_rank_is_the_single_solver(card, tmp_path):
    import torch.distributed as dist

    from mppi_playground_tpu_torch.core.config import MPPIConfig
    from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
    from mppi_playground_tpu_torch.models.racing_mpcc import calc_ref_trajectory
    from mppi_playground_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        make_sharded_fused_solver,
    )

    initialize_distributed(f"file://{tmp_path / 'init'}", 1, 0, device="cuda")
    try:
        config = MPPIConfig(horizon=T, num_samples=1500, dim_state=4, dim_control=2,
                            u_min=BOUNDS[1], u_max=BOUNDS[2], sigmas=BOUNDS[0], lambda_="ESSPS",
                            store_rollouts=False)
        task = make_racing_fused_task_from_env(card)
        sharded = make_sharded_fused_solver(config, task, card.dynamics, make_mesh())
        single = make_fused_solver(config, task, card.dynamics, device="cuda",
                                   lambda_epilogue=False)
        x = card.reset()
        info = {"reference_path": calc_ref_trajectory(
            x, card.racing_center_path, torch.zeros((), dtype=torch.int64, device="cuda"), T)[0]}
        a, b = sharded.init(), single.init()
        for _ in range(3):
            ra, rb = sharded.solve(a, x, info=info), single.solve(b, x, info=info)
            for got, want in ((ra.action_seq, rb.action_seq), (ra.aux.costs, rb.aux.costs),
                              (ra.aux.weights, rb.aux.weights), (ra.aux.lam, rb.aux.lam),
                              (ra.state.key, rb.state.key)):
                assert torch.equal(got, want)
            a, b = ra.state, rb.state
    finally:
        dist.destroy_process_group()
