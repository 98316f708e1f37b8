"""Diagnostics of the port against the JAX package, on the CPU: top samples and the posterior.

* Top-k order: on weights with many exact zeros the port's indices equal
  ``jax.lax.top_k``'s (descending, lower index first among ties).
* Fused ``top_samples`` (the regeneration twin and a re-roll of the top n)
  against the unfused solver's stored-rollout ``top_samples``, racing T=8,
  K=1,500 (a padded last block), at a fixed lambda and under ESSPS, and the
  same against the JAX ``make_solver(store_rollouts=True)`` with JAX
  ``diagnostics.top_samples``: weights atol 1e-5, states atol 5e-4, the
  JAX package's bar for its fused top samples against XLA
  (tests/test_fused_solve.py).  The JAX side runs in a subprocess with
  XLA's FMA contraction off (see tests/test_torch_fused_solve.py), so its
  costs and the port's round alike.
* The regeneration twin in noise mode against the JAX ``run_regen`` in
  interpret mode, T=8: bitwise (a clamp of ``prev + noise``).  Seeded, the
  twin at all K equals phase 1's dump bit for bit, and any subset of rows
  equals those rows.
* The posterior: shapes, moments within 3 sigma / sqrt(N), and its
  predicted states against the JAX ``states_prediction`` (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_playground_tpu.core.solver import make_states_prediction as jax_states_prediction
from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
from mppi_playground_tpu.models import pendulum
from mppi_playground_tpu_torch import MPPI
from mppi_playground_tpu_torch.core import diagnostics
from mppi_playground_tpu_torch.core.config import MPPIConfig, tick_seed
from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
from mppi_playground_tpu_torch.core.solver import make_solver
from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
from mppi_playground_tpu_torch.models.racing_mpcc import (
    calc_ref_trajectory,
    make_mpcc_cost,
    make_racing_fused_task_from_env,
)
from mppi_playground_tpu_torch.ops import fused_solve
from tests.test_oracle_parity import torch_pendulum_cost, torch_pendulum_dynamics
from tests.test_torch_fused_solve import run_jax_references

HORIZON, K, TOP = 8, 1500, 300
SIGMAS = (0.5, 0.1)
U_MIN, U_MAX = (-2.0, -0.25), (2.0, 0.25)
MODES = (1.0, "ESSPS")
REGEN_K = 700


def _config(lambda_, store_rollouts):
    return dict(horizon=HORIZON, num_samples=K, dim_state=4, dim_control=2, u_min=U_MIN,
                u_max=U_MAX, sigmas=SIGMAS, lambda_=lambda_, store_rollouts=store_rollouts,
                exploration=0.2)


def _noise(seed, k=K):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, HORIZON, 2)) * SIGMAS).astype(np.float32)


def _start(env_reset):
    return (np.asarray(env_reset) + np.array([0.1, -0.1, 0.05, 5.0])).astype(np.float32)


def jax_top_samples_reference(out_path: str) -> None:
    """Subprocess body: JAX XLA solves with stored rollouts and their top samples."""
    jax.config.update("jax_platforms", "cpu")
    from mppi_playground_tpu.core import diagnostics as jax_diag
    from mppi_playground_tpu.core.solver import make_solver as jax_make_solver
    from mppi_playground_tpu.envs.racing_env import RacingEnv as JaxRacingEnv
    from mppi_playground_tpu.models import racing_mpcc

    env = JaxRacingEnv()
    cost = racing_mpcc.make_mpcc_cost(env.obstacle_map.device_map, env.lane_map.device_map)
    x0 = _start(env.reset())
    out = {"x0": x0}
    for i, mode in enumerate(MODES):
        solver = jax_make_solver(JaxConfig(**_config(mode, True)), env.dynamics, cost,
                                 donate_state=False)
        xref, _ = racing_mpcc.calc_ref_trajectory(
            jnp.asarray(x0), env.racing_center_path, jnp.asarray(0, jnp.int32), HORIZON)
        r = solver.solve(solver.init(), jnp.asarray(x0), info={"reference_path": xref},
                         noise=jnp.asarray(_noise(i)))
        seqs, w = jax_diag.top_samples(r.aux.state_seq_batch, r.aux.weights, TOP)
        out.update({f"{i}_xref": np.asarray(xref), f"{i}_weights": np.asarray(r.aux.weights),
                    f"{i}_top_states": np.asarray(seqs), f"{i}_top_weights": np.asarray(w)})
    np.savez(out_path, **out)


def jax_regen_reference(out_path: str) -> None:
    """Subprocess body: the JAX ``run_regen`` in interpret mode, noise mode."""
    jax.config.update("jax_platforms", "cpu")
    from mppi_playground_tpu.envs.racing_env import RacingEnv as JaxRacingEnv
    from mppi_playground_tpu.models import racing_mpcc
    from mppi_playground_tpu.ops.fused_solve import make_fused_solve

    env = JaxRacingEnv()
    cfg = JaxConfig(**dict(_config(1.0, False), num_samples=REGEN_K, exploration=0.3))
    core = make_fused_solve(cfg, racing_mpcc.make_racing_fused_task_from_env(env), interpret=True)
    rng = np.random.default_rng(5)
    prev = (rng.standard_normal((HORIZON, 2)) * 1.5).astype(np.float32)
    noise = (rng.standard_normal((REGEN_K, HORIZON, 2)) * 1.5).astype(np.float32)
    pert = core.run_regen(jnp.asarray(prev), jnp.int32(0), jnp.asarray(noise))
    np.savez(out_path, prev=prev, noise=noise, pert=np.asarray(pert))


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    return run_jax_references(
        "tests.test_torch_diagnostics", ["jax_top_samples_reference", "jax_regen_reference"],
        tmp_path_factory.mktemp("jax_diagnostics"))


@pytest.fixture(scope="module")
def env():
    return RacingEnv(device="cpu")


def test_top_indices_order_ties_like_jax_top_k():
    rng = np.random.default_rng(0)
    w = np.zeros(4000, np.float32)
    w[rng.choice(4000, 40, replace=False)] = rng.uniform(0, 1, 40).astype(np.float32)
    w[[7, 900, 3000]] = 0.5  # equal nonzero weights too
    for n in (5, 43, 300, 4000):
        want_v, want_i = jax.lax.top_k(jnp.asarray(w), n)
        got_v, got_i = diagnostics.top_indices(torch.from_numpy(w), n)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    small = np.array([0, 1, 0, 0, 1, 0], np.float32)
    assert diagnostics.top_indices(torch.from_numpy(small), 5)[1].tolist() == [1, 4, 0, 2, 3]


def _port_solves(env, mode, noise):
    x0 = torch.from_numpy(_start(env.reset()))
    xref, _ = calc_ref_trajectory(x0, env.racing_center_path, torch.tensor(0), HORIZON)
    info = {"reference_path": xref}
    fused = make_fused_solver(MPPIConfig(**_config(mode, False)),
                              make_racing_fused_task_from_env(env), env.dynamics, device="cpu")
    unfused = make_solver(MPPIConfig(**_config(mode, True)), env.dynamics,
                          make_mpcc_cost(env.obstacle_cost_map, env.lane_cost_map), device="cpu")
    rf = fused.solve(fused.init(), x0, info=info, noise=noise)
    ru = unfused.solve(unfused.init(), x0, info=info, noise=noise)
    return fused, rf, ru, xref


@pytest.mark.parametrize("mode_index", [0, 1], ids=["fixed", "ESSPS"])
def test_fused_top_samples_match_stored_rollouts(env, mode_index):
    noise = torch.from_numpy(_noise(mode_index))
    fused, rf, ru, _ = _port_solves(env, MODES[mode_index], noise)
    seqs_f, w_f = fused.top_samples(rf.aux, TOP, noise=noise)
    seqs_u, w_u = diagnostics.top_samples(ru.aux.state_seq_batch, ru.aux.weights, TOP)
    assert seqs_f.shape == (TOP, HORIZON + 1, 4) and w_f.shape == (TOP,)
    assert bool((w_f[:-1] >= w_f[1:]).all())
    np.testing.assert_allclose(w_f.numpy(), w_u.numpy(), atol=1e-5)
    np.testing.assert_allclose(seqs_f.numpy(), seqs_u.numpy(), atol=5e-4)


@pytest.mark.parametrize("mode_index", [0, 1], ids=["fixed", "ESSPS"])
def test_top_samples_match_jax(jax_refs, env, mode_index):
    ref = jax_refs["jax_top_samples_reference"]
    noise = torch.from_numpy(_noise(mode_index))
    fused, rf, ru, xref = _port_solves(env, MODES[mode_index], noise)
    np.testing.assert_array_equal(xref.numpy(), ref[f"{mode_index}_xref"])
    want_s, want_w = ref[f"{mode_index}_top_states"], ref[f"{mode_index}_top_weights"]
    for name, (seqs, w) in {
        "fused": fused.top_samples(rf.aux, TOP, noise=noise),
        "unfused": diagnostics.top_samples(ru.aux.state_seq_batch, ru.aux.weights, TOP),
    }.items():
        np.testing.assert_allclose(w.numpy(), want_w, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(seqs.numpy(), want_s, atol=5e-4, err_msg=name)


def test_regen_twin_matches_jax_run_regen(jax_refs):
    ref = jax_refs["jax_regen_reference"]
    threshold = int(REGEN_K * 0.7)
    rows = torch.arange(REGEN_K)
    got = fused_solve.fused_regen(torch.from_numpy(ref["prev"]), 0, rows, SIGMAS, U_MIN, U_MAX,
                                   REGEN_K, threshold, torch.from_numpy(ref["noise"]))
    np.testing.assert_array_equal(got.numpy(), ref["pert"])  # tolerance 0
    some = torch.tensor([REGEN_K - 1, 3, 3, 0, threshold, threshold - 1])
    sub = fused_solve.fused_regen(torch.from_numpy(ref["prev"]), 0, some, SIGMAS, U_MIN, U_MAX,
                                   REGEN_K, threshold, torch.from_numpy(ref["noise"]))
    np.testing.assert_array_equal(sub.numpy(), ref["pert"][some.numpy()])


@pytest.mark.parametrize("exploration", [0.0, 0.3])
def test_seeded_regen_equals_phase1_dump(env, exploration):
    """The regenerated rows are the draws phase 1 dumped, bit for bit."""
    k = 1300
    seed = tick_seed(42, 5)
    threshold = int(k * (1.0 - exploration))
    prev = torch.from_numpy((np.random.default_rng(1).standard_normal((HORIZON, 2)) * SIGMAS)
                            .astype(np.float32))
    x0 = torch.from_numpy(_start(env.reset()))
    xref, _ = calc_ref_trajectory(x0, env.racing_center_path, torch.tensor(0), HORIZON)
    from mppi_playground_tpu_torch.models.racing_mpcc import extend_reference_path

    _, dump = fused_solve.fused_costs_dump(
        x0, prev, seed, extend_reference_path(xref), make_racing_fused_task_from_env(env),
        SIGMAS, U_MIN, U_MAX, k, threshold)
    full = fused_solve.fused_regen(prev, seed, torch.arange(k), SIGMAS, U_MIN, U_MAX, k,
                                    threshold)
    torch.testing.assert_close(full, dump.t().reshape(k, HORIZON, 2), rtol=0, atol=0)
    rows = torch.tensor([k - 1, 0, 777, threshold - 1, 256, 255])
    sub = fused_solve.fused_regen(prev, seed, rows, SIGMAS, U_MIN, U_MAX, k, threshold)
    torch.testing.assert_close(sub, full[rows], rtol=0, atol=0)
    assert fused_solve.fused_regen(prev, seed, rows[:0], SIGMAS, U_MIN, U_MAX, k,
                                    threshold).shape == (0, HORIZON, 2)


def test_top_samples_errors(env):
    noise = torch.from_numpy(_noise(3))
    fused, rf, ru, _ = _port_solves(env, 1.0, noise)
    # the tick's seed word, a device tensor that top_samples replays from
    assert rf.aux.noise_injected is True and rf.aux.seed.dtype == torch.int32
    assert rf.aux.seed.shape == (1,)
    assert ru.aux.seed is None and ru.aux.noise_injected is None
    with pytest.raises(ValueError, match="injected noise"):
        fused.top_samples(rf.aux, 5)
    with pytest.raises(ValueError, match="num_samples"):
        fused.top_samples(rf.aux, K + 1, noise=noise)
    with pytest.raises(ValueError, match="aux"):
        fused.top_samples(ru.aux, 5)
    with pytest.raises(ValueError, match="requested top"):
        diagnostics.top_samples(ru.aux.state_seq_batch, ru.aux.weights, K + 1)
    # seeded: no noise to pass back
    x0 = torch.from_numpy(_start(env.reset()))
    xref, _ = calc_ref_trajectory(x0, env.racing_center_path, torch.tensor(0), HORIZON)
    seeded = fused.solve(fused.init(), x0, info={"reference_path": xref})
    assert seeded.aux.noise_injected is False
    seqs, w = fused.top_samples(seeded.aux, 10)
    assert seqs.shape == (10, HORIZON + 1, 4) and torch.isfinite(seqs).all()


def _pendulum_mppi(**kw):
    return MPPI(horizon=5, num_samples=4096, dim_state=2, dim_control=1,
                dynamics=torch_pendulum_dynamics, cost_func=torch_pendulum_cost,
                u_min=[-2.0], u_max=[2.0], sigmas=[0.7], lambda_=1.0, device="cpu", **kw)


def test_get_top_samples_needs_a_solve():
    c = _pendulum_mppi()
    with pytest.raises(RuntimeError, match="prior forward"):
        c.get_top_samples(5)
    c.forward(torch.tensor([np.pi, 0.0]))
    seqs, w = c.get_top_samples(5)
    assert seqs.shape == (5, 6, 2) and bool((w[:-1] >= w[1:]).all())
    c.reset()
    with pytest.raises(RuntimeError, match="prior forward"):
        c.get_top_samples(5)
    assert float(c.solver_state.previous_action_seq.abs().sum()) == 0.0


def test_posterior_samples_moments_and_prediction():
    c = _pendulum_mppi(seed=3)
    action_seq, _ = c.forward(torch.tensor([np.pi, 0.0]))
    n = 4096
    x = torch.tensor([np.pi - 0.1, 0.3])
    samples, states = c.get_samples_from_posterior(action_seq, x, n)
    assert samples.shape == (n, 5, 1) and states.shape == (n, 6, 2)
    dev = (samples - action_seq[None]).double()
    sigma = 0.7
    assert (dev.mean(0).abs() <= 3 * sigma / np.sqrt(n)).all()
    assert ((dev.std(0) - sigma).abs() <= 3 * sigma / np.sqrt(n)).all()
    again, _ = c.get_samples_from_posterior(action_seq, x, n)
    assert not torch.equal(again, samples)  # the generator advances
    cfg = JaxConfig(horizon=5, num_samples=4096, dim_state=2, dim_control=1, u_min=(-2.0,),
                    u_max=(2.0,), sigmas=(0.7,), lambda_=1.0)
    want = jax_states_prediction(cfg, pendulum.dynamics)(jnp.asarray(x.numpy()),
                                                         jnp.asarray(samples.numpy()))
    np.testing.assert_allclose(states.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="posterior samples"):
        c.get_samples_from_posterior(action_seq, x, 10**6)
