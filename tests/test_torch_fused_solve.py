"""The fused kernels' plain twins against the JAX package's Pallas kernels.

The JAX kernels run in Pallas interpret mode on the CPU, as the JAX
package's own tests run them; the port's wrappers take their plain PyTorch
twins for CPU tensors.  Both sides get the same inputs, made from seeds
with numpy, and the same injected noise.

The JAX side runs in a subprocess with ``--xla_cpu_max_isa=AVX``.  On a CPU
with FMA units, XLA contracts ``a * b + c`` into one fused multiply-add
inside a compiled program; the port, like its CUDA kernels (built with
``-fmad=false``), rounds every operation.  With FMA off both compute the
same operations in the same order, so the costs must be bitwise equal
(tolerance 0).  Everything downstream is held to the JAX package's own bar
for fused against XLA (tests/test_fused_solve.py): weights atol 1e-5,
update and states atol 5e-3, ESS rtol 1e-3; exp and the sums are taken in
another order.  The seeded stream (Philox) cannot replay the TPU's
hardware bits, so it is checked by its statistics.

The auto-lambda phases run at the flagship's horizon (T=50) with a padded
last tile (K=1500): phase 1's costs and perturbation dump against
``run_kernel(costs_only=True, dump_pert=True)``, phase 2 at the JAX ESSPS
lambda* against ``run_weighted(pert=...)``, with the same bars.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch.core.config import tick_seed
from mppi_playground_tpu_torch.envs.racing_env import RacingEnv
from mppi_playground_tpu_torch.models.racing_mpcc import make_racing_fused_task_from_env
from mppi_playground_tpu_torch.ops import fused_solve
from mppi_playground_tpu_torch.ops.weighted_update import combine_partials, weighted_update

ROOT = Path(__file__).resolve().parent.parent
HORIZON = 8
SIGMAS = (0.5, 0.1)
U_MIN = (-2.0, -0.25)
U_MAX = (2.0, 0.25)
SOLVE_CASES = ((2048, 0.0), (1500, 0.3))
REROLL_HORIZON = 50
PHASE_T, PHASE_K, PHASE_EXPLORATION = 50, 1500, 0.3


def run_jax_references(module: str, functions, out_dir: Path) -> dict:
    """Run each ``module.function(out_path)`` in its own subprocess, all at once.

    XLA's FMA contraction is off and JAX is pinned to the CPU in each.
    Returns the arrays they saved, keyed by function name.
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    procs = {}
    for function in functions:
        out_path = out_dir / f"{function}.npz"
        code = f"import {module} as m; m.{function}({str(out_path)!r})"
        procs[function] = (out_path, subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    results = {}
    try:
        for function, (out_path, proc) in procs.items():
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"{function}:\n{log[-8000:]}"
            with np.load(out_path) as data:
                results[function] = dict(data)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def run_jax_reference(module: str, function: str, out_dir: Path) -> dict:
    """Run ``module.function(out_path)`` in a subprocess with XLA's FMA contraction off.

    Returns the arrays it saved.  The subprocess pins JAX to the CPU.
    """
    return run_jax_references(module, [function], out_dir)[function]


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def jax_fused_reference(out_path: str) -> None:
    """Subprocess body: inputs and JAX interpret-mode outputs of both kernels."""
    jax = _jax_cpu()
    import jax.numpy as jnp

    from mppi_playground_tpu.core.config import MPPIConfig
    from mppi_playground_tpu.envs.racing_env import RacingEnv as JaxRacingEnv
    from mppi_playground_tpu.models import racing_mpcc
    from mppi_playground_tpu.ops.fused_solve import make_fused_reroll, make_fused_solve

    assert jax.default_backend() == "cpu"
    env = JaxRacingEnv()
    task = racing_mpcc.make_racing_fused_task_from_env(env)
    out = {}

    def config(num_samples, exploration, horizon):
        return MPPIConfig(horizon=horizon, num_samples=num_samples, dim_state=4,
                          dim_control=2, u_min=U_MIN, u_max=U_MAX, sigmas=SIGMAS,
                          lambda_=1.0, store_rollouts=False, exploration=exploration)

    for num_samples, exploration in SOLVE_CASES:
        rng = np.random.default_rng(num_samples)
        # the car moving near its target speed just off the start of the track
        x0 = (np.asarray(env.reset()) + np.array([0.2, -0.1, 0.05, 6.0])).astype(np.float32)
        prev = (rng.standard_normal((HORIZON, 2)) * SIGMAS).astype(np.float32)
        noise = (rng.standard_normal((num_samples, HORIZON, 2)) * SIGMAS).astype(np.float32)
        xref, _ = racing_mpcc.calc_ref_trajectory(
            jnp.asarray(x0), env.racing_center_path, jnp.asarray(0, jnp.int32), HORIZON
        )
        xref5 = np.asarray(racing_mpcc.extend_reference_path(xref))
        core = make_fused_solve(config(num_samples, exploration, HORIZON), task, interpret=True)
        costs, update, weights, ess = core(
            jnp.asarray(x0), jnp.asarray(prev), jnp.float32(1.0), jnp.int32(0),
            {"xref": jnp.asarray(xref5)}, jnp.asarray(noise),
        )
        for name, value in dict(x0=x0, prev=prev, noise=noise, xref5=xref5, costs=costs,
                                update=update, weights=weights, ess=ess).items():
            out[f"{num_samples}_{name}"] = np.asarray(value)

    # jit: interpret mode otherwise traces and compiles the kernel at every call
    reroll = jax.jit(make_fused_reroll(config(64, 0.0, REROLL_HORIZON), task, interpret=True))
    rng = np.random.default_rng(5)
    x0s = np.stack([rng.uniform(-39, 39, 3), rng.uniform(-39, 39, 3),
                    rng.uniform(-3, 3, 3), rng.uniform(-8, 8, 3)], axis=1).astype(np.float32)
    seqs = np.stack([rng.uniform(-2.5, 2.5, (3, REROLL_HORIZON)),
                     rng.uniform(-0.3, 0.3, (3, REROLL_HORIZON))], axis=2).astype(np.float32)
    out["reroll_x0"], out["reroll_seq"] = x0s, seqs
    out["reroll_states"] = np.stack(
        [np.asarray(reroll(jnp.asarray(x), jnp.asarray(s))) for x, s in zip(x0s, seqs)]
    )
    np.savez(out_path, **out)


def jax_phase_reference(out_path: str) -> None:
    """Subprocess body: auto-lambda phase 1, the ESSPS search and phase 2 in interpret mode."""
    jax = _jax_cpu()
    import jax.numpy as jnp

    from mppi_playground_tpu.core.config import MPPIConfig
    from mppi_playground_tpu.envs.racing_env import RacingEnv as JaxRacingEnv
    from mppi_playground_tpu.models import racing_mpcc
    from mppi_playground_tpu.ops.fused_solve import make_fused_solve
    from mppi_playground_tpu.ops.lambda_search import essps_lambda_fused

    assert jax.default_backend() == "cpu"
    env = JaxRacingEnv()
    task = racing_mpcc.make_racing_fused_task_from_env(env)
    cfg = MPPIConfig(horizon=PHASE_T, num_samples=PHASE_K, dim_state=4, dim_control=2,
                     u_min=U_MIN, u_max=U_MAX, sigmas=SIGMAS, lambda_=1.0,
                     store_rollouts=False, exploration=PHASE_EXPLORATION)
    out = {}
    rng = np.random.default_rng(PHASE_K + PHASE_T)
    x0 = (np.asarray(env.reset()) + np.array([0.2, -0.1, 0.05, 6.0])).astype(np.float32)
    prev = (rng.standard_normal((PHASE_T, 2)) * SIGMAS).astype(np.float32)
    noise = (rng.standard_normal((PHASE_K, PHASE_T, 2)) * SIGMAS).astype(np.float32)
    xref, _ = racing_mpcc.calc_ref_trajectory(
        jnp.asarray(x0), env.racing_center_path, jnp.asarray(0, jnp.int32), PHASE_T
    )
    xref5 = np.asarray(racing_mpcc.extend_reference_path(xref))
    core = make_fused_solve(cfg, task, interpret=True)
    costs, pert = core.run_kernel(
        jnp.asarray(x0), jnp.asarray(prev), jnp.float32(1.0), jnp.int32(0),
        {"xref": jnp.asarray(xref5)}, jnp.asarray(noise), dump_pert=True, costs_only=True,
    )
    lam = essps_lambda_fused(costs, PHASE_K / 10.0, 0.01, 10.0, interpret=True)
    stats, numer = core.run_weighted(jnp.asarray(prev), lam, jnp.int32(0), costs, pert=pert)
    update, weights, ess = core.combine_partials(costs, stats, numer, lam)
    # the dump's kernel layout [T*m, K_pad/128, 128] -> [K, T, m]
    pert = np.asarray(pert).reshape(2 * PHASE_T, -1).T[:PHASE_K].reshape(PHASE_K, PHASE_T, 2)
    for name, value in dict(x0=x0, prev=prev, noise=noise, xref5=xref5, costs=costs, pert=pert,
                            lam=lam, update=update, weights=weights, ess=ess).items():
        out[f"phase_{name}"] = np.asarray(value)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    refs = run_jax_references("tests.test_torch_fused_solve",
                              ["jax_fused_reference", "jax_phase_reference"],
                              tmp_path_factory.mktemp("jax_fused"))
    return {**refs["jax_fused_reference"], **refs["jax_phase_reference"]}


@pytest.fixture(scope="module")
def task():
    return make_racing_fused_task_from_env(RacingEnv(device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("num_samples,exploration", SOLVE_CASES)
def test_fused_solve_twin_matches_jax_interpret(jax_ref, task, num_samples, exploration):
    ref = {k.split("_", 1)[1]: v for k, v in jax_ref.items() if k.startswith(f"{num_samples}_")}
    lam = torch.tensor([1.0])
    threshold = int(num_samples * (1.0 - exploration))
    costs, stats, numer = fused_solve.fused_solve(
        _t(ref["x0"]), _t(ref["prev"]), lam, 0, _t(ref["xref5"]), task,
        SIGMAS, U_MIN, U_MAX, num_samples, threshold, _t(ref["noise"]),
    )
    blocks = -(-num_samples // fused_solve.BLOCK)
    assert costs.shape == (num_samples,)
    assert stats.shape == (blocks, 3) and numer.shape == (blocks, 2 * HORIZON)
    update, weights, ess = combine_partials(costs, stats, numer, lam, HORIZON, 2)

    np.testing.assert_array_equal(costs.numpy(), ref["costs"])  # tolerance 0
    np.testing.assert_allclose(weights.numpy(), ref["weights"], atol=1e-5)
    np.testing.assert_allclose(update.numpy(), ref["update"], atol=5e-3)
    np.testing.assert_allclose(float(ess), float(ref["ess"]), rtol=1e-3)


def test_reroll_twin_matches_jax_interpret(jax_ref, task):
    for x0, seq, want in zip(jax_ref["reroll_x0"], jax_ref["reroll_seq"],
                             jax_ref["reroll_states"]):
        got = fused_solve.fused_reroll(_t(x0), _t(seq), task).numpy()
        assert got.shape == (REROLL_HORIZON + 1, 4)
        np.testing.assert_allclose(got, want, atol=5e-3)
        np.testing.assert_array_equal(got, want)  # op for op: tolerance 0


def _phase_inputs(ref, task):
    threshold = int(PHASE_K * (1.0 - PHASE_EXPLORATION))
    return (_t(ref["phase_x0"]), _t(ref["phase_prev"]), 0, _t(ref["phase_xref5"]), task,
            SIGMAS, U_MIN, U_MAX, PHASE_K, threshold, _t(ref["phase_noise"]))


def test_phase1_twin_matches_jax_costs_and_dump(jax_ref, task):
    costs, dump = fused_solve.fused_costs_dump(*_phase_inputs(jax_ref, task))
    assert costs.shape == (PHASE_K,) and dump.shape == (2 * PHASE_T, PHASE_K)
    np.testing.assert_allclose(costs.numpy(), jax_ref["phase_costs"], rtol=1e-5)
    np.testing.assert_array_equal(costs.numpy(), jax_ref["phase_costs"])  # bitwise under AVX
    # slot-major [2T, K] against the JAX dump, both as [K, T, m]: the same clamped values
    np.testing.assert_array_equal(dump.t().reshape(PHASE_K, PHASE_T, 2).numpy(),
                                  jax_ref["phase_pert"])


def test_phase2_twin_matches_jax_run_weighted(jax_ref, task):
    costs, dump = fused_solve.fused_costs_dump(*_phase_inputs(jax_ref, task))
    lam = _t(jax_ref["phase_lam"]).reshape(1)
    stats, numer = fused_solve.fused_weighted(costs, dump, lam)
    update, weights, ess = combine_partials(costs, stats, numer, lam, PHASE_T, 2)
    np.testing.assert_allclose(weights.numpy(), jax_ref["phase_weights"], atol=1e-5)
    np.testing.assert_allclose(update.numpy(), jax_ref["phase_update"], atol=5e-3)
    np.testing.assert_allclose(float(ess), float(jax_ref["phase_ess"]), rtol=1e-3)


def test_phase2_at_lambda_one_equals_the_fixed_solve(jax_ref, task):
    """Phase 2 on phase 1's outputs gives the fixed-lambda solve's partials, bit for bit."""
    args = _phase_inputs(jax_ref, task)
    costs, dump = fused_solve.fused_costs_dump(*args)
    lam = torch.ones(1)
    stats, numer = fused_solve.fused_weighted(costs, dump, lam)
    want_costs, want_stats, want_numer = fused_solve.fused_solve(
        args[0], args[1], lam, *args[2:])
    torch.testing.assert_close(costs, want_costs, rtol=0, atol=0)
    torch.testing.assert_close(stats, want_stats, rtol=0, atol=0)
    torch.testing.assert_close(numer, want_numer, rtol=0, atol=0)


def test_phase_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_solve.fused_weighted(torch.zeros(8, device="meta"), torch.zeros(4, 8, device="meta"),
                                    torch.ones(1, device="meta"))


def test_seeded_normals_have_standard_moments():
    z = fused_solve.seeded_normals(tick_seed(42, 0), 4096, 50, "cpu").double().numpy()
    n = z.size  # 409,600 draws
    flat = z.ravel()
    # bounds at about 5 standard errors of each moment estimate
    assert abs(flat.mean()) < 5 / np.sqrt(n)
    assert abs(flat.var() - 1.0) < 5 * np.sqrt(2.0 / n)
    assert abs(np.mean(flat**3)) < 5 * np.sqrt(15.0 / n)
    assert abs(np.mean(flat**4) - 3.0) < 5 * np.sqrt(96.0 / n)
    # 24-bit Box-Muller: u1 >= 2^-25 caps |z| below sqrt(2 * 25 ln 2) ~ 5.89
    assert np.abs(flat).max() < 5.9
    # every slot of the horizon is standard, not only the pooled draws
    assert np.all(np.abs(z.mean(axis=0)) < 5 / np.sqrt(4096))


def test_seeded_stream_is_independent_across_ticks_and_samples():
    k, t = 4096, 50
    a = fused_solve.seeded_normals(tick_seed(42, 0), k, t, "cpu").double().numpy()
    b = fused_solve.seeded_normals(tick_seed(42, 1), k, t, "cpu").double().numpy()
    bound = 5 / np.sqrt(a.size)
    assert abs(np.corrcoef(a.ravel(), b.ravel())[0, 1]) < bound  # tick to tick
    assert abs(np.corrcoef(a[:-1].ravel(), a[1:].ravel())[0, 1]) < bound  # sample to sample
    assert abs(np.corrcoef(a[:, :, 0].ravel(), a[:, :, 1].ravel())[0, 1]) < 5 / np.sqrt(k * t)
    assert abs(np.corrcoef(a[:, :-1].ravel(), a[:, 1:].ravel())[0, 1]) < bound  # step to step
    assert not np.array_equal(a, b)


def test_seeded_draws_do_not_depend_on_block_size(task):
    """Draws are keyed on the global sample index: a wider solve extends a narrower one."""
    seed = tick_seed(7, 3)
    small = fused_solve.seeded_normals(seed, 700, HORIZON, "cpu")
    large = fused_solve.seeded_normals(seed, 1800, HORIZON, "cpu")
    torch.testing.assert_close(small, large[:700], rtol=0, atol=0)
    x0 = torch.tensor([27.0, 0.5, 1.6, 5.0])
    prev = torch.zeros(HORIZON, 2)
    xref5 = torch.tensor(np.tile([[27.0, 1.0, 1.0, 0.0, 8.0]], (HORIZON + 1, 1)),
                         dtype=torch.float32)
    lam = torch.tensor([1.0])
    args = (x0, prev, lam, seed, xref5, task, SIGMAS, U_MIN, U_MAX)
    c_small, s_small, _ = fused_solve.fused_solve(*args, 700, 700)
    c_large, _, _ = fused_solve.fused_solve(*args, 1800, 1800)
    torch.testing.assert_close(c_small, c_large[:700], rtol=0, atol=0)
    # partials of the padded last block: padding weighs nothing
    assert s_small.shape == (3, 3) and torch.isfinite(s_small).all()


def test_combine_partials_equals_plain_softmin(task):
    """Block partials merged == softmax and weighted average over the same samples."""
    rng = np.random.default_rng(9)
    num_samples = 1000
    x0 = torch.tensor([27.0, 0.5, 1.6, 5.0])
    prev = _t((rng.standard_normal((HORIZON, 2)) * SIGMAS).astype(np.float32))
    noise = _t((rng.standard_normal((num_samples, HORIZON, 2)) * SIGMAS).astype(np.float32))
    xref5 = torch.tensor(np.tile([[27.0, 1.0, 1.0, 0.0, 8.0]], (HORIZON + 1, 1)),
                         dtype=torch.float32)
    lam = torch.tensor([2.5])
    costs, stats, numer = fused_solve.fused_solve(
        x0, prev, lam, 0, xref5, task, SIGMAS, U_MIN, U_MAX, num_samples, num_samples, noise,
    )
    update, weights, ess = combine_partials(costs, stats, numer, lam, HORIZON, 2)
    pert = torch.clamp(prev[None] + noise, torch.tensor(U_MIN), torch.tensor(U_MAX))
    w_update, w_weights, w_ess = weighted_update(costs, pert, lam.reshape(()), backend="xla")
    # the same exponentials summed in another order
    torch.testing.assert_close(weights, w_weights, rtol=0, atol=1e-6)
    torch.testing.assert_close(update, w_update, rtol=0, atol=1e-6)
    torch.testing.assert_close(ess, w_ess, rtol=1e-5, atol=0)


def test_wrappers_reject_other_devices(task):
    x0 = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_solve.fused_reroll(x0, torch.zeros(5, 2, device="meta"), task)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_solve.fused_solve(
            x0, torch.zeros(5, 2, device="meta"), torch.ones(1, device="meta"), 0,
            torch.zeros(6, 5, device="meta"), task, SIGMAS, U_MIN, U_MAX, 8, 8,
        )
