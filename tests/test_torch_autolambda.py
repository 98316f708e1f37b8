"""The port's temperature auto-tuning against the JAX package, on the CPU.

* ``core/autolambda`` (the loops of the unfused solver) against the JAX
  package's ``core/autolambda``: ESS, the ESSPS bisection with both bracket
  clamps, the LBPS objective and golden section, and five chained MPO steps.
* The search kernels' plain twins (``ops/lambda_search``) against the JAX
  package's Pallas kernels ``essps_lambda_fused`` / ``lbps_lambda_fused`` in
  interpret mode.

The JAX side runs once, in a subprocess with XLA's FMA contraction off (see
tests/test_torch_fused_solve.py).  Tolerances are the JAX package's own for
its search kernels against its loops (tests/test_autolambda.py): ESSPS
lambda rtol 1e-4, atol 1e-6; LBPS lambda rtol 1e-3, atol 1e-4, since the
objective is flat near its minimum (0.1% of lambda moves it by about 3e-7
relative) and the two sides sum in other orders; the LBPS objective at the
two lambdas rtol 1e-5; MPO lambda, log-temperature and Adam moments rtol
1e-4 (the gradient is taken in closed form here, by reverse mode in JAX).
The costs are uniform on [0, 20], the family the JAX package holds its own
search kernels to that bar on.
"""

import numpy as np
import pytest
import torch

from mppi_playground_tpu_torch.core import autolambda
from mppi_playground_tpu_torch.ops import lambda_search
from tests.test_torch_fused_solve import run_jax_reference

LAMBDA_MIN, LAMBDA_MAX, DELTA = 0.01, 10.0, 0.01
LOOP_SIZES = (1000, 5000)
KERNEL_SIZES = (1000, 1500, 5000)
PROBE_LAMBDAS = (0.05, 1.0, 7.5)
MPO_STEPS = 5


def _costs(k: int) -> np.ndarray:
    return np.random.default_rng(k).uniform(0.0, 20.0, size=k).astype(np.float32)


def _clamp_costs():
    """Cost vectors whose ESSPS target lies outside [ESS(lambda_min), ESS(lambda_max)]."""
    flat = (np.arange(512) * 1e-9).astype(np.float32)  # every sample alike: ESS ~ K
    spike = np.concatenate([np.zeros(1), np.full(511, 1e6)]).astype(np.float32)  # ESS ~ 1
    return {"to_min": flat, "to_max": spike}


def jax_autolambda_reference(out_path: str) -> None:
    """Subprocess body: the JAX package's searches and MPO steps on seeded costs."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu.core import autolambda as jal
    from mppi_playground_tpu.ops.lambda_search import essps_lambda_fused, lbps_lambda_fused

    out = {}
    for k in sorted(set(LOOP_SIZES + KERNEL_SIZES)):
        c = jnp.asarray(_costs(k))
        for lam in PROBE_LAMBDAS:
            out[f"{k}_ess_{lam}"] = np.asarray(jal.ess_from_costs(c, jnp.float32(lam)))
            out[f"{k}_lbps_obj_{lam}"] = np.asarray(jal.lbps_objective(c, jnp.float32(lam), DELTA))
        out[f"{k}_essps"] = np.asarray(jal.essps_lambda(c, k / 10.0, LAMBDA_MIN, LAMBDA_MAX))
        out[f"{k}_lbps"] = np.asarray(jal.lbps_lambda(c, DELTA, LAMBDA_MIN, LAMBDA_MAX))
        out[f"{k}_essps_kernel"] = np.asarray(
            essps_lambda_fused(c, k / 10.0, LAMBDA_MIN, LAMBDA_MAX, interpret=True))
        out[f"{k}_lbps_kernel"] = np.asarray(
            lbps_lambda_fused(c, DELTA, LAMBDA_MIN, LAMBDA_MAX, interpret=True))
    for name, c in _clamp_costs().items():
        c = jnp.asarray(c)
        out[f"clamp_{name}"] = np.asarray(jal.essps_lambda(c, 51.2, LAMBDA_MIN, LAMBDA_MAX))
        out[f"clamp_{name}_kernel"] = np.asarray(
            essps_lambda_fused(c, 51.2, LAMBDA_MIN, LAMBDA_MAX, interpret=True))

    costs = jnp.asarray(np.random.default_rng(0).uniform(0.0, 10.0, size=500).astype(np.float32))
    optimizer = jal.make_mpo_optimizer()
    log_t = jnp.log(jnp.asarray([1.0], jnp.float32))[0]
    opt_state = optimizer.init(log_t)
    for i in range(MPO_STEPS):
        lam, log_t, opt_state = jal.mpo_step(costs, log_t, opt_state, optimizer)
        adam = opt_state[0]
        for name, value in dict(lam=lam, log_t=log_t, count=adam.count, mu=adam.mu,
                                nu=adam.nu).items():
            out[f"mpo_{i}_{name}"] = np.asarray(value)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax_reference("tests.test_torch_autolambda", "jax_autolambda_reference",
                             tmp_path_factory.mktemp("jax_autolambda"))


def _f(x) -> float:
    return float(np.asarray(x))


@pytest.mark.parametrize("k", LOOP_SIZES)
def test_ess_and_lbps_objective_match_jax(jax_ref, k):
    c = torch.from_numpy(_costs(k))
    for lam in PROBE_LAMBDAS:
        lam_t = torch.tensor(lam)
        np.testing.assert_allclose(_f(autolambda.ess_from_costs(c, lam_t)),
                                   _f(jax_ref[f"{k}_ess_{lam}"]), rtol=1e-5)
        np.testing.assert_allclose(_f(autolambda.lbps_objective(c, lam_t, DELTA)),
                                   _f(jax_ref[f"{k}_lbps_obj_{lam}"]), rtol=1e-5)


@pytest.mark.parametrize("k", LOOP_SIZES)
def test_essps_and_lbps_loops_match_jax(jax_ref, k):
    c = torch.from_numpy(_costs(k))
    essps = autolambda.essps_lambda(c, k / 10.0, LAMBDA_MIN, LAMBDA_MAX)
    lbps = autolambda.lbps_lambda(c, DELTA, LAMBDA_MIN, LAMBDA_MAX)
    assert essps.shape == () and lbps.shape == ()
    np.testing.assert_allclose(_f(essps), _f(jax_ref[f"{k}_essps"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_f(lbps), _f(jax_ref[f"{k}_lbps"]), rtol=1e-3, atol=1e-4)
    # the interior of the bracket: neither clamp fired
    assert LAMBDA_MIN < _f(essps) < LAMBDA_MAX and LAMBDA_MIN < _f(lbps) < LAMBDA_MAX


@pytest.mark.parametrize("name", ["to_min", "to_max"])
def test_essps_bracket_clamps_match_jax(jax_ref, name):
    c = torch.from_numpy(_clamp_costs()[name])
    bound = LAMBDA_MIN if name == "to_min" else LAMBDA_MAX
    loop = autolambda.essps_lambda(c, 51.2, LAMBDA_MIN, LAMBDA_MAX)
    twin = lambda_search.essps_lambda_fused(c, 51.2, LAMBDA_MIN, LAMBDA_MAX)
    for got, want in ((loop, jax_ref[f"clamp_{name}"]), (twin, jax_ref[f"clamp_{name}_kernel"])):
        assert _f(got) == _f(want) == np.float32(bound)


def test_mpo_steps_match_jax(jax_ref):
    costs = torch.from_numpy(
        np.random.default_rng(0).uniform(0.0, 10.0, size=500).astype(np.float32))
    log_t, opt_state = autolambda.mpo_init(1.0, costs)
    assert _f(log_t) == 0.0 and int(opt_state.count) == 0
    for i in range(MPO_STEPS):
        lam, log_t, opt_state = autolambda.mpo_step(costs, log_t, opt_state)
        assert int(opt_state.count) == int(jax_ref[f"mpo_{i}_count"]) == i + 1
        assert opt_state.count.dtype == torch.int32
        for name, got in dict(lam=lam, log_t=log_t, mu=opt_state.mu, nu=opt_state.nu).items():
            np.testing.assert_allclose(_f(got), _f(jax_ref[f"mpo_{i}_{name}"]), rtol=1e-4,
                                       err_msg=f"step {i}: {name}")
    # the reference's quirk: lambda is exp(log_t), not softplus(log_t)
    assert _f(lam) == pytest.approx(np.exp(_f(log_t)), rel=1e-6)


@pytest.mark.parametrize("k", KERNEL_SIZES)
def test_search_twins_match_jax_kernels(jax_ref, k):
    c = torch.from_numpy(_costs(k))
    essps = lambda_search.essps_lambda_fused(c, k / 10.0, LAMBDA_MIN, LAMBDA_MAX)
    lbps = lambda_search.lbps_lambda_fused(c, DELTA, LAMBDA_MIN, LAMBDA_MAX)
    assert essps.shape == () and lbps.shape == () and essps.dtype == torch.float32
    np.testing.assert_allclose(_f(essps), _f(jax_ref[f"{k}_essps_kernel"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_f(lbps), _f(jax_ref[f"{k}_lbps_kernel"]), rtol=1e-3, atol=1e-4)
    # where golden section stopped, the objective is the same to rtol 1e-5
    pen = lambda_search.lbps_range_penalty(c, DELTA)
    want_lam = torch.tensor(float(jax_ref[f"{k}_lbps_kernel"]))
    np.testing.assert_allclose(_f(lambda_search.lbps_objective_plain(c, lbps, pen)),
                               _f(lambda_search.lbps_objective_plain(c, want_lam, pen)), rtol=1e-5)


def test_search_gate_and_wrapper_checks():
    # the kernels' 32-bit indexing is the only limit: no gate at the JAX package's 1M
    assert lambda_search.MAX_SAMPLES == 2**31 - lambda_search.CLUSTER
    too_many = torch.zeros(1).expand(lambda_search.MAX_SAMPLES + 1)  # no memory behind it
    for fn, arg in ((lambda_search.essps_lambda_fused, 100.0),
                    (lambda_search.lbps_lambda_fused, DELTA)):
        for costs in (too_many, torch.zeros(0)):
            with pytest.raises(ValueError, match="1 <= K"):
                fn(costs, arg, LAMBDA_MIN, LAMBDA_MAX)
        with pytest.raises(ValueError, match="dtype"):
            fn(torch.zeros(16, dtype=torch.float64), arg, LAMBDA_MIN, LAMBDA_MAX)
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.zeros(16, 2)[:, 0], arg, LAMBDA_MIN, LAMBDA_MAX)
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(torch.zeros(16, device="meta"), arg, LAMBDA_MIN, LAMBDA_MAX)
