"""The weighted update's plain twin and dispatch against the JAX package, on the CPU.

The JAX package's streaming Pallas kernel runs in interpret mode, and its
``_xla_weighted_update`` eagerly; the port's ``weighted_update`` on CPU
tensors takes the kernel's twin (block partials of 256, merged in torch),
``kernel_backend="xla"`` the softmax and einsum.  Inputs are made with
numpy from seeds.  The bars are those of ``tests/test_ops.py``, which holds
the Pallas kernel against XLA: update rtol 2e-5 atol 2e-6, weights rtol
2e-5 atol 1e-8, ESS rtol 2e-4 (the extreme-cost case rtol 1e-4 and 1e-3).
The sums are taken in other orders, so nothing here is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_playground_tpu.ops import pallas_kernels
from mppi_playground_tpu.ops.weighted_update import _xla_weighted_update
from mppi_playground_tpu.ops.weighted_update import weighted_update as jax_weighted_update
from mppi_playground_tpu_torch.core.config import MPPIConfig
from mppi_playground_tpu_torch.core.solver import make_solver
from mppi_playground_tpu_torch.ops import weighted_update as wu

BARS = dict(update=(2e-5, 2e-6), weights=(2e-5, 1e-8), ess=2e-4)
EXTREME_BARS = dict(update=(1e-4, 1e-6), weights=(1e-4, 1e-8), ess=1e-3)


def _port(costs, samples, lam, backend="auto"):
    return wu.weighted_update(torch.from_numpy(costs), torch.from_numpy(samples),
                              torch.tensor(lam, dtype=torch.float32), backend=backend)


def _jax(costs, samples, lam):
    """(Pallas interpret mode, XLA) outputs of the JAX package, as numpy."""
    args = (jnp.asarray(costs), jnp.asarray(samples), jnp.asarray(lam, jnp.float32))
    pallas = pallas_kernels.weighted_update(*args, interpret=True)
    xla = _xla_weighted_update(*args)
    return [tuple(np.asarray(v) for v in out) for out in (pallas, xla)]


def _assert_close(got, want, bars, name):
    (u_rtol, u_atol), (w_rtol, w_atol) = bars["update"], bars["weights"]
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=u_rtol, atol=u_atol, err_msg=name)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=w_rtol, atol=w_atol, err_msg=name)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=bars["ess"], err_msg=name)


def _check_against_jax(costs, samples, lam, bars):
    pallas, xla = _jax(costs, samples, lam)
    got = _port(costs, samples, lam)
    k = costs.shape[0]
    twin = wu.combine_partials(
        torch.from_numpy(costs),
        *wu.block_partials_plain(torch.from_numpy(costs),
                                 torch.from_numpy(samples.reshape(k, -1)),
                                 torch.tensor([lam], dtype=torch.float32)),
        torch.tensor(lam, dtype=torch.float32), samples.shape[1], samples.shape[2])
    # the default dispatch on CPU tensors is the twin, operation for operation
    for a, b in zip(got, twin):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _assert_close(got, pallas, bars, "twin vs JAX Pallas (interpret)")
    _assert_close(got, xla, bars, "twin vs JAX XLA")


@pytest.mark.parametrize("k,t,m", [(1024, 10, 2), (2048, 25, 2), (1024, 7, 1)])
@pytest.mark.parametrize("lam", [0.01, 1.0, 10.0])
def test_twin_matches_jax_pallas_and_xla(k, t, m, lam):
    rng = np.random.default_rng(0)
    costs = rng.uniform(0, 100, size=k).astype(np.float32)
    samples = rng.normal(size=(k, t, m)).astype(np.float32)
    _check_against_jax(costs, samples, lam, BARS)


def test_twin_extreme_costs():
    """Penalty spikes of 1e6 across the blocks: the merge stays stable."""
    rng = np.random.default_rng(1)
    costs = rng.uniform(0, 10, size=1024).astype(np.float32)
    costs[::7] += 1e6
    samples = rng.normal(size=(1024, 5, 2)).astype(np.float32)
    _check_against_jax(costs, samples, 0.5, EXTREME_BARS)


@pytest.mark.parametrize("k", [1000, 3000, 4000])
def test_twin_padded_k(k):
    """Sample counts that are not multiples of the block: padding weighs nothing."""
    rng = np.random.default_rng(2)
    costs = rng.uniform(0, 100, size=k).astype(np.float32)
    samples = rng.normal(size=(k, 10, 2)).astype(np.float32)
    _check_against_jax(costs, samples, 1.0, BARS)


def test_wide_d_runs_where_jax_falls_back():
    """D = 2,000: past the JAX package's VMEM gate (1536), its dispatch takes XLA.

    The port has no gate: its twin (and the kernel on the card) takes any D.
    """
    rng = np.random.default_rng(3)
    k, t, m = 1500, 1000, 2
    costs = rng.uniform(0, 100, size=k).astype(np.float32)
    samples = rng.normal(size=(k, t, m)).astype(np.float32)
    assert not pallas_kernels.supports_weighted_update(jnp.asarray(costs), jnp.asarray(samples))
    want = [np.asarray(v) for v in jax_weighted_update(
        jnp.asarray(costs), jnp.asarray(samples), jnp.asarray(2.0, jnp.float32), backend="pallas")]
    got = _port(costs, samples, 2.0, backend="pallas")
    assert got[0].shape == (t, m)
    _assert_close(got, want, BARS, "twin vs JAX (XLA fallback), D=2000")


@pytest.mark.parametrize("slots", [1, 3, 100, 1536, 2000])
def test_twin_in_the_kernel_block_layout_matches_jax(slots):
    """The twin's 256-row blocks (the CUDA kernel's) against the JAX package at its widths.

    K=2,500 fills 10 blocks, the last one ragged.  The JAX Pallas kernel in
    interpret mode up to its widest D (1,536), ``_xla_weighted_update`` past
    it; the JAX package's fused-against-XLA bar: weights atol 1e-5, update
    atol 5e-3, ESS rtol 1e-3.
    """
    k = 2500
    t, m = (slots // 2, 2) if slots % 2 == 0 else (slots, 1)
    rng = np.random.default_rng(slots)
    costs = rng.uniform(0, 100, size=k).astype(np.float32)
    samples = rng.normal(size=(k, t, m)).astype(np.float32)
    args = (jnp.asarray(costs), jnp.asarray(samples), jnp.asarray(1.0, jnp.float32))
    want = (pallas_kernels.weighted_update(*args, interpret=True) if slots <= 1536
            else _xla_weighted_update(*args))
    lam = torch.tensor([1.0])
    stats, numer = wu.block_partials_plain(torch.from_numpy(costs),
                                           torch.from_numpy(samples.reshape(k, slots)), lam)
    assert stats.shape == (10, 3) and numer.shape == (10, slots)
    got = wu.combine_partials(torch.from_numpy(costs), stats, numer, lam, t, m)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=5e-3)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-3)


def test_xla_backend_is_softmax_and_einsum():
    rng = np.random.default_rng(4)
    costs = rng.uniform(0, 100, size=600).astype(np.float32)
    samples = rng.normal(size=(600, 6, 2)).astype(np.float32)
    got = _port(costs, samples, 3.0, backend="xla")
    c, s = torch.from_numpy(costs), torch.from_numpy(samples)
    weights = torch.softmax(-c / torch.tensor(3.0), dim=0)
    torch.testing.assert_close(got[1], weights, rtol=0, atol=0)
    torch.testing.assert_close(got[0], torch.einsum("k,ktm->tm", weights, s), rtol=0, atol=0)
    _assert_close(got, _jax(costs, samples, 3.0)[1], BARS, "xla route vs JAX XLA")
    with pytest.raises(ValueError, match="backend"):
        _port(costs, samples, 3.0, backend="cuda")


def _solver_outputs(kernel_backend):
    cfg = MPPIConfig(horizon=6, num_samples=700, dim_state=2, dim_control=2,
                     u_min=(-1.0, -1.0), u_max=(1.0, 1.0), sigmas=(0.5, 0.5), lambda_=0.7,
                     kernel_backend=kernel_backend)
    goal = torch.tensor([1.0, 1.0])
    solver = make_solver(cfg, lambda x, u: x + u, lambda x, u, info: ((x - goal) ** 2).sum(1),
                         device="cpu")
    noise = torch.from_numpy(
        np.random.default_rng(5).normal(size=(700, 6, 2)).astype(np.float32) * 0.5)
    result = solver.solve(solver.init(), torch.zeros(2), noise=noise)
    pert = torch.clamp(noise, -1.0, 1.0)  # zero warm start
    return result, pert


@pytest.mark.parametrize("kernel_backend", ["auto", "pallas", "xla"])
def test_solver_softmin_tail_follows_kernel_backend(kernel_backend):
    result, pert = _solver_outputs(kernel_backend)
    lam = torch.tensor(0.7)
    want = (wu.xla_weighted_update(result.aux.costs, pert, lam) if kernel_backend == "xla"
            else wu.weighted_update(result.aux.costs, pert, lam, backend="pallas"))
    torch.testing.assert_close(result.aux.weights, want[1], rtol=0, atol=0)
    torch.testing.assert_close(result.aux.ess, want[2], rtol=0, atol=0)
    # and the routes agree with each other to the JAX package's bar
    other = wu.weighted_update(result.aux.costs, pert, lam,
                               backend="auto" if kernel_backend == "xla" else "xla")
    torch.testing.assert_close(result.aux.weights, other[1], rtol=2e-5, atol=1e-8)


def test_partials_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        wu.weighted_update_partials(torch.zeros(8, device="meta"),
                                    torch.zeros(8, 4, device="meta"), torch.ones(1, device="meta"))
