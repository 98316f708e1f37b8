"""A user's own model on the fused kernels: ``FusedTask(model=ModelPlug(...))``.

The plugs are the JAX package's own user-defined tasks (``chip_smoke.py``
holds each one's CUDA plug struct and torch twins): the toy point mass with
its per-tick target table and the quad task of ``tests/test_fused_solve.py``,
and the linear task of ``tests/test_fused_config_sweep.py`` at any m.  On the
CPU the fused solver runs the plug's twins; the JAX side runs the JAX XLA
solver in a subprocess with FMA contraction off, on the same noise (numpy,
from a seed).  The bars are the JAX package's for fused against XLA
(``tests/test_fused_solve.py``): costs rtol 1e-5, actions atol 5e-3,
weights atol 1e-5 (1e-4 for the toy at T=160, whose 160 summed stage costs
the softmin's exponential amplifies).  The tests marked ``cuda`` build the
plugs with ``nvcc`` and hold every instantiation against its twin bit for
bit on the card; they skip without one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from mppi_playground_tpu_torch.core.config import MPPIConfig
from mppi_playground_tpu_torch.core.controller import MPPI
from mppi_playground_tpu_torch.core.fused_solver import make_fused_solver
from mppi_playground_tpu_torch.core.solver import make_solver
from mppi_playground_tpu_torch.ops import fused_solve
from mppi_playground_tpu_torch.ops.fused_solve import FusedTask, ModelPlug
from mppi_playground_tpu_torch.parallel.sharded import make_batched_fused_solver, scenario
from tests.test_torch_fused_solve import run_jax_references

K = 1024
TOY_HORIZONS = (8, 160)
QUAD_HORIZONS = (33, 64)
TOY_TARGET = 2.0


def _noise(seed, horizon, sigmas):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, horizon, len(sigmas))) * np.asarray(sigmas)).astype(
        np.float32)


def _toy_config(horizon, **kw):
    """tests/test_fused_solve.py's ``_config``: the toy task's bounds, sigma and lambda."""
    return dict(dict(horizon=horizon, num_samples=K, dim_state=2, dim_control=1,
                     u_min=(-1.0,), u_max=(1.0,), sigmas=(0.7,), lambda_=0.5,
                     store_rollouts=False), **kw)


def _quad_config(horizon):
    return _toy_config(horizon, dim_state=3, dim_control=4, u_min=(-1.0,) * 4,
                       u_max=(1.0,) * 4, sigmas=(0.5, 0.5, 0.3, 0.3))


def jax_toy_reference(out_path: str) -> None:
    """Subprocess body: the JAX XLA solver on the JAX toy task at T=8 and T=160."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
    from mppi_playground_tpu.core.solver import make_solver as jax_make_solver
    from tests.test_fused_solve import _toy_aos

    out = {}
    for horizon in TOY_HORIZONS:
        xla = jax_make_solver(JaxConfig(**_toy_config(horizon)), *_toy_aos(), jit=True,
                              donate_state=False)
        info = {"target": jnp.ones((horizon, 1), jnp.float32) * TOY_TARGET}
        r = xla.solve(xla.init(), jnp.zeros(2, jnp.float32), info=info,
                      noise=jnp.asarray(_noise(horizon, horizon, (0.7,))))
        out.update({f"{horizon}_costs": np.asarray(r.aux.costs),
                    f"{horizon}_actions": np.asarray(r.action_seq),
                    f"{horizon}_weights": np.asarray(r.aux.weights)})
    np.savez(out_path, **out)


def jax_quad_reference(out_path: str) -> None:
    """Subprocess body: the JAX XLA solver on the JAX quad task at T=33 and T=64."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mppi_playground_tpu.core.config import MPPIConfig as JaxConfig
    from mppi_playground_tpu.core.solver import make_solver as jax_make_solver
    from tests.test_fused_solve import _quad_aos

    out = {}
    for horizon in QUAD_HORIZONS:
        config = _quad_config(horizon)
        xla = jax_make_solver(JaxConfig(**config), *_quad_aos(), jit=True, donate_state=False)
        r = xla.solve(xla.init(), jnp.zeros(3, jnp.float32),
                      noise=jnp.asarray(_noise(horizon, horizon, config["sigmas"])))
        out.update({f"{horizon}_costs": np.asarray(r.aux.costs),
                    f"{horizon}_actions": np.asarray(r.action_seq),
                    f"{horizon}_weights": np.asarray(r.aux.weights)})
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax_references("tests.test_torch_plugs",
                              ["jax_toy_reference", "jax_quad_reference"],
                              tmp_path_factory.mktemp("jax_plugs"))


def _toy_info(horizon, batch=None):
    shape = (horizon, 1) if batch is None else (batch, horizon, 1)
    return {"target": torch.full(shape, TOY_TARGET)}


@pytest.mark.parametrize("horizon", TOY_HORIZONS)
def test_toy_plug_matches_jax(jax_ref, horizon):
    """The toy plug reads its target table as per-tick reference rows, step t row t."""
    plug = chip_smoke.toy_plug()
    solver = make_fused_solver(MPPIConfig(**_toy_config(horizon)), plug.task, plug.dynamics,
                               device="cpu")
    r = solver.solve(solver.init(), torch.zeros(2), info=_toy_info(horizon),
                     noise=torch.from_numpy(_noise(horizon, horizon, (0.7,))))
    ref = jax_ref["jax_toy_reference"]
    np.testing.assert_allclose(r.aux.costs.numpy(), ref[f"{horizon}_costs"], rtol=1e-5)
    np.testing.assert_allclose(r.action_seq.numpy(), ref[f"{horizon}_actions"], atol=5e-3)
    np.testing.assert_allclose(r.aux.weights.numpy(), ref[f"{horizon}_weights"],
                               atol=1e-5 if horizon <= 8 else 1e-4)


@pytest.mark.parametrize("horizon", QUAD_HORIZONS)
def test_quad_plug_matches_jax(jax_ref, horizon):
    """Four controls a step: the draws of a step fill one whole Philox block."""
    plug = chip_smoke.quad_plug()
    config = _quad_config(horizon)
    solver = make_fused_solver(MPPIConfig(**config), plug.task, plug.dynamics, device="cpu")
    r = solver.solve(solver.init(), torch.zeros(3),
                     noise=torch.from_numpy(_noise(horizon, horizon, config["sigmas"])))
    ref = jax_ref["jax_quad_reference"]
    np.testing.assert_allclose(r.aux.costs.numpy(), ref[f"{horizon}_costs"], rtol=1e-5)
    np.testing.assert_allclose(r.action_seq.numpy(), ref[f"{horizon}_actions"], atol=5e-3)
    np.testing.assert_allclose(r.aux.weights.numpy(), ref[f"{horizon}_weights"], atol=1e-5)


def test_top_samples_at_t72_under_essps_match_unfused():
    """Two-phase ESSPS and the regenerated top samples at T*m = 72, against the unfused
    solver's stored rollouts (tests/test_fused_solve.py's multi-vreg case)."""
    horizon = 72
    plug = chip_smoke.toy_plug()
    config = _toy_config(horizon, lambda_="ESSPS")
    fused = make_fused_solver(MPPIConfig(**config), plug.task, plug.dynamics, device="cpu")
    unfused = make_solver(MPPIConfig(**dict(config, store_rollouts=True)), plug.dynamics,
                          plug.cost, device="cpu")
    x0 = torch.tensor([0.1, 0.2])
    noise = torch.from_numpy(_noise(41, horizon, (0.7,)))
    info = _toy_info(horizon)
    rf = fused.solve(fused.init(), x0, info=info, noise=noise)
    ru = unfused.solve(unfused.init(), x0, info=info, noise=noise)
    np.testing.assert_allclose(rf.aux.costs.numpy(), ru.aux.costs.numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(rf.aux.lam), float(ru.aux.lam), rtol=1e-3)
    np.testing.assert_allclose(rf.action_seq.numpy(), ru.action_seq.numpy(), atol=5e-3)
    seqs, weights = fused.top_samples(rf.aux, 40, noise=noise)
    order = torch.argsort(ru.aux.weights, descending=True, stable=True)[:40]
    np.testing.assert_allclose(weights.numpy(), ru.aux.weights[order].numpy(), atol=1e-5)
    np.testing.assert_allclose(seqs.numpy(), ru.aux.state_seq_batch[order].numpy(), atol=5e-4)
    assert seqs.shape == (40, horizon + 1, 2)


@pytest.mark.parametrize("m", [3, 5])
def test_seeded_stream_at_any_m_is_the_slot_stream(m):
    """Slot f = t*m + j takes normal f mod 4 of Philox block f div 4, whatever m: the phase-1
    dump of a plug at m = 3 or 5 is the one-control stream over T*m slots, scaled and
    clamped."""
    horizon, n, seed = 7, 2, 1234
    plug = chip_smoke.linear_plug(n, m)
    prev = torch.zeros(horizon, m)
    sigmas = torch.tensor(plug.sigmas)
    _, dump = fused_solve.fused_costs_dump_plain(
        torch.zeros(n), prev, seed, None, plug.task, plug.sigmas, plug.u_min, plug.u_max, K, 0)
    flat = fused_solve.seeded_normals(seed, K, horizon * m, "cpu", dim_control=1)
    want = torch.clamp(flat.reshape(K, horizon, m) * sigmas, -1.0, 1.0)
    assert torch.equal(dump, want.reshape(K, horizon * m).t())
    assert torch.equal(fused_solve.seeded_normals(seed, K, horizon, "cpu", dim_control=m),
                       flat.reshape(K, horizon, m))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_batched_plug_solver_equals_single_solves():
    """A fleet of B=3 toy scenarios, each with its own target table, is bit for bit its three
    single solves, tick after tick."""
    batch, horizon = 3, 8
    plug = chip_smoke.toy_plug()
    config = MPPIConfig(**_toy_config(horizon, num_samples=512))
    fleet = make_batched_fused_solver(config, plug.task, plug.dynamics, "cpu", batch)
    targets = torch.tensor([1.0, 2.0, -0.5]).reshape(batch, 1, 1).expand(batch, horizon, 1)
    states = fleet.init_batch(seed=4)
    singles = [scenario(states, b) for b in range(batch)]
    xs = torch.tensor([[0.0, 0.0], [0.3, -0.1], [-0.2, 0.4]])
    for _ in range(2):
        out = fleet.solve_batch(states, xs, batched_info={"target": targets})
        for b in range(batch):
            one = fleet.solver.solve(singles[b], xs[b], info={"target": targets[b]})
            assert _same((one.action_seq, one.state_seq, one.aux.costs, one.aux.weights),
                         (out.action_seq[b], out.state_seq[b], out.aux.costs[b],
                          out.aux.weights[b])), b
            singles[b] = one.state
        states = out.state
        xs = plug.dynamics(xs, out.action_seq[:, 0])


def test_mppi_closed_loop_with_a_plug_on_the_cpu():
    """``MPPI`` routes a plug task to the fused solver: five ticks bit for bit its solves."""
    horizon = 10
    plug = chip_smoke.linear_plug(3, 3)
    kw = dict(horizon=horizon, num_samples=K, dim_state=3, dim_control=3, u_min=plug.u_min,
              u_max=plug.u_max, sigmas=plug.sigmas, lambda_="ESSPS")
    ctrl = MPPI(dynamics=plug.dynamics, cost_func=plug.cost, store_rollouts=False,
                fused_task=plug.task, device="cpu", **kw)
    assert ctrl.solver_backend == "fused"
    solver = make_fused_solver(MPPIConfig(store_rollouts=False, seed=42, **kw), plug.task,
                               plug.dynamics, device="cpu")
    state, x = solver.init(), torch.tensor([0.4, -0.2, 0.1])
    for _ in range(5):
        action_seq, state_seq = ctrl.forward(x)
        r = solver.solve(state, x)
        assert torch.equal(action_seq, r.action_seq) and torch.equal(state_seq, r.state_seq)
        state, x = r.state, plug.dynamics(x[None], action_seq[:1])[0]
    top, weights = ctrl.get_top_samples(20)
    assert top.shape == (20, horizon + 1, 3) and bool((weights[1:] <= weights[:-1]).all())


def _plug(**kw):
    fields = dict(name="mine", source="", struct="plugs::Mine", dim_state=2, dim_control=1)
    return ModelPlug(**dict(fields, **kw))


@pytest.mark.parametrize("bad", [dict(name="racing"), dict(name="pendulum"),
                                 dict(name="my-model"), dict(name="2fast"), dict(name=""),
                                 dict(struct="plugs::"), dict(dim_control=0)])
def test_a_bad_plug_raises(bad):
    with pytest.raises(ValueError):
        _plug(**bad)


def test_a_plug_reading_reference_rows_needs_a_builder():
    plug = chip_smoke.toy_plug()
    with pytest.raises(ValueError, match="reference builder"):
        dataclasses.replace(plug.task, reference=None)


def test_a_config_of_other_dimensions_raises():
    plug = chip_smoke.linear_plug(3, 2)
    config = MPPIConfig(horizon=5, num_samples=K, dim_state=3, dim_control=3,
                        u_min=(-1.0,) * 3, u_max=(1.0,) * 3, sigmas=(0.5,) * 3, lambda_=1.0,
                        store_rollouts=False)
    with pytest.raises(ValueError, match="dim_control"):
        make_fused_solver(config, plug.task, plug.dynamics, device="cpu")


def test_a_plug_names_its_kernels_and_counters():
    plug = chip_smoke.quad_plug()
    library, symbol = plug.task.entry("tick_tail_batch")
    assert library == plug.task.plug.library and library.startswith("plug_quad_")
    assert symbol == "quad_tick_tail_batch"
    names = fused_solve.kernel_names(fused_solve.fused_solve, [plug.task.plug])
    assert "quad_fused_solve" in names and "racing_fused_solve" in names
    assert "quad_fused_solve" not in fused_solve.kernel_names(fused_solve.fused_solve)
    unit = plug.task.plug.unit
    assert "FUSED_MODEL_ENTRY_POINTS(quad, plugs::Quad)" in unit
    assert "TAIL_ENTRY_POINTS(quad, plugs::Quad)" in unit
    assert FusedTask(model="racing", dynamics_soa=None, stage_cost_soa=None,
                     reference=lambda info: None).entry("fused_solve_batch") == (
        "fused_racing", "racing_fused_solve_batch")


# --- on the card -------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py phase 16 runs these on the card")
    return torch.device("cuda")


CARD_PLUGS = {"linear_n2_m1": lambda: chip_smoke.linear_plug(2, 1),
              "linear_n3_m2": lambda: chip_smoke.linear_plug(3, 2),
              "linear_n4_m3": lambda: chip_smoke.linear_plug(4, 3),
              "linear_n3_m3": lambda: chip_smoke.linear_plug(3, 3),
              "linear_n2_m5": lambda: chip_smoke.linear_plug(2, 5),
              "toy": chip_smoke.toy_plug, "quad": chip_smoke.quad_plug,
              "speed_bicycle": chip_smoke.bicycle_plug}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_PLUGS))
def test_plug_kernels_are_their_twins_on_the_card(card, name):
    """Rows 1 and 3 of every plug instantiation bit for bit their twins in both noise modes."""
    plug = CARD_PLUGS[name]()
    horizon, k = 33, 3000
    x0, prev, noise, bounds, ref = chip_smoke.plug_inputs(torch, np, plug, horizon, k)
    lam = torch.ones(1, device=card)
    seed = chip_smoke.device_seed(torch, 7)
    for nz in (noise, None):
        args = (x0, prev, lam, seed, ref, plug.task, *bounds, k, k // 2, nz)
        got, want = fused_solve.fused_solve(*args), fused_solve.fused_solve_plain(*args)
        assert torch.equal(got[0], want[0])
        p1 = fused_solve.fused_costs_dump(x0, prev, *args[3:])
        assert all(torch.equal(a, b) for a, b in zip(
            p1, fused_solve.fused_costs_dump_plain(x0, prev, *args[3:])))
        assert all(torch.equal(a, b) for a, b in zip(fused_solve.fused_weighted(*p1, lam),
                                                     got[1:]))


@pytest.mark.cuda
def test_a_wide_prepare_takes_its_shared_memory_on_the_card(card):
    """kPre * T past 48 KB: the re-roll and the tail raise their limits, bit for bit their twins."""
    plug = chip_smoke.linear_plug(3, 1, pre=chip_smoke.WIDE_PRE)
    horizon, k = chip_smoke.WIDE_PRE_T, chip_smoke.WIDE_PRE_K
    x0, prev, _, bounds, _ = chip_smoke.plug_inputs(torch, np, plug, horizon, k)
    assert torch.equal(fused_solve.fused_reroll(x0, prev, plug.task),
                       fused_solve.fused_reroll_plain(x0, prev, plug.task))
    lam = torch.ones(1, device=card)
    args = (x0, prev, lam, chip_smoke.device_seed(torch, 7), None, plug.task, *bounds, k, k)
    costs, stats, numer = fused_solve.fused_solve(*args)
    history = torch.zeros(horizon - 1, 1, device=card)
    tail = (x0, costs, stats, numer, lam, plug.task, history)
    assert all(torch.equal(a, b) for a, b in zip(fused_solve.fused_tick_tail(*tail),
                                                 fused_solve.fused_tick_tail_plain(*tail)))


@pytest.mark.cuda
def test_an_nvcc_error_raises_with_the_compiler_output(card):
    broken = ModelPlug(name="broken", source="namespace plugs { struct Broken { int oops } }",
                       struct="plugs::Broken", dim_state=1, dim_control=1)
    task = FusedTask(model=broken, dynamics_soa=None, stage_cost_soa=None)
    prev = torch.zeros(4, 1, device=card)
    with pytest.raises(RuntimeError, match="nvcc failed(.|\n)*error"):
        fused_solve.fused_costs_dump(torch.zeros(1, device=card), prev, 1, None, task, (0.1,),
                                     (-1.0,), (1.0,), 256, 0)
