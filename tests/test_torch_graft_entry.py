"""The port's graft entry points, ``graft_entry_torch.py``, on the CPU.

The counterpart of tests/test_graft_entry.py:

* ``entry(device="cpu")`` gives the flagship tick at K=8,192, T=50 on the
  kernels' twins, with the four outputs of the JAX entry's tick; on the noise
  the JAX ``__graft_entry__.entry()`` tick draws (recomputed from its state's
  key in the JAX subprocess and injected here), from the same state, start
  and ``cind``, its action and state sequences meet the JAX tick's at the
  port's bar (atol 5e-3) and its ``cind`` is the JAX one;
* ``entry()``, ``dryrun_multichip(n)`` and ``dryrun_multihost()`` with no
  device raise where there is no card, and the dry runs where there are
  fewer cards than ranks;
* ``dryrun_multichip(2, device="cpu")`` and ``dryrun_multichip(4, ...)`` on
  spawned gloo ranks (4 ranks: the 2 x 2 mesh, so leg 3b runs), each fused leg bit for bit the
  single solver inside the ranks; a rank that raises makes the spawn raise;
* ``dryrun_multihost(device="cpu")``: two separate processes, one ``env://``
  rendezvous, one sharded solve bit for bit the single solver (``slow``, as
  the JAX test is: it starts three interpreters);
* neither ``graft_entry_torch`` nor any module of the port nor
  ``chip_smoke.py`` imports jax or the JAX package.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import graft_entry_torch
from mppi_playground_tpu_torch.parallel.mesh import run_on_ranks
from tests.test_torch_fused_solve import ROOT, run_jax_reference

T, K = 50, graft_entry_torch.CPU_NUM_SAMPLES


def jax_entry_reference(out_path: str) -> None:
    """Subprocess body: the JAX entry's tick, and the noise it draws."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import __graft_entry__ as ge

    fn, (state, cind, x) = ge.entry()
    # the draw of the XLA solve (core/solver.py): the second half of the key's split
    _, noise_key = jax.random.split(state.key)
    noise = jax.random.normal(noise_key, (K, T, 2), jnp.float32) * jnp.asarray([0.5, 0.1],
                                                                              jnp.float32)
    action_seq, state_seq, new_state, new_cind = jax.jit(fn)(state, cind, x)
    np.savez(out_path, noise=np.asarray(noise), x=np.asarray(x), cind=np.asarray(cind),
             prev=np.asarray(state.previous_action_seq), action_seq=np.asarray(action_seq),
             state_seq=np.asarray(state_seq), new_prev=np.asarray(new_state.previous_action_seq),
             new_cind=np.asarray(new_cind))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax_reference("tests.test_torch_graft_entry", "jax_entry_reference",
                             tmp_path_factory.mktemp("jax_entry"))


def test_entry_on_the_cpu_meets_the_jax_entry(jax_ref):
    fn, (state, cind, x) = graft_entry_torch.entry(device="cpu")
    assert x.device.type == "cpu" and int(cind) == int(jax_ref["cind"]) == 0
    np.testing.assert_array_equal(x.numpy(), jax_ref["x"])  # the same start
    np.testing.assert_array_equal(state.previous_action_seq.numpy(), jax_ref["prev"])
    # the seeded tick: the four outputs of the JAX entry's tick
    action_seq, state_seq, new_state, new_cind = fn(state, cind, x)
    assert action_seq.shape == (T, 2) and state_seq.shape == (T + 1, 4)
    assert torch.isfinite(action_seq).all() and torch.isfinite(state_seq).all()
    assert new_state.tick == 1 and int(new_cind) >= 0
    # on the JAX tick's noise
    action_seq, state_seq, new_state, new_cind = fn(state, cind, x,
                                                    noise=torch.from_numpy(jax_ref["noise"]))
    np.testing.assert_allclose(action_seq.numpy(), jax_ref["action_seq"], atol=5e-3, rtol=0)
    np.testing.assert_allclose(state_seq.numpy(), jax_ref["state_seq"], atol=5e-3, rtol=0)
    np.testing.assert_allclose(new_state.previous_action_seq.numpy(), jax_ref["new_prev"],
                               atol=5e-3, rtol=0)
    assert int(new_cind) == int(jax_ref["new_cind"])


@pytest.mark.parametrize("call", [
    graft_entry_torch.entry,
    lambda: graft_entry_torch.dryrun_multichip(2),
    graft_entry_torch.dryrun_multihost,
], ids=["entry", "dryrun_multichip", "dryrun_multihost"])
def test_an_entry_point_without_a_card_raises(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


@pytest.mark.parametrize("call, ranks", [
    (lambda: graft_entry_torch.dryrun_multichip(4), 4),
    (graft_entry_torch.dryrun_multihost, 2),
], ids=["dryrun_multichip", "dryrun_multihost"])
def test_a_dry_run_on_too_few_cards_raises(monkeypatch, call, ranks):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=f"{ranks} ranks on cuda need {ranks} cards"):
        call()


@pytest.mark.parametrize("ranks, mesh, legs", [
    (2, "{'scenario': 1, 'samples': 2}", ["unfused_batched_mpcc_essps(B=2,K=32)",
                                          "sharded_fused_racing_essps(K=2548,shards=2)",
                                          "batched_fused_racing(B=1,K=1024)",
                                          "fleet_episodes(B=2,ticks=3)"]),
    (4, "{'scenario': 2, 'samples': 2}", ["unfused_batched_mpcc_essps(B=4,K=32)",
                                          "sharded_fused_racing_essps(K=2548,shards=2)",
                                          "batched_fused_racing(B=2,K=1024)",
                                          "fused_2d_fleet(B=2,K=2548,sample_shards=2)",
                                          "fleet_episodes(B=4,ticks=3)"]),
])
def test_dryrun_multichip_runs_every_leg_on_gloo_ranks(capsys, ranks, mesh, legs):
    graft_entry_torch.dryrun_multichip(ranks, device="cpu")
    line, = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip OK")]
    assert f"mesh={mesh} ranks={ranks} device=cpu" in line
    assert line.endswith("paths=[" + ", ".join(legs) + "]")


def _fails_on_rank_one(rank: int, world: int) -> int:
    if rank == 1:
        raise ValueError(f"rank {rank} of {world} fails")
    return rank


def test_a_failing_rank_makes_the_spawn_raise():
    assert run_on_ranks(_fails_on_rank_one, 1, device="cpu") == [0]
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="rank 1 of 2 fails"):
        run_on_ranks(_fails_on_rank_one, 2, device="cpu")


@pytest.mark.slow
def test_dryrun_multihost_two_processes(capsys):
    """Marked slow as tests/test_graft_entry.py's twin is: it starts a parent and two
    child interpreters (~8 s on a CPU host)."""
    graft_entry_torch.dryrun_multihost(device="cpu")
    out = capsys.readouterr().out
    assert '"check": "multihost_dryrun", "ok": true' in out
    assert out.count('"bitwise_vs_local": true') == 2


def test_no_module_of_the_port_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import graft_entry_torch, chip_smoke, mppi_playground_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = chip_smoke.foreign_modules(sys.modules)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_foreign_modules_names_jax_and_the_jax_package():
    import chip_smoke

    names = ["jax", "jax.numpy", "jaxlib", "mppi_playground_tpu", "mppi_playground_tpu.core",
             "mppi_playground_tpu_torch", "mppi_playground_tpu_torch.core", "jaxtyping", "torch"]
    assert chip_smoke.foreign_modules(names) == ["jax", "jax.numpy", "jaxlib",
                                                 "mppi_playground_tpu",
                                                 "mppi_playground_tpu.core"]
