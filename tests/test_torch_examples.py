"""The port's example scripts (``mppi_playground_tpu_torch/examples``) on the CPU.

* **Headless runs**, case for case the JAX scripts' ``tests/test_examples.py``
  with ``device="cpu"`` and tiny step counts: each script's printed lines,
  its ``--episode`` mode, the gifs under ``video/`` and ``make_media --fast
  --out``.  The cases the JAX file marks ``slow`` are ``slow`` here too.
* **Config parity**: the JAX script's ``MPPI``, ``RacingController`` or
  ``make_solver`` is patched with a recorder that captures its arguments and
  stops the script; the port's ``make_solver`` / ``make_controller`` builds
  the same config (horizon, K, sigmas, the λ mode, the bounds,
  ``store_rollouts``, the route).
* **Closed loop**: the pendulum's ``--episode`` at the example's own
  configuration (T=15, K=1,000, ESSPS, 200 ticks) swings up.
"""

import inspect
import os
import re
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# measured (CPU): the example's seed 42 ends at |θ| 0.00022, its |θ| over ticks
# 150-200 at most 0.0205 (0.0139-0.0308 over seeds 0-5); about 2x headroom
PENDULUM_EPISODE_THETA_BOUND = 0.04


def _ex(name):
    import importlib

    return importlib.import_module(f"mppi_playground_tpu_torch.examples.{name}")


# ---------------------------------------------------------------------------
# Headless runs (tests/test_examples.py, case for case)
# ---------------------------------------------------------------------------

def test_pendulum_example_runs(capsys):
    _ex("pendulum").main(save_mode=False, steps=3, use_gym=False, device="cpu")
    out = capsys.readouterr().out
    assert "average solve time" in out and "final theta" in out


def test_pendulum_example_episode_mode(capsys):
    """--episode: every tick through run_episode on the internal simulator."""
    _ex("pendulum").main(save_mode=False, steps=3, episode=True, device="cpu")
    out = capsys.readouterr().out
    assert "episode: " in out
    assert "final theta" in out


def test_pendulum_example_fused(capsys):
    """--fused: the pendulum's fused kernels (their twins on the CPU), no fallback."""
    _ex("pendulum").main(save_mode=False, steps=3, use_gym=False, fused=True, device="cpu")
    out = capsys.readouterr().out
    assert "average solve time" in out and "XLA" not in out


def test_cartpole_example_runs(capsys):
    _ex("cartpole").main(save_mode=False, steps=3, use_gym=False, device="cpu")
    assert "average solve time" in capsys.readouterr().out


def test_cartpole_example_episode_mode(capsys):
    """--episode: every tick through run_episode on the bang-bang dynamics."""
    _ex("cartpole").main(save_mode=False, steps=3, episode=True, device="cpu")
    out = capsys.readouterr().out
    assert "episode: " in out and "final pole angle" in out


def test_mountaincar_example_runs(capsys):
    _ex("mountaincar").main(save_mode=False, steps=3, use_gym=False, device="cpu")
    assert "average solve time" in capsys.readouterr().out


def test_mountaincar_example_episode_mode(capsys):
    """--episode: run_episode with the hilltop test on the device."""
    _ex("mountaincar").main(save_mode=False, steps=3, episode=True, device="cpu")
    out = capsys.readouterr().out
    assert "episode: " in out and "final position" in out


@pytest.mark.slow
def test_navigation_example_runs(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _ex("navigation2d").main(save_mode=True, max_steps=2, render=True, device="cpu")
    assert "average solve time" in capsys.readouterr().out
    # gif written from the captured frames
    assert (tmp_path / "video" / "navigation_2d_42.gif").exists()


@pytest.mark.slow
def test_navigation_example_episode_mode(capsys):
    """--episode: run_episode with the goal test on the device."""
    _ex("navigation2d").main(save_mode=False, max_steps=2, render=False, episode=True,
                             device="cpu")
    assert "episode: " in capsys.readouterr().out


def test_navigation_example_fused_headless(capsys):
    """--fused: the navigation model's fused kernels, the top 300 regenerated."""
    _ex("navigation2d").main(save_mode=False, max_steps=2, render=False, fused=True,
                             device="cpu")
    assert "average solve time" in capsys.readouterr().out


@pytest.mark.slow
def test_racing_example_runs(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _ex("racing").main(save_mode=False, max_steps=2, render=False, device="cpu")
    assert "average solve time" in capsys.readouterr().out


@pytest.mark.slow
def test_racing_example_episode_mode(capsys):
    """--episode: run_episode with the goal test on the device."""
    _ex("racing").main(save_mode=False, max_steps=2, render=False, episode=True, device="cpu")
    assert "episode: " in capsys.readouterr().out


def test_racing_example_fused_headless(capsys):
    """--fused: the racing model's fused kernels, the top 300 regenerated."""
    _ex("racing").main(save_mode=False, max_steps=2, render=False, fused=True, device="cpu")
    assert "average solve time" in capsys.readouterr().out


def test_danger_zone_example_runs(capsys):
    _ex("goal_in_danger_zone").main(save_mode=False, render=False, max_steps=3, device="cpu")
    out = capsys.readouterr().out
    assert "episodic reward" in out and "episodic cost" in out


def test_danger_zone_example_episode_mode(capsys):
    """--episode: run_episode with the CMDP bookkeeping from the visited states."""
    _ex("goal_in_danger_zone").main(save_mode=False, render=False, max_steps=3, episode=True,
                                    device="cpu")
    out = capsys.readouterr().out
    assert "episode: " in out
    assert "episodic reward" in out and "episodic cost" in out


@pytest.mark.slow
def test_racing_example_saves_gif(capsys, tmp_path, monkeypatch):
    """save_mode writes the gif on close."""
    monkeypatch.chdir(tmp_path)
    _ex("racing").main(save_mode=True, max_steps=2, render=True, device="cpu")
    assert "average solve time" in capsys.readouterr().out
    assert (tmp_path / "video" / "racing_42.gif").exists()


@pytest.mark.slow
def test_danger_zone_example_saves_gif(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _ex("goal_in_danger_zone").main(save_mode=True, max_steps=2, device="cpu")
    out = capsys.readouterr().out
    assert "episodic reward" in out
    assert (tmp_path / "video" / "goal_in_danger_zone_42.gif").exists()


def _inverted_pendulum():
    """Skip unless gymnasium and mujoco can make InvertedPendulum-v4."""
    pytest.importorskip("mujoco")
    gym = pytest.importorskip("gymnasium")
    try:
        gym.make("InvertedPendulum-v4").close()
    except Exception as exc:  # missing assets / GL stack
        pytest.skip(f"InvertedPendulum-v4 unavailable: {exc}")


def test_mujoco_example_runs(capsys):
    """The approximate-dynamics demo against InvertedPendulum-v4."""
    _inverted_pendulum()
    _ex("mujoco_cartpole").main(save_mode=False, steps=2, render=False, device="cpu")
    assert "average solve time" in capsys.readouterr().out


def test_make_media_fast(tmp_path, monkeypatch):
    """make_media renders the three gymnasium workloads' gifs."""
    pytest.importorskip("gymnasium")
    monkeypatch.setattr(sys, "argv", ["make_media", "--fast", "--out", str(tmp_path),
                                      "--device", "cpu"])
    _ex("make_media").main()
    for name in ("pendulum", "cartpole", "mountaincar"):
        p = tmp_path / f"{name}.gif"
        assert p.exists() and os.path.getsize(p) > 0, name


@pytest.mark.slow
def test_racing_example_pipelined_mode(capsys):
    """--pipelined N: the PipelinedRunner serving demo closes the loop."""
    _ex("racing").main(save_mode=False, max_steps=4, render=False, pipelined=2, device="cpu")
    assert "pipelined depth=2" in capsys.readouterr().out


def test_racing_example_pipelined_headless_fast(capsys):
    """--pipelined 2 --no-compensate on the fused route, two ticks past the fill."""
    _ex("racing").main(save_mode=False, max_steps=4, render=False, pipelined=2,
                       no_compensate=True, fused=True, device="cpu")
    assert "pipelined depth=2 compensate=False" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The pendulum swings up at the example's configuration
# ---------------------------------------------------------------------------

def test_pendulum_example_episode_swings_up(capsys):
    """``--episode`` at T=15, K=1,000, ESSPS, 200 ticks from hanging down ends upright.

    Measured on the CPU: final |θ| 0.00022, |θ| over ticks 150-200 at most
    0.0205 (at most 0.0308 over seeds 0-5); the bound
    (:data:`PENDULUM_EPISODE_THETA_BOUND`, 0.04) leaves about 2x.
    """
    _ex("pendulum").main(save_mode=False, steps=200, episode=True, device="cpu")
    theta = float(re.search(r"final theta: (\S+)", capsys.readouterr().out).group(1))
    assert abs(theta) < PENDULUM_EPISODE_THETA_BOUND, theta


# ---------------------------------------------------------------------------
# Config parity with the JAX scripts
# ---------------------------------------------------------------------------

class _Stop(Exception):
    """Raised by a recorder once it has the JAX script's arguments."""


def _recorder(calls, stop=True):
    def record(*args, **kwargs):
        calls.append((args, kwargs))
        if stop:
            raise _Stop
        return None

    return record


def _floats(values) -> tuple:
    return tuple(float(v) for v in np.asarray(values, dtype=np.float64).reshape(-1))


FIELDS = ("horizon", "num_samples", "sigmas", "lambda_", "u_min", "u_max", "store_rollouts")


def _fields(values: dict) -> dict:
    return {f: _floats(values[f]) if f in ("sigmas", "u_min", "u_max") else values[f]
            for f in FIELDS}


def _with_defaults(cls, kwargs) -> dict:
    """``kwargs`` of a call to ``cls`` over its constructor's defaults."""
    params = inspect.signature(cls.__init__).parameters
    merged = {k: p.default for k, p in params.items() if p.default is not inspect.Parameter.empty}
    merged.update(kwargs)
    return merged


def _port(config) -> dict:
    return _fields({f: getattr(config, f) for f in FIELDS})


def _jax_mppi(calls) -> dict:
    from mppi_playground_tpu import MPPI as JaxMPPI

    (_, kwargs), = calls
    merged = _with_defaults(JaxMPPI, kwargs)
    return dict(_fields(merged), fused=merged.get("fused_task") is not None)


def _allow_fused(monkeypatch):
    """Let the JAX scripts' ``--fused`` through off the TPU (their arguments only)."""
    import mppi_playground_tpu.ops.fused_solve as jax_fs

    monkeypatch.setattr(jax_fs, "resolve_fused_request", lambda fused: fused)


@pytest.mark.parametrize("fused", [False, True])
def test_pendulum_config_matches_jax(monkeypatch, fused):
    from examples import pendulum as jax_ex

    _allow_fused(monkeypatch)
    calls = []
    monkeypatch.setattr(jax_ex, "MPPI", _recorder(calls))
    with pytest.raises(_Stop):
        jax_ex.main(steps=1, use_gym=False, fused=fused)
    solver = _ex("pendulum").make_solver("cpu", fused=fused)
    assert dict(_port(solver.config), fused=solver.solver_backend == "fused") == _jax_mppi(calls)


def test_cartpole_config_matches_jax(monkeypatch):
    from examples import cartpole as jax_ex

    calls = []
    monkeypatch.setattr(jax_ex, "MPPI", _recorder(calls))
    with pytest.raises(_Stop):
        jax_ex.main(steps=1, use_gym=False)
    solver = _ex("cartpole").make_solver("cpu")
    assert dict(_port(solver.config), fused=False) == _jax_mppi(calls)


def test_mountaincar_config_matches_jax(monkeypatch):
    from examples import mountaincar as jax_ex

    calls = []
    monkeypatch.setattr(jax_ex, "MPPI", _recorder(calls))
    with pytest.raises(_Stop):
        jax_ex.main(steps=1, use_gym=False)
    solver = _ex("mountaincar").make_solver("cpu")
    assert dict(_port(solver.config), fused=False) == _jax_mppi(calls)


@pytest.mark.parametrize("fused", [False, True])
def test_navigation_config_matches_jax(monkeypatch, fused):
    from examples import navigation2d as jax_ex

    from mppi_playground_tpu_torch.envs import Navigation2DEnv

    _allow_fused(monkeypatch)
    calls = []
    monkeypatch.setattr(jax_ex, "MPPI", _recorder(calls))
    with pytest.raises(_Stop):
        jax_ex.main(max_steps=1, render=False, fused=fused)
    solver = _ex("navigation2d").make_solver(Navigation2DEnv(device="cpu"), fused=fused)
    assert dict(_port(solver.config), fused=solver.solver_backend == "fused") == _jax_mppi(calls)


def test_danger_zone_config_matches_jax(monkeypatch):
    from examples import goal_in_danger_zone as jax_ex

    from mppi_playground_tpu_torch.envs import GoalInDangerZoneEnv

    calls = []
    monkeypatch.setattr(jax_ex, "MPPI", _recorder(calls))
    with pytest.raises(_Stop):
        jax_ex.main(render=False, max_steps=1)
    env = GoalInDangerZoneEnv(render_mode=None, seed=42)
    solver = _ex("goal_in_danger_zone").make_solver(env, "cpu")
    assert dict(_port(solver.config), fused=False) == _jax_mppi(calls)


@pytest.mark.parametrize("fused", [False, True])
def test_racing_config_matches_jax(monkeypatch, fused):
    from examples import racing as jax_ex

    from mppi_playground_tpu.envs import RacingController as JaxController
    from mppi_playground_tpu_torch.envs import RacingEnv

    _allow_fused(monkeypatch)
    calls = []
    monkeypatch.setattr(jax_ex, "RacingController", _recorder(calls))
    with pytest.raises(_Stop):
        jax_ex.main(max_steps=1, render=False, fused=fused)
    (args, kwargs), = calls
    jax_env = args[0]
    want = _with_defaults(JaxController, kwargs)
    want.update(u_min=jax_env.u_min, u_max=jax_env.u_max)
    controller = _ex("racing").make_controller(RacingEnv(device="cpu"), fused=fused)
    assert _port(controller.config) == _fields(want)
    assert controller.solver_backend == ("fused" if fused else "xla")
    assert want["solver_backend"] == ("fused" if fused else "auto")


def test_racing_pipelined_config_matches_jax(monkeypatch):
    import mppi_playground_tpu.core.solver as jax_solver
    from examples import racing as jax_ex

    from mppi_playground_tpu_torch.envs import RacingEnv

    calls = []
    monkeypatch.setattr(jax_solver, "make_solver", _recorder(calls))
    with pytest.raises(_Stop):
        jax_ex.main(max_steps=1, render=False, pipelined=2)
    (args, _), = calls
    want = args[0]
    solver = _ex("racing").make_pipelined_solver(RacingEnv(device="cpu"))
    assert _port(solver.config) == _port(want)


def test_mujoco_config_and_model_match_jax(monkeypatch):
    """The port's copy of the approximate dynamics and cost, and the solver's config."""
    _inverted_pendulum()
    import jax.numpy as jnp
    import torch
    from examples import mujoco_cartpole as jax_ex

    port = _ex("mujoco_cartpole")
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 4)) * (0.5, 1.0, 0.15, 1.0)).astype(np.float32)
    u = (rng.standard_normal((64, 1)) * 2.0).astype(np.float32)
    np.testing.assert_allclose(port.dynamics(torch.from_numpy(x), torch.from_numpy(u)).numpy(),
                               np.asarray(jax_ex.dynamics(jnp.asarray(x), jnp.asarray(u))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.cost_func(torch.from_numpy(x), torch.from_numpy(u), {}).numpy(),
                               np.asarray(jax_ex.cost_func(jnp.asarray(x), jnp.asarray(u), {})),
                               rtol=1e-5, atol=1e-6)
    calls = []
    monkeypatch.setattr(jax_ex, "MPPI", _recorder(calls))
    with pytest.raises(_Stop):
        jax_ex.main(steps=1, render=False)
    solver = port.make_solver("cpu")
    assert dict(_port(solver.config), fused=False) == _jax_mppi(calls)


def test_make_media_configs_match_jax(monkeypatch, tmp_path):
    from examples import make_media as jax_ex

    calls = []
    monkeypatch.setattr(jax_ex, "MPPI", _recorder(calls, stop=False))
    monkeypatch.setattr(jax_ex, "_record", lambda *args, **kwargs: None)
    monkeypatch.setattr(sys, "argv", ["make_media.py", "--fast", "--out", str(tmp_path)])
    jax_ex.main()
    port = _ex("make_media")
    assert len(calls) == len(port.WORKLOADS)
    for name, call in zip(port.WORKLOADS, calls):
        solver = port.make_solver(name, "cpu")
        assert dict(_port(solver.config), fused=False) == _jax_mppi([call]), name
