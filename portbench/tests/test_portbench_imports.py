"""Nothing the benchmark runs loads JAX or the JAX package, by whole top-level names."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "mppi_playground_tpu"}


def test_foreign_modules_compare_whole_top_level_names():
    loaded = ["mppi_playground_tpu_torch", "mppi_playground_tpu_torch.core", "jaxtyping",
              "jax", "jax.numpy", "mppi_playground_tpu", "mppi_playground_tpu.core", "flax",
              "jaxlib.xla_client", "portbench"]
    assert harness.foreign_modules(loaded) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla_client", "mppi_playground_tpu",
        "mppi_playground_tpu.core"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(harness.HERE).as_posix()
                                        for p in harness.HERE.rglob("*.py")))
def test_no_file_imports_jax_or_the_jax_package(path):
    names = {n.split(".")[0] for n in _imports(harness.HERE / path)}
    assert not names & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        names = {n.split(".")[0] for n in _imports(path)}
        assert "mppi_playground_tpu_torch" not in names and not names & FORBIDDEN, path


def test_a_run_loads_no_jax():
    """A whole small run in a fresh interpreter, then its modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.tests.common import line_of\n"
        "from portbench import harness\n"
        "line = line_of('racing_ref.fleet32')\n"
        "assert line['correct'], line\n"
        "print(harness.foreign_modules(sys.modules))\n" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "racing_flagship.control", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=harness.ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_refuses_and_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: no port, no result."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "racing_flagship.control", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "the port is not in this checkout" in out.stderr
