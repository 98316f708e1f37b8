"""Build the CUDA kernels of ``csrc/`` with ``nvcc``, load them with ``ctypes``, launch them.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<name>-<hash>.so`` at the
root of the checkout, at first use.  The hash covers the sources and the
flags, so an edited kernel is rebuilt and an unchanged one is loaded as it
is.  A generated unit (:func:`define_unit`: a user's model plug,
``ops/fused_solve.ModelPlug``) is written to
``build/kernels/<name>-<hash>.cu`` and built the same way with ``-I
csrc``; its name stands for its text.  The flags target Hopper
(``sm_90a``), keep IEEE float arithmetic (no ``--use_fast_math``) and turn
off FMA contraction (``-fmad=false``), so a kernel rounds as its plain
PyTorch twin does.  Nothing here runs at import.

Every launch opens the span ``kernel.<symbol>`` and counts in the registry
of ``utils/timing`` (``kernel.launches``); each ``nvcc`` run counts in
``kernels.built``, each library loaded that an earlier process built in
``kernels.loaded``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

from mppi_playground_tpu_torch.utils import timing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# every csrc/<name>.cu, each its own library
SOURCES = tuple(sorted(path.stem for path in CSRC.glob("*.cu")))

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], object] = {}
# library name -> the text of its generated unit (define_unit)
_units: Dict[str, str] = {}
# ptxas reports (registers, spills) of the builds this process ran
build_logs: Dict[str, str] = {}
# seconds from the start of its build() call to each build's end, read in turn
build_seconds: Dict[str, float] = {}


def nvcc() -> str:
    """The ``nvcc`` on the PATH, else the CUDA toolkit's default one."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def define_unit(name: str, text: str) -> None:
    """Make library ``name`` the build of the generated CUDA unit ``text``.

    The unit includes headers of ``csrc/`` by name.  ``name`` stands for
    its text (``ModelPlug.library`` carries the text's digest): defining it
    again with the same text does nothing, with another text raises.
    """
    if (CSRC / f"{name}.cu").exists():
        raise ValueError(f"{name} is a source of csrc/, not a generated unit")
    with _lock:
        if _units.setdefault(name, text) != text:
            raise ValueError(f"the generated unit {name} is already defined with another text")


def _target(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    target = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if name in _units:  # the generated unit beside its library, headers from csrc/
        source = target.with_suffix(".cu")
        unit_tmp = target.with_suffix(f".{os.getpid()}.cu.tmp")
        unit_tmp.write_text(_units[name])
        os.replace(unit_tmp, source)
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(source)]
    else:
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile the named sources (or generated units) that are not built yet, all at once.

    One ``nvcc`` per source, started together.  Returns the wall seconds;
    raises with the compiler's output if any build fails.
    """
    t0 = time.perf_counter()
    procs: List[Tuple[str, subprocess.Popen, Path, Path]] = []
    try:
        for name in names:
            if not _target(name).exists():
                procs.append((name, *_start(name)))
        for name, proc, tmp, target in procs:
            out, _ = proc.communicate()
            build_logs[name] = out
            build_seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                source = target.with_suffix(".cu") if name in _units else f"{name}.cu"
                raise RuntimeError(f"nvcc failed for {source}:\n{out}")
            os.replace(tmp, target)
            timing.count("kernels.built")
    finally:
        for _, proc, tmp, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return time.perf_counter() - t0


def function(name: str, symbol: str, argtypes: list):
    """C function ``symbol`` of ``csrc/<name>.cu`` (or of a generated unit), built and loaded
    on first use.

    ``argtypes`` are the arguments before the stream, every pointer a
    ``c_void_p``; the stream, which every entry point takes last, is added
    here.  The function returns a ``cudaError_t`` as ``int``.
    """
    with _lock:
        fn = _functions.get((name, symbol))
        if fn is None:
            lib = _loaded.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(_target(name)))
                _loaded[name] = lib
                if name not in build_seconds:  # found built by an earlier process
                    timing.count("kernels.loaded")
            fn = getattr(lib, symbol)
            fn.argtypes = [*argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _functions[(name, symbol)] = fn
        return fn


def launch(name: str, symbol: str, argtypes: list, device, *args) -> None:
    """Call ``symbol`` of library ``name`` with ``args`` and ``device``'s current stream.

    The C function enqueues its kernel and returns ``cudaGetLastError()``;
    a refused launch raises here.  The call is the span ``kernel.<symbol>``,
    and the launch counts in ``kernel.launches`` (:func:`launched`).
    """
    fn = function(name, symbol, argtypes)
    stream = torch.cuda.current_stream(device).cuda_stream
    with timing.kernel_span(symbol), torch.cuda.device(device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError_t {err}")
    timing.count_launch(symbol, launched())


def launched() -> int:
    """Whether a launch just made on the current stream ran (1) or was recorded by a CUDA
    graph's capture (0).

    It is what the launch adds to the registry's eager count of its kernel
    (``utils/timing``), which the wrappers' ``launches`` read; a captured
    launch counts in ``kernel.launches`` once for every replay of its graph,
    from the graph's capture map.
    """
    return 0 if torch.cuda.is_current_stream_capturing() else 1
