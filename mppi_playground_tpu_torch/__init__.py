"""mppi_playground_tpu_torch — the MPPI framework in PyTorch, for one NVIDIA H100.

A port of ``mppi_playground_tpu`` (JAX/XLA/Pallas) that mirrors its layout
(``core/``, ``models/``, ``maps/``, ``ops/``, ``envs/``, ``parallel/``, ``utils/``,
``workloads.py``).  Plain tensor code is PyTorch; every Pallas kernel on the
ported path is a CUDA C++ kernel for Hopper (``csrc/``), built with ``nvcc``
at first use and bound with ``ctypes``.  Each kernel wrapper has a plain
PyTorch twin that it runs only for CPU tensors.

Entry points take ``device=None``, which means ``"cuda"``: without a card
they raise unless the caller asks for ``device="cpu"``.

This package imports neither ``jax`` nor anything of ``mppi_playground_tpu``.
"""

from mppi_playground_tpu_torch.core.closed_loop import PipelinedRunner
from mppi_playground_tpu_torch.core.config import MPPIConfig, MPPIState
from mppi_playground_tpu_torch.core.controller import MPPI
from mppi_playground_tpu_torch.core.solver import (
    MPPISolver,
    SolveAux,
    SolveResult,
    make_solver,
)

__all__ = [
    "MPPI",
    "MPPIConfig",
    "MPPIState",
    "MPPISolver",
    "PipelinedRunner",
    "SolveAux",
    "SolveResult",
    "make_solver",
]

__version__ = "0.1.0"
