"""Solve-time measurement and profiling hooks.

Counterpart of ``mppi_playground_tpu/utils/timing.py``.  The reference
controller's examples measure wall-clock around the solve and print an
average; these do the same with the clock stopped only once the device has
finished: where the JAX
package calls ``jax.block_until_ready``, :func:`block_until_ready` waits on
the device of every CUDA tensor of the result (``torch.cuda.synchronize``),
and does nothing for CPU tensors.  :func:`profile_trace` records a
``torch.profiler`` trace of a block (the card's kernels too, where there is
one) and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mppi_playground_tpu_torch.core.closed_loop import _tensors


def block_until_ready(tree):
    """Wait until the devices of ``tree``'s CUDA tensors have finished; returns ``tree``."""
    for device in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)
    return tree


class SolveTimer:
    """Running average of solve latency (reference-style reporting)."""

    def __init__(self) -> None:
        self.times = []

    @contextlib.contextmanager
    def measure(self, result_fn: Optional[Callable] = None):
        """Time a block; pass ``result_fn`` returning the block's output so
        that the device finishes it before the clock stops."""
        start = time.perf_counter()
        yield
        if result_fn is not None:
            block_until_ready(result_fn())
        self.times.append(time.perf_counter() - start)

    def add(self, seconds: float) -> None:
        self.times.append(seconds)

    @property
    def average_ms(self) -> float:
        return 1000.0 * float(np.mean(self.times)) if self.times else 0.0

    def summary(self) -> str:
        return f"average solve time: {self.average_ms:.3f} ms"


def time_fn(fn: Callable, *args, warmup: int = 3, iters: int = 20, **kwargs) -> Dict:
    """Steady-state latency of ``fn(*args, **kwargs)``, each call waited for on the device.

    Returns a dict with the mean, median and 95th percentile seconds and
    calls/s, on the host clock.
    """
    for _ in range(warmup):
        block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - start)
    times = np.asarray(times)
    return {
        "mean_s": float(times.mean()),
        "p50_s": float(np.percentile(times, 50)),
        "p95_s": float(np.percentile(times, 95)),
        "per_s": float(1.0 / times.mean()),
    }


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Record a ``torch.profiler`` trace around a block into ``log_dir/trace.json``.

    The host's operations, and the card's kernels where CUDA is available;
    open the file with Perfetto or ``chrome://tracing``.  ``log_dir``
    defaults to ``torch-trace`` in the temporary directory.  Yields the
    directory.
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
