"""ESSPS and LBPS temperature searches in one launch: CUDA kernels and their twins.

Counterpart of ``mppi_playground_tpu/ops/lambda_search.py``.  Each search
reads the cost vector ``[K]`` once and runs every iteration on it, written
by hand for Hopper in ``csrc/lambda_search.cu``:

* :func:`essps_lambda_fused` — bisection on ``ESS(lambda) = target`` with
  ``d = min(c) - c`` hoisted and ``ESS = (sum e)^2 / sum e^2``,
  ``e = exp(d * (1 / lambda))``; the reference's bracket clamps.
* :func:`lbps_lambda_fused` — golden section on ``(sum e*c + range_pen *
  sqrt(sum e^2)) / sum e`` with ``a = -1/lambda``, ``e = exp(c*a -
  min(c)*a)`` (the exact hoist), carrying the surviving value;
  ``range_pen = (max - min) * sqrt(f32((1 - delta) / delta))``.

A fleet's searches are one launch, a cluster a scenario
(:func:`essps_lambda_fused_batch`, :func:`lbps_lambda_fused_batch`: costs
``[B, K]`` -> ``[B]``), each scenario's λ* bit for bit its own launch's.

The λ epilogue of auto-lambda phase 1 (``ops/fused_solve.fused_costs_dump_lambda``)
runs the same searches, with the same element bodies and summation order
(``csrc/lambda_search.cuh``), so both routes give λ* bit for bit; its twin
is :meth:`LambdaSearch.plain`.

These differ from the loops of ``core/autolambda.py`` only in rounding: the
same searches on another form of the same sums.  Each wrapper launches its
kernel for CUDA tensors, and raises on what the kernel does not take; its
``launches`` reads the eager launches in ``utils/timing``'s registry (a
launch a CUDA graph captures counts there once a replay:
``cuda_build.launched``).  For CPU tensors it runs the plain twin
beside it (``*_plain``), which does the kernel's arithmetic operation for
operation, its sums included (:func:`kernel_order_sum`): the
LBPS objective is so flat near its minimum that two summation orders can
stop golden section ~0.1% apart.  The result is a 0-dim tensor on the
costs' device; nothing is read back to the host.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from mppi_playground_tpu_torch.ops import cuda_build
from mppi_playground_tpu_torch.utils import timing

_INVPHI = (math.sqrt(5.0) - 1.0) / 2.0
# the kernels' launch geometry (csrc/lambda_search.cu kCluster, kThreads)
CLUSTER = 8
THREADS = 1024
# The kernels index the costs with 32-bit ints (the slice size is rounded up
# from K + CLUSTER - 1).  Unlike the JAX package's VMEM gate of 1M, there is
# no size limit below that: each CTA keeps the first 200 KB of its slice in
# shared memory and reads the rest from global memory (from L2 while the
# costs fit there, up to about 12M samples on the H100's 50 MB).
MAX_SAMPLES = 2**31 - CLUSTER


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def kernel_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x [K]`` in the search kernels' order, as a 0-dim tensor.

    CTA r of the cluster holds the r-th slice of ``ceil(K / 8)`` values;
    thread t adds its slice's values t, t + 1024, ... in turn; a warp folds
    its 32 lanes by halves (the xor-shuffle butterfly, lane 0's result),
    warp 0 folds the 32 warp sums the same way, and the 8 CTA sums are added
    in rank order.  The padding adds exact zeros.
    """
    k = x.shape[0]
    chunk = -(-k // CLUSTER)
    per_thread = -(-chunk // THREADS)
    slices = torch.cat([x, x.new_zeros(CLUSTER * chunk - k)]).view(CLUSTER, chunk)
    slices = torch.cat([slices, x.new_zeros(CLUSTER, per_thread * THREADS - chunk)], dim=1)
    strided = slices.view(CLUSTER, per_thread, THREADS)
    acc = strided[:, 0]
    for j in range(1, per_thread):
        acc = acc + strided[:, j]
    for _ in range(2):  # lanes of each warp, then the warps of the CTA
        acc = acc.reshape(CLUSTER, -1, 32)
        while acc.shape[-1] > 1:
            half = acc.shape[-1] // 2
            acc = acc[..., :half] + acc[..., half:]
    acc = acc.reshape(CLUSTER)
    total = acc[0]
    for r in range(1, CLUSTER):
        total = total + acc[r]
    return total


def essps_lambda_plain(costs, target_ess, lambda_min, lambda_max, iters: int = 40):
    """The ESSPS kernel's plain twin: 0-dim ``lambda*``."""
    lam_min = _scalar(lambda_min, costs)
    lam_max = _scalar(lambda_max, costs)
    target = _scalar(target_ess, costs)
    d = torch.min(costs) - costs

    def ess(lam):
        e = torch.exp(d * (1.0 / lam))
        z = kernel_order_sum(e)
        return z * z / kernel_order_sum(e * e)

    ess_at_min = ess(lam_min)
    ess_at_max = ess(lam_max)
    a, b = lam_min, lam_max
    for _ in range(iters):
        mid = 0.5 * (a + b)
        below = ess(mid) < target  # the root lies above mid
        a, b = torch.where(below, mid, a), torch.where(below, b, mid)
    root = 0.5 * (a + b)
    return torch.where(
        target <= ess_at_min, lam_min, torch.where(target >= ess_at_max, lam_max, root)
    )


def lbps_range_penalty(costs: torch.Tensor, delta: float) -> torch.Tensor:
    """``(max - min) * sqrt(f32((1 - delta) / delta))`` over the costs."""
    return (torch.max(costs) - torch.min(costs)) * torch.sqrt(
        _scalar((1.0 - delta) / delta, costs)
    )


def lbps_objective_plain(costs, lam, range_pen):
    """The LBPS kernel's objective: ``(sum e*c + range_pen * sqrt(sum e^2)) / sum e``."""
    cmin = torch.min(costs)
    a = -1.0 / lam
    e = torch.exp(costs * a - cmin * a)
    z, sq, wc = (kernel_order_sum(v) for v in (e, e * e, e * costs))
    return (wc + range_pen * torch.sqrt(sq)) / z


def lbps_lambda_plain(costs, delta, lambda_min, lambda_max, iters: int = 32):
    """The LBPS kernel's plain twin: 0-dim ``lambda*``."""
    range_pen = lbps_range_penalty(costs, delta)

    def objective(lam):
        return lbps_objective_plain(costs, lam, range_pen)

    invphi = _scalar(_INVPHI, costs)
    a = _scalar(lambda_min, costs)
    b = _scalar(lambda_max, costs)
    c = b - (b - a) * invphi
    d = a + (b - a) * invphi
    fc = objective(c)
    fd = objective(d)
    for _ in range(iters):
        shrink_right = fc < fd  # the minimum lies in [a, d]
        new_a = torch.where(shrink_right, a, c)
        new_b = torch.where(shrink_right, d, b)
        fresh_lo = new_b - (new_b - new_a) * invphi
        fresh_hi = new_a + (new_b - new_a) * invphi
        x = torch.where(shrink_right, fresh_lo, fresh_hi)
        fx = objective(x)
        # the surviving interior point keeps its value
        c, fc, d, fd = (
            torch.where(shrink_right, x, d),
            torch.where(shrink_right, fx, fd),
            torch.where(shrink_right, c, x),
            torch.where(shrink_right, fc, fx),
        )
        a, b = new_a, new_b
    return 0.5 * (a + b)


@dataclasses.dataclass(frozen=True)
class LambdaSearch:
    """One LBPS or ESSPS search as a solver runs it, for the lambda epilogue.

    ``param`` is the ESSPS target ESS or the LBPS delta.  :meth:`plain`
    is the search kernels' twin; :attr:`kernel_param` what the kernels take
    (the target, or LBPS's ratio ``(1 - delta) / delta``).
    """

    mode: str
    lambda_min: float
    lambda_max: float
    param: float
    iters: int

    def __post_init__(self):
        if self.mode not in ("ESSPS", "LBPS"):
            raise ValueError(f"mode must be 'ESSPS' or 'LBPS', got {self.mode!r}")

    @property
    def kernel_param(self) -> float:
        return self.param if self.mode == "ESSPS" else (1.0 - self.param) / self.param

    def run(self, costs: torch.Tensor) -> torch.Tensor:
        """lambda* of ``costs`` by its search kernel (its twin for CPU costs), 0-dim."""
        if self.mode == "ESSPS":
            return essps_lambda_fused(costs, self.param, self.lambda_min, self.lambda_max,
                                      self.iters)
        return lbps_lambda_fused(costs, self.param, self.lambda_min, self.lambda_max, self.iters)

    def plain(self, costs: torch.Tensor) -> torch.Tensor:
        """lambda* of ``costs`` by the search kernels' twin, a 0-dim tensor."""
        if self.mode == "ESSPS":
            return essps_lambda_plain(costs, self.param, self.lambda_min, self.lambda_max,
                                      self.iters)
        return lbps_lambda_plain(costs, self.param, self.lambda_min, self.lambda_max, self.iters)

    def run_batch(self, costs: torch.Tensor) -> torch.Tensor:
        """lambda* of each row of ``costs [B, K]`` in one launch (the twin for CPU costs), ``[B]``."""
        if self.mode == "ESSPS":
            return essps_lambda_fused_batch(costs, self.param, self.lambda_min, self.lambda_max,
                                            self.iters)
        return lbps_lambda_fused_batch(costs, self.param, self.lambda_min, self.lambda_max,
                                       self.iters)


def _check_costs(name: str, costs: torch.Tensor, iters: int) -> bool:
    """Validate costs ``[B, K]``; True where the kernel runs (a CUDA tensor)."""
    if costs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {costs.device}")
    if costs.dim() != 2 or not 1 <= costs.shape[1] <= MAX_SAMPLES or costs.shape[0] < 1:
        raise ValueError(
            f"{name} takes costs [B, K] with 1 <= K <= {MAX_SAMPLES}, got {tuple(costs.shape)}"
        )
    if costs.dtype != torch.float32:
        raise ValueError(f"costs has dtype {costs.dtype}, expected torch.float32")
    if not costs.is_contiguous():
        raise ValueError("costs must be contiguous")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    return costs.device.type == "cuda"


def _one_row(name: str, costs: torch.Tensor) -> torch.Tensor:
    """A single search's costs ``[K]`` as a batch of one's ``[1, K]``."""
    if costs.dim() != 1:
        raise ValueError(f"{name} takes costs [K], got {tuple(costs.shape)}")
    return costs[None]


@timing.counted_launches("essps_search_batch")
def essps_lambda_fused(
    costs: torch.Tensor, target_ess: float, lambda_min: float, lambda_max: float,
    iters: int = 40,
) -> torch.Tensor:
    """ESSPS ``lambda*`` of ``costs [K]`` float32, a 0-dim tensor on its device.

    :func:`essps_lambda_fused_batch` of a batch of one, which counts the
    launch here.
    """
    return essps_lambda_fused_batch(_one_row("essps_lambda_fused", costs), target_ess,
                                    lambda_min, lambda_max, iters)[0]



@timing.counted_launches("lbps_search_batch")
def lbps_lambda_fused(
    costs: torch.Tensor, delta: float, lambda_min: float, lambda_max: float, iters: int = 32,
) -> torch.Tensor:
    """LBPS ``lambda*`` of ``costs [K]`` float32, a 0-dim tensor on its device.

    :func:`lbps_lambda_fused_batch` of a batch of one, which counts the
    launch here.
    """
    return lbps_lambda_fused_batch(_one_row("lbps_lambda_fused", costs), delta, lambda_min,
                                   lambda_max, iters)[0]



_SEARCH_BATCH_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 3
    + [ctypes.c_int, ctypes.c_void_p]
)


def _launch_batch(symbol: str, costs: torch.Tensor, lambda_min, lambda_max, param, iters: int):
    batch, num_samples = costs.shape
    out = torch.empty(batch, dtype=torch.float32, device=costs.device)
    cuda_build.launch("lambda_search", symbol, _SEARCH_BATCH_ARGTYPES, costs.device,
                      costs.data_ptr(), num_samples, batch, ctypes.c_float(lambda_min),
                      ctypes.c_float(lambda_max), ctypes.c_float(param), int(iters),
                      out.data_ptr())
    return out


def essps_lambda_fused_batch(
    costs: torch.Tensor, target_ess: float, lambda_min: float, lambda_max: float,
    iters: int = 40,
) -> torch.Tensor:
    """ESSPS ``lambda*`` of each row of ``costs [B, K]``, ``[B]``: one cluster a scenario.

    Counts in ``essps_lambda_fused.launches``.  CPU costs take
    :func:`essps_lambda_plain` row by row.
    """
    if not _check_costs("essps_lambda_fused", costs, iters):
        return torch.stack([essps_lambda_plain(c, target_ess, lambda_min, lambda_max, iters)
                            for c in costs])
    lam = _launch_batch("essps_search_batch", costs, lambda_min, lambda_max, target_ess, iters)
    return lam


def lbps_lambda_fused_batch(
    costs: torch.Tensor, delta: float, lambda_min: float, lambda_max: float, iters: int = 32,
) -> torch.Tensor:
    """LBPS ``lambda*`` of each row of ``costs [B, K]``, ``[B]``: one cluster a scenario.

    Counts in ``lbps_lambda_fused.launches``.  CPU costs take
    :func:`lbps_lambda_plain` row by row.
    """
    if not _check_costs("lbps_lambda_fused", costs, iters):
        return torch.stack([lbps_lambda_plain(c, delta, lambda_min, lambda_max, iters)
                            for c in costs])
    lam = _launch_batch("lbps_search_batch", costs, lambda_min, lambda_max,
                        (1.0 - delta) / delta, iters)
    return lam
