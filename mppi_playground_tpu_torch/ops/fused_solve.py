"""Fused racing MPPI solve, its auto-lambda phases, seed regeneration and the re-roll.

Counterpart of ``mppi_playground_tpu/ops/fused_solve.py`` for the racing
model.  Five kernels, written by hand for Hopper in ``csrc/``:

* :func:`fused_racing_solve` (``csrc/fused_solve.cu``) — per sample: the
  perturbed, clamped warm start, T bicycle steps with the MPCC stage and
  terminal cost and two occupancy reads per point; per block of 256
  samples the softmin partials.  ``ops/weighted_update.combine_partials``
  merges the blocks.
* :func:`fused_racing_costs_dump` (same source) — auto-lambda phase 1: the
  same rollout and costs, and the clamped perturbations dumped as
  ``[2T, K]`` (slot-major, sample fastest); no partials.
* :func:`racing_weighted` (same source) — auto-lambda phase 2: the block
  partials of the fixed solve, from the costs and the dump at a lambda
  searched in between, without a rollout.  Its partials and the fixed
  solve's come from one device function, and here from one twin
  (:func:`block_partials_plain`, in ``ops/weighted_update.py``).
* :func:`racing_regen` (same source) — the clamped perturbations of chosen
  sample indices, replayed from a solve's seed and warm start (or its
  injected noise): the rows ``get_top_samples`` re-rolls on the fused route.
* :func:`racing_reroll` (``csrc/reroll.cu``) — the nominal re-roll.

Each wrapper launches its kernel for CUDA tensors, counts the launch in its
``launches`` attribute, and raises on what the kernel does not take.  For
CPU tensors it runs the plain PyTorch twin beside it (``*_plain``), which
does the kernel's arithmetic operation for operation.  The twins also run
on CUDA tensors when called directly, which is how the kernels are held
against them on the card.

Noise: with ``noise=`` ([K, T, 2], already scaled by sigma, the seam the
JAX solvers take) both sides consume the same numbers.  Without it, both
draw from Philox4x32-10 keyed on (seed, global sample index), counter
(pair index // 2, 0, 0, 0), and Box–Muller on 24 bits of each word: the
draws do not depend on the launch geometry.  The TPU's hardware bits cannot
be replayed, so the seeded stream is checked by its statistics.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from mppi_playground_tpu_torch.models.bicycle import make_dynamics_soa
from mppi_playground_tpu_torch.models.racing_mpcc import make_mpcc_cost_soa
from mppi_playground_tpu_torch.ops import cuda_build
from mppi_playground_tpu_torch.ops.weighted_update import BLOCK, block_partials_plain
from mppi_playground_tpu_torch.utils.fastmath import sincos_2pi

MAX_SLOTS = 1024  # the port's envelope: horizon * dim_control

_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


@dataclasses.dataclass(frozen=True)
class RacingFusedTask:
    """The racing model's data for the fused kernel.

    Attributes:
        obstacle_grid / lane_grid: ``[W, H]`` uint8 occupancy (1 = blocked)
            on the solver's device, one raster.
        origin: cell coordinates of the world origin, two floats.
        cell_size: meters per cell.
        x_lim / y_lim: position clamp of the bicycle dynamics.
    """

    obstacle_grid: torch.Tensor
    lane_grid: torch.Tensor
    origin: Tuple[float, float]
    cell_size: float
    x_lim: Tuple[float, float]
    y_lim: Tuple[float, float]


# ---------------------------------------------------------------------------
# Philox4x32-10 and Box–Muller in int64 tensor arithmetic (the kernel's twin)
# ---------------------------------------------------------------------------

def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``a * m`` for ``a, m < 2^32``, no overflow.

    The product is taken in 16-bit halves of ``m`` so that every partial
    stays below 2^49 in int64; all values are non-negative, so the right
    shifts are logical.
    """
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(ctr: Sequence[torch.Tensor], key0, key1):
    """Philox4x32-10 on int64 tensors holding 32-bit words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key0, key1
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def normal_pair_from_bits(b1: torch.Tensor, b2: torch.Tensor):
    """Two standard normals per Box–Muller transform on 24 bits each."""
    u1 = (b1 & 0xFFFFFF).to(torch.float32) * (2.0**-24) + (2.0**-25)
    u2 = (b2 & 0xFFFFFF).to(torch.float32) * (2.0**-24)
    r = torch.sqrt(-2.0 * torch.log(u1))
    sin_t, cos_t = sincos_2pi(2.0 * math.pi * u2)
    return r * cos_t, r * sin_t


def seeded_normals(seed: int, num_samples: int, horizon: int, device) -> torch.Tensor:
    """``[K, T, 2]`` standard normals of the kernel's seeded stream."""
    quads = (horizon + 1) // 2
    k = torch.arange(num_samples, dtype=torch.int64, device=device)[:, None]
    q = torch.arange(quads, dtype=torch.int64, device=device)[None, :].expand(num_samples, quads)
    zero = torch.zeros_like(q)
    w0, w1, w2, w3 = philox4x32_10((q, zero, zero, zero), int(seed) & _MASK32, k)
    a0, a1 = normal_pair_from_bits(w0, w1)
    b0, b1 = normal_pair_from_bits(w2, w3)
    z = torch.stack([a0, a1, b0, b1], dim=-1).reshape(num_samples, 4 * quads)
    return z[:, : 2 * horizon].reshape(num_samples, horizon, 2)


# ---------------------------------------------------------------------------
# Kernel 1: fused racing solve
# ---------------------------------------------------------------------------

def _perturbations(prev, noise, seed, num_samples, threshold, sigmas, u_min, u_max):
    """Clamped perturbed action sequences ``[K, T, 2]``."""
    horizon = prev.shape[0]
    dev = prev.device
    if noise is None:
        sig = torch.tensor(sigmas, dtype=torch.float32, device=dev)
        noise = seeded_normals(seed, num_samples, horizon, dev) * sig
    inherit = (torch.arange(num_samples, device=dev) < threshold)[:, None, None]
    v = torch.where(inherit, prev[None] + noise, noise)
    lo = torch.tensor(u_min, dtype=torch.float32, device=dev)
    hi = torch.tensor(u_max, dtype=torch.float32, device=dev)
    return torch.clamp(v, lo, hi)


def _rollout_costs_plain(x0, pert, xref, task: RacingFusedTask):
    """Costs ``[K]`` of the clamped perturbations ``[K, T, 2]``: rollout, stage, terminal."""
    num_samples, horizon = pert.shape[0], pert.shape[1]
    dynamics = make_dynamics_soa(x_lim=task.x_lim, y_lim=task.y_lim)
    stage_cost = make_mpcc_cost_soa()
    maps = (task.obstacle_grid, task.lane_grid, task.origin, task.cell_size)

    xs = tuple(x0[c].expand(num_samples) for c in range(4))
    acc = torch.zeros(num_samples, dtype=torch.float32, device=x0.device)
    for t in range(horizon):
        us = (pert[:, t, 0], pert[:, t, 1])
        prev_us = (pert[:, max(t - 1, 0), 0], pert[:, max(t - 1, 0), 1])
        acc = acc + stage_cost(xs, us, dict(t=t, prev_us=prev_us, xref=xref, maps=maps))
        xs = dynamics(xs, us)
    zeros = torch.zeros_like(acc)
    prev_us = (pert[:, max(horizon - 2, 0), 0], pert[:, max(horizon - 2, 0), 1])
    return acc + stage_cost(
        xs, (zeros, zeros), dict(t=horizon - 1, prev_us=prev_us, xref=xref, maps=maps)
    )


def fused_racing_solve_plain(
    x0, prev, lam, seed, xref, task: RacingFusedTask, sigmas, u_min, u_max,
    num_samples: int, threshold: int, noise: Optional[torch.Tensor] = None,
):
    """The fused kernel's plain twin: ``(costs [K], stats [B, 3], numer [B, 2T])``."""
    pert = _perturbations(prev, noise, seed, num_samples, threshold, sigmas, u_min, u_max)
    costs = _rollout_costs_plain(x0, pert, xref, task)
    stats, numer = block_partials_plain(costs, pert.reshape(num_samples, -1), lam)
    return costs, stats, numer


def fused_racing_costs_dump_plain(
    x0, prev, seed, xref, task: RacingFusedTask, sigmas, u_min, u_max,
    num_samples: int, threshold: int, noise: Optional[torch.Tensor] = None,
):
    """The phase-1 kernel's plain twin: ``(costs [K], dump [2T, K])``."""
    pert = _perturbations(prev, noise, seed, num_samples, threshold, sigmas, u_min, u_max)
    costs = _rollout_costs_plain(x0, pert, xref, task)
    return costs, pert.reshape(num_samples, -1).t().contiguous()


def racing_weighted_plain(costs, dump, lam):
    """The phase-2 kernel's plain twin: ``(stats [B, 3], numer [B, 2T])``."""
    return block_partials_plain(costs, dump.t(), lam)


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _f(v) -> ctypes.c_float:
    return ctypes.c_float(float(v))


_SOLVE_ARGTYPES = (
    [ctypes.c_void_p] * 7
    + [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_float] * 13
    + [ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 4
)


def _racing_args(x0, prev, lam, seed, xref, task, sigmas, u_min, u_max, num_samples,
                 threshold, noise):
    """Check the racing kernels' inputs on the card -> ``(args, noise)``.

    ``args`` are the leading arguments the two rollout entry points of
    ``csrc/fused_solve.cu`` share (``lam`` None: a null pointer, for phase 1,
    which reads none); ``noise`` is transposed to the kernels' ``[2T, K]``
    layout (kept alive by the caller until the launch).
    """
    dev = x0.device
    horizon = prev.shape[0]
    if not 1 <= horizon or 2 * horizon > MAX_SLOTS:
        raise ValueError(f"fused racing kernel needs 1 <= 2 * horizon <= {MAX_SLOTS}")
    if num_samples < 1 or num_samples >= 2**31 - BLOCK:
        raise ValueError(f"num_samples out of range: {num_samples}")
    f32 = torch.float32
    _check("x0", x0, (4,), f32, dev)
    _check("prev", prev, (horizon, 2), f32, dev)
    if lam is not None:
        _check("lam", lam, tuple(lam.shape), f32, dev)
        if lam.numel() != 1:
            raise ValueError("lam must hold one element")
    _check("xref", xref, (horizon + 1, 5), f32, dev)
    grid_shape = tuple(task.obstacle_grid.shape)
    if len(grid_shape) != 2:
        raise ValueError("the occupancy grids must be 2-D")
    _check("obstacle_grid", task.obstacle_grid, grid_shape, torch.uint8, dev)
    _check("lane_grid", task.lane_grid, grid_shape, torch.uint8, dev)
    noise_ptr = None
    if noise is not None:
        _check("noise", noise, (num_samples, horizon, 2), f32, dev)
        noise = noise.reshape(num_samples, 2 * horizon).t().contiguous()
        noise_ptr = noise.data_ptr()
    args = (
        x0.data_ptr(), prev.data_ptr(), None if lam is None else lam.data_ptr(),
        xref.data_ptr(),
        task.obstacle_grid.data_ptr(), task.lane_grid.data_ptr(), noise_ptr,
        grid_shape[0], grid_shape[1],
        _f(task.origin[0]), _f(task.origin[1]), _f(task.cell_size),
        _f(task.x_lim[0]), _f(task.x_lim[1]), _f(task.y_lim[0]), _f(task.y_lim[1]),
        _f(sigmas[0]), _f(sigmas[1]), _f(u_min[0]), _f(u_min[1]),
        _f(u_max[0]), _f(u_max[1]),
        int(seed) & _MASK32, horizon, num_samples, max(0, min(threshold, num_samples)),
    )
    return args, noise


def _on_card(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other device."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return t.device.type == "cuda"


def fused_racing_solve(
    x0: torch.Tensor,
    prev: torch.Tensor,
    lam: torch.Tensor,
    seed: int,
    xref: torch.Tensor,
    task: RacingFusedTask,
    sigmas: Tuple[float, float],
    u_min: Tuple[float, float],
    u_max: Tuple[float, float],
    num_samples: int,
    threshold: int,
    noise: Optional[torch.Tensor] = None,
):
    """One fused racing solve -> ``(costs [K], stats [B, 3], numer [B, 2T])``.

    ``x0 [4]``, ``prev [T, 2]``, ``lam`` (one element), ``xref [T+1, 5]``
    rows ``(x, y, sin, cos, v)``, all float32 on one device; ``seed`` a host
    integer; ``noise`` optional ``[K, T, 2]`` already scaled by sigma.
    ``B = ceil(K / 256)``.  CPU tensors take :func:`fused_racing_solve_plain`.
    """
    if not _on_card("fused_racing_solve", x0):
        return fused_racing_solve_plain(
            x0, prev, lam, seed, xref, task, sigmas, u_min, u_max,
            num_samples, threshold, noise,
        )
    args, noise = _racing_args(x0, prev, lam, seed, xref, task, sigmas, u_min, u_max,
                               num_samples, threshold, noise)
    horizon, dev = prev.shape[0], x0.device
    blocks = -(-num_samples // BLOCK)
    costs = torch.empty(num_samples, dtype=torch.float32, device=dev)
    stats = torch.empty(blocks, 3, dtype=torch.float32, device=dev)
    numer = torch.empty(blocks, 2 * horizon, dtype=torch.float32, device=dev)
    cuda_build.launch("fused_solve", "racing_fused_solve", _SOLVE_ARGTYPES, dev, *args,
                      costs.data_ptr(), stats.data_ptr(), numer.data_ptr())
    fused_racing_solve.launches += 1
    return costs, stats, numer


fused_racing_solve.launches = 0

_DUMP_ARGTYPES = _SOLVE_ARGTYPES[:-4] + [ctypes.c_void_p] * 3


def fused_racing_costs_dump(
    x0: torch.Tensor,
    prev: torch.Tensor,
    seed: int,
    xref: torch.Tensor,
    task: RacingFusedTask,
    sigmas: Tuple[float, float],
    u_min: Tuple[float, float],
    u_max: Tuple[float, float],
    num_samples: int,
    threshold: int,
    noise: Optional[torch.Tensor] = None,
):
    """Auto-lambda phase 1 -> ``(costs [K], dump [2T, K])``.

    The rollout and costs of :func:`fused_racing_solve` (same arguments,
    no lambda), and each sample's clamped perturbations, slot-major.  CPU
    tensors take :func:`fused_racing_costs_dump_plain`.
    """
    if not _on_card("fused_racing_costs_dump", x0):
        return fused_racing_costs_dump_plain(
            x0, prev, seed, xref, task, sigmas, u_min, u_max, num_samples, threshold, noise,
        )
    dev = x0.device
    args, noise = _racing_args(x0, prev, None, seed, xref, task, sigmas, u_min, u_max,
                               num_samples, threshold, noise)
    costs = torch.empty(num_samples, dtype=torch.float32, device=dev)
    dump = torch.empty(2 * prev.shape[0], num_samples, dtype=torch.float32, device=dev)
    cuda_build.launch("fused_solve", "racing_costs_dump", _DUMP_ARGTYPES, dev, *args,
                      costs.data_ptr(), dump.data_ptr())
    fused_racing_costs_dump.launches += 1
    return costs, dump


fused_racing_costs_dump.launches = 0

_WEIGHTED_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3


def racing_weighted(costs: torch.Tensor, dump: torch.Tensor, lam: torch.Tensor):
    """Auto-lambda phase 2 -> ``(stats [B, 3], numer [B, 2T])`` at ``lam``.

    ``costs [K]`` and ``dump [2T, K]`` from :func:`fused_racing_costs_dump`,
    ``lam`` one element on the same device (read by the kernel, never by the
    host).  The same partials :func:`fused_racing_solve` gives at ``lam``.
    CPU tensors take :func:`racing_weighted_plain`.
    """
    if not _on_card("racing_weighted", costs):
        return racing_weighted_plain(costs, dump, lam)
    dev = costs.device
    num_samples = costs.shape[0]
    slots = dump.shape[0]
    if slots % 2 or not 2 <= slots <= MAX_SLOTS:
        raise ValueError(f"dump must be [2T, K] with 2 <= 2T <= {MAX_SLOTS}")
    if not 1 <= num_samples < 2**31 - BLOCK:
        raise ValueError(f"num_samples out of range: {num_samples}")
    f32 = torch.float32
    _check("costs", costs, (num_samples,), f32, dev)
    _check("dump", dump, (slots, num_samples), f32, dev)
    _check("lam", lam, tuple(lam.shape), f32, dev)
    if lam.numel() != 1:
        raise ValueError("lam must hold one element")
    blocks = -(-num_samples // BLOCK)
    stats = torch.empty(blocks, 3, dtype=f32, device=dev)
    numer = torch.empty(blocks, slots, dtype=f32, device=dev)
    cuda_build.launch("fused_solve", "racing_weighted", _WEIGHTED_ARGTYPES, dev,
                      costs.data_ptr(), dump.data_ptr(), lam.data_ptr(), slots // 2,
                      num_samples, stats.data_ptr(), numer.data_ptr())
    racing_weighted.launches += 1
    return stats, numer


racing_weighted.launches = 0


def racing_regen_plain(prev, seed, rows, sigmas, u_min, u_max, num_samples: int,
                       threshold: int, noise: Optional[torch.Tensor] = None):
    """The regeneration kernel's plain twin: all K perturbations, gathered at ``rows``."""
    pert = _perturbations(prev, noise, seed, num_samples, threshold, sigmas, u_min, u_max)
    return pert[rows]


_REGEN_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_float] * 6
    + [ctypes.c_uint32] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
)


def racing_regen(
    prev: torch.Tensor,
    seed: int,
    rows: torch.Tensor,
    sigmas: Tuple[float, float],
    u_min: Tuple[float, float],
    u_max: Tuple[float, float],
    num_samples: int,
    threshold: int,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Replay a solve's clamped perturbations at ``rows`` -> ``[n, T, 2]``.

    ``prev [T, 2]`` is the warm start the solve sampled around and ``seed``
    its host kernel seed; ``noise`` the ``[K, T, 2]`` noise it was given,
    if any.  ``rows [n]`` (int64, each in ``[0, K)``) picks the samples;
    row ``i`` of the result is sample ``rows[i]``'s perturbation, bit for
    bit the one the solve drew (and phase 1 dumped).  CPU tensors take
    :func:`racing_regen_plain`.
    """
    if not _on_card("racing_regen", prev):
        return racing_regen_plain(prev, seed, rows, sigmas, u_min, u_max, num_samples,
                                  threshold, noise)
    dev = prev.device
    horizon = prev.shape[0]
    if not 1 <= horizon or 2 * horizon > MAX_SLOTS:
        raise ValueError(f"racing_regen needs 1 <= 2 * horizon <= {MAX_SLOTS}")
    if not 1 <= num_samples < 2**31 - BLOCK:
        raise ValueError(f"num_samples out of range: {num_samples}")
    _check("prev", prev, (horizon, 2), torch.float32, dev)
    num_rows = rows.shape[0]
    _check("rows", rows, (num_rows,), torch.int64, dev)
    out = torch.empty(num_rows, horizon, 2, dtype=torch.float32, device=dev)
    if num_rows == 0:
        return out
    noise_ptr = None
    if noise is not None:
        _check("noise", noise, (num_samples, horizon, 2), torch.float32, dev)
        noise = noise.reshape(num_samples, 2 * horizon).t().contiguous()  # [2T, K]
        noise_ptr = noise.data_ptr()
    cuda_build.launch(
        "fused_solve", "racing_regen", _REGEN_ARGTYPES, dev, prev.data_ptr(), noise_ptr,
        rows.data_ptr(), _f(sigmas[0]), _f(sigmas[1]), _f(u_min[0]), _f(u_min[1]),
        _f(u_max[0]), _f(u_max[1]), int(seed) & _MASK32, horizon, num_samples,
        max(0, min(threshold, num_samples)), num_rows, out.data_ptr(),
    )
    racing_regen.launches += 1
    return out


racing_regen.launches = 0


# ---------------------------------------------------------------------------
# Kernel 2: nominal re-roll
# ---------------------------------------------------------------------------

def racing_reroll_plain(x0, action_seq, x_lim, y_lim):
    """The re-roll kernel's plain twin: ``[T+1, 4]``."""
    dynamics = make_dynamics_soa(x_lim=x_lim, y_lim=y_lim)
    xs = tuple(x0[c] for c in range(4))
    rows = [torch.stack(xs)]
    for t in range(action_seq.shape[0]):
        xs = dynamics(xs, (action_seq[t, 0], action_seq[t, 1]))
        rows.append(torch.stack(xs))
    return torch.stack(rows)


_REROLL_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_float] * 4
    + [ctypes.c_void_p, ctypes.c_void_p]
)


def racing_reroll(
    x0: torch.Tensor,
    action_seq: torch.Tensor,
    x_lim: Tuple[float, float],
    y_lim: Tuple[float, float],
) -> torch.Tensor:
    """``(x0 [4], action_seq [T, 2]) -> state_seq [T+1, 4]`` of the bicycle."""
    if not _on_card("racing_reroll", x0):
        return racing_reroll_plain(x0, action_seq, x_lim, y_lim)
    dev = x0.device
    horizon = action_seq.shape[0]
    _check("x0", x0, (4,), torch.float32, dev)
    _check("action_seq", action_seq, (horizon, 2), torch.float32, dev)
    out = torch.empty(horizon + 1, 4, dtype=torch.float32, device=dev)
    cuda_build.launch("reroll", "racing_reroll", _REROLL_ARGTYPES, dev, x0.data_ptr(),
                      action_seq.data_ptr(), horizon, _f(x_lim[0]), _f(x_lim[1]),
                      _f(y_lim[0]), _f(y_lim[1]), out.data_ptr())
    racing_reroll.launches += 1
    return out


racing_reroll.launches = 0
