"""The fused MPPI kernels of every model: solve, auto-lambda phases, epilogue, regen, re-roll.

Counterpart of ``mppi_playground_tpu/ops/fused_solve.py``.  Every model
plugs into the same kernels, written by hand for Hopper in ``csrc/``, through
a :class:`FusedTask`; the kernels are templated on a model plug
(``csrc/fused_solve.cuh``) and each bundled model is one explicit
instantiation (``csrc/fused_<model>.cu``).  A user's own model is a
:class:`ModelPlug`: the CUDA C++ source of one plug struct, which
``ops/cuda_build.py`` builds into a unit of its own at first use
(:meth:`FusedTask.entry` names every kernel's library and symbol):

* :func:`fused_solve` (``<model>_fused_solve_batch``) — per sample: the perturbed,
  clamped warm start, T model steps with the stage and terminal cost; per
  block of 256 samples the softmin partials.
* :func:`fused_costs_dump` (``<model>_costs_dump_batch``) — auto-lambda phase 1:
  the same rollout and costs, and the clamped perturbations dumped as
  ``[T*m, K]`` (slot-major, sample fastest); no partials.
* :func:`fused_costs_dump_lambda` (``<model>_costs_dump_lambda_batch``) — phase 1
  with the ESSPS or LBPS search in the same launch: phase 1 runs as
  clusters of 8 blocks, and the cluster that finishes last searches the K
  costs with the search kernels' own body and writes lambda* to the device,
  bit for bit the search kernels' (``ops/lambda_search.py``) on the same
  costs.
* :func:`fused_weighted` (``fused_weighted_batch``, ``csrc/fused_solve.cu``) —
  auto-lambda phase 2: the block partials of the fixed solve, from the
  costs and the dump at a lambda searched in between, without a rollout.
* :func:`fused_top_rollouts` (``<model>_top_rollouts``, ``csrc/reroll.cu``)
  — the states ``[n, T+1, n_x]`` of chosen sample indices: their clamped
  perturbations replayed from a solve's seed and warm start (or its
  injected noise) and rolled out through the model, in one launch: the
  fused route's ``get_top_samples``.
* :func:`fused_regen` (``fused_regen_m1_batch`` / ``_m2_batch``) — the
  same kernel on its actions-only plug: the clamped perturbations alone.
* :func:`fused_tick_tail` (``<model>_tick_tail_batch``, ``csrc/reroll.cu``,
  ``csrc/tick_tail.cuh``) — the tick's tail in one launch after the fused
  solve or phase 2: the block partials merged into the update, the weights
  and the ESS (``ops/weighted_update.combine_partials``' function, summed in
  the kernel's order), the SG filter where the config has one, its history
  shifted, and the nominal re-roll.
* :func:`fused_reroll` (``<model>_reroll``, ``csrc/reroll.cu``) — the
  nominal re-roll alone.

A fleet of B scenarios launches each kernel of its tick once, the scenarios
on the grid's second axis (``blockIdx.y``): :func:`fused_solve_batch`,
:func:`fused_costs_dump_batch`, :func:`fused_costs_dump_lambda_batch`,
:func:`fused_weighted_batch`, :func:`fused_tick_tail_batch` and
:func:`fused_regen_batch` (the symbols above, each kernel's one C entry
point; the searches' in ``ops/lambda_search.py``, the weighted update's in
``ops/weighted_update.py``).  Every per-scenario array
gains a leading ``[B]`` axis; the bounds, the model's constants and grids,
the SG window and the regenerated rows are shared.  The λ epilogue takes a
ticket a scenario (int32 ``[B]``).  Scenario b's outputs are bit for bit the
single launch's on scenario b's inputs, and its draws are the single
solve's stream, keyed on (its seed word, k).  Their twins run the single
twins scenario by scenario.  :func:`fused_solve`, :func:`fused_costs_dump`,
:func:`fused_costs_dump_lambda`, :func:`fused_weighted`,
:func:`fused_tick_tail` and :func:`fused_regen` are these wrappers on a
batch of one.

A shard of a sample-sharded solve (``parallel/sharded.py``) passes the rollout
wrappers and phase 2 (rows 1, 3 and 5) its ``sample_offset``, the global index
of its first sample (a multiple of 256), and the solve's ``total_samples``;
``num_samples`` is then the shard's.  The local index addresses memory (the
costs, the dump, the injected noise, the block partials), the global one keys
the draws and decides inheritance (``< threshold``) and validity (``<
total_samples``).  A shard's samples past the solve cost 1e30 and dump zero
actions, and weigh 0 in its partials; so the shards' outputs concatenated and
sliced to the solve's K samples and ``ceil(K / 256)`` blocks are the whole
launch's.  The defaults (0 and ``num_samples``) are the whole launch.

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take.  The ``launches`` of the kernel's single-scenario
wrapper reads its eager launches under the kernel's name, whichever form
launched it: a view of ``utils/timing``'s registry, in which a launch a CUDA
graph captures counts once for every replay instead (``cuda_build.launched``).  For CPU tensors it runs the plain PyTorch twin beside it
(``*_plain``), which does the kernel's arithmetic operation for operation
through the task's own ``dynamics_soa`` and ``stage_cost_soa``.  The twins
also run on CUDA tensors when called directly, which is how the kernels are
held against them on the card.

Noise: with ``noise=`` ([K, T, m], already scaled by sigma, the seam the
JAX solvers take) both sides consume the same numbers.  Without it, action
slot ``f = t*m + j`` of sample k takes normal ``f mod 4`` of Philox4x32-10
keyed on (seed, k) with counter (f div 4, 0, 0, 0), and Box–Muller on 24
bits of each word: the draws do not depend on the launch geometry.  The
TPU's hardware bits cannot be replayed, so the seeded stream is checked by
its statistics.

The seed is a word in device memory that each CTA of a drawing kernel loads
once: a solver passes its key's seed word (``core/config.make_key``, a view
``key[2:]``), so that a CUDA graph of the tick replays a new stream at every
replay; a host integer is filled into a one-word tensor first.  The tail and the
regeneration kernel take the key and a ``key_out`` besides: CTA 0 writes the
next tick's key there.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import re
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from mppi_playground_tpu_torch.ops import cuda_build
from mppi_playground_tpu_torch.ops.lambda_search import LambdaSearch
from mppi_playground_tpu_torch.ops.weighted_update import BLOCK, block_partials_plain
from mppi_playground_tpu_torch.utils import timing
from mppi_playground_tpu_torch.utils.fastmath import sincos_2pi

MAX_SLOTS = 1024  # the port's envelope: horizon * dim_control
MAX_STATE = 128  # the port's envelope: dim_state, as the JAX package's
# The JAX package takes the lambda epilogue up to a 2 MiB padded cost block.
EPILOGUE_MAX_SAMPLES = 524_288

# model -> (dim_state, dim_control, floats of its per-tick reference row):
# the instantiations of csrc/fused_solve.cuh, one csrc/fused_<model>.cu each
MODELS = {
    "racing": (4, 2, 5),
    "navigation": (3, 2, 0),
    "danger_zone": (7, 2, 0),
    "pendulum": (2, 1, 0),
    "cartpole": (4, 1, 0),
    "mountain_car": (2, 1, 0),
    "integrator": (2, 2, 0),
}
REGEN_WIDTHS = (1, 2)  # fused_regen_m1, fused_regen_m2
# the kernels of the tail's library (csrc/reroll.cu for the bundled models)
TAIL_KERNELS = ("tick_tail_batch", "reroll", "top_rollouts")
_C_IDENTIFIER = re.compile(r"[A-Za-z_][A-Za-z0-9_]*\Z")
_CPP_NAME = re.compile(r"(::)?[A-Za-z_][A-Za-z0-9_]*(::[A-Za-z_][A-Za-z0-9_]*)*\Z")

_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


@dataclasses.dataclass(frozen=True)
class ModelPlug:
    """A user's model for the fused kernels: one CUDA C++ plug struct, built at first use.

    ``source`` defines the struct ``struct`` in the contract of
    ``csrc/fused_solve.cuh`` (``kN``, ``kM``, ``kRefWidth``, ``kPre``;
    ``Args`` and ``make_args(floats, ints, grid0, grid1)``; ``prepare`` and
    ``step_prepared``; ``stage_cost(x, u, pu, ref, args)``), as the bundled
    plugs of ``csrc/classic_models.cuh`` do; it may include the headers of
    ``csrc/`` (``device_math.cuh``'s ``devmath::clampf`` and the like).  The
    step runs with null grids in the tail and the re-roll, so only the cost
    may read them.  ``dim_state``, ``dim_control`` and ``reference_width``
    are the struct's ``kN``, ``kM`` and ``kRefWidth``: the unit checks them
    at compile time.  ``name`` (a C identifier, not a bundled model's) names
    the kernels (``<name>_fused_solve``, ...) and their launch counters.  On
    the card the first launch builds the unit with ``nvcc``
    (``ops/cuda_build.define_unit``, ``-fmad=false`` and no fast math, as
    every kernel), and a compile error raises with the compiler's output.
    The kernels keep the prepared terms of every step (``kPre * T`` floats)
    and the reference rows (``kRefWidth * (T + 1)``) in shared memory, 227
    KB a block on Hopper: each fits up to about 50,000 floats, and past that
    the launch raises.
    """

    name: str
    source: str
    struct: str
    dim_state: int
    dim_control: int
    reference_width: int = 0

    def __post_init__(self):
        if not isinstance(self.name, str) or not _C_IDENTIFIER.match(self.name):
            raise ValueError(f"a plug's name must be a C identifier, got {self.name!r}")
        if self.name in MODELS:
            raise ValueError(f"{self.name!r} is a bundled model's name; give the plug its own")
        if not isinstance(self.struct, str) or not _CPP_NAME.match(self.struct):
            raise ValueError(f"a plug's struct must be a C++ name, got {self.struct!r}")
        for field, low, high in (("dim_state", 1, MAX_STATE), ("dim_control", 1, MAX_SLOTS),
                                 ("reference_width", 0, None)):
            value = getattr(self, field)
            if (not isinstance(value, int) or value < low
                    or (high is not None and value > high)):
                raise ValueError(f"a plug's {field} must be an int in [{low}, "
                                 f"{'any' if high is None else high}], got {value!r}")

    @functools.cached_property
    def library(self) -> str:
        """The name of the plug's library (``ops/cuda_build.py``), its unit's digest in it."""
        digest = hashlib.sha256(self.unit.encode()).hexdigest()[:12]
        return f"plug_{self.name}_{digest}"

    @functools.cached_property
    def unit(self) -> str:
        """The generated CUDA unit: the kernels' headers, the plug, its entry points."""
        name, struct = self.name, self.struct
        return (
            f"// The fused kernels on the model plug {struct} ({name}), generated by\n"
            "// mppi_playground_tpu_torch/ops/fused_solve.py ModelPlug.unit.\n"
            '#include "fused_solve.cuh"\n#include "tail_entry_points.cuh"\n\n'
            f"{self.source}\n\n"
            f"static_assert({struct}::kN == {self.dim_state} && {struct}::kM == "
            f"{self.dim_control} && {struct}::kRefWidth == {self.reference_width},\n"
            f'              "the plug {name} declares kN={self.dim_state}, '
            f'kM={self.dim_control}, kRefWidth={self.reference_width}");\n'
            f"FUSED_MODEL_ENTRY_POINTS({name}, {struct})\n"
            f"TAIL_ENTRY_POINTS({name}, {struct})\n"
        )


@dataclasses.dataclass(frozen=True)
class FusedTask:
    """A model's plug for the fused kernels.

    Attributes:
        model: one of :data:`MODELS`, or a user's :class:`ModelPlug`; names
            the model's kernels.
        dynamics_soa: ``(xs, us) -> xs`` on tuples of same-shape tensors,
            the twins' step (the kernels' ``Model::step``).
        stage_cost_soa: ``(xs, us, ctx) -> cost``, the twins' stage cost;
            ``ctx`` carries ``t``, ``prev_us`` and ``xref``, the reference
            rows ``[T+1, W]`` of :attr:`reference` (None where it has none).
        floats / ints: the model's per-launch constants, in the order its
            header (``csrc/*_model.cuh``, or the plug's ``make_args``) reads
            them.
        grids: its ``[W, H]`` uint8 occupancy grids on the solver's device
            (racing: obstacle and lane; navigation: obstacle; at most two).
        reference: ``info -> [T+1, W]`` float32 per-tick rows (``[B, T+1,
            W]`` for a fleet's ``info``), row t read at step t, for a model
            with a reference width W > 0: the JAX package's ``smem_builder``.
    """

    model: Union[str, ModelPlug]
    dynamics_soa: Callable
    stage_cost_soa: Callable
    floats: Tuple[float, ...] = ()
    ints: Tuple[int, ...] = ()
    grids: Tuple[torch.Tensor, ...] = ()
    reference: Optional[Callable] = None

    def __post_init__(self):
        if isinstance(self.model, ModelPlug):
            cuda_build.define_unit(self.model.library, self.model.unit)
        elif self.model not in MODELS:
            raise ValueError(f"no fused kernels for model {self.model!r}; have {sorted(MODELS)} "
                             "or a ModelPlug")
        if len(self.grids) > 2:
            raise ValueError(f"the fused kernels take at most two grids, got {len(self.grids)}")
        if self.reference_width and self.reference is None:
            raise ValueError(f"the {self.name} model reads {self.reference_width} reference "
                             "floats a step: give the task its reference builder")

    @property
    def plug(self) -> Optional[ModelPlug]:
        """The user's :class:`ModelPlug`, or None for a bundled model."""
        return self.model if isinstance(self.model, ModelPlug) else None

    @property
    def name(self) -> str:
        """The model's name: its kernels' prefix and launch counters'."""
        return self.model.name if self.plug is not None else self.model

    @property
    def dim_state(self) -> int:
        return self.plug.dim_state if self.plug is not None else MODELS[self.model][0]

    @property
    def dim_control(self) -> int:
        return self.plug.dim_control if self.plug is not None else MODELS[self.model][1]

    @property
    def reference_width(self) -> int:
        """Floats of the per-tick reference row a solve reads (racing: 5), else 0."""
        return self.plug.reference_width if self.plug is not None else MODELS[self.model][2]

    def entry(self, kernel: str) -> Tuple[str, str]:
        """``(library, symbol)`` of the task's ``kernel`` (``"fused_solve_batch"``,
        ``"tick_tail_batch"``, ...): the bundled model's ``csrc/`` source, or the
        plug's generated unit (built at its first launch)."""
        if self.plug is not None:
            library = self.plug.library
        elif kernel in TAIL_KERNELS:
            library = "reroll"
        else:
            library = f"fused_{self.model}"
        return library, f"{self.name}_{kernel}"

    def reference_rows(self, info, batch: Optional[int], device) -> Optional[torch.Tensor]:
        """The kernels' reference rows of ``info``: ``[T+1, W]``, or ``[B, T+1, W]`` for
        ``batch`` (a single table broadcast to every scenario); None at width 0."""
        if not self.reference_width:
            return None
        rows = torch.as_tensor(self.reference(info), dtype=torch.float32, device=device)
        if batch is not None and rows.dim() == 2:
            rows = rows.expand(batch, *rows.shape)
        return rows.contiguous()


def RacingFusedTask(obstacle_grid, lane_grid, origin, cell_size, x_lim, y_lim) -> FusedTask:
    """The racing model's :class:`FusedTask`: two uint8 grids on one raster and the bounds.

    ``origin`` is the cell coordinates of the world origin (two floats),
    ``cell_size`` meters per cell, ``x_lim``/``y_lim`` the position clamp
    of the bicycle dynamics.
    """
    from mppi_playground_tpu_torch.models.bicycle import make_dynamics_soa
    from mppi_playground_tpu_torch.models.racing_mpcc import make_mpcc_cost_soa, racing_reference

    origin = (float(origin[0]), float(origin[1]))
    x_lim = (float(x_lim[0]), float(x_lim[1]))
    y_lim = (float(y_lim[0]), float(y_lim[1]))
    maps = (obstacle_grid, lane_grid, origin, float(cell_size))
    mpcc = make_mpcc_cost_soa()

    def stage_cost_soa(xs, us, ctx):
        return mpcc(xs, us, dict(ctx, maps=maps))

    return FusedTask(
        model="racing",
        dynamics_soa=make_dynamics_soa(x_lim=x_lim, y_lim=y_lim),
        stage_cost_soa=stage_cost_soa,
        floats=(*x_lim, *y_lim, *origin, float(cell_size)),
        ints=tuple(int(v) for v in obstacle_grid.shape),
        grids=(obstacle_grid, lane_grid),
        reference=racing_reference,
    )


# ---------------------------------------------------------------------------
# Philox4x32-10 and Box–Muller in int64 tensor arithmetic (the kernels' twin)
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


def seed_word(seed):
    """The seed as Philox's first key word: a host int, or an int64 0-dim tensor of a seed tensor."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).to(torch.int64) & _MASK32
    return int(seed) & _MASK32


def seeded_normals(seed, num_samples: int, horizon: int, device,
                   dim_control: int = 2, sample_offset: int = 0) -> torch.Tensor:
    """``[K, T, m]`` standard normals of the kernels' seeded stream.

    Slot ``f = t*m + j`` of sample k is normal ``f mod 4`` of the Philox
    block with counter ``f div 4`` and key ``(seed, k)``; for m=2 an even
    step takes words (x, y), an odd one (z, w).  ``seed`` is a host int or
    a one-element int32 tensor (a key's seed word), read on the device.  Row
    i is sample ``sample_offset + i``: a shard draws its rows of the stream.
    """
    slots = horizon * dim_control
    quads = -(-slots // 4)
    k = torch.arange(sample_offset, sample_offset + num_samples, dtype=torch.int64,
                     device=device)[:, None]
    q = torch.arange(quads, dtype=torch.int64, device=device)[None, :].expand(num_samples, quads)
    zero = torch.zeros_like(q)
    w0, w1, w2, w3 = philox4x32_10((q, zero, zero, zero), seed_word(seed), k)
    a0, a1 = normal_pair_from_bits(w0, w1)
    b0, b1 = normal_pair_from_bits(w2, w3)
    z = torch.stack([a0, a1, b0, b1], dim=-1).reshape(num_samples, 4 * quads)
    return z[:, :slots].reshape(num_samples, horizon, dim_control)


# ---------------------------------------------------------------------------
# The plain twins
# ---------------------------------------------------------------------------

def _perturbations(prev, noise, seed, num_samples, threshold, sigmas, u_min, u_max,
                   sample_offset: int = 0):
    """Clamped perturbed action sequences ``[K, T, m]`` of samples ``sample_offset + k``."""
    horizon, dim_control = prev.shape
    dev = prev.device
    if noise is None:
        sig = torch.tensor(sigmas, dtype=torch.float32, device=dev)
        noise = seeded_normals(seed, num_samples, horizon, dev, dim_control, sample_offset) * sig
    inherit = (torch.arange(sample_offset, sample_offset + num_samples, device=dev)
               < threshold)[:, None, None]
    v = torch.where(inherit, prev[None] + noise, noise)
    lo = torch.tensor(u_min, dtype=torch.float32, device=dev)
    hi = torch.tensor(u_max, dtype=torch.float32, device=dev)
    return torch.clamp(v, lo, hi)


def _rollout_costs_plain(x0, pert, ref, task: FusedTask):
    """Costs ``[K]`` of the clamped perturbations ``[K, T, m]``: rollout, stage, terminal."""
    num_samples, horizon, m = pert.shape

    def actions(t):
        return tuple(pert[:, t, j] for j in range(m))

    xs = tuple(x0[c].expand(num_samples) for c in range(task.dim_state))
    acc = torch.zeros(num_samples, dtype=torch.float32, device=x0.device)
    for t in range(horizon):
        ctx = dict(t=t, prev_us=actions(max(t - 1, 0)), xref=ref)
        acc = acc + task.stage_cost_soa(xs, actions(t), ctx)
        xs = task.dynamics_soa(xs, actions(t))
    # terminal cost: zero action; t and prev_action keep their last values
    zeros = tuple(torch.zeros_like(acc) for _ in range(m))
    ctx = dict(t=horizon - 1, prev_us=actions(max(horizon - 2, 0)), xref=ref)
    return acc + task.stage_cost_soa(xs, zeros, ctx)


def _absent(num_samples: int, sample_offset: int, total_samples: Optional[int], device):
    """``[K]`` bool: a shard's samples past the solve's ``total_samples`` (None: none are)."""
    if total_samples is None:
        return None
    return torch.arange(sample_offset, sample_offset + num_samples, device=device) >= total_samples


def _pad_absent(costs, pert, absent):
    """``(costs, pert [K, D])`` with the absent samples at cost 1e30 and zero actions."""
    if absent is None:
        return costs, pert
    return (torch.where(absent, costs.new_full((), 1e30), costs),
            torch.where(absent[:, None], pert.new_zeros(()), pert))


def fused_solve_plain(
    x0, prev, lam, seed, ref, task: FusedTask, sigmas, u_min, u_max,
    num_samples: int, threshold: int, noise: Optional[torch.Tensor] = None,
    sample_offset: int = 0, total_samples: Optional[int] = None,
):
    """The fused kernel's plain twin: ``(costs [K], stats [B, 3], numer [B, T*m])``.

    On a shard, the samples from ``sample_offset`` of a solve of
    ``total_samples``; those past it cost 1e30 and weigh 0.
    """
    pert = _perturbations(prev, noise, seed, num_samples, threshold, sigmas, u_min, u_max,
                          sample_offset)
    costs = _rollout_costs_plain(x0, pert, ref, task)
    costs, flat = _pad_absent(costs, pert.reshape(num_samples, -1),
                              _absent(num_samples, sample_offset, total_samples, x0.device))
    stats, numer = block_partials_plain(costs, flat, lam)
    return costs, stats, numer


def fused_costs_dump_plain(
    x0, prev, seed, ref, task: FusedTask, sigmas, u_min, u_max,
    num_samples: int, threshold: int, noise: Optional[torch.Tensor] = None,
    sample_offset: int = 0, total_samples: Optional[int] = None,
):
    """The phase-1 kernel's plain twin: ``(costs [K], dump [T*m, K])``.

    On a shard, the samples past the solve cost 1e30 and dump zeros.
    """
    pert = _perturbations(prev, noise, seed, num_samples, threshold, sigmas, u_min, u_max,
                          sample_offset)
    costs = _rollout_costs_plain(x0, pert, ref, task)
    costs, flat = _pad_absent(costs, pert.reshape(num_samples, -1),
                              _absent(num_samples, sample_offset, total_samples, x0.device))
    return costs, flat.t().contiguous()


def fused_costs_dump_lambda_plain(
    x0, prev, seed, ref, task: FusedTask, sigmas, u_min, u_max,
    num_samples: int, threshold: int, noise: Optional[torch.Tensor], search: LambdaSearch,
):
    """The epilogue kernel's plain twin: ``(costs [K], dump [T*m, K], lam [1])``.

    Phase 1's twin, then the search kernels' twin on its costs.
    """
    costs, dump = fused_costs_dump_plain(x0, prev, seed, ref, task, sigmas, u_min, u_max,
                                         num_samples, threshold, noise)
    return costs, dump, search.plain(costs).reshape(1)


def fused_weighted_plain(costs, dump, lam, sample_offset: int = 0,
                         total_samples: Optional[int] = None):
    """The phase-2 kernel's plain twin: ``(stats [B, 3], numer [B, T*m])``.

    On a shard, the samples past the solve's ``total_samples`` weigh 0.
    """
    costs, flat = _pad_absent(costs, dump.t(),
                              _absent(costs.shape[0], sample_offset, total_samples, costs.device))
    return block_partials_plain(costs, flat, lam)


def _nan_rows(values: torch.Tensor, rows: torch.Tensor, num_samples: int) -> torch.Tensor:
    """``values`` with row i all NaN where ``rows[i]`` is outside ``[0, K)``, as in the kernel."""
    valid = ((rows >= 0) & (rows < num_samples)).reshape(-1, *([1] * (values.dim() - 1)))
    return torch.where(valid, values, torch.full_like(values, float("nan")))


def fused_regen_plain(prev, seed, rows, sigmas, u_min, u_max, num_samples: int,
                      threshold: int, noise: Optional[torch.Tensor] = None):
    """The regeneration kernel's plain twin: all K perturbations, gathered at ``rows``."""
    pert = _perturbations(prev, noise, seed, num_samples, threshold, sigmas, u_min, u_max)
    return _nan_rows(pert[rows.clamp(0, num_samples - 1)], rows, num_samples)


def fused_top_rollouts_plain(x0, prev, seed, rows, task: FusedTask, sigmas, u_min, u_max,
                             num_samples: int, threshold: int,
                             noise: Optional[torch.Tensor] = None):
    """The top rows' kernel's plain twin: :func:`fused_regen_plain`, then a batched SoA re-roll.

    ``[n, T+1, n_x]``: the rows' perturbations rolled from ``x0`` through
    the task's ``dynamics_soa``, what :func:`fused_reroll_plain` does for one
    sequence.  A row outside ``[0, K)`` is all NaN.
    """
    pert = fused_regen_plain(prev, seed, rows, sigmas, u_min, u_max, num_samples, threshold,
                             noise)
    return _nan_rows(rolled_out_plain(x0, pert, task), rows, num_samples)


def rolled_out_plain(x0, pert, task: FusedTask):
    """States ``[n, T+1, n_x]`` of perturbations ``pert [n, T, m]`` rolled from ``x0`` through
    the task's ``dynamics_soa``."""
    xs = tuple(x0[c].expand(pert.shape[0]) for c in range(task.dim_state))
    states = [torch.stack(xs, dim=-1)]
    for t in range(pert.shape[1]):
        xs = task.dynamics_soa(xs, tuple(pert[:, t, j] for j in range(task.dim_control)))
        states.append(torch.stack(xs, dim=-1))
    return torch.stack(states, dim=1)


TAIL_BLOCK = 1024  # threads of the tail kernel's CTAs (csrc/tick_tail.cuh kTailBlock)


def _tail_thread_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of ``v [B]`` in the tail kernel's order, a 0-dim tensor.

    Thread t adds ``v[t], v[t + 1024], ...`` in turn from 0; each warp folds
    its 32 lanes by halves (lane 0's result of the shuffle-down tree), and
    the 32 warp sums are added in warp order.  The padding adds exact zeros.
    """
    rows = -(-v.shape[0] // TAIL_BLOCK)
    v = torch.cat([v, v.new_zeros(rows * TAIL_BLOCK - v.shape[0])]).view(rows, TAIL_BLOCK)
    acc = v.new_zeros(TAIL_BLOCK)
    for r in range(rows):
        acc = acc + v[r]
    acc = acc.view(TAIL_BLOCK // 32, 32)
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    total = acc[0, 0]
    for w in range(1, acc.shape[0]):
        total = total + acc[w, 0]
    return total


def tail_merge_plain(costs, stats, numer, lam):
    """``(update [D], weights [K], ess)`` of the block partials, in the tail kernel's order.

    ``combine_partials``' function: alpha = exp(block max - max), z = sum
    alpha s1, sumsq = sum alpha^2 s2 (each by :func:`_tail_thread_sum`).  The
    numerators: ``1024 // D`` groups, group g summing alpha numer over the
    blocks g, g + groups, ... in turn from 0, then the groups' sums added in
    group order.
    """
    tile_max = stats[:, 0]
    mx = torch.max(tile_max)
    alpha = torch.exp(tile_max - mx)
    z = _tail_thread_sum(alpha * stats[:, 1])
    sumsq = _tail_thread_sum(alpha * alpha * stats[:, 2])
    blocks, slots = numer.shape
    groups = TAIL_BLOCK // slots
    pad = -(-blocks // groups) * groups - blocks
    a = torch.cat([alpha, alpha.new_zeros(pad)]).view(-1, groups, 1)
    rows = torch.cat([numer, numer.new_zeros(pad, slots)]).view(-1, groups, slots)
    acc = numer.new_zeros(groups, slots)
    for r in range(rows.shape[0]):
        acc = acc + a[r] * rows[r]
    numer_g = acc[0]
    for g in range(1, groups):
        numer_g = numer_g + acc[g]
    weights = torch.exp(-costs / lam.reshape(()) - mx) / z
    return numer_g / z, weights, z * z / sumsq


def sg_filter_plain(action_seq, history, coeffs):
    """``core/sg_filter.apply_sg_filter`` with each output's taps summed in order from 0.

    The tail kernel's filter: the history and the sequence ``[2T-1, m]``,
    mirrored at each end (edge rows repeated), cross-correlated with the
    window, the last T rows kept.
    """
    horizon = action_seq.shape[0]
    prolonged = torch.cat([history, action_seq], dim=0)
    length, pad = prolonged.shape[0], coeffs.shape[0] // 2
    padded = torch.cat(
        [prolonged[:pad].flip(0), prolonged, prolonged[length - pad:].flip(0)], dim=0
    )
    acc = action_seq.new_zeros(action_seq.shape)
    for j in range(coeffs.shape[0]):
        acc = acc + padded[horizon - 1 + j: 2 * horizon - 1 + j] * coeffs[j]
    return acc


def fused_tick_tail_plain(x0, costs, stats, numer, lam, task: FusedTask, sg_history,
                          sg_coeffs=None):
    """The tail kernel's plain twin: ``(action_seq, state_seq, weights, ess, sg_history)``.

    :func:`tail_merge_plain`, :func:`sg_filter_plain` where ``sg_coeffs`` is
    given, the history shifted by the first action (``cat(history[1:],
    action_seq[:1])``), and :func:`fused_reroll_plain` of the action
    sequence.
    """
    m = task.dim_control
    horizon = numer.shape[1] // m
    update, w, ess = tail_merge_plain(costs, stats, numer, lam)
    action_seq = update.reshape(horizon, m)
    if sg_coeffs is not None:
        action_seq = sg_filter_plain(action_seq, sg_history, sg_coeffs)
    history = torch.cat([sg_history[1:], action_seq[:1]], dim=0)[:horizon - 1]
    states = fused_reroll_plain(x0, action_seq, task)
    return action_seq, states, w, ess, history


def fused_reroll_plain(x0, action_seq, task: FusedTask):
    """The re-roll kernel's plain twin: ``[T+1, n]``."""
    xs = tuple(x0[c] for c in range(task.dim_state))
    rows = [torch.stack(xs)]
    for t in range(action_seq.shape[0]):
        xs = task.dynamics_soa(xs, tuple(action_seq[t, j] for j in range(task.dim_control)))
        rows.append(torch.stack(xs))
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_card(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other device."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return t.device.type == "cuda"


def _floats(values) -> ctypes.Array:
    """A host float32 array for the kernels (``c_float`` rounds each value)."""
    values = [float(v) for v in values]
    return (ctypes.c_float * max(1, len(values)))(*values)


def _ints(values) -> ctypes.Array:
    values = [int(v) for v in values]
    return (ctypes.c_int * max(1, len(values)))(*values)


def _seed_tensor(seed, device) -> torch.Tensor:
    """The kernels' seed word ``[1]`` int32 on ``device``: a host int filled in, a tensor checked.

    A fill copies nothing from the host, so a CUDA graph can capture it (as a
    constant: every replay draws that one stream).
    """
    if not isinstance(seed, torch.Tensor):
        word = int(seed) & _MASK32
        return torch.full((1,), word - (1 << 32) if word >= 1 << 31 else word,
                          dtype=torch.int32, device=device)
    if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != device:
        raise ValueError(f"a seed tensor is one int32 word on {device}, got {seed.dtype} "
                         f"{tuple(seed.shape)} on {seed.device}")
    return seed.reshape(1)


def _advance_plain(key, key_out) -> None:
    """The kernels' key advance on the twins' side: ``key_out`` <- the next tick's key."""
    if (key is None) != (key_out is None):
        raise ValueError("key and key_out come together")
    if key is not None:
        from mppi_playground_tpu_torch.core.config import advance_key_plain

        key_out.copy_(advance_key_plain(key))


def _check_sampling(prev, num_samples, sigmas, u_min, u_max, widths=None):
    """Check a drawing kernel's warm start and bounds -> the bounds array.

    ``widths``: the action widths the kernel is built for (None: any m).
    """
    horizon, m = prev.shape if prev.dim() == 2 else (0, 0)
    if (prev.dim() != 2 or not 1 <= m or not 1 <= horizon or horizon * m > MAX_SLOTS
            or (widths is not None and m not in widths)):
        within = "" if widths is None else f"m in {widths} and "
        raise ValueError(f"prev must be [horizon, m] with {within}1 <= horizon * m <= "
                         f"{MAX_SLOTS}, got {tuple(prev.shape)}")
    if not 1 <= num_samples < 2**31 - BLOCK:
        raise ValueError(f"num_samples out of range: {num_samples}")
    if not len(sigmas) == len(u_min) == len(u_max) == m:
        raise ValueError(f"sigmas, u_min and u_max need {m} values each")
    _check("prev", prev, (horizon, m), torch.float32, prev.device)
    return _floats((*sigmas, *u_min, *u_max))


def _slot_major(noise, num_samples, horizon, m):
    """Injected noise ``[K, T, m]`` -> the kernels' ``[T*m, K]``, checked."""
    _check("noise", noise, (num_samples, horizon, m), torch.float32, noise.device)
    return noise.reshape(num_samples, horizon * m).t().contiguous()


def _seed_words(seeds, batch: int, device) -> Tuple[torch.Tensor, int]:
    """A fleet's seed words -> ``(tensor, stride in words)``.

    A tensor is ``batch`` int32 words on ``device`` at any stride (a batch
    of keys' ``keys[:, 2]``, stride 3); host integers are filled in word by
    word (:func:`_seed_tensor`: a CUDA graph can capture the fills).
    """
    if not isinstance(seeds, torch.Tensor):
        words = [_seed_tensor(v, device) for v in seeds]
        seeds = words[0] if len(words) == 1 else torch.cat(words)
    if seeds.dtype != torch.int32 or tuple(seeds.shape) != (batch,) or seeds.device != device:
        raise ValueError(f"the seed words are [{batch}] int32 on {device}, got {seeds.dtype} "
                         f"{tuple(seeds.shape)} on {seeds.device}")
    return seeds, seeds.stride(0)


def _one_seed(seed):
    """A single launch's seed (host int, or one int32 word on the device) as a batch of one's."""
    return seed.reshape(1) if isinstance(seed, torch.Tensor) else [seed]


def _one(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A single launch's array as a batch of one's (a view)."""
    return None if t is None else t[None]


def _shard(num_samples: int, sample_offset: int, total_samples: Optional[int]) -> int:
    """Check a shard's ``sample_offset`` and the solve's ``total_samples`` -> the latter."""
    total = num_samples if total_samples is None else int(total_samples)
    if sample_offset < 0 or sample_offset % BLOCK:
        raise ValueError(f"sample_offset must be a non-negative multiple of {BLOCK}, got "
                         f"{sample_offset}")
    if not 1 <= total < 2**31 - BLOCK or sample_offset + num_samples >= 2**31 - BLOCK:
        raise ValueError(f"total_samples out of range: {total} (offset {sample_offset}, "
                         f"{num_samples} samples a shard)")
    return total


def _rollout_args(x0s, prevs, lams, seeds, refs, task, sigmas, u_min, u_max, num_samples,
                  threshold, noise, sample_offset=0, total_samples=None):
    """Check a rollout kernel's inputs for B scenarios on the card -> ``(args, keep)``.

    Every array but the bounds, the model's constants and grids has a
    leading ``[B]`` axis (``lams`` ``[B]``, ``seeds`` the scenarios' words,
    :func:`_seed_words`).  ``args`` are the leading arguments the rollout
    entry points of ``csrc/fused_solve.cuh`` share (``lams`` None: a null
    pointer, for phase 1, which reads none), then the batch, the seed
    words' stride, the shard's ``sample_offset`` and the solve's
    ``total_samples``; ``keep`` holds what must live until the launch
    returns (the noise in the kernels' layout, the seed words, the host
    arrays).
    """
    dev = x0s.device
    n, m = task.dim_state, task.dim_control
    if prevs.dim() != 3 or prevs.shape[-1] != m or prevs.shape[0] < 1:
        raise ValueError(f"the {task.name} model takes prev [B, T, {m}], got "
                         f"{tuple(prevs.shape)}")
    batch, horizon = prevs.shape[:2]
    bounds = _check_sampling(prevs[0], num_samples, sigmas, u_min, u_max)
    f32 = torch.float32
    _check("x0", x0s, (batch, n), f32, dev)
    _check("prev", prevs, (batch, horizon, m), f32, dev)
    if lams is not None:
        _check("lam", lams, tuple(lams.shape), f32, dev)
        if lams.numel() != batch:
            raise ValueError(f"lam must hold {batch} element(s), one a scenario")
    width = task.reference_width
    if width:
        if refs is None:
            raise ValueError(f"the {task.name} model needs its reference rows [T+1, {width}]")
        _check("ref", refs, (batch, horizon + 1, width), f32, dev)
    grids = list(task.grids)
    for i, grid in enumerate(grids):
        _check(f"grid {i}", grid, tuple(grids[0].shape), torch.uint8, dev)
        if grid.dim() != 2:
            raise ValueError("the occupancy grids must be 2-D")
    grid_ptrs = [g.data_ptr() for g in grids] + [None] * (2 - len(grids))
    noise_ptr = None
    if noise is not None:
        _check("noise", noise, (batch, num_samples, horizon, m), f32, noise.device)
        noise = noise.reshape(batch, num_samples, horizon * m).transpose(1, 2).contiguous()
        noise_ptr = noise.data_ptr()
    model_f, model_i = _floats(task.floats), _ints(task.ints)
    seeds, stride = _seed_words(seeds, batch, dev)
    total = _shard(num_samples, sample_offset, total_samples)
    args = (
        x0s.data_ptr(), prevs.data_ptr(), None if lams is None else lams.data_ptr(),
        refs.data_ptr() if width else None, *grid_ptrs, noise_ptr, bounds, model_f, model_i,
        seeds.data_ptr(), horizon, num_samples, max(0, min(threshold, total)), batch,
        stride, sample_offset, total,
    )
    return args, (noise, seeds, bounds, model_f, model_i)


_ROLLOUT_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
# after the shared arguments, the epilogue takes the batch, the seed words' stride, the
# search's mode, bracket, parameter and steps, the tickets and its outputs
_DUMP_LAMBDA_BATCH_ARGTYPES = (_ROLLOUT_ARGTYPES + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
                               + [ctypes.c_int] + [ctypes.c_void_p] * 4)
# and the solve and phase 1 the batch, the seed words' stride, the shard's sample offset
# and the solve's total samples, then their outputs
_SOLVE_BATCH_ARGTYPES = _ROLLOUT_ARGTYPES + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
_DUMP_BATCH_ARGTYPES = _ROLLOUT_ARGTYPES + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2


def fused_solve(
    x0: torch.Tensor,
    prev: torch.Tensor,
    lam: torch.Tensor,
    seed,
    ref: Optional[torch.Tensor],
    task: FusedTask,
    sigmas: Sequence[float],
    u_min: Sequence[float],
    u_max: Sequence[float],
    num_samples: int,
    threshold: int,
    noise: Optional[torch.Tensor] = None,
    sample_offset: int = 0,
    total_samples: Optional[int] = None,
):
    """One fused solve -> ``(costs [K], stats [B, 3], numer [B, T*m])``.

    ``x0 [n]``, ``prev [T, m]``, ``lam`` (one element), all float32 on one
    device; ``ref`` the racing model's ``[T+1, 5]`` reference rows ``(x, y,
    sin, cos, v)`` (None for the other models); ``seed`` a host integer or
    a one-element int32 tensor on the device (a key's seed word);
    ``noise`` optional ``[K, T, m]`` already scaled by sigma.  ``B =
    ceil(K / 256)``.  A shard passes its ``sample_offset`` and the solve's
    ``total_samples`` (the module's docstring).  :func:`fused_solve_batch`
    of a batch of one, which counts the launch here; CPU tensors take
    :func:`fused_solve_plain`.
    """
    costs, stats, numer = fused_solve_batch(
        x0[None], prev[None], lam.reshape(-1), _one_seed(seed), _one(ref), task, sigmas, u_min,
        u_max, num_samples, threshold, _one(noise), sample_offset, total_samples)
    return costs[0], stats[0], numer[0]


fused_solve.launches = timing.LaunchCounts(lambda name: name.endswith("_fused_solve"))


def fused_costs_dump(
    x0: torch.Tensor,
    prev: torch.Tensor,
    seed,
    ref: Optional[torch.Tensor],
    task: FusedTask,
    sigmas: Sequence[float],
    u_min: Sequence[float],
    u_max: Sequence[float],
    num_samples: int,
    threshold: int,
    noise: Optional[torch.Tensor] = None,
    sample_offset: int = 0,
    total_samples: Optional[int] = None,
):
    """Auto-lambda phase 1 -> ``(costs [K], dump [T*m, K])``.

    The rollout and costs of :func:`fused_solve` (same arguments, no
    lambda), and each sample's clamped perturbations, slot-major.
    :func:`fused_costs_dump_batch` of a batch of one, which counts the
    launch here; CPU tensors take :func:`fused_costs_dump_plain`.
    """
    costs, dump = fused_costs_dump_batch(x0[None], prev[None], _one_seed(seed), _one(ref), task,
                                         sigmas, u_min, u_max, num_samples, threshold,
                                         _one(noise), sample_offset, total_samples)
    return costs[0], dump[0]


fused_costs_dump.launches = timing.LaunchCounts(lambda name: name.endswith("_costs_dump"))


def fused_costs_dump_lambda(
    x0: torch.Tensor,
    prev: torch.Tensor,
    seed,
    ref: Optional[torch.Tensor],
    task: FusedTask,
    sigmas: Sequence[float],
    u_min: Sequence[float],
    u_max: Sequence[float],
    num_samples: int,
    threshold: int,
    noise: Optional[torch.Tensor],
    search: LambdaSearch,
    ticket: torch.Tensor,
):
    """Phase 1 with the lambda search in one launch -> ``(costs [K], dump [T*m, K], lam [1])``.

    :func:`fused_costs_dump`'s outputs, and lambda* of ``search`` over the
    K costs, bit for bit the search kernel's on the same costs.  ``ticket``
    is the kernel's ``[1]`` int32 count of finished clusters, zero between
    launches (the kernel resets it): a solver allocates one and passes it
    every tick.  :func:`fused_costs_dump_lambda_batch` of a batch of one,
    which counts the launch here; CPU tensors take
    :func:`fused_costs_dump_lambda_plain`.
    """
    costs, dump, lam = fused_costs_dump_lambda_batch(
        x0[None], prev[None], _one_seed(seed), _one(ref), task, sigmas, u_min, u_max,
        num_samples, threshold, _one(noise), search, ticket)
    return costs[0], dump[0], lam


fused_costs_dump_lambda.launches = timing.LaunchCounts(lambda name: name.endswith("_costs_dump_lambda"))


def fused_weighted(costs: torch.Tensor, dump: torch.Tensor, lam: torch.Tensor,
                   sample_offset: int = 0, total_samples: Optional[int] = None):
    """Auto-lambda phase 2 -> ``(stats [B, 3], numer [B, D])`` at ``lam``.

    ``costs [K]`` and ``dump [D, K]`` (``D = T*m``) from
    :func:`fused_costs_dump`, ``lam`` one element on the same device (read
    by the kernel, never by the host).  The same partials
    :func:`fused_solve` gives at ``lam``; a shard passes the ``sample_offset``
    and ``total_samples`` its phase 1 took.  :func:`fused_weighted_batch` of
    a batch of one, which counts the launch here; CPU tensors take
    :func:`fused_weighted_plain`.
    """
    stats, numer = fused_weighted_batch(costs[None], dump[None], lam.reshape(-1), sample_offset,
                                        total_samples)
    return stats[0], numer[0]


fused_weighted.launches = timing.LaunchCounts(lambda name: name == "fused_weighted")

_REGEN_BATCH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3


def fused_regen(
    prev: torch.Tensor,
    seed,
    rows: torch.Tensor,
    sigmas: Sequence[float],
    u_min: Sequence[float],
    u_max: Sequence[float],
    num_samples: int,
    threshold: int,
    noise: Optional[torch.Tensor] = None,
    key: Optional[torch.Tensor] = None,
    key_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Replay a solve's clamped perturbations at ``rows`` -> ``[n, T, m]``.

    ``prev [T, m]`` is the warm start the solve sampled around and ``seed``
    its kernel seed (a host int or a one-element int32 tensor on the
    device); ``noise`` the ``[K, T, m]`` noise it was given, if any.
    ``rows [n]`` (int64, each in ``[0, K)``) picks the samples; row ``i`` of
    the result is sample ``rows[i]``'s perturbation, bit for bit the one the
    solve drew (and phase 1 dumped).  The kernel depends on the model only
    through m.  With a solver's ``key`` ``[3]`` and ``key_out`` (int32, not
    aliased), the launch also writes the next tick's key to ``key_out``: the
    unfused solver draws all K rows so, one launch a tick.
    :func:`fused_regen_batch` of a batch of one, which counts the launch
    here; CPU tensors take :func:`fused_regen_plain` (and the key's twin).
    """
    if (key is None) != (key_out is None):
        raise ValueError("key and key_out come together")
    return fused_regen_batch(prev[None], _one_seed(seed), rows, sigmas, u_min, u_max,
                             num_samples, threshold, _one(noise), _one(key), _one(key_out))[0]


fused_regen.launches = timing.LaunchCounts(lambda name: name.startswith("fused_regen_m"))

_TOP_ROLLOUTS_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def fused_top_rollouts(
    x0: torch.Tensor,
    prev: torch.Tensor,
    seed,
    rows: torch.Tensor,
    task: FusedTask,
    sigmas: Sequence[float],
    u_min: Sequence[float],
    u_max: Sequence[float],
    num_samples: int,
    threshold: int,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Regenerate a solve's samples at ``rows`` and roll them out -> ``[n, T+1, n_x]``.

    ``x0 [n_x]`` and ``prev [T, m]`` are the state and warm start the solve
    sampled from, ``seed`` its kernel seed (a host int or a one-element int32
    tensor on the device), ``noise`` the ``[K, T, m]``
    noise it was given, if any; ``rows [n]`` (int64) picks the samples.  Row
    ``i`` is sample ``rows[i]``'s trajectory from ``x0`` under the
    perturbation the solve drew (:func:`fused_regen`'s row, bit for bit),
    through the task's model; a row outside ``[0, K)`` is all NaN.  One
    launch.  CPU tensors take :func:`fused_top_rollouts_plain`.
    """
    if not _on_card("fused_top_rollouts", x0):
        return fused_top_rollouts_plain(x0, prev, seed, rows, task, sigmas, u_min, u_max,
                                        num_samples, threshold, noise)
    dev = x0.device
    n, m = task.dim_state, task.dim_control
    if prev.dim() != 2 or prev.shape[1] != m:
        raise ValueError(f"the {task.name} model takes prev [T, {m}], got {tuple(prev.shape)}")
    bounds = _check_sampling(prev, num_samples, sigmas, u_min, u_max)
    horizon = prev.shape[0]
    _check("x0", x0, (n,), torch.float32, dev)
    _check("prev", prev, (horizon, m), torch.float32, dev)
    num_rows = rows.shape[0]
    _check("rows", rows, (num_rows,), torch.int64, dev)
    out = torch.empty(num_rows, horizon + 1, n, dtype=torch.float32, device=dev)
    if num_rows == 0:
        return out
    noise_ptr = None
    if noise is not None:
        noise = _slot_major(noise, num_samples, horizon, m)
        noise_ptr = noise.data_ptr()
    model_f, model_i = _floats(task.floats), _ints(task.ints)
    seed = _seed_tensor(seed, dev)
    library, symbol = task.entry("top_rollouts")
    cuda_build.launch(
        library, symbol, _TOP_ROLLOUTS_ARGTYPES, dev, x0.data_ptr(), prev.data_ptr(), noise_ptr,
        rows.data_ptr(), bounds, model_f, model_i, seed.data_ptr(), horizon, num_samples,
        max(0, min(threshold, num_samples)), num_rows, out.data_ptr(),
    )
    return out


fused_top_rollouts.launches = timing.LaunchCounts(lambda name: name.endswith("_top_rollouts"))

_REROLL_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p]


def fused_reroll(x0: torch.Tensor, action_seq: torch.Tensor, task: FusedTask) -> torch.Tensor:
    """``(x0 [n], action_seq [T, m]) -> state_seq [T+1, n]`` through the task's model."""
    if not _on_card("fused_reroll", x0):
        return fused_reroll_plain(x0, action_seq, task)
    dev = x0.device
    horizon = action_seq.shape[0]
    n, m = task.dim_state, task.dim_control
    _check("x0", x0, (n,), torch.float32, dev)
    _check("action_seq", action_seq, (horizon, m), torch.float32, dev)
    out = torch.empty(horizon + 1, n, dtype=torch.float32, device=dev)
    model_f, model_i = _floats(task.floats), _ints(task.ints)
    library, symbol = task.entry("reroll")
    cuda_build.launch(library, symbol, _REROLL_ARGTYPES, dev, x0.data_ptr(),
                      action_seq.data_ptr(), model_f, model_i, horizon, out.data_ptr())
    return out


fused_reroll.launches = timing.LaunchCounts(lambda name: name.endswith("_reroll"))


def fused_tick_tail(
    x0: torch.Tensor,
    costs: torch.Tensor,
    stats: torch.Tensor,
    numer: torch.Tensor,
    lam: torch.Tensor,
    task: FusedTask,
    sg_history: torch.Tensor,
    sg_coeffs: Optional[torch.Tensor] = None,
    key: Optional[torch.Tensor] = None,
    key_out: Optional[torch.Tensor] = None,
):
    """The tick's tail in one launch -> ``(action_seq [T, m], state_seq [T+1, n], weights [K],
    ess, sg_history [T-1, m])``.

    ``costs [K]``, ``stats [B, 3]`` and ``numer [B, T*m]`` from
    :func:`fused_solve` or :func:`fused_weighted`, ``lam`` (one element,
    read by the kernel, never by the host) the lambda they were weighted at,
    ``x0 [n]`` the state to re-roll from, ``sg_history [T-1, m]`` the SG
    filter's history, ``sg_coeffs [w]`` its window (None: no filter).  The
    action sequence is the merged update, filtered where ``sg_coeffs`` is
    given; ``sg_history`` comes back shifted by its first action, as
    ``core/solver.smooth_predict_advance`` shifts it; ``ess`` is 0-dim.  With
    a solver's ``key`` ``[3]`` and ``key_out`` (int32, not aliased), the
    launch also writes the next tick's key to ``key_out``, so that a fused
    tick moves its key on without a launch of its own.
    :func:`fused_tick_tail_batch` of a batch of one, which counts the launch
    here; CPU tensors take :func:`fused_tick_tail_plain` (and the key's twin).
    """
    action_seq, states, w, ess, history = fused_tick_tail_batch(
        x0[None], costs[None], stats[None], numer[None], lam.reshape(-1), task, sg_history[None],
        sg_coeffs, _one(key), _one(key_out))
    return action_seq[0], states[0], w[0], ess[0], history[0]


fused_tick_tail.launches = timing.LaunchCounts(lambda name: name.endswith("_tick_tail"))

# ---------------------------------------------------------------------------
# A fleet of scenarios, one launch a kernel: the wrappers and their twins
# ---------------------------------------------------------------------------

def _scenario_seed(seeds, b):
    """Scenario b's seed for the single twins: a host int, or its word as a 0-dim view."""
    return seeds[b] if isinstance(seeds, torch.Tensor) else int(seeds[b])


def _stack(parts):
    """Per-scenario outputs (tuples of tensors) -> one tuple of ``[B, ...]`` tensors."""
    return tuple(torch.stack(column) for column in zip(*parts))


def fused_solve_batch_plain(x0s, prevs, lams, seeds, refs, task: FusedTask, sigmas, u_min,
                            u_max, num_samples: int, threshold: int, noise=None,
                            sample_offset: int = 0, total_samples: Optional[int] = None):
    """:func:`fused_solve_batch`'s twin: :func:`fused_solve_plain` scenario by scenario."""
    return _stack(fused_solve_plain(
        x0s[b], prevs[b], lams[b], _scenario_seed(seeds, b), None if refs is None else refs[b],
        task, sigmas, u_min, u_max, num_samples, threshold, None if noise is None else noise[b],
        sample_offset, total_samples)
        for b in range(x0s.shape[0]))


def fused_solve_batch(
    x0s: torch.Tensor,
    prevs: torch.Tensor,
    lams: torch.Tensor,
    seeds,
    refs: Optional[torch.Tensor],
    task: FusedTask,
    sigmas: Sequence[float],
    u_min: Sequence[float],
    u_max: Sequence[float],
    num_samples: int,
    threshold: int,
    noise: Optional[torch.Tensor] = None,
    sample_offset: int = 0,
    total_samples: Optional[int] = None,
):
    """:func:`fused_solve` for B scenarios in one launch -> ``(costs [B, K], stats [B, blocks,
    3], numer [B, blocks, T*m])``.

    ``x0s [B, n]``, ``prevs [B, T, m]``, ``lams [B]``, ``refs [B, T+1, 5]``
    (racing) or None, ``noise [B, K, T, m]`` or None; ``seeds`` the B seed
    words, an int32 ``[B]`` tensor at any stride (a batch of keys'
    ``keys[:, 2]``) or host integers.  A shard's ``sample_offset`` and the
    solve's ``total_samples`` are shared by every scenario.  CPU tensors take
    :func:`fused_solve_batch_plain`.
    """
    if not _on_card("fused_solve_batch", x0s):
        return fused_solve_batch_plain(x0s, prevs, lams, seeds, refs, task, sigmas, u_min, u_max,
                                       num_samples, threshold, noise, sample_offset,
                                       total_samples)
    args, keep = _rollout_args(x0s, prevs, lams, seeds, refs, task, sigmas, u_min, u_max,
                               num_samples, threshold, noise, sample_offset, total_samples)
    batch, dev = prevs.shape[0], x0s.device
    blocks = -(-num_samples // BLOCK)
    costs = torch.empty(batch, num_samples, dtype=torch.float32, device=dev)
    stats = torch.empty(batch, blocks, 3, dtype=torch.float32, device=dev)
    numer = torch.empty(batch, blocks, prevs[0].numel(), dtype=torch.float32, device=dev)
    cuda_build.launch(*task.entry("fused_solve_batch"), _SOLVE_BATCH_ARGTYPES, dev, *args,
                      costs.data_ptr(), stats.data_ptr(), numer.data_ptr())
    return costs, stats, numer


def fused_costs_dump_batch_plain(x0s, prevs, seeds, refs, task: FusedTask, sigmas, u_min, u_max,
                                 num_samples: int, threshold: int, noise=None,
                                 sample_offset: int = 0, total_samples: Optional[int] = None):
    """:func:`fused_costs_dump_batch`'s twin: :func:`fused_costs_dump_plain` scenario by scenario."""
    return _stack(fused_costs_dump_plain(
        x0s[b], prevs[b], _scenario_seed(seeds, b), None if refs is None else refs[b], task,
        sigmas, u_min, u_max, num_samples, threshold, None if noise is None else noise[b],
        sample_offset, total_samples)
        for b in range(x0s.shape[0]))


def fused_costs_dump_batch(
    x0s: torch.Tensor,
    prevs: torch.Tensor,
    seeds,
    refs: Optional[torch.Tensor],
    task: FusedTask,
    sigmas: Sequence[float],
    u_min: Sequence[float],
    u_max: Sequence[float],
    num_samples: int,
    threshold: int,
    noise: Optional[torch.Tensor] = None,
    sample_offset: int = 0,
    total_samples: Optional[int] = None,
):
    """Phase 1 for B scenarios in one launch -> ``(costs [B, K], dump [B, T*m, K])``.

    The arguments of :func:`fused_solve_batch` without lambda.  CPU tensors
    take :func:`fused_costs_dump_batch_plain`.
    """
    if not _on_card("fused_costs_dump_batch", x0s):
        return fused_costs_dump_batch_plain(x0s, prevs, seeds, refs, task, sigmas, u_min, u_max,
                                            num_samples, threshold, noise, sample_offset,
                                            total_samples)
    args, keep = _rollout_args(x0s, prevs, None, seeds, refs, task, sigmas, u_min, u_max,
                               num_samples, threshold, noise, sample_offset, total_samples)
    batch, dev = prevs.shape[0], x0s.device
    costs = torch.empty(batch, num_samples, dtype=torch.float32, device=dev)
    dump = torch.empty(batch, prevs[0].numel(), num_samples, dtype=torch.float32, device=dev)
    cuda_build.launch(*task.entry("costs_dump_batch"), _DUMP_BATCH_ARGTYPES, dev, *args,
                      costs.data_ptr(), dump.data_ptr())
    return costs, dump


def fused_weighted_batch_plain(costs, dump, lam, sample_offset: int = 0,
                               total_samples: Optional[int] = None):
    """:func:`fused_weighted_batch`'s twin: :func:`fused_weighted_plain` scenario by scenario."""
    return _stack(fused_weighted_plain(costs[b], dump[b], lam[b], sample_offset, total_samples)
                  for b in range(costs.shape[0]))


_WEIGHTED_BATCH_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2


def fused_weighted_batch(costs: torch.Tensor, dump: torch.Tensor, lam: torch.Tensor,
                         sample_offset: int = 0, total_samples: Optional[int] = None):
    """Phase 2 for B scenarios in one launch -> ``(stats [B, blocks, 3], numer [B, blocks, D])``.

    ``costs [B, K]``, ``dump [B, D, K]`` from :func:`fused_costs_dump_batch`,
    ``lam [B]`` (read by the kernel); a shard's ``sample_offset`` and the
    solve's ``total_samples``, as its phase 1 took them.  CPU tensors take
    :func:`fused_weighted_batch_plain`.
    """
    if not _on_card("fused_weighted_batch", costs):
        return fused_weighted_batch_plain(costs, dump, lam, sample_offset, total_samples)
    dev = costs.device
    if costs.dim() != 2 or dump.dim() != 3:
        raise ValueError(f"costs must be [B, K] and dump [B, D, K], got {tuple(costs.shape)} and "
                         f"{tuple(dump.shape)}")
    batch, num_samples = costs.shape
    slots = dump.shape[1]
    if not 1 <= slots <= MAX_SLOTS:
        raise ValueError(f"dump must be [B, D, K] with 1 <= D <= {MAX_SLOTS}")
    if not 1 <= num_samples < 2**31 - BLOCK or batch < 1:
        raise ValueError(f"costs out of range: {tuple(costs.shape)}")
    total = _shard(num_samples, sample_offset, total_samples)
    f32 = torch.float32
    _check("costs", costs, (batch, num_samples), f32, dev)
    _check("dump", dump, (batch, slots, num_samples), f32, dev)
    _check("lam", lam, (batch,), f32, dev)
    blocks = -(-num_samples // BLOCK)
    stats = torch.empty(batch, blocks, 3, dtype=f32, device=dev)
    numer = torch.empty(batch, blocks, slots, dtype=f32, device=dev)
    cuda_build.launch("fused_solve", "fused_weighted_batch", _WEIGHTED_BATCH_ARGTYPES, dev,
                      costs.data_ptr(), dump.data_ptr(), lam.data_ptr(), slots, num_samples,
                      batch, sample_offset, total, stats.data_ptr(), numer.data_ptr())
    return stats, numer


def fused_tick_tail_batch_plain(x0s, costs, stats, numer, lam, task: FusedTask, sg_history,
                                sg_coeffs=None, keys=None, keys_out=None):
    """:func:`fused_tick_tail_batch`'s twin: :func:`fused_tick_tail_plain` (and the key's twin)
    scenario by scenario."""
    parts = []
    for b in range(x0s.shape[0]):
        if keys is not None or keys_out is not None:
            _advance_plain(None if keys is None else keys[b],
                           None if keys_out is None else keys_out[b])
        action_seq, states, w, ess, history = fused_tick_tail_plain(
            x0s[b], costs[b], stats[b], numer[b], lam[b], task, sg_history[b], sg_coeffs)
        parts.append((action_seq, states, w, ess.reshape(()), history))
    return _stack(parts)


_TAIL_BATCH_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 7


def fused_tick_tail_batch(
    x0s: torch.Tensor,
    costs: torch.Tensor,
    stats: torch.Tensor,
    numer: torch.Tensor,
    lam: torch.Tensor,
    task: FusedTask,
    sg_history: torch.Tensor,
    sg_coeffs: Optional[torch.Tensor] = None,
    keys: Optional[torch.Tensor] = None,
    keys_out: Optional[torch.Tensor] = None,
):
    """:func:`fused_tick_tail` for B scenarios in one launch -> ``(action_seq [B, T, m],
    state_seq [B, T+1, n], weights [B, K], ess [B], sg_history [B, T-1, m])``.

    ``x0s [B, n]``, ``costs [B, K]``, ``stats [B, blocks, 3]``, ``numer [B,
    blocks, T*m]``, ``lam [B]``, ``sg_history [B, T-1, m]``; ``sg_coeffs``
    shared; with ``keys`` and ``keys_out`` (int32 ``[B, 3]``, not aliased)
    the first CTA of each scenario writes that scenario's next key.  CPU
    tensors take :func:`fused_tick_tail_batch_plain`.
    """
    if not _on_card("fused_tick_tail_batch", x0s):
        return fused_tick_tail_batch_plain(x0s, costs, stats, numer, lam, task, sg_history,
                                           sg_coeffs, keys, keys_out)
    dev = x0s.device
    n, m = task.dim_state, task.dim_control
    if costs.dim() != 2 or stats.dim() != 3 or numer.dim() != 3:
        raise ValueError("costs must be [B, K], stats [B, blocks, 3] and numer [B, blocks, T*m]")
    batch, num_samples = costs.shape
    blocks, slots = stats.shape[1], numer.shape[2]
    horizon = slots // m
    if not (1 <= horizon and horizon * m == slots <= MAX_SLOTS):
        raise ValueError(f"numer must be [B, blocks, T*{m}] with 1 <= T*{m} <= {MAX_SLOTS}, got "
                         f"{tuple(numer.shape)}")
    if not 1 <= num_samples < 2**31 - BLOCK or blocks != -(-num_samples // BLOCK):
        raise ValueError(f"stats must be [B, ceil(K / {BLOCK}), 3] for K={num_samples}, got "
                         f"{tuple(stats.shape)}")
    f32 = torch.float32
    _check("x0s", x0s, (batch, n), f32, dev)
    _check("costs", costs, (batch, num_samples), f32, dev)
    _check("stats", stats, (batch, blocks, 3), f32, dev)
    _check("numer", numer, (batch, blocks, slots), f32, dev)
    _check("lam", lam, (batch,), f32, dev)
    _check("sg_history", sg_history, (batch, horizon - 1, m), f32, dev)
    window = 0
    if sg_coeffs is not None:
        window = sg_coeffs.shape[0]
        _check("sg_coeffs", sg_coeffs, (window,), f32, dev)
        if window % 2 == 0 or window // 2 > 2 * horizon - 2:
            raise ValueError(f"the SG window must be odd with window // 2 <= 2T - 2, got "
                             f"{window} at T={horizon}")
    if (keys is None) != (keys_out is None):
        raise ValueError("keys and keys_out come together")
    key_ptr = key_out_ptr = None
    if keys is not None:
        _check("keys", keys, (batch, 3), torch.int32, dev)
        _check("keys_out", keys_out, (batch, 3), torch.int32, dev)
        if keys_out.data_ptr() == keys.data_ptr():
            raise ValueError("keys_out must not alias keys: other CTAs read the seed words")
        key_ptr, key_out_ptr = keys.data_ptr(), keys_out.data_ptr()
    action_seq = torch.empty(batch, horizon, m, dtype=f32, device=dev)
    states = torch.empty(batch, horizon + 1, n, dtype=f32, device=dev)
    ess = torch.empty(batch, dtype=f32, device=dev)
    w = torch.empty(batch, num_samples, dtype=f32, device=dev)
    history = torch.empty(batch, horizon - 1, m, dtype=f32, device=dev)
    model_f, model_i = _floats(task.floats), _ints(task.ints)
    cuda_build.launch(
        *task.entry("tick_tail_batch"), _TAIL_BATCH_ARGTYPES, dev, x0s.data_ptr(), costs.data_ptr(),
        stats.data_ptr(), numer.data_ptr(), lam.data_ptr(), sg_history.data_ptr(),
        None if sg_coeffs is None else sg_coeffs.data_ptr(), model_f, model_i, blocks, horizon,
        num_samples, window, batch, action_seq.data_ptr(), states.data_ptr(), ess.data_ptr(),
        w.data_ptr(), history.data_ptr(), key_ptr, key_out_ptr,
    )
    return action_seq, states, w, ess, history

def fused_costs_dump_lambda_batch_plain(x0s, prevs, seeds, refs, task: FusedTask, sigmas,
                                        u_min, u_max, num_samples: int, threshold: int,
                                        noise, search: LambdaSearch):
    """:func:`fused_costs_dump_lambda_batch`'s twin: :func:`fused_costs_dump_lambda_plain`
    scenario by scenario -> ``(costs [B, K], dump [B, T*m, K], lam [B])``."""
    costs, dump, lam = _stack(fused_costs_dump_lambda_plain(
        x0s[b], prevs[b], _scenario_seed(seeds, b), None if refs is None else refs[b], task,
        sigmas, u_min, u_max, num_samples, threshold, None if noise is None else noise[b],
        search)
        for b in range(x0s.shape[0]))
    return costs, dump, lam.reshape(-1)


def fused_costs_dump_lambda_batch(
    x0s: torch.Tensor,
    prevs: torch.Tensor,
    seeds,
    refs: Optional[torch.Tensor],
    task: FusedTask,
    sigmas: Sequence[float],
    u_min: Sequence[float],
    u_max: Sequence[float],
    num_samples: int,
    threshold: int,
    noise: Optional[torch.Tensor],
    search: LambdaSearch,
    tickets: torch.Tensor,
):
    """:func:`fused_costs_dump_lambda` for B scenarios in one launch -> ``(costs [B, K], dump
    [B, T*m, K], lam [B])``.

    The arguments of :func:`fused_costs_dump_batch` (no shard: the epilogue
    searches one launch's costs), the search, and ``tickets``, the kernel's
    int32 ``[B]`` counts of finished clusters, one a scenario, zero between
    launches (the kernel resets each): the last cluster of scenario b
    searches b's costs and writes ``lam[b]``, bit for bit the search
    kernel's on them.  CPU tensors take
    :func:`fused_costs_dump_lambda_batch_plain`.
    """
    if not _on_card("fused_costs_dump_lambda_batch", x0s):
        return fused_costs_dump_lambda_batch_plain(x0s, prevs, seeds, refs, task, sigmas, u_min,
                                                   u_max, num_samples, threshold, noise, search)
    args, keep = _rollout_args(x0s, prevs, None, seeds, refs, task, sigmas, u_min, u_max,
                               num_samples, threshold, noise)
    args = args[:-2]  # the batch and the seed words' stride; no shard
    batch, dev = prevs.shape[0], x0s.device
    _check("tickets", tickets, (batch,), torch.int32, dev)
    if search.iters < 0:
        raise ValueError(f"iters must be >= 0, got {search.iters}")
    costs = torch.empty(batch, num_samples, dtype=torch.float32, device=dev)
    dump = torch.empty(batch, prevs[0].numel(), num_samples, dtype=torch.float32, device=dev)
    lam = torch.empty(batch, dtype=torch.float32, device=dev)
    cuda_build.launch(
        *task.entry("costs_dump_lambda_batch"), _DUMP_LAMBDA_BATCH_ARGTYPES, dev, *args,
        int(search.mode == "LBPS"), ctypes.c_float(search.lambda_min),
        ctypes.c_float(search.lambda_max), ctypes.c_float(search.kernel_param),
        int(search.iters), tickets.data_ptr(), costs.data_ptr(), dump.data_ptr(), lam.data_ptr(),
    )
    return costs, dump, lam


def fused_regen_batch_plain(prevs, seeds, rows, sigmas, u_min, u_max, num_samples: int,
                            threshold: int, noise=None, keys=None, keys_out=None):
    """:func:`fused_regen_batch`'s twin: :func:`fused_regen_plain` (and the key's twin)
    scenario by scenario -> ``[B, n, T, m]``."""
    if (keys is None) != (keys_out is None):
        raise ValueError("keys and keys_out come together")
    parts = []
    for b in range(prevs.shape[0]):
        if keys is not None:
            _advance_plain(keys[b], keys_out[b])
        parts.append(fused_regen_plain(prevs[b], _scenario_seed(seeds, b), rows, sigmas, u_min,
                                       u_max, num_samples, threshold,
                                       None if noise is None else noise[b]))
    return torch.stack(parts)


def fused_regen_batch(
    prevs: torch.Tensor,
    seeds,
    rows: torch.Tensor,
    sigmas: Sequence[float],
    u_min: Sequence[float],
    u_max: Sequence[float],
    num_samples: int,
    threshold: int,
    noise: Optional[torch.Tensor] = None,
    keys: Optional[torch.Tensor] = None,
    keys_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`fused_regen` for B scenarios in one launch -> ``[B, n, T, m]``.

    ``prevs [B, T, m]``, ``seeds`` the B seed words (an int32 ``[B]``
    tensor at any stride, a batch of keys' ``keys[:, 2]``, or host
    integers), ``noise [B, K, T, m]`` or None; ``rows [n]`` shared.  With
    ``keys`` and ``keys_out`` (int32 ``[B, 3]``, not aliased) CTA 0 of each
    scenario writes that scenario's next key: an unfused fleet's draw of all
    K rows is its tick's one drawing launch.  Scenario b is bit for bit
    :func:`fused_regen` on b's inputs.  CPU tensors take
    :func:`fused_regen_batch_plain`.
    """
    if not _on_card("fused_regen_batch", prevs):
        return fused_regen_batch_plain(prevs, seeds, rows, sigmas, u_min, u_max, num_samples,
                                       threshold, noise, keys, keys_out)
    dev = prevs.device
    if prevs.dim() != 3 or prevs.shape[0] < 1:
        raise ValueError(f"prevs must be [B, T, m], got {tuple(prevs.shape)}")
    batch, horizon, m = prevs.shape
    bounds = _check_sampling(prevs[0], num_samples, sigmas, u_min, u_max, REGEN_WIDTHS)
    _check("prevs", prevs, (batch, horizon, m), torch.float32, dev)
    num_rows = rows.shape[0]
    _check("rows", rows, (num_rows,), torch.int64, dev)
    if (keys is None) != (keys_out is None):
        raise ValueError("keys and keys_out come together")
    key_ptr = key_out_ptr = None
    if keys is not None:
        _check("keys", keys, (batch, 3), torch.int32, dev)
        _check("keys_out", keys_out, (batch, 3), torch.int32, dev)
        if keys_out.data_ptr() == keys.data_ptr():
            raise ValueError("keys_out must not alias keys: other CTAs read the seed words")
        key_ptr, key_out_ptr = keys.data_ptr(), keys_out.data_ptr()
    out = torch.empty(batch, num_rows, horizon, m, dtype=torch.float32, device=dev)
    if num_rows == 0 and keys is None:
        return out
    noise_ptr = None
    if noise is not None:
        _check("noise", noise, (batch, num_samples, horizon, m), torch.float32, noise.device)
        noise = noise.reshape(batch, num_samples, horizon * m).transpose(1, 2).contiguous()
        noise_ptr = noise.data_ptr()
    seeds, stride = _seed_words(seeds, batch, dev)
    name = f"fused_regen_m{m}"
    cuda_build.launch(
        "fused_solve", f"{name}_batch", _REGEN_BATCH_ARGTYPES, dev, prevs.data_ptr(), noise_ptr,
        rows.data_ptr(), bounds, seeds.data_ptr(), horizon, num_samples,
        max(0, min(threshold, num_samples)), num_rows, batch, stride, out.data_ptr(), key_ptr,
        key_out_ptr,
    )
    return out


# every wrapper, and the kernel names each counts launches under
WRAPPERS = (fused_solve, fused_costs_dump, fused_costs_dump_lambda, fused_weighted, fused_regen,
            fused_top_rollouts, fused_reroll, fused_tick_tail)


def kernel_names(wrapper, plugs: Sequence[ModelPlug] = ()) -> Tuple[str, ...]:
    """The kernels ``wrapper`` launches, by the names its ``launches`` counts: every bundled
    model's, and each of ``plugs``'."""
    if wrapper is fused_weighted:
        return ("fused_weighted",)
    if wrapper is fused_regen:
        return tuple(f"fused_regen_m{m}" for m in REGEN_WIDTHS)
    suffix = {fused_solve: "fused_solve", fused_costs_dump: "costs_dump",
              fused_costs_dump_lambda: "costs_dump_lambda", fused_top_rollouts: "top_rollouts",
              fused_reroll: "reroll", fused_tick_tail: "tick_tail"}[wrapper]
    return tuple(f"{model}_{suffix}" for model in (*MODELS, *(plug.name for plug in plugs)))
