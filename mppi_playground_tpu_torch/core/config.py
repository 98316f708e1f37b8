"""Static solver configuration and the explicit warm-start state.

Counterpart of ``mppi_playground_tpu/core/config.py``.  :class:`MPPIConfig`
has the same fields, validation and derived properties, with ``dtype`` a
``torch.dtype``.  :class:`MPPIState` holds plain tensors plus a ``(seed,
tick)`` pair in place of the JAX PRNG key, twice: as host integers, which
read without waiting on the device, and as the device key the kernels draw
from (:func:`make_key`: the seed, the tick and the tick's kernel seed
:func:`tick_seed` as three 32-bit words).  A solve reads the key's seed word
through a pointer and moves the key on by one tick on the device, so that
a CUDA graph of the tick draws a new stream at every replay.  The MPO
temperature and its Adam moments are tensors on the solver's device
(:class:`AdamState`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch

AUTO_LAMBDA_MODES = ("MPO", "LBPS", "ESSPS")


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """Configuration of the MPPI solver (names and defaults of the reference)."""

    horizon: int
    num_samples: int
    dim_state: int
    dim_control: int
    u_min: Tuple[float, ...]
    u_max: Tuple[float, ...]
    sigmas: Tuple[float, ...]
    lambda_: Union[float, str]
    lbps_delta: float = 0.01
    essps_target_ess: Optional[float] = None
    lambda_min: float = 0.01
    lambda_max: float = 10.0
    exploration: float = 0.0
    use_sg_filter: bool = False
    sg_window_size: int = 5
    sg_poly_order: int = 3
    dtype: torch.dtype = torch.float32
    seed: int = 42
    store_rollouts: bool = True
    essps_iters: int = 40
    lbps_iters: int = 32
    kernel_backend: str = "auto"

    def __post_init__(self):
        if self.horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {self.horizon}")
        if self.num_samples < 1:
            raise ValueError(f"num_samples must be >= 1, got {self.num_samples}")
        for name in ("u_min", "u_max", "sigmas"):
            if len(getattr(self, name)) != self.dim_control:
                raise ValueError(
                    f"{name} must have length dim_control={self.dim_control}"
                )
        if isinstance(self.lambda_, str):
            if self.lambda_ not in AUTO_LAMBDA_MODES:
                raise ValueError(
                    "lambda_ takes a fixed float temperature or one of the "
                    "auto-tuning modes 'MPO' / 'LBPS' / 'ESSPS'"
                )
        elif not isinstance(self.lambda_, (float, int)):
            raise ValueError(
                "lambda_ takes a fixed float temperature or one of the "
                "auto-tuning modes 'MPO' / 'LBPS' / 'ESSPS'"
            )
        if self.use_sg_filter:
            if self.sg_window_size % 2 == 0 or self.sg_window_size <= self.sg_poly_order:
                raise ValueError(
                    "the SG filter needs an odd sg_window_size larger than "
                    "sg_poly_order"
                )
            if self.sg_window_size // 2 > 2 * self.horizon - 2:
                raise ValueError(
                    "sg_window_size too large for this horizon: the mirror "
                    "pad exceeds the prolonged action signal."
                )
        if not 0.0 <= self.exploration <= 1.0:
            raise ValueError("exploration must be in [0, 1].")
        if self.kernel_backend not in ("auto", "xla", "pallas"):
            raise ValueError("kernel_backend must be 'auto', 'xla' or 'pallas'.")

    @property
    def auto_lambda(self) -> Optional[str]:
        return self.lambda_ if isinstance(self.lambda_, str) else None

    @property
    def initial_lambda(self) -> float:
        """Fixed configs start at their value, auto modes at 1.0."""
        if isinstance(self.lambda_, str):
            return 1.0
        return float(self.lambda_)

    @property
    def target_ess(self) -> float:
        """ESSPS target effective sample size."""
        if self.essps_target_ess is not None:
            return float(self.essps_target_ess)
        return self.num_samples / 10.0

    @property
    def inherited_samples(self) -> int:
        """Samples that inherit the previous solution."""
        return int(self.num_samples * (1.0 - self.exploration))


class AdamState(NamedTuple):
    """Adam's state for the MPO temperature, as ``optax.adam`` keeps it.

    ``count`` is a 0-dim int32 tensor, ``mu`` and ``nu`` 0-dim tensors of the
    solver's dtype, all on the solver's device.
    """

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MPPIState:
    """Cross-tick solver state.

    Attributes:
        previous_action_seq: ``[horizon, dim_control]`` warm start.
        sg_history: ``[horizon-1, dim_control]`` previously applied actions.
        lam: current temperature, a 0-dim tensor on the solver's device.
        seed: host integer; with ``tick`` it names the first tick's noise stream.
        tick: host integer, advanced by one every solve: the ticks run.
        key: the device key the kernels draw from, ``make_key(seed, tick)``
            advanced on the device; ``None`` makes it from the host pair at
            the next solve.  Once made, the key decides every later draw and
            the host pair only counts: a closed loop whose ``done_fn`` fired
            froze the key at the tick it fired, while ``tick`` counts every
            tick the loop ran, so ``make_key(seed, tick)`` then names another
            stream than the state's key.
        mpo_log_temperature: 0-dim tensor; ``init`` sets it to
            ``log(initial_lambda)`` in MPO mode, else 0.
        mpo_opt_state: the MPO temperature's :class:`AdamState` in MPO mode,
            else ``None``.  An MPO solve needs both.
    """

    previous_action_seq: torch.Tensor
    sg_history: torch.Tensor
    lam: torch.Tensor
    seed: int
    tick: int = 0
    mpo_log_temperature: Optional[torch.Tensor] = None
    mpo_opt_state: Optional[AdamState] = None
    key: Optional[torch.Tensor] = None


_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


def tick_seed(seed: int, tick: int) -> int:
    """31-bit kernel seed for one tick: splitmix64 of ``(seed, tick)``, on the host."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(tick) & 0xFFFFFFFF)) & _MASK64
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    z ^= z >> 31
    return int(z & 0x7FFFFFFF)


def _int32(word: int) -> int:
    """A 32-bit word as the int32 of the same bits."""
    word &= _MASK32
    return word - (1 << 32) if word >= 1 << 31 else word


def make_key(seed: int, tick: int, device) -> torch.Tensor:
    """The device key of ``(seed, tick)``: int32 ``[3]`` words (seed, tick, tick_seed).

    The low 32 bits of the seed and the tick, which are all :func:`tick_seed`
    reads, and the tick's kernel seed.  Made on the host and copied once.
    """
    words = (seed, tick, tick_seed(seed, tick))
    return torch.tensor([_int32(w) for w in words], dtype=torch.int32, device=device)


def _mul64(hi: torch.Tensor, lo: torch.Tensor, m: int):
    """``(hi, lo) * m mod 2^64`` on int64 tensors holding 32-bit words."""
    from mppi_playground_tpu_torch.ops.fused_solve import _mulhilo

    m_hi, m_lo = m >> 32, m & _MASK32
    p_hi, p_lo = _mulhilo(lo, m_lo)
    cross = _mulhilo(lo, m_hi)[1] + _mulhilo(hi, m_lo)[1]
    return (p_hi + cross) & _MASK32, p_lo


def _xorshift(hi: torch.Tensor, lo: torch.Tensor, r: int):
    """``z ^ (z >> r)`` for ``0 < r < 32`` on (hi, lo) 32-bit words."""
    return hi ^ (hi >> r), lo ^ (((lo >> r) | (hi << (32 - r))) & _MASK32)


def tick_seed_plain(seed_lo: torch.Tensor, tick_lo: torch.Tensor) -> torch.Tensor:
    """:func:`tick_seed` on int64 tensors of 32-bit words, the device function's twin."""
    lo = tick_lo + (0x9E3779B97F4A7C15 & _MASK32)
    hi = (seed_lo + (0x9E3779B97F4A7C15 >> 32) + (lo >> 32)) & _MASK32
    lo = lo & _MASK32
    hi, lo = _mul64(*_xorshift(hi, lo, 30), 0xBF58476D1CE4E5B9)
    hi, lo = _mul64(*_xorshift(hi, lo, 27), 0x94D049BB133111EB)
    hi, lo = _xorshift(hi, lo, 31)
    return lo & 0x7FFFFFFF


# Scenario b of a fleet seeded with s draws from seed (s + b * SCENARIO_STRIDE) mod 2^32
SCENARIO_STRIDE = 0x9E3779B9


def scenario_seed(seed: int, b: int) -> int:
    """The host seed of scenario ``b`` of a fleet whose batch seed is ``seed``.

    ``(seed + b * 0x9E3779B9) mod 2^32``: the multiplier is odd, so ``b ->
    scenario_seed(seed, b)`` is one to one on ``[0, 2^32)`` and the
    scenarios of a fleet draw from distinct seeds, each through the single
    solver's stream (``make_key``); scenario 0 keeps the low 32 bits of
    ``seed``, all :func:`tick_seed` reads.  The JAX package splits one
    ``PRNGKey`` into B keys, whose stream torch cannot replay.
    """
    return (int(seed) + int(b) * SCENARIO_STRIDE) & _MASK32


def make_batch_key(seed: int, tick: int, batch: int, device) -> torch.Tensor:
    """A fleet's device keys at ``tick``: int32 ``[batch, 3]``, row b ``make_key(scenario_seed(seed, b), tick)``."""
    rows = [(scenario_seed(seed, b), tick, tick_seed(scenario_seed(seed, b), tick))
            for b in range(batch)]
    return torch.tensor([[_int32(w) for w in row] for row in rows], dtype=torch.int32,
                        device=device)


def batch_key(states: "MPPIState", batch: int, device) -> torch.Tensor:
    """A batched state's device keys ``[B, 3]``; made from its host pair where it has none."""
    if states.key is not None:
        return states.key
    return make_batch_key(states.seed, states.tick, batch, device)


def advance_key_plain(key: torch.Tensor) -> torch.Tensor:
    """The key of the next tick, ``devmath::advance_key``'s twin: int32 ``[3]``."""
    words = key.to(torch.int64) & _MASK32
    seed, tick = words[0], (words[1] + 1) & _MASK32
    out = torch.stack([seed, tick, tick_seed_plain(seed, tick)])
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)
