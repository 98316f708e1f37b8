"""Racing MPCC with MPPI, one tick at a time, in plain PyTorch: the benchmark's reference.

It imports nothing of the program.  For each tick it works out, from the
plant state, the warm start, the path index and the tick's count:

* the tick's kernel seed: splitmix64 of (solver seed, tick), 31 bits;
* the reference rows: the nearest path point (first minimum), kept
  monotone with the previous index, and a lookahead of 3 m at 0.85 m
  intervals (offsets accumulated in float64), the target speed zeroed for
  the whole horizon once the lookahead runs past the path's end;
* the draws: slot ``f = t*m + j`` of sample k is normal ``f mod 4`` of
  Philox4x32-10 keyed on (seed, k) with counter (f div 4, 0, 0, 0), by
  Box-Muller on 24 bits of each word, times sigma; each sample is the warm
  start plus its draws, clamped to the action bounds;
* the rollout of each sample through the kinematic bicycle (Euler at 0.1 s,
  position clamped to the map, speed to +-8 m/s, steer's tangent by its
  degree-7 series) and the MPCC stage cost at every step, then once more at
  the final state with zero action (contouring and lag error, speed
  tracking, obstacle and lane cells, inputs and their change);
* λ: fixed, or ESSPS's bisection of ESS(λ) = K/10 over [0.01, 10];
* the softmin plan: the samples weighted by exp(-(c - c_min)/λ);
* the plan rolled out from the plant state (the predicted states);
* the plant's step under the applied action.

Every float operation runs in ``dtype`` (float32 for the reference; a lower
precision makes the control).  Ticks are batched over a leading axis ``S``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
SCENARIO_STRIDE = 0x9E3779B9

# the MPCC weights (upstream example/racing.py) and the bicycle
QC, QL, QV, QO, QIN, QDIN = 2.0, 3.0, 2.0, 10000.0, 0.01, 0.5
WHEELBASE, V_MAX, DT = 1.0, 8.0, 0.1


def tick_seed(seed: int, tick: int) -> int:
    """splitmix64 of the seed's and the tick's low 32 bits, cut to 31 bits."""
    mask64 = (1 << 64) - 1
    z = ((seed & MASK32) << 32 | (tick & MASK32)) & mask64
    z = (z + 0x9E3779B97F4A7C15) & mask64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask64
    z ^= z >> 31
    return int(z & 0x7FFFFFFF)


def scenario_seed(seed: int, b: int) -> int:
    """The solver seed of scenario ``b`` of a fleet seeded with ``seed``."""
    return (seed + b * SCENARIO_STRIDE) & MASK32


def key_words(seed: int, tick: int) -> tuple:
    """The device key a solve of ``(seed, tick)`` draws from: (seed, tick, tick seed) as int32."""
    def int32(w):
        w &= MASK32
        return w - (1 << 32) if w >= 1 << 31 else w
    return int32(seed), int32(tick), int32(tick_seed(seed, tick))


def _mulhilo(a, m: int):
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & MASK32


def _philox(c0, c1, c2, c3, k0, k1):
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & MASK32
            k1 = (k1 + _PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _sincos(x):
    """sin and cos on [-pi, pi] by quadrant and octant folding and short Taylor series."""
    ax = torch.abs(x)
    flip = ax > math.pi / 2
    r = torch.where(flip, math.pi - ax, ax)
    swap = r > math.pi / 4
    t = torch.where(swap, math.pi / 2 - r, r)
    t2 = t * t
    sp = t * (1.0 + t2 * (-1.0 / 6.0 + t2 * (1.0 / 120.0 + t2 * (-1.0 / 5040.0
                                                                 + t2 * (1.0 / 362880.0)))))
    cp = 1.0 + t2 * (-0.5 + t2 * (1.0 / 24.0 + t2 * (-1.0 / 720.0 + t2 * (1.0 / 40320.0))))
    s = torch.where(swap, cp, sp)
    c = torch.where(swap, sp, cp)
    return torch.where(x < 0, -s, s), torch.where(flip, -c, c)


def _normals(b1, b2, dtype):
    u1 = (b1 & 0xFFFFFF).to(dtype) * (2.0**-24) + (2.0**-25)
    u2 = (b2 & 0xFFFFFF).to(dtype) * (2.0**-24)
    radius = torch.sqrt(-2.0 * torch.log(u1))
    s, c = _sincos(2.0 * math.pi * u2 - math.pi)
    return radius * -c, radius * -s


def draws(tick_seeds, num_samples: int, horizon: int, m: int, dtype, device):
    """Standard normals ``[S, K, T, m]`` of the tick seeds ``[S]`` (host ints)."""
    quads = -(-horizon * m // 4)
    seeds = torch.tensor([s & MASK32 for s in tick_seeds], dtype=torch.int64,
                         device=device)[:, None, None]
    k = torch.arange(num_samples, dtype=torch.int64, device=device)[None, :, None]
    q = torch.arange(quads, dtype=torch.int64, device=device)[None, None, :]
    shape = (len(tick_seeds), num_samples, quads)
    q = q.expand(shape)
    zero = torch.zeros_like(q)
    w0, w1, w2, w3 = _philox(q, zero, zero, zero, seeds.expand(shape), k.expand(shape))
    a0, a1 = _normals(w0, w1, dtype)
    b0, b1 = _normals(w2, w3, dtype)
    z = torch.stack([a0, a1, b0, b1], dim=-1).reshape(len(tick_seeds), num_samples, 4 * quads)
    return z[..., :horizon * m].reshape(len(tick_seeds), num_samples, horizon, m)


class Racing:
    """The racing problem on ``device`` in ``dtype``: the scene's path and grids, the bounds."""

    def __init__(self, scene, solver: dict, dtype=torch.float32, device="cpu"):
        self.dtype, self.device = dtype, torch.device(device)
        self.path = torch.as_tensor(scene.path, dtype=dtype, device=self.device)
        self.obstacles = torch.as_tensor(scene.obstacle_grid != 0, device=self.device)
        self.lanes = torch.as_tensor(scene.lane_grid != 0, device=self.device)
        self.origin = scene.origin
        self.cell = torch.full((), scene.cell_size, dtype=dtype, device=self.device)
        self.x_lim, self.y_lim = scene.x_lim, scene.y_lim
        self.u_min = tuple(float(v) for v in solver["u_min"])
        self.u_max = tuple(float(v) for v in solver["u_max"])
        self.sigmas = tuple(float(v) for v in solver["sigmas"])
        self.horizon = int(solver["horizon"])
        self.num_samples = int(solver["num_samples"])
        self.lambda_ = solver["lambda_"]
        self.lambda_range = (float(solver.get("lambda_min", 0.01)),
                             float(solver.get("lambda_max", 10.0)))
        self.essps_iters = int(solver.get("essps_iters", 40))
        # stored rollouts are the unfused route, which sums the cost in the upstream order
        self.upstream_order = bool(solver.get("store_rollouts", False))
        ref = solver["reference"]
        travel, offsets = float(ref["lookahead_distance"]), []
        for _ in range(self.horizon + 1):
            travel += float(ref["reference_path_interval"])
            offsets.append(int(round(travel / float(ref["path_spacing"]))))
        self.offsets = torch.tensor(offsets, dtype=torch.int64, device=self.device)

    # -- the model ---------------------------------------------------------
    def _wrap(self, a):
        return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi

    def step(self, xs, us):
        """One bicycle step of ``xs = (x, y, theta, v)`` under ``us = (accel, steer)``."""
        x, y, theta, v = xs
        accel_dt = torch.clamp(us[0], self.u_min[0], self.u_max[0]) * DT
        steer = torch.clamp(us[1], self.u_min[1], self.u_max[1])
        s2 = steer * steer
        tan = steer * (1.0 + s2 * (1.0 / 3.0 + s2 * (2.0 / 15.0 + s2 * (17.0 / 315.0))))
        theta = self._wrap(theta)
        sin_t, cos_t = _sincos(theta)
        return (torch.clamp(x + v * cos_t * DT, self.x_lim[0], self.x_lim[1]),
                torch.clamp(y + v * sin_t * DT, self.y_lim[0], self.y_lim[1]),
                self._wrap(theta + v * tan / WHEELBASE * DT),
                torch.clamp(v + accel_dt, -V_MAX, V_MAX))

    def _cells(self, x, y):
        w, h = self.obstacles.shape
        ix = torch.round(x / self.cell + self.origin[0])
        iy = torch.round(y / self.cell + self.origin[1])
        off = (ix < 0) | (ix >= w) | (iy < 0) | (iy >= h)
        # a NaN position reads cell 0; the integer clamp keeps a low precision's rounding in
        ixi = torch.nan_to_num(torch.clamp(ix, 0.0, float(w - 1)), nan=0.0).to(torch.int64)
        iyi = torch.nan_to_num(torch.clamp(iy, 0.0, float(h - 1)), nan=0.0).to(torch.int64)
        ixi, iyi = ixi.clamp(0, w - 1), iyi.clamp(0, h - 1)
        return ((off | self.obstacles[ixi, iyi]).to(x.dtype)
                + (off | self.lanes[ixi, iyi]).to(x.dtype))

    def stage_cost(self, xs, us, prev_us, row):
        """The MPCC stage cost; ``row`` holds ``(x, y, sin yaw, cos yaw, v)`` broadcastable.

        Summed in one of two orders, which round apart by a few units in the
        last place: the upstream example's (``q * e**2``, the inputs' squares
        summed before their weight), which the unfused route keeps, or the
        fused kernels' (``q * e * e``, each input term weighted).  A softmin
        at λ=1 over costs of 1e5 (a rollout off the lane pays 1e4 a step)
        turns such a rounding into a weight change of a few percent, so the
        reference sums in the order of the route it is held against.
        """
        x, y, _, v = xs
        rx, ry, sin_yaw, cos_yaw, rv = row
        dx, dy = x - rx, y - ry
        ec = sin_yaw * dx - cos_yaw * dy
        el = -cos_yaw * dx - sin_yaw * dy
        dv = v - rv
        d0, d1 = us[0] - prev_us[0], us[1] - prev_us[1]
        if self.upstream_order:
            cost = QC * (ec * ec) + QL * (el * el) + QV * (dv * dv) + QO * self._cells(x, y)
            inputs = QIN * (us[0] * us[0] + us[1] * us[1])
            return cost + (inputs + QDIN * (d0 * d0 + d1 * d1))
        cost = QC * ec * ec + QL * el * el + QV * (dv * dv) + QO * self._cells(x, y)
        inputs = QIN * us[0] * us[0] + QIN * us[1] * us[1]
        return cost + (inputs + (QDIN * (d0 * d0) + QDIN * (d1 * d1)))

    # -- a tick ------------------------------------------------------------
    def reference_rows(self, x, cind):
        """``(rows [S, T+1, 5], new index [S])`` from plant states ``[S, 4]``, indices ``[S]``."""
        n = self.path.shape[0]
        dx = self.path[None, :, 0] - x[:, 0:1]
        dy = self.path[None, :, 1] - x[:, 1:2]
        nearest = torch.argmin(torch.sqrt(dx * dx + dy * dy), dim=1)
        ind = torch.maximum(cind, nearest)
        rows = ind[:, None] + self.offsets
        full = torch.all(rows < n, dim=1, keepdim=True)
        pose = self.path[torch.clamp(rows, max=n - 1)]
        speed = torch.where(full, torch.full_like(pose[..., 0], V_MAX),
                            torch.zeros_like(pose[..., 0]))
        yaw = pose[..., 2]
        return torch.stack([pose[..., 0], pose[..., 1], torch.sin(yaw), torch.cos(yaw), speed],
                           dim=-1), ind

    def costs(self, x0, samples, rows):
        """Costs ``[S, K]`` of the action sequences ``samples [S, K, T, m]``."""
        horizon = samples.shape[2]
        xs = tuple(x0[:, None, c].expand(samples.shape[:2]) for c in range(4))
        total = torch.zeros(samples.shape[:2], dtype=self.dtype, device=self.device)

        def at(t):
            return tuple(samples[:, :, t, j] for j in range(2))

        def row(t):
            return tuple(rows[:, t, c, None] for c in range(5))

        for t in range(horizon):
            total = total + self.stage_cost(xs, at(t), at(max(t - 1, 0)), row(t))
            xs = self.step(xs, at(t))
        zero = torch.zeros_like(total)
        return total + self.stage_cost(xs, (zero, zero), at(max(horizon - 2, 0)),
                                       row(horizon - 1))

    def essps(self, costs):
        """λ [S] at which the effective sample size of the softmin is K/10, by bisection."""
        lo = torch.full(costs.shape[:1], self.lambda_range[0], dtype=self.dtype,
                        device=self.device)
        hi = torch.full_like(lo, self.lambda_range[1])
        target = self.num_samples / 10.0
        d = torch.min(costs, dim=1, keepdim=True).values - costs

        def ess(lam):
            e = torch.exp(d * (1.0 / lam[:, None]))
            return e.sum(dim=1) ** 2 / (e * e).sum(dim=1)

        at_lo, at_hi = ess(lo), ess(hi)
        a, b = lo, hi
        for _ in range(self.essps_iters):
            mid = 0.5 * (a + b)
            below = ess(mid) < target
            a, b = torch.where(below, mid, a), torch.where(below, b, mid)
        root = 0.5 * (a + b)
        return torch.where(target <= at_lo, lo, torch.where(target >= at_hi, hi, root))

    def rollout(self, x0, plan):
        """Predicted states ``[S, T+1, 4]`` of the plans ``[S, T, m]`` from ``x0 [S, 4]``."""
        xs = tuple(x0[:, c] for c in range(4))
        states = [torch.stack(xs, dim=-1)]
        for t in range(plan.shape[1]):
            xs = self.step(xs, (plan[:, t, 0], plan[:, t, 1]))
            states.append(torch.stack(xs, dim=-1))
        return torch.stack(states, dim=1)

    def plant(self, x, u):
        """The plant's next states ``[S, 4]`` under actions ``u [S, m]``."""
        xs = self.step(tuple(x[:, c] for c in range(4)), (u[:, 0], u[:, 1]))
        return torch.stack(xs, dim=-1)

    def tick(self, x0, warm, cind, tick_seeds, lam=None):
        """One MPPI tick of S problems.

        ``x0 [S, 4]``, ``warm [S, T, m]``, ``cind [S]`` int64, ``tick_seeds``
        S host ints; ``lam`` a fixed temperature (None: the configuration's,
        or ESSPS's search).  Returns a dict of ``plan [S, T, m]``, ``states
        [S, T+1, 4]``, ``lam [S]``, ``cind [S]``.
        """
        x0 = x0.to(self.device, self.dtype)
        warm = warm.to(self.device, self.dtype)
        rows, new_cind = self.reference_rows(x0, cind.to(self.device))
        sig = torch.tensor(self.sigmas, dtype=self.dtype, device=self.device)
        lo = torch.tensor(self.u_min, dtype=self.dtype, device=self.device)
        hi = torch.tensor(self.u_max, dtype=self.dtype, device=self.device)
        noise = draws(tick_seeds, self.num_samples, self.horizon, 2, self.dtype, self.device)
        samples = torch.clamp(warm[:, None] + noise * sig, lo, hi)
        del noise
        costs = self.costs(x0, samples, rows)
        if lam is None:
            if self.lambda_ == "ESSPS":
                lam = self.essps(costs)
            else:
                lam = torch.full(costs.shape[:1], float(self.lambda_), dtype=self.dtype,
                                 device=self.device)
        s = -costs / lam[:, None]
        e = torch.exp(s - s.max(dim=1, keepdim=True).values)
        plan = torch.einsum("sk,sktm->stm", e, samples) / e.sum(dim=1)[:, None, None]
        return dict(plan=plan, states=self.rollout(x0, plan), lam=lam, cind=new_cind)


def start_states(path: np.ndarray, indices) -> np.ndarray:
    """Plant states ``[S, 4]`` at rest on path points ``indices``, heading along the path."""
    p = path[np.asarray(indices)]
    return np.column_stack([p[:, 0], p[:, 1], p[:, 2], np.zeros(len(p))]).astype(np.float32)
