"""Navigation2D with MPPI, one tick at a time, in plain PyTorch: the benchmark's reference.

It imports nothing of the program.  The scene is worked out again in numpy
from upstream's description (kohonda/mppi_playground
``src/envs/navigation_2d.py:34-58``): a 20 x 20 m map at 0.1 m cells with
the world origin at cell (100, 100); 7 disks of radius 1 m and then 7
2 x 2 m rectangles placed by rejection sampling inside +-7.5 m from
``numpy.random.default_rng(42)`` (each obstacle's center x, center y, then
its radius, or its width and height), redrawn while it overlaps one placed
before; a disk rasterized around its rounded center cell, a rectangle from
its ceiled center cell.  For each tick it works out, from the plant state,
the warm start and the tick's count:

* the draws: ``draws`` of ``portbench/reference/racing.py`` (Philox4x32-10
  keyed on the tick's seed and the sample, Box-Muller; its polynomial sin
  and cos serve the heading here too), times sigma; each
  sample is the warm start plus its draws, clamped to the action bounds;
* the rollout of each sample through the unicycle (Euler at 0.1 s: the
  heading wrapped into [-pi, pi), v clamped to [0, 2] m/s and omega to
  [-1, 1] rad/s, the position clamped to the map) and the cost at every
  state before a step and once more at the final state: the distance to the
  goal (9, 9) plus 10,000 times the occupancy of the position's cell (1 off
  the map);
* λ: ESSPS's bisection of ESS(λ) = the target (K/10 unless the
  configuration sets it) over [λ_min, λ_max];
* the softmin weights exp(-(c - c_min)/λ) / their sum, and the plan, the
  samples weighted by them; the plan rolled out from the plant state (the
  predicted states); the next warm start is the plan;
* the top n samples by weight (a stable descending sort: among equal
  weights the lower index first) with their rollouts;
* the plant's step under the applied action.

Departures from upstream (``src/envs/navigation_2d.py:70-71,257-279`` and
its MPPI), each the port's: the noise stream is Philox's, not torch's
global generator; sin and cos of the heading are the polynomial on [-pi, pi]
that the port's kernels evaluate (within about 1e-7 of ``torch.sin``), so
that positions agree to the bit and no sample lands in another cell than the
program's; a position's cell divides by the cell size as an IEEE division
(a tensor divisor: a CUDA division by a Python scalar multiplies by its
reciprocal); the top n by a stable sort where upstream calls ``torch.topk``,
whose order among ties is not defined.

Every float operation runs in ``dtype`` (float32 for the reference; a lower
precision makes the control).  Ticks are batched over a leading axis ``S``.
"""

from __future__ import annotations

import dataclasses
import math
from math import ceil

import numpy as np
import torch

from portbench.reference.racing import _sincos, draws

U_MIN, U_MAX = (0.0, -1.0), (2.0, 1.0)
DT = 0.1
OBSTACLE_WEIGHT = 10000.0


@dataclasses.dataclass(frozen=True)
class Scene:
    """A navigation deployment's host data: the grid ``[W, H]`` (1 blocked), the origin cell,
    the cell size, the position clamp, the start and the goal."""

    grid: np.ndarray
    origin: tuple
    cell_size: float
    x_lim: tuple
    y_lim: tuple
    start: tuple
    goal: tuple


def _draw(rng, lo, hi, sizes, overlaps, max_tries):
    """One obstacle ``(center, sizes)``, drawn (center x, center y, then each size) until
    ``overlaps(center, sizes)`` is false."""
    for _ in range(max_tries):
        center = np.array([rng.uniform(lo[0], hi[0]), rng.uniform(lo[1], hi[1])])
        size = tuple(rng.uniform(*r) for r in sizes)
        if not overlaps(center, size):
            return center, size
    raise RuntimeError(f"no free spot for an obstacle in {max_tries} tries")


def scene(config: dict) -> Scene:
    """The scene of a navigation configuration (its file's ``scene``)."""
    s = config["scene"]
    cell = float(s["cell_size"])
    cells = (ceil(s["map_size"][0] / cell), ceil(s["map_size"][1] / cell))
    origin = np.array([cells[0] / 2, cells[1] / 2]).astype(int)
    x_lim = (-cell * cells[0] / 2, cell * cells[0] / 2)
    y_lim = (-cell * cells[1] / 2, cell * cells[1] / 2)
    spread = s["obstacle_spread"]
    lo = (max(spread[0], x_lim[0]), max(spread[0], y_lim[0]))
    hi = (min(spread[1], x_lim[1]), min(spread[1], y_lim[1]))
    rng = np.random.default_rng(int(s["obstacle_seed"]))
    tries = int(s["max_tries"])
    disks, rects = [], []

    def near(center, other):
        return np.linalg.norm(other - center)

    def disk_overlaps(center, size):
        (r,) = size
        return (any(near(center, c) <= rc + r for c, (rc,) in disks)
                or any(near(center, c) <= w / 2 + r and near(center, c) <= h / 2 + r
                       for c, (w, h) in rects))

    def rect_overlaps(center, size):
        w, h = size
        return (any(near(center, c) <= rc + w / 2 and near(center, c) <= rc + h / 2
                    for c, (rc,) in disks)
                or any(near(center, c) <= wr / 2 + w / 2 and near(center, c) <= hr / 2 + h / 2
                       for c, (wr, hr) in rects))

    for _ in range(int(s["circles"])):
        disks.append(_draw(rng, lo, hi, [s["circle_radius"]], disk_overlaps, tries))
    for _ in range(int(s["rectangles"])):
        rects.append(_draw(rng, lo, hi, [s["rectangle_width"], s["rectangle_height"]],
                           rect_overlaps, tries))
    grid = np.zeros(cells)
    for center, (r,) in disks:
        at = np.round(center / cell + origin).astype(int)
        reach = ceil(r / cell)
        offsets = np.arange(-reach, reach + 1)
        ii, jj = np.meshgrid(offsets, offsets, indexing="ij")
        inside = ii**2 + jj**2 <= reach**2
        grid[np.clip(at[0] + ii[inside], 0, cells[0] - 1),
             np.clip(at[1] + jj[inside], 0, cells[1] - 1)] = 1
    for center, (w, h) in rects:
        at = np.ceil(center / cell + origin).astype(int)
        half_w, half_h = ceil(ceil(w / cell) / 2), ceil(ceil(h / cell) / 2)
        x0, x1 = (np.clip(at[0] + d, 0, cells[0] - 1) for d in (-half_w, half_w))
        y0, y1 = (np.clip(at[1] + d, 0, cells[1] - 1) for d in (-half_h, half_h))
        grid[x0:x1, y0:y1] = 1
    return Scene(grid, (float(origin[0]), float(origin[1])), cell, x_lim, y_lim,
                 tuple(float(v) for v in s["start"]), tuple(float(v) for v in s["goal"]))


class Navigation:
    """The navigation problem on ``device`` in ``dtype``: the grid, the goal, the bounds."""

    def __init__(self, scene: Scene, solver: dict, dtype=torch.float32, device="cpu"):
        # the plan's weighted sum is a matrix product: in float32, never in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dtype, self.device = dtype, torch.device(device)
        self.blocked = torch.as_tensor(scene.grid != 0, device=self.device)
        self.origin = scene.origin
        self.cell = torch.full((), scene.cell_size, dtype=dtype, device=self.device)
        self.x_lim, self.y_lim, self.goal = scene.x_lim, scene.y_lim, scene.goal
        self.u_min = tuple(float(v) for v in solver["u_min"])
        self.u_max = tuple(float(v) for v in solver["u_max"])
        self.sigmas = tuple(float(v) for v in solver["sigmas"])
        self.horizon = int(solver["horizon"])
        self.num_samples = int(solver["num_samples"])
        self.lambda_range = (float(solver["lambda_min"]), float(solver["lambda_max"]))
        self.essps_iters = int(solver["essps_iters"])
        target = solver.get("essps_target_ess")
        self.target = self.num_samples / 10.0 if target is None else float(target)

    # -- the model ---------------------------------------------------------
    def _wrap(self, a):
        return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi

    def step(self, xs, us):
        """One unicycle step of ``xs = (x, y, theta)`` under ``us = (v, omega)``."""
        x, y, theta = xs
        theta = self._wrap(theta)
        v = torch.clamp(us[0], self.u_min[0], self.u_max[0])
        turn = torch.clamp(us[1], self.u_min[1], self.u_max[1]) * DT
        sin_t, cos_t = _sincos(theta)
        return (torch.clamp(x + v * cos_t * DT, self.x_lim[0], self.x_lim[1]),
                torch.clamp(y + v * sin_t * DT, self.y_lim[0], self.y_lim[1]),
                self._wrap(theta + turn))

    def occupancy(self, x, y):
        """1 where ``(x, y)`` is on a blocked cell or off the map, else 0."""
        w, h = self.blocked.shape
        ix = torch.round(x / self.cell + self.origin[0])
        iy = torch.round(y / self.cell + self.origin[1])
        off = (ix < 0) | (ix >= w) | (iy < 0) | (iy >= h)
        # a NaN position reads cell 0; the integer clamp keeps a low precision's rounding in
        ixi = torch.nan_to_num(torch.clamp(ix, 0.0, float(w - 1)), nan=0.0).to(torch.int64)
        iyi = torch.nan_to_num(torch.clamp(iy, 0.0, float(h - 1)), nan=0.0).to(torch.int64)
        return (off | self.blocked[ixi.clamp(0, w - 1), iyi.clamp(0, h - 1)]).to(x.dtype)

    def cost(self, xs):
        """The stage cost of states ``xs``: the distance to the goal plus the weighted
        occupancy (the action does not enter it)."""
        x, y, _ = xs
        dx, dy = x - self.goal[0], y - self.goal[1]
        return torch.sqrt(dx * dx + dy * dy) + OBSTACLE_WEIGHT * self.occupancy(x, y)

    # -- a tick ------------------------------------------------------------
    def rollouts(self, x0, samples):
        """``(costs [S, K], states [S, K, T+1, 3])`` of the action sequences ``samples [S, K,
        T, m]`` from ``x0 [S, 3]``."""
        xs = tuple(x0[:, None, c].expand(samples.shape[:2]) for c in range(3))
        total = torch.zeros(samples.shape[:2], dtype=self.dtype, device=self.device)
        states = [torch.stack(xs, dim=-1)]
        for t in range(samples.shape[2]):
            total = total + self.cost(xs)
            xs = self.step(xs, (samples[:, :, t, 0], samples[:, :, t, 1]))
            states.append(torch.stack(xs, dim=-1))
        return total + self.cost(xs), torch.stack(states, dim=2)

    def essps(self, costs):
        """λ [S] at which the softmin's effective sample size is the target, by bisection."""
        lo = torch.full(costs.shape[:1], self.lambda_range[0], dtype=self.dtype,
                        device=self.device)
        hi = torch.full_like(lo, self.lambda_range[1])
        d = torch.min(costs, dim=1, keepdim=True).values - costs

        def ess(lam):
            e = torch.exp(d * (1.0 / lam[:, None]))
            return e.sum(dim=1) ** 2 / (e * e).sum(dim=1)

        at_lo, at_hi = ess(lo), ess(hi)
        a, b = lo, hi
        for _ in range(self.essps_iters):
            mid = 0.5 * (a + b)
            below = ess(mid) < self.target
            a, b = torch.where(below, mid, a), torch.where(below, b, mid)
        root = 0.5 * (a + b)
        inside = torch.where(self.target >= at_hi, hi, root)
        return torch.where(self.target <= at_lo, lo, inside)

    def rollout(self, x0, plan):
        """Predicted states ``[S, T+1, 3]`` of the plans ``[S, T, m]`` from ``x0 [S, 3]``."""
        xs = tuple(x0[:, c] for c in range(3))
        states = [torch.stack(xs, dim=-1)]
        for t in range(plan.shape[1]):
            xs = self.step(xs, (plan[:, t, 0], plan[:, t, 1]))
            states.append(torch.stack(xs, dim=-1))
        return torch.stack(states, dim=1)

    def plant(self, x, u):
        """The plant's next states ``[S, 3]`` under actions ``u [S, m]``."""
        return torch.stack(self.step(tuple(x[:, c] for c in range(3)), (u[:, 0], u[:, 1])),
                           dim=-1)

    def tick(self, x0, warm, tick_seeds, top: int = 0):
        """One MPPI tick of S problems.

        ``x0 [S, 3]``, ``warm [S, T, m]``, ``tick_seeds`` S host ints, ``top``
        the rows of the top samples wanted.  Returns a dict of ``plan [S, T,
        m]``, ``states [S, T+1, 3]``, ``lam [S]``, ``weights [S, K]``,
        ``rollouts [S, K, T+1, 3]`` (every sample's), and ``top_rows``,
        ``top_weights [S, top]``.
        """
        x0 = x0.to(self.device, self.dtype)
        warm = warm.to(self.device, self.dtype)
        sig = torch.tensor(self.sigmas, dtype=self.dtype, device=self.device)
        lo = torch.tensor(self.u_min, dtype=self.dtype, device=self.device)
        hi = torch.tensor(self.u_max, dtype=self.dtype, device=self.device)
        noise = draws(tick_seeds, self.num_samples, self.horizon, 2, self.dtype, self.device)
        samples = torch.clamp(warm[:, None] + noise * sig, lo, hi)
        del noise
        costs, rollouts = self.rollouts(x0, samples)
        lam = self.essps(costs)
        s = -costs / lam[:, None]
        e = torch.exp(s - s.max(dim=1, keepdim=True).values)
        total = e.sum(dim=1)
        plan = torch.einsum("sk,sktm->stm", e, samples) / total[:, None, None]
        weights = e / total[:, None]
        order = torch.sort(weights, dim=1, descending=True, stable=True)
        return dict(plan=plan, states=self.rollout(x0, plan), lam=lam, weights=weights,
                    rollouts=rollouts, top_rows=order.indices[:, :top],
                    top_weights=order.values[:, :top])
