"""Temperature (lambda) auto-tuning on tensors: ESSPS, LBPS and MPO.

Counterpart of ``mppi_playground_tpu/core/autolambda.py``.  Every search
is a fixed number of branchless iterations on device tensors, so nothing
here reads a value back to the host:

* ESSPS bisects the monotone map ``ESS(lambda)`` towards the target ESS,
  with the reference's bracket clamps;
* LBPS runs a golden-section search on the negated LBPS lower bound,
  carrying the surviving objective value from one iteration to the next;
* MPO takes one Adam step on ``log_temperature``.

The unfused solver (``core/solver.py``) uses these functions, as the JAX
package's XLA path does; the fused solver uses the search kernels of
``ops/lambda_search.py`` at every sample count.  Scalars are 0-dim tensors made with ``torch.full``
(a fill, not a host-to-device copy) on the costs' device.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from mppi_playground_tpu_torch.core.config import AdamState

# torch.optim.Adam([log_temperature], lr=0.2) in the upstream controller
MPO_LEARNING_RATE = 0.2
MPO_EPSILON = 0.1
# optax.adam's defaults, which the JAX package takes
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """Stable logsumexp over a flat vector, in the reference's form."""
    m = torch.max(x)
    return m + torch.log(torch.sum(torch.exp(x - m)))


def fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed pairwise order, whatever the leading axes.

    The axis is padded with zeros to a power of two and halved until one
    element is left (``x[:h] + x[h:]``).  Elementwise adds only, so each row
    of a ``[B, K]`` tensor sums to the bits of the same ``[K]`` vector alone:
    torch's own reductions pick their order by the shape, B included.
    """
    n = x.shape[-1]
    width = 1 << max(0, (n - 1).bit_length())
    if width != n:
        x = torch.cat([x, x.new_zeros(*x.shape[:-1], width - n)], dim=-1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def ess_from_costs(costs: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """ESS of ``softmax(-costs / lam)``: ``exp(2 lse(s) - lse(2 s))``."""
    s = -costs / lam
    return torch.exp(2.0 * _logsumexp(s) - _logsumexp(2.0 * s))


def essps_lambda(
    costs: torch.Tensor,
    target_ess: float,
    lambda_min: float,
    lambda_max: float,
    iters: int = 40,
) -> torch.Tensor:
    """Bisection on ``ESS(lambda) = target`` over ``[lambda_min, lambda_max]``.

    Clamps to the bound whose ESS already satisfies the target, as the
    reference does.  Returns a 0-dim tensor.
    """
    lam_min = _scalar(lambda_min, costs)
    lam_max = _scalar(lambda_max, costs)
    target = _scalar(target_ess, costs)
    ess_at_min = ess_from_costs(costs, lam_min)
    ess_at_max = ess_from_costs(costs, lam_max)
    a, b = lam_min, lam_max
    for _ in range(iters):
        mid = 0.5 * (a + b)
        below = ess_from_costs(costs, mid) < target  # the root lies above mid
        a, b = torch.where(below, mid, a), torch.where(below, b, mid)
    root = 0.5 * (a + b)
    return torch.where(
        target <= ess_at_min, lam_min, torch.where(target >= ess_at_max, lam_max, root)
    )


def lbps_objective(costs: torch.Tensor, lam: torch.Tensor, delta: float) -> torch.Tensor:
    """Negated LBPS lower bound ``-(E_w[-c] - range(c) sqrt((1-delta)/delta) / sqrt(ESS))``."""
    s = -costs / lam
    w = torch.softmax(s, dim=0)
    ess = 1.0 / torch.sum(w * w)
    expected_return = -torch.sum(w * costs)
    cost_range = torch.max(costs) - torch.min(costs)
    penalty = cost_range * torch.sqrt(_scalar((1.0 - delta) / delta, costs)) / torch.sqrt(ess)
    return -(expected_return - penalty)


def lbps_lambda(
    costs: torch.Tensor,
    delta: float,
    lambda_min: float,
    lambda_max: float,
    iters: int = 32,
) -> torch.Tensor:
    """Golden-section search of :func:`lbps_objective` on ``[lambda_min, lambda_max]``.

    One fresh objective evaluation an iteration: the surviving interior
    point keeps its value.  Returns a 0-dim tensor.
    """
    invphi = _scalar((math.sqrt(5.0) - 1.0) / 2.0, costs)
    a = _scalar(lambda_min, costs)
    b = _scalar(lambda_max, costs)
    c = b - (b - a) * invphi
    d = a + (b - a) * invphi
    fc = lbps_objective(costs, c, delta)
    fd = lbps_objective(costs, d, delta)
    for _ in range(iters):
        shrink_right = fc < fd  # the minimum lies in [a, d]
        new_a = torch.where(shrink_right, a, c)
        new_b = torch.where(shrink_right, d, b)
        fresh_lo = new_b - (new_b - new_a) * invphi
        fresh_hi = new_a + (new_b - new_a) * invphi
        x = torch.where(shrink_right, fresh_lo, fresh_hi)
        fx = lbps_objective(costs, x, delta)
        c, fc, d, fd = (
            torch.where(shrink_right, x, d),
            torch.where(shrink_right, fx, fd),
            torch.where(shrink_right, c, x),
            torch.where(shrink_right, fc, fx),
        )
        a, b = new_a, new_b
    return 0.5 * (a + b)


def mpo_init(initial_lambda: float, like: torch.Tensor) -> Tuple[torch.Tensor, AdamState]:
    """``(log_temperature, AdamState)`` at the start, on ``like``'s device."""
    log_t = torch.log(_scalar(initial_lambda, like))
    zero = torch.zeros_like(log_t)
    count = torch.zeros((), dtype=torch.int32, device=like.device)
    return log_t, AdamState(count=count, mu=zero, nu=zero.clone())


def mpo_step(
    costs: torch.Tensor, log_temperature: torch.Tensor, opt_state: AdamState
) -> Tuple[torch.Tensor, torch.Tensor, AdamState]:
    """One MPO temperature update -> ``(new_lambda, new_log_t, new_opt_state)``.

    Loss ``softplus(log_t) * (eps + lse(-costs / softplus(log_t)))`` with
    eps = 0.1.  Its gradient is taken in closed form, in the order JAX's
    reverse mode takes it: with ``t = softplus(log_t)`` and ``w =
    softmax(-costs / t)``, ``dL/dt = (eps + lse) + t * (sum(w * costs) /
    (t * t))`` and ``dL/dlog_t = dL/dt * sigmoid(log_t)``.  Then one Adam
    step at lr 0.2 in ``optax.adam``'s order.  As in the reference, the new
    lambda is read back as ``exp(log_t)``, not ``softplus(log_t)``.

    ``costs [..., K]`` with the other arguments ``[...]``: a fleet's
    ``[B, K]`` steps each scenario as its own ``[K]`` would, bit for bit
    (the sums are :func:`fold_sum`'s; the max is exact in any order).
    """
    temperature = torch.nn.functional.softplus(log_temperature)
    s = -costs / temperature[..., None]
    m = torch.max(s, dim=-1, keepdim=True).values
    e = torch.exp(s - m)
    z = fold_sum(e)
    lse = m[..., 0] + torch.log(z)
    w = e / z[..., None]
    grad_t = (MPO_EPSILON + lse) + temperature * (
        fold_sum(w * costs) / (temperature * temperature)
    )
    grad = grad_t * torch.sigmoid(log_temperature)

    mu = (1 - ADAM_B1) * grad + ADAM_B1 * opt_state.mu
    nu = (1 - ADAM_B2) * (grad * grad) + ADAM_B2 * opt_state.nu
    count = opt_state.count + 1
    mu_hat = mu / (1 - ADAM_B1**count).to(mu.dtype)
    nu_hat = nu / (1 - ADAM_B2**count).to(nu.dtype)
    update = -MPO_LEARNING_RATE * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
    new_log_t = log_temperature + update
    return torch.exp(new_log_t), new_log_t, AdamState(count=count, mu=mu, nu=nu)
