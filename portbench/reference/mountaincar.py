"""The continuous mountain car with MPPI, one tick at a time, in plain PyTorch: the benchmark's
reference.

It imports nothing of the program.  The model is upstream's
(kohonda/mppi_playground ``example/mountaincar.py:17-55``, gymnasium's
MountainCarContinuous-v0 physics): the state is (position, velocity), the
action a force clamped to [-1, 1]; a step adds ``force * 0.0015 - 0.0025 *
cos(3 * position)`` to the velocity, clamps it to +-0.07, adds it to the
position and clamps that to [-1.2, 0.6]; the cost of a state is ``(0.45 -
position)^2``.  For each tick it works out, from the plant state, the warm
start and the tick's count, with the solver of ``example/mountaincar.py:66-77``
(T=100, K=1,000, sigma 1, λ 0.1 fixed):

* the draws: ``draws`` of ``portbench/reference/racing.py`` at m = 1 (slot t
  of sample k is normal ``t mod 4`` of Philox4x32-10 keyed on (tick seed, k)
  with counter (t div 4, 0, 0, 0), Box-Muller), times sigma; each sample is
  the warm start plus its draws, clamped to the action bounds;
* the rollout of each sample: the cost of the state before each of the T
  steps, summed in step order onto a zero total, then the terminal cost of
  the final state; the states ``[K, T+1, 2]`` kept;
* the softmin at λ: ``e = exp(s - max s)`` of ``s = -c / λ``, and the plan,
  the samples weighted by ``e / sum e``;
* the plan rolled out from the plant state (the predicted states ``[T+1, 2]``);
* the warm start's shift: none, the next warm start is the plan itself, as
  upstream's MPPI keeps its last optimal sequence;
* the plant's step under the applied action.

Departures from upstream, each the port's: the noise stream is Philox's, not
torch's global generator; the stage cost is summed onto a zero total in step
order and the terminal cost added last (upstream sums the same terms); the
square is ``d * d``; gymnasium's env, but not the example's model, sets a
negative velocity to 0 at the left wall, and the reference follows the
model.

Every float operation runs in ``dtype`` (float32 for the reference; a lower
precision makes the control), with TF32 off.  Ticks are batched over a
leading axis ``S``.
"""

from __future__ import annotations

import torch

from portbench.reference.racing import draws

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

POWER, GRAVITY = 0.0015, 0.0025
MIN_POSITION, MAX_POSITION, MAX_SPEED = -1.2, 0.6, 0.07
GOAL = 0.45


class MountainCar:
    """The mountain car's MPPI on ``device`` in ``dtype``, at the solver settings given."""

    def __init__(self, solver: dict, dtype=torch.float32, device="cpu"):
        self.dtype, self.device = dtype, torch.device(device)
        self.u_min = tuple(float(v) for v in solver["u_min"])
        self.u_max = tuple(float(v) for v in solver["u_max"])
        self.sigmas = tuple(float(v) for v in solver["sigmas"])
        self.horizon = int(solver["horizon"])
        self.num_samples = int(solver["num_samples"])
        self.lambda_ = float(solver["lambda_"])

    # -- the model ---------------------------------------------------------
    def step(self, position, velocity, force):
        """One step of states ``(position, velocity)`` under ``force``, each a tensor."""
        force = torch.clamp(force, -1.0, 1.0)
        velocity = velocity + force * POWER - GRAVITY * torch.cos(3 * position)
        velocity = torch.clamp(velocity, -MAX_SPEED, MAX_SPEED)
        position = torch.clamp(position + velocity, MIN_POSITION, MAX_POSITION)
        return position, velocity

    @staticmethod
    def cost(position):
        d = GOAL - position
        return d * d

    # -- a tick ------------------------------------------------------------
    def rollouts(self, x0, samples):
        """``(costs [S, K], states [S, K, T+1, 2])`` of ``samples [S, K, T, 1]`` from
        ``x0 [S, 2]``."""
        shape = samples.shape[:2]
        position = x0[:, None, 0].expand(shape)
        velocity = x0[:, None, 1].expand(shape)
        total = torch.zeros(shape, dtype=self.dtype, device=self.device)
        states = [torch.stack([position, velocity], dim=-1)]
        for t in range(samples.shape[2]):
            total = total + self.cost(position)
            position, velocity = self.step(position, velocity, samples[:, :, t, 0])
            states.append(torch.stack([position, velocity], dim=-1))
        return total + self.cost(position), torch.stack(states, dim=2)

    def rollout(self, x0, plan):
        """Predicted states ``[S, T+1, 2]`` of the plans ``[S, T, 1]`` from ``x0 [S, 2]``."""
        position, velocity = x0[:, 0], x0[:, 1]
        states = [torch.stack([position, velocity], dim=-1)]
        for t in range(plan.shape[1]):
            position, velocity = self.step(position, velocity, plan[:, t, 0])
            states.append(torch.stack([position, velocity], dim=-1))
        return torch.stack(states, dim=1)

    def plant(self, x, u):
        """The plant's next states ``[S, 2]`` under actions ``u [S, 1]``."""
        return torch.stack(self.step(x[:, 0], x[:, 1], u[:, 0]), dim=-1)

    def tick(self, x0, warm, tick_seeds):
        """One MPPI tick of S problems.

        ``x0 [S, 2]``, ``warm [S, T, 1]``, ``tick_seeds`` S host ints.  Returns
        a dict of ``plan [S, T, 1]`` (the next warm start too), ``states
        [S, T+1, 2]``, ``costs [S, K]`` and ``rollouts [S, K, T+1, 2]``.
        """
        x0 = x0.to(self.device, self.dtype)
        warm = warm.to(self.device, self.dtype)
        sig = torch.tensor(self.sigmas, dtype=self.dtype, device=self.device)
        lo = torch.tensor(self.u_min, dtype=self.dtype, device=self.device)
        hi = torch.tensor(self.u_max, dtype=self.dtype, device=self.device)
        noise = draws(tick_seeds, self.num_samples, self.horizon, 1, self.dtype, self.device)
        samples = torch.clamp(warm[:, None] + noise * sig, lo, hi)
        del noise
        costs, rollouts = self.rollouts(x0, samples)
        lam = torch.full(costs.shape[:1], self.lambda_, dtype=self.dtype, device=self.device)
        s = -costs / lam[:, None]
        e = torch.exp(s - s.max(dim=1, keepdim=True).values)
        plan = torch.einsum("sk,sktm->stm", e, samples) / e.sum(dim=1)[:, None, None]
        return dict(plan=plan, states=self.rollout(x0, plan), costs=costs, rollouts=rollouts)
