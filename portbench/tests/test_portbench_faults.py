"""A run with the timed path broken underneath comes out not correct.

The look for a card is skipped (the CPU runs the kernels' plain twins, on
the same path) and the rest of a run is driven at a small size, once for
each fault a cell can have:

* a step that returns its state unchanged (the warm start and the key stay);
* half of the batch left out, the mean taken over the rest (the softmin
  weighs only the first half of each solve's samples);
* an answer altered where it is produced (the tail's plan, or the unfused
  route's, moved by 0.01);

The exchange between chips does not exist on the one card every cell takes.
"""

from __future__ import annotations

import pytest

from mppi_playground_tpu_torch.core import fused_solver, solver
from mppi_playground_tpu_torch.ops import fused_solve, weighted_update
from portbench.tests.common import CELLS, line_of


def state_unchanged(monkeypatch):
    def keep(config, state, *args, **kwargs):
        return state

    monkeypatch.setattr(fused_solver, "advance_state", keep)
    monkeypatch.setattr(solver, "advance_state", keep)


def half_the_batch(monkeypatch):
    for module in (fused_solve, weighted_update):
        plain = module.block_partials_plain

        def first_half(costs, flat, lam, plain=plain):
            kept = costs.clone()
            kept[costs.shape[0] // 2:] = 1e30
            return plain(kept, flat, lam)

        monkeypatch.setattr(module, "block_partials_plain", first_half)


def answer_altered(monkeypatch):
    tail = fused_solve.fused_tick_tail_plain

    def moved_tail(*args, **kwargs):
        action_seq, *rest = tail(*args, **kwargs)
        return (action_seq + 0.01, *rest)

    advance = solver.smooth_predict_advance

    def moved_plan(*args, **kwargs):
        action_seq, *rest = advance(*args, **kwargs)
        return (action_seq + 0.01, *rest)

    monkeypatch.setattr(fused_solve, "fused_tick_tail_plain", moved_tail)
    monkeypatch.setattr(solver, "smooth_predict_advance", moved_plan)


FAULTS = {"state_unchanged": state_unchanged, "half_the_batch": half_the_batch,
          "answer_altered": answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    line = line_of(workload, seed=31)
    failed = [k for k, c in line["checks"].items() if not c["value"] <= c["limit"]]
    assert line["correct"] is False and failed, line["checks"]


def test_the_same_run_unbroken_is_correct():
    assert line_of("racing_ref.control_xla", seed=31)["correct"] is True
