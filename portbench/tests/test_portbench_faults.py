"""A run with its timed path broken underneath comes out not correct:
each fault a cell can have, planted at a tiny size on the CPU and read
against the cell's own limits."""
from __future__ import annotations

import pytest

from portbench import calibrate
from portbench.tests import _tiny

CASES = [("sc2-3b.train-power", "state_unchanged"),
         ("sc2-3b.train-power", "half_batch"),
         ("sc2-3b.train-power", "answer_altered"),
         ("jamba-52b.prefill-pool", "answer_altered"),
         ("jamba-52b.prefill-pool", "slots_swapped"),
         ("jamba-52b.prefill-pool", "bucket_swapped")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_is_not_correct(name, fault):
    got = calibrate.readings(name, 7, 0.0, False, ctx=_tiny.ctx(name),
                             faults=(fault,))["faults"][fault]
    limits = _tiny.cell(name).limits
    assert any(got[k] > lim for k, lim in limits.items()), (got, limits)
