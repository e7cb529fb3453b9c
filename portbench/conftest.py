"""The made-up traces of `tests/test_portbench_readers.py` with the
program's AdamW tally added (key ``adamw_fused``: 3 of 4 elements by the
kernels), as a program that keeps it would leave them and as the reader
of ``adamw_fused.train`` takes it before the program's own, so that every
reader of a cell reads there."""
from __future__ import annotations

import pytest


@pytest.fixture(autouse=True)
def _adamw_tally_in_made_up_traces(request, monkeypatch):
    mod = request.module
    if not mod.__name__.endswith("test_portbench_readers"):
        return
    made_up = mod.made_up

    def made_up_with_tally(cell, empty=False):
        summary = made_up(cell, empty=empty)
        summary["adamw_fused"] = (3, 4)
        return summary

    monkeypatch.setattr(mod, "made_up", made_up_with_tally)
