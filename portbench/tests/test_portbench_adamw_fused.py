"""The reader of ``adamw_fused.train``: a made-up summary's own tally
first, else the program's (`optim.adamw.FUSED`), and nothing where
neither holds an element."""
from __future__ import annotations

import sys
import types

import pytest

from portbench import spec

READ = spec.reader("adamw_fused.train")


def test_the_reader_takes_a_made_up_summarys_tally():
    assert READ({"trace": {"adamw_fused": (3, 4)}}) == pytest.approx(75.0)
    assert READ({"trace": {"adamw_fused": [8, 8]}}) == pytest.approx(100.0)
    assert READ({"trace": {"adamw_fused": (0, 0)}}) is None


def test_the_reader_reads_the_programs_tally(monkeypatch):
    from repro_torch.optim import adamw
    monkeypatch.setitem(adamw.FUSED, "kernel", 6)
    monkeypatch.setitem(adamw.FUSED, "all", 8)
    assert READ({"trace": {}}) == pytest.approx(75.0)
    monkeypatch.setitem(adamw.FUSED, "kernel", 0)
    monkeypatch.setitem(adamw.FUSED, "all", 0)
    assert READ({"trace": {}}) is None


def test_the_reader_reads_nothing_from_a_program_without_the_tally(
        monkeypatch):
    """A program without the tally (the parent's `optim.adamw` has no
    `fused_tally`) or without the module reads None and raises nothing."""
    monkeypatch.setitem(sys.modules, "repro_torch.optim.adamw",
                        types.ModuleType("repro_torch.optim.adamw"))
    assert READ({"trace": {}}) is None
    monkeypatch.delitem(sys.modules, "repro_torch.optim.adamw")
    assert READ({"trace": {}}) is None
