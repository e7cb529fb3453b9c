"""The plain references against the port at a tiny size on the CPU
(float32 on both sides): the same numbers, so a reading of the full-size
cells measures the program's precision and nothing of the reference's
mathematics. The control (the reference in float8) reads far above."""
from __future__ import annotations

import pytest

from portbench import calibrate
from portbench.tests import _tiny

CELLS = _tiny.CELLS


def numbers(got: dict) -> dict:
    """The readings that are numbers (not the per-request record)."""
    return {k: v for k, v in got.items() if isinstance(v, float)}


@pytest.fixture(scope="module")
def readings():
    return {name: calibrate.readings(name, 7, 0.0, True,
                                     ctx=_tiny.ctx(name)) for name in CELLS}


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_agrees_with_the_port(readings, name):
    got = numbers(readings[name]["program"])
    assert got and all(v < 1e-5 for v in got.values()), got


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_far_above_the_port(readings, name):
    prog = numbers(readings[name]["program"])
    ctl = numbers(readings[name]["control"])
    assert any(ctl[k] > 100 * max(prog[k], 1e-7) for k in prog), (prog, ctl)
