"""The control on the card at each cell's own size: the reference in
float8 put in the program's place comes out not correct on three seeds.
Needs the card (marker ``cuda``); it skips without one. On the chip:

    PYTHONPATH=src python -m pytest -q -m cuda portbench/tests/test_portbench_control.py
"""
from __future__ import annotations

import pytest

from portbench import calibrate
from portbench.tests import _tiny

CELLS = _tiny.CELLS
SEEDS = (8101, 8102, 8103)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(card, name):
    limits = _tiny.cell(name).limits
    for seed in SEEDS:
        got = calibrate.readings(name, seed, 2.0, True, device=card,
                                 cell=_tiny.cell(name))
        assert all(got["program"][k] <= lim for k, lim in limits.items()), got
        assert any(got["control"][k] > lim for k, lim in limits.items()), got
