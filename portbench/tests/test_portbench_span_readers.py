"""The readers of the program's spans (`portbench.spans`): the card's idle
time goes to the innermost span open over it, split by overlap, and the
readers of kernels launched inside spans read the made-up trace's
kernels."""
from __future__ import annotations

import pytest

from portbench import spans, spec
from portbench.tests import _tiny
from portbench.tests.conftest import step_spans

MS = 1_000_000


def test_idle_goes_to_the_innermost_span_split_by_overlap():
    """One step of kernels at 0-1, 2-3 and 9-10 ms in a 10 ms stretch
    (idle 1-2 and 3-9 ms), under a step span 0-8 ms holding a forward
    0-1.5 ms and an optimizer 2.5-4 ms, and the NRM 5-6 ms outside it:
    the gap 1-2 ms is 0.5 ms forward, 0.5 ms step; the gap 3-9 ms is 1 ms
    optimizer, 1 ms step, 1 ms NRM, 2 ms step and 1 ms under no span."""
    events = [("k", 0, MS, None), ("k", 2 * MS, MS, None),
              ("k", 9 * MS, MS, None)]
    summary = {"events": events, "window_s": 0.010, "spans": [
        ("steps.forward", 0, MS * 3 // 2),
        ("adamw.apply", MS * 5 // 2, 4 * MS),
        ("steps.train_step", 0, 8 * MS),
        ("nrm.control_step", 5 * MS, 6 * MS)]}
    by = spans.idle_by_span(summary)
    assert by == pytest.approx({"steps.forward": 0.5e-3,
                                "steps.train_step": 3.5e-3,
                                "adamw.apply": 1e-3,
                                "nrm.control_step": 1e-3, None: 1e-3})
    ctx = {"trace": summary}
    for name, want in (("idle_step.train", 35.0), ("idle_fwd.train", 5.0),
                       ("idle_opt.train", 10.0), ("idle_nrm.train", 10.0)):
        assert spec.reader(name)(ctx) == pytest.approx(want), name
    assert spec.reader("idle_bwd.train")(ctx) is None  # no such span


def test_span_readers_count_the_kernels_launched_inside_their_spans():
    """Two made-up training steps, each with one kernel launched inside
    ``adamw.apply`` (0.4 ms), two inside the NRM's spans and one after
    them, and a control period each: AdamW reads 0.4 ms a step, the NRM
    two launches a period, and the slot tally 3 of 4 reads 75%."""
    events, t0 = [], [0, 20 * MS]
    for t in t0:
        events += [("adam", t + 2 * MS + 10, 400_000, t + 2 * MS + 5),
                   ("nrm", t + 3 * MS + 10, 1_000, t + 3 * MS + 5),
                   ("nrm", t + 5 * MS + 10, 1_000, t + 5 * MS + 5),
                   ("other", t + 7 * MS + 10, 1_000, t + 7 * MS + 5)]
    summary = {"events": events, "host_events": events, "ranges": [],
               "host_notes": {"steps": [1, 1]}, "window_s": 0.04,
               "spans": [s for t in t0 for s in step_spans(t)],
               "moe_slots": (3, 4)}
    ctx = {"trace": summary}
    assert spec.reader("adamw_span_ms")(ctx) == pytest.approx(0.4)
    assert spec.reader("nrm_launches.train")(ctx) == pytest.approx(2.0)
    assert spec.reader("moe_fill.prefill")(ctx) == pytest.approx(75.0)
    assert spec.reader("moe_span_ms.prefill")(
        {"trace": {**summary, "host_notes": {"lengths": [1]}}}) is None


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_span_readers_read_none_without_program_spans(name):
    """Where the trace holds no program span and no slot tally, as a
    program that records none leaves it, every reader of spans reads
    None."""
    events = [("k", 0, MS, 0), ("k", 2 * MS, MS, 2 * MS)]
    summary = {"events": events, "host_events": events, "ranges": [],
               "host_notes": {"steps": [1], "lengths": [1]},
               "window_s": 0.003, "spans": [], "moe_slots": (0, 0)}
    span_metrics = {"idle_step.train", "idle_fwd.train", "idle_bwd.train",
                    "idle_opt.train", "idle_nrm.train", "nrm_launches.train",
                    "adamw_span_ms", "moe_span_ms.prefill",
                    "moe_fill.prefill"}
    for m in spec.cell(name).per_layer:
        if m["name"] in span_metrics:
            assert spec.reader(m["name"])({"trace": summary}) is None, \
                m["name"]
