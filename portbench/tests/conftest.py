"""The made-up traces of `test_portbench_readers.py` with the program's
own spans and MoE slot tally added, as a program that records them would
leave them (keys ``spans`` and ``moe_slots``, which `portbench.spans`
reads before the live tracer), so that every reader of a cell, the
readers of spans among them, reads there."""
from __future__ import annotations

import pytest

MS = 1_000_000


def step_spans(t):
    """The program's spans of a made-up step starting at ``t`` ns, whose
    kernels start at t, t + 1 ms and t + 2 ms: the forward (with an MoE
    call) over the first, the backward over the second, AdamW over the
    third, then the NRM."""
    return [("moe.apply", t, t + MS * 8 // 10),
            ("steps.forward", t, t + MS * 9 // 10),
            ("steps.backward", t + MS, t + MS * 19 // 10),
            ("adamw.apply", t + 2 * MS, t + MS * 255 // 100),
            ("steps.train_step", t, t + MS * 26 // 10),
            ("nrm.heartbeat", t + 3 * MS, t + 4 * MS),
            ("nrm.advance", t + 4 * MS, t + 5 * MS),
            ("nrm.control_step", t + 5 * MS, t + 6 * MS)]


def with_program_spans(made_up):
    """``made_up`` whose summaries also hold each step's program spans
    (a step starts where its ``pb.step`` range does) and a slot tally of
    3 filled out of 4."""
    def made_up_with_spans(cell, empty=False):
        summary = made_up(cell, empty=empty)
        summary["spans"] = [s for name, t, _ in summary["ranges"]
                            if name == "pb.step" for s in step_spans(t)]
        summary["moe_slots"] = (3, 4)
        return summary
    return made_up_with_spans


@pytest.fixture(autouse=True)
def _program_spans_in_made_up_traces(request, monkeypatch):
    mod = request.module
    if mod.__name__.endswith("test_portbench_readers"):
        monkeypatch.setattr(mod, "made_up", with_program_spans(mod.made_up))
