"""Every per-layer metric's reader on a made-up trace of its cell: it
reads a number where the trace holds its kernels and ranges, and nothing
where it holds none; the breakdown names the longest device operations
and the idle gaps by host range."""
from __future__ import annotations

import pytest

from portbench import roofline, spec, trace
from portbench.roofline import model as rmodel
from portbench.tests import _tiny

CELLS = _tiny.CELLS


def metrics(cell):
    """(name, source) of the cell's per-layer metrics."""
    return [(m["name"], m["source"]) for m in cell.per_layer]

KERNELS = {"train": ["flash_bwd_delta_wgmma_kernel", "nvjet_gemm",
                     "elementwise_kernel"],
           "prefill_pool": ["flash_fwd_wgmma_kernel",
                            "selective_scan_seq_kernel", "nvjet_gemm"]}


def made_up(cell, empty=False):
    """A summary of two stretches of 4 steps: each step's kernels 1 ms
    apart, every host op inside ``pb.step`` and, within it, ``pb.adamw``
    and ``pb.moe``."""
    kind = cell.traffic["driver"]
    s = cell.config["as_run"]
    n_attn = sum(p[0] == "attn" for p in s["pattern"]) * \
        s["num_layers"] // len(s["pattern"])
    n_mamba = s["num_layers"] - n_attn
    steps, events, ranges = 4, [], []
    t = 0
    for i in range(steps):
        ranges += [("pb.step", t, t + 20_000_000),
                   ("pb.adamw", t, t + 15_000_000),
                   ("pb.moe", t, t + 15_000_000)]
        for name in ([] if empty else KERNELS[kind]):
            events.append((name, t, 500_000, t + 1))
            t += 1_000_000
        t += 10_000_000
    notes = {"train": {"steps": [1] * steps},
             "prefill_pool": {"lengths": [1024] * steps}}[kind]
    counters = {"flash_fwd": n_attn * steps, "flash_bwd": n_attn * steps,
                "scan_seq": n_mamba * steps}
    return {"events": events, "counters": counters, "notes": notes,
            "busy_s": 0.5e-3 * len(events), "window_s": t / 1e9,
            "host_events": events, "ranges": ranges, "dev_ranges": [],
            "host_notes": notes, "host_window_s": t / 1e9}


def ctx_for(cell, summary):
    kind = cell.traffic["driver"]
    n = 10
    host = {"step_s": [0.5] * n, "nrm_ms": [1.0] * n,
            "traced": [False] * n, "batch_s": [0.1] * n,
            "lengths": [1024] * n}
    return {"trace": summary, "host": host, "spec": cell.config["as_run"],
            "traffic": cell.traffic, "roofline": roofline, "model": rmodel,
            "window_s": 5.0, "kind": kind}


@pytest.mark.parametrize("name", CELLS)
def test_each_reader_reads_its_cells_trace(name):
    cell = _tiny.cell(name)
    ctx = ctx_for(cell, made_up(cell))
    for m, _ in metrics(cell):
        v = spec.reader(m)(ctx)
        assert v is not None and v >= 0, m


@pytest.mark.parametrize("name", CELLS)
def test_a_kernel_reader_reads_nothing_where_no_kernel_ran(name):
    cell = _tiny.cell(name)
    ctx = ctx_for(cell, made_up(cell, empty=True))
    for m, source in metrics(cell):
        if m.endswith("_roofline") or m.endswith("_ms") \
                and source == "device_trace":
            assert spec.reader(m)(ctx) is None, m


def test_the_breakdown_names_ops_and_gaps():
    cell = spec.cell(CELLS[0])
    b = trace.breakdown(made_up(cell))
    assert set(b) == {"device_ops", "idle_gaps"}
    assert b["device_ops"] and len(b["device_ops"]) <= 10
    assert b["idle_gaps"][0][0] == "host: pb.adamw"
    assert trace.union_ns([(0, 5), (3, 8), (10, 12)]) == 10
