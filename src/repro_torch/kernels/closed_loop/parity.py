"""The parity bar between two closed-loop runs on the same inputs: the
CUDA kernel against its plain version on the card, or the plain version
against the JAX reference on the CPU.

Why it is not bitwise: an ulp of difference in an upstream ``exp`` can
flip the heartbeat count ``floor(lam + sqrt(lam) z + 0.5)`` by one beat.
So counts and masks must be equal; at least 99.9% of progress entries
equal at rtol 1e-5; caps within 1e-2 W; the energy/work integrals and
the summary sums at rtol 1e-5; and each run's histograms must hold the
same total with at most 2 counts moved.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

EXACT_FINALS = ("t", "steps", "done", "count")
RTOL_FINALS = ("energy", "work", "power_sum", "progress_sum",
               "progress_sq_sum")
HISTS = ("progress_hist", "pcap_hist")
RTOL = 1e-5
PCAP_ATOL = 1e-2          # watts
PROGRESS_EQUAL_SHARE = 0.999
MAX_MOVED = 2             # histogram counts per run

# Shapes at which the kernel is held against its plain version on the
# card (chip_smoke.py and tests/test_torch_cuda.py), each in trace and
# summary mode: (profiles, repeats of them, max_time, total_work). The
# first five are the reference kernel test's CASES; the last is a ragged
# batch of 280 runs (not a multiple of the kernel's 64-run block) in
# which some runs finish early.
CARD_CASES = (
    (("gros", "dahu"), 4, 96.0, 1e9),
    (("yeti",), 16, 64.0, 1e9),
    (("v5e-chip",), 4, 64.0, 1e9),
    (("gros",), 8, 48.0, 150.0),
    (("gros", "dahu", "yeti"), 2, 64.0, 1e9),
    (("gros", "dahu", "yeti", "v5e-host"), 70, 200.0, 3000.0),
)
CARD_SUMMARY_FROM = 5.0   # steps before the summaries start


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.float64)


def check_parity(traces: Optional[Mapping], final: Mapping,
                 ref_traces: Optional[Mapping], ref_final: Mapping,
                 tag: str = "") -> float:
    """Raise AssertionError unless (traces, final) match (ref_traces,
    ref_final) at the bar above; return the largest |difference| over
    every compared output. Leaves are tensors or arrays of one layout
    (the `ref.closed_loop_ref` contract)."""
    worst = 0.0

    def diff(a, b):
        nonlocal worst
        d = np.abs(_np(a) - _np(b))
        worst = max(worst, float(d.max()) if d.size else 0.0)
        return d

    def fail(msg):
        raise AssertionError(f"{tag}: {msg}" if tag else msg)

    for k in EXACT_FINALS:
        if diff(final[k], ref_final[k]).max() != 0:
            fail(f"final {k} differs")
    for k in RTOL_FINALS:
        d = diff(final[k], ref_final[k])
        if (d > RTOL * np.abs(_np(ref_final[k]))).any():
            fail(f"final {k} beyond rtol {RTOL}: max |diff| {d.max()}")
    if diff(final["pcap"], ref_final["pcap"]).max() > PCAP_ATOL:
        fail("final pcap beyond 1e-2 W")
    for k in ("progress_l", "prev_error", "prev_pcap_l", "anchor_gap"):
        diff(final[k], ref_final[k])  # reported, not bounded
    for k in HISTS:
        a, b = _np(final[k]), _np(ref_final[k])
        diff(a, b)
        if not np.array_equal(a.sum(-1), b.sum(-1)):
            fail(f"{k} totals differ")
        moved = 0.5 * np.abs(a - b).sum(-1).max()
        if moved > MAX_MOVED:
            fail(f"{k}: {moved} counts moved in one run")
    if (traces is None) != (ref_traces is None):
        fail("one run has traces, the other not")
    if traces is None:
        return worst
    for k in ("t", "valid"):
        if diff(traces[k], ref_traces[k]).max() != 0:
            fail(f"trace {k} differs")
    a, b = _np(traces["progress"]), _np(ref_traces["progress"])
    diff(a, b)
    share = np.isclose(a, b, rtol=RTOL, atol=0.0).mean()
    if share < PROGRESS_EQUAL_SHARE:
        fail(f"progress equal on only {share:.6f} of entries")
    if diff(traces["pcap"], ref_traces["pcap"]).max() > PCAP_ATOL:
        fail("trace pcap beyond 1e-2 W")
    for k in ("energy", "work"):
        d = diff(traces[k], ref_traces[k])
        if (d > RTOL * np.abs(_np(ref_traces[k]))).any():
            fail(f"trace {k} beyond rtol {RTOL}")
    diff(traces["power"], ref_traces["power"])
    return worst
