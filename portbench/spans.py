"""The program's own spans (`repro_torch.obs.trace`) laid over a traced
run's device events: both are on the profiler's clock (Unix-epoch ns),
so a span belongs to the stretch whose events it overlaps. The readers of
the ``idle_*``, ``*_span_ms``, ``nrm_launches`` and ``moe_fill`` metrics
share these. A program that records no spans or keeps no slot tally
gives nothing here, and those readers read None."""
from __future__ import annotations

import bisect
import sys
from typing import Dict, List, Optional, Tuple

from portbench.trace import in_range

Span = Tuple[str, int, int]  # name, start ns, end ns


def program_spans(summary: dict) -> List[Span]:
    """The summary's own ``spans`` where it holds them (a made-up trace),
    else every span the program's tracer recorded in this process."""
    if "spans" in summary:
        return list(summary["spans"])
    mod = sys.modules.get("repro_torch.obs.trace")
    get = getattr(mod.get_tracer(), "spans", None) if mod else None
    return [] if get is None else [(s.name, s.start_ns, s.end_ns)
                                   for s in get()]


def _overlapping(spans: List[Span], lo: int, hi: int) -> List[Span]:
    return [s for s in spans if s[1] <= hi and s[2] >= lo]


def card_spans(summary: dict) -> List[Span]:
    """The spans over the card's stretch: between its first and last
    device event."""
    evs = summary["events"]
    if not evs:
        return []
    hi = max(s + d for _, s, d, _ in evs)
    return _overlapping(program_spans(summary), evs[0][1], hi)


def host_spans(summary: dict) -> List[Span]:
    """The spans over the host's stretch: between its first host op,
    range or device event and its last."""
    evs, ranges = summary["host_events"], summary["ranges"]
    lo = [s for _, s, _, _ in evs] + [h for *_, h in evs if h is not None] \
        + [s for _, s, _ in ranges]
    hi = [s + d for _, s, d, _ in evs] + [e for _, _, e in ranges]
    if not lo:
        return []
    return _overlapping(program_spans(summary), min(lo), max(hi))


def innermost(spans: List[Span]) -> List[Tuple[int, int, str]]:
    """Disjoint (start, end, name) pieces of the spans' union, each named
    by the innermost span open over it (the latest to start, the shortest
    among those)."""
    points = sorted({t for _, s, e in spans for t in (s, e)})
    out = []
    for p, q in zip(points, points[1:]):
        open_ = [s for s in spans if s[1] <= p and s[2] >= q]
        if open_:
            name = max(open_, key=lambda s: (s[1], -s[2]))[0]
            out.append((p, q, name))
    return out


def idle_gaps(events: list) -> List[Tuple[int, int]]:
    """The intervals between the first and the last device event (sorted
    by start) in which none ran."""
    gaps, end = [], None
    for _, s, d, _ in events:
        if end is not None and s > end:
            gaps.append((end, s))
        end = s + d if end is None else max(end, s + d)
    return gaps


def idle_by_span(summary: dict) -> Optional[Dict[Optional[str], float]]:
    """Seconds of the card's stretch with no device event, between its
    first and last, by the innermost program span open over each part
    (None: under no span), split by overlap; None without a span over
    the stretch."""
    spans = card_spans(summary)
    if not spans:
        return None
    pieces = innermost(spans)
    starts = [p for p, _, _ in pieces]
    out: Dict[Optional[str], float] = {}
    for a, b in idle_gaps(summary["events"]):
        covered = 0
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(pieces) and pieces[i][0] < b:
            p, q, name = pieces[i]
            ov = min(b, q) - max(a, p)
            if ov > 0:
                out[name] = out.get(name, 0.0) + ov / 1e9
                covered += ov
            i += 1
        out[None] = out.get(None, 0.0) + (b - a - covered) / 1e9
    return out


def idle_under(ctx, match) -> Optional[float]:
    """100 x the idle seconds under the spans whose name ``match``
    accepts, over the card's stretch; None where no such span lies over
    it."""
    tr = ctx["trace"]
    by = idle_by_span(tr)
    if by is None or not any(match(n) for n, _, _ in card_spans(tr)):
        return None
    return 100.0 * sum(v for n, v in by.items()
                       if n is not None and match(n)) / tr["window_s"]


def launched_in(summary: dict, spans: List[Span]) -> List[tuple]:
    """The host stretch's device events launched by a host op that
    started inside any of ``spans`` (`trace.in_range` over them)."""
    over = {**summary, "ranges": spans, "dev_ranges": []}
    return list({ev: None for name in {s[0] for s in spans}
                 for ev in in_range(over, name)})


def span_ms(ctx, name: str, per: str) -> Optional[float]:
    """Device ms of the kernels launched inside the host stretch's spans
    ``name``, a step (``per``: the host notes' key that counts them);
    None where none ran."""
    tr = ctx["trace"]
    n = len(tr["host_notes"].get(per, []))
    evs = launched_in(tr, [s for s in host_spans(tr) if s[0] == name])
    ns = sum(d for _, _, d, _ in evs)
    return ns / 1e6 / n if n and ns > 0 else None


def moe_slots(summary: dict) -> Optional[Tuple[int, int]]:
    """(slots filled, slots computed) of the MoE calls made while the
    program's spans recorded: the summary's own ``moe_slots`` where it
    holds them (a made-up trace), else the program's tally."""
    if "moe_slots" in summary:
        return tuple(summary["moe_slots"])
    mod = sys.modules.get("repro_torch.models.moe")
    fill = getattr(mod, "slot_fill", None)
    return None if fill is None else fill()
