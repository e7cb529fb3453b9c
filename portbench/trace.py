"""The traced run's reading of the device: `torch.profiler` over two
bounded steady stretches of the window (`Tracer`), their raw kineto
events kept in memory and reduced to device events, host ranges, busy
time and the launch counters' deltas. Nothing is written to disk.

Host ranges: the drivers wrap their own calls (``pb.*``), and while the
stretch is traced `optim.adamw.apply_adamw` (as `launch.steps` calls it)
and `models.moe.moe_apply` are wrapped from outside in ``pb.adamw`` and
``pb.moe``. A device kernel belongs to a range when the host op that
launched it started inside the range."""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Tuple

COUNTERS = {
    "flash_fwd": ("repro_torch.kernels.flash_attention.kernel", "LAUNCHES"),
    "flash_bwd": ("repro_torch.kernels.flash_attention.kernel",
                  "BWD_LAUNCHES"),
    "scan_seq": ("repro_torch.kernels.selective_scan.kernel",
                 "ROUTE_LAUNCHES", "seq"),
}
WRAPPED = (("repro_torch.launch.steps", "apply_adamw", "pb.adamw"),
           ("repro_torch.models.moe", "moe_apply", "pb.moe"))


def counters() -> Dict[str, int]:
    import importlib
    out = {}
    for name, (mod, attr, *key) in COUNTERS.items():
        v = getattr(importlib.import_module(mod), attr)
        out[name] = int(v[key[0]] if key else v)
    return out


class NoTrace:
    """The untraced run: spans cost nothing and nothing is recorded."""
    active = False

    def span(self, name: str):
        return contextlib.nullcontext()

    def tick(self, n: int, skip: int, length: int):
        pass

    def note(self, key, value):
        pass


class _Stretch:
    """One stretch of the window under `torch.profiler`."""

    def __init__(self, host: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.host = host
        self.notes: Dict[str, list] = {}
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host else []))
        self.prof.start()
        torch.cuda.synchronize()
        self.c0 = counters()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.deltas = {k: v - self.c0[k] for k, v in counters().items()}
        self.prof.stop()


class Tracer(NoTrace):
    """Two stretches of the window under `torch.profiler`, each ``length``
    steps (or batches) long, one after the other from step ``skip``: the
    first records the card alone (the busy time, the idle share, each
    kernel's time and calls: recording host ops slows the host and
    inflates idle time), the second the host too (ranges, and the idle
    gaps by what the host was doing)."""

    def __init__(self):
        self.stretches: List[_Stretch] = []
        self._saved = []

    @property
    def active(self) -> bool:
        return bool(self.stretches) and not hasattr(self.stretches[-1],
                                                    "window_s")

    def span(self, name: str):
        if not (self.active and self.stretches[-1].host):
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def note(self, key, value):
        if self.active:
            self.stretches[-1].notes.setdefault(key, []).append(value)

    def tick(self, n: int, skip: int, length: int):
        """Called before step ``n`` of the window (0 first)."""
        if n == skip:
            self.stretches.append(_Stretch(host=False))
        elif n == skip + length:
            self.stop()
            self._wrap()
            self.stretches.append(_Stretch(host=True))
        elif n == skip + 2 * length:
            self.stop()

    def _wrap(self):
        import importlib
        from torch.profiler import record_function
        for mod, attr, label in WRAPPED:
            m = importlib.import_module(mod)
            fn = getattr(m, attr)

            def wrapped(*a, _fn=fn, _label=label, **k):
                with record_function(_label):
                    return _fn(*a, **k)

            self._saved.append((m, attr, fn))
            setattr(m, attr, functools.wraps(fn)(wrapped))

    def stop(self):
        """Ends the open stretch (and the wrapping), if one is open."""
        if self.active:
            self.stretches[-1].stop()
        for m, attr, fn in self._saved:
            setattr(m, attr, fn)
        self._saved = []

    def summary(self) -> dict:
        """From the card's stretch: device events (name, start ns,
        duration ns), busy seconds (their union), the stretch's seconds,
        the counters' deltas and the drivers' notes. From the host's:
        its device events (with the start ns of the host op that launched
        each, or None), host ranges (name, start ns, end ns), the ranges'
        spans on the card and its notes. Raises when a stretch holds no
        device event."""
        card, host = (_events(s) for s in self.stretches)
        a, b = self.stretches
        return {"events": card[0], "counters": a.deltas, "notes": a.notes,
                "busy_s": union_ns([(s, s + d) for _, s, d, _ in card[0]])
                / 1e9, "window_s": a.window_s,
                "host_events": host[0], "ranges": host[1],
                "dev_ranges": host[2], "host_notes": b.notes,
                "host_window_s": b.window_s}


def _events(stretch: _Stretch):
    """(device events, host ranges, ranges' spans on the card) of a
    stretch, from the profiler's raw kineto events (`prof.events()` builds
    a tree an event, too slow over 10^5 launches)."""
    from torch.autograd import DeviceType
    raw = stretch.prof.profiler.kineto_results
    host_start: Dict[int, int] = {}
    ranges: List[Tuple[str, int, int]] = []
    dev_ranges: List[Tuple[str, int, int]] = []
    dev: List[tuple] = []
    for ev in raw.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if not _runtime_call(name):  # ops and ranges, not API calls
                host_start[ev.correlation_id()] = ev.start_ns()
            if name.startswith("pb."):
                ranges.append((name, ev.start_ns(), ev.end_ns()))
        elif ev.device_type() == DeviceType.CUDA:
            if name.startswith("pb."):  # the range's span on the card
                dev_ranges.append((name, ev.start_ns(), ev.end_ns()))
                continue
            hidden = getattr(ev, "is_hidden_event", lambda: False)()
            if hidden or ev.is_user_annotation():
                continue
            dev.append((name, ev.start_ns(), ev.duration_ns(),
                        ev.linked_correlation_id()))
    if not dev:
        raise RuntimeError("a traced stretch holds no device events: the "
                           "profiler did not trace the card")
    dev = [(n, s, d, host_start.get(c)) for n, s, d, c in dev]
    dev.sort(key=lambda e: e[1])
    return dev, ranges, dev_ranges


def union_ns(intervals: List[Tuple[int, int]]) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _runtime_call(name: str) -> bool:
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def in_range(summary: dict, name: str) -> List[tuple]:
    """The device events of ``summary`` that belong to host range
    ``name``: launched by a host op that started inside it or, where the
    trace links no kernel to a host op, run inside the range's span on
    the card."""
    host = [(s, e) for n, s, e in summary["ranges"] if n == name]
    evs = summary["host_events"]
    if any(h is not None for _, _, _, h in evs):
        return [ev for ev in evs if ev[3] is not None
                and any(s <= ev[3] <= e for s, e in host)]
    spans = [(s, e) for n, s, e in summary["dev_ranges"] if n == name]
    return [ev for ev in evs if any(s <= ev[1] and ev[1] + ev[2] <= e
                                    for s, e in spans)]


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time (the card's stretch),
    and the idle gaps between device events summed by the innermost host
    range open where each gap began (``host: other`` outside every range;
    the host's stretch, whose profiling slows the host)."""
    ops: Dict[str, float] = {}
    for name, _, d, _ in summary["events"]:
        ops[name] = ops.get(name, 0.0) + d / 1e9
    gaps: Dict[str, float] = {}
    end = None
    ranges = sorted(summary["ranges"], key=lambda r: r[1])
    for _, s, d, _ in summary["host_events"]:
        if end is not None and s > end:
            open_ = [r for r in ranges if r[1] <= end <= r[2]]
            name = ("host: " + min(open_, key=lambda r: r[2] - r[1])[0]
                    if open_ else "host: other")
            gaps[name] = gaps.get(name, 0.0) + (s - end) / 1e9
        end = s + d if end is None else max(end, s + d)
    first = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in first(ops)],
            "idle_gaps": [[k, v] for k, v in first(gaps)]}
