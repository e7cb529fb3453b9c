"""Span tracing on the profiler's clock, with Chrome trace-event JSON
export.

Port of `repro.obs.trace`: the same span API and the same Chrome
trace-event layout (`tests/test_torch_obs.py` holds the layout to the
reference's). Beyond the reference, each span is kept as a `Span`
record (`Tracer.spans`): name, start and end, the thread, its parent
(the innermost span open on that thread when it began) and args.

``executor.run_grid`` wraps every chunk in prepare / compute / transfer /
merge spans (device ids in args); the training and prefill paths span
their layers with the module-level `span`: ``steps.train_step`` around a
step's host enqueue, ``steps.forward`` and ``steps.backward`` inside it
(`launch.steps`), ``adamw.apply`` (`optim.adamw`), ``nrm.heartbeat``,
``nrm.control_step`` and ``nrm.advance`` (`core.nrm`), ``moe.apply``
(`models.moe`, which also tallies its expert slots while spans record).
Open the exported file in chrome://tracing or https://ui.perfetto.dev to
see the spans laid out on a timeline.

Spans record while ``enable()`` is on, or while a `torch.profiler`
session records (the profiler's own module flag, read on each call), so a
profiled run gets the program's spans with no switch of its own.
Otherwise ``span()`` is one flag check that returns a shared null
context: no clock read, no list growth. The clock is Unix-epoch
nanoseconds (`time.time_ns`), the clock of the profiler's kineto events
(``start_ns()``), so the spans lay over a device trace; the Chrome export
gives ``ts`` in microseconds from the tracer's epoch.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int             # `threading.get_ident()` of the span's thread
    id: int
    parent: Optional[int]   # the id of the span open around it, if any
    tid: int                # the Chrome row the caller named
    args: Dict[str, Any]


class _Instant(NamedTuple):
    name: str
    ts_ns: int
    tid: int
    args: Dict[str, Any]


class _Null:
    """The context a span is when nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """A span being recorded: pushed on its thread's stack on entry, kept
    as a `Span` on exit."""
    __slots__ = ("tracer", "name", "tid", "args", "id", "parent", "start",
                 "stack")

    def __init__(self, tracer: "Tracer", name: str, tid: int, args: dict):
        self.tracer, self.name, self.tid, self.args = (tracer, name,
                                                       int(tid), args)

    def __enter__(self):
        tr = self.tracer
        stack = getattr(tr._local, "stack", None)
        if stack is None:
            stack = tr._local.stack = []
        self.stack = stack
        self.parent = stack[-1] if stack else None
        self.id = next(tr._ids)
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.stack.pop()
        # a plain tuple (a `Span` once read); list.append is atomic
        self.tracer._records.append((self.name, self.start, end,
                                     threading.get_ident(), self.id,
                                     self.parent, self.tid, self.args))
        return False


class Tracer:
    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self._lock = threading.RLock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._epoch_ns = time.time_ns()
        self._records: list = []

    # ------------------------------------------------------------ record
    def span(self, name: str, tid: int = 0, **args):
        if not (self.enabled or _profiler._is_profiler_enabled):
            return _NULL
        return _Open(self, name, tid, args)

    def instant(self, name: str, tid: int = 0, **args) -> None:
        if not (self.enabled or _profiler._is_profiler_enabled):
            return
        self._records.append(_Instant(name, time.time_ns(), int(tid), args))

    # ------------------------------------------------------------ export
    def spans(self) -> List[Span]:
        """Every span recorded, in the order they ended."""
        with self._lock:
            recs = list(self._records)
        return [Span._make(r) for r in recs if not isinstance(r, _Instant)]

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            recs = list(self._records)
        pid, us = os.getpid(), lambda ns: (ns - self._epoch_ns) / 1e3
        out = []
        for r in recs:
            if isinstance(r, _Instant):
                out.append({"name": r.name, "ph": "i", "s": "t",
                            "ts": us(r.ts_ns), "pid": pid, "tid": r.tid,
                            "args": {k: _jsonable(v)
                                     for k, v in r.args.items()}})
                continue
            r = Span._make(r)
            out.append({"name": r.name, "ph": "X", "ts": us(r.start_ns),
                        "dur": (r.end_ns - r.start_ns) / 1e3, "pid": pid,
                        "tid": r.tid,
                        "args": {k: _jsonable(v) for k, v in r.args.items()}})
        return out

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._epoch_ns = time.time_ns()

    def to_chrome(self) -> Dict[str, Any]:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def write(self, path) -> Dict[str, Any]:
        doc = self.to_chrome()
        validate_chrome_trace(doc)
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
        return doc


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


def validate_chrome_trace(doc: Any, require_spans: bool = False) -> None:
    """Raise ValueError unless ``doc`` is a well-formed Chrome trace-event
    document (CI runs this against the exported BENCH_trace.json)."""
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("chrome trace must be a dict with a "
                         "'traceEvents' list")
    n_spans = 0
    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict):
            raise ValueError(f"trace event must be a dict, got {ev!r}")
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"trace event missing {field!r}: {ev!r}")
        if ev["ph"] == "X":
            n_spans += 1
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"complete event needs dur >= 0: {ev!r}")
    if require_spans and n_spans == 0:
        raise ValueError("trace contains no complete ('X') spans")


# --------------------------------------------------------------- default
_TRACER = Tracer(enabled=False)
_NO_ARGS: Dict[str, Any] = {}


def get_tracer() -> Tracer:
    return _TRACER


def enable(flag: bool = True) -> Tracer:
    _TRACER.enabled = bool(flag)
    return _TRACER


def recording() -> bool:
    """Whether the process-wide tracer records now."""
    return _TRACER.enabled or _profiler._is_profiler_enabled


def span(name: str):
    """A span ``name`` (no args) on the process-wide tracer: the form the
    program's hot paths use, which allocates nothing while off."""
    if not (_TRACER.enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _Open(_TRACER, name, 0, _NO_ARGS)
