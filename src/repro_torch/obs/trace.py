"""Span tracing with Chrome trace-event JSON export.

Port of `repro.obs.trace`, copied line for line (stdlib only): the same
span API and Chrome trace-event layout.

``executor.run_grid`` wraps every chunk in prepare / compute / transfer /
merge spans (device ids in args), and ``benchmarks/telemetry.py`` spans
each timed workload — open the exported file in chrome://tracing or
https://ui.perfetto.dev to see the chunk pipeline laid out on a
timeline.

The process-wide tracer starts **disabled**: ``span()`` is then a no-op
context manager (no timestamps taken, no list growth), so the hot
executor loop pays nothing until someone calls ``enable()``.  Timestamps
are ``perf_counter`` microseconds relative to the tracer epoch, which is
what the trace-event ``ts`` field wants.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class Tracer:
    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self._lock = threading.RLock()
        self._epoch = time.perf_counter()
        self._events: List[Dict[str, Any]] = []

    # ------------------------------------------------------------ record
    def _ts_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, tid: int = 0, **args):
        if not self.enabled:
            yield
            return
        t0 = self._ts_us()
        try:
            yield
        finally:
            t1 = self._ts_us()
            with self._lock:
                self._events.append({
                    "name": name, "ph": "X", "ts": t0, "dur": t1 - t0,
                    "pid": os.getpid(), "tid": int(tid),
                    "args": {k: _jsonable(v) for k, v in args.items()},
                })

    def instant(self, name: str, tid: int = 0, **args) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._events.append({
                "name": name, "ph": "i", "s": "t", "ts": self._ts_us(),
                "pid": os.getpid(), "tid": int(tid),
                "args": {k: _jsonable(v) for k, v in args.items()},
            })

    # ------------------------------------------------------------ export
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._epoch = time.perf_counter()

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


def get_tracer() -> Tracer:
    return _TRACER


def enable(flag: bool = True) -> Tracer:
    _TRACER.enabled = bool(flag)
    return _TRACER
