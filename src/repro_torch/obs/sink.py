"""Streaming telemetry sinks: bounded-memory, bounded-disk JSONL export;
port of `repro.obs.sink`.

  * `JsonlSink` — append-only, size-rotated JSONL writer (thread-safe).
    When the active file would exceed ``max_bytes`` it rotates
    ``path -> path.1 -> ... -> path.{max_files-1}`` (oldest deleted), so
    a long campaign holds at most ``max_bytes * max_files`` on disk.
  * `MetricsSampler` — background daemon thread writing periodic
    registry snapshots as compact rows with **per-counter deltas** since
    the previous sample.
  * `decision_consumer` — adapts a sink to the ``consume(lo, hi, out)``
    hook `executor.run_grid` / `sim.sweep` / `ControlPlane.tick` expose:
    per-chunk summary rows (or full per-run rows) go to disk and the
    chunk arrays are dropped, keeping campaign memory O(chunk).
  * `PushSink` — HTTP push-gateway client: rows spool in a bounded
    in-memory deque (oldest dropped and counted when full) and flush as
    newline-delimited JSON batches through the shared
    `repro_torch.obs.retry` ladder. Push failures are swallowed and
    counted (``errors`` + ``sink_errors_total``) — telemetry export must
    never take a campaign down.
  * ``EventLog(sink=...)`` (in `repro_torch.obs.events`) streams every
    decoded event through the same writer before eviction.

Stdlib + numpy only.
"""
from __future__ import annotations

import collections
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.retry import RetryPolicy, call_with_retries


class JsonlSink:
    """Append-only JSONL writer with size rotation.

    ``write(obj)`` serializes one row; when the active file would grow
    past ``max_bytes`` it is rotated first (``path.1`` newest rotated,
    higher suffixes older, beyond ``max_files`` deleted). ``written`` /
    ``rotations`` count activity; all methods are thread-safe.
    """

    def __init__(self, path, max_bytes: int = 32 << 20,
                 max_files: int = 4):
        if max_bytes < 1 or max_files < 1:
            raise ValueError("max_bytes and max_files must be >= 1")
        self.path = Path(path)
        self.max_bytes = int(max_bytes)
        self.max_files = int(max_files)
        self.written = 0
        self.rotations = 0
        self._lock = threading.Lock()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = self.path.stat().st_size

    def _rotate_locked(self) -> None:
        self._fh.close()
        oldest = self.path.with_name(
            f"{self.path.name}.{self.max_files - 1}")
        if oldest.exists():
            oldest.unlink()
        for i in range(self.max_files - 2, 0, -1):
            src = self.path.with_name(f"{self.path.name}.{i}")
            if src.exists():
                src.rename(self.path.with_name(f"{self.path.name}.{i + 1}"))
        if self.max_files > 1:
            self.path.rename(self.path.with_name(f"{self.path.name}.1"))
        else:
            self.path.unlink()
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = 0
        self.rotations += 1

    def write(self, obj: Any) -> None:
        line = json.dumps(obj, separators=(",", ":"),
                          default=_jsonable) + "\n"
        with self._lock:
            if self._size and self._size + len(line) > self.max_bytes:
                self._rotate_locked()
            self._fh.write(line)
            self._size += len(line)
            self.written += 1

    def write_many(self, objs: Sequence[Any]) -> None:
        for o in objs:
            self.write(o)

    def flush(self) -> None:
        with self._lock:
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            self._fh.close()

    def files(self) -> List[Path]:
        """Active file + rotated generations, newest first."""
        out = [self.path]
        for i in range(1, self.max_files):
            p = self.path.with_name(f"{self.path.name}.{i}")
            if p.exists():
                out.append(p)
        return out

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


def read_jsonl(path) -> List[dict]:
    """Parse one JSONL file (tests / analysis helper)."""
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


# ----------------------------------------------------------- flattening
def _flat_key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    body = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{body}}}"


def snapshot_row(snap: dict,
                 prev_counters: Optional[Dict[str, float]] = None
                 ) -> dict:
    """Flatten one registry snapshot into a compact sample row:
    ``gauges``/``counters`` keyed ``name{label=value,...}``, histograms
    reduced to (count, sum), and ``deltas`` = counter increments since
    ``prev_counters`` (a fresh counter's delta is its value)."""
    row: dict = {"t": snap.get("unix_time"), "gauges": {},
                 "counters": {}, "histograms": {}, "deltas": {}}
    for name, m in snap.get("metrics", {}).items():
        for s in m["samples"]:
            key = _flat_key(name, s["labels"])
            if m["type"] == "gauge":
                row["gauges"][key] = s["value"]
            elif m["type"] == "counter":
                row["counters"][key] = s["value"]
            else:
                row["histograms"][key] = {"count": s["count"],
                                          "sum": s["sum"]}
    if prev_counters is not None:
        for key, v in row["counters"].items():
            row["deltas"][key] = round(v - prev_counters.get(key, 0.0), 9)
    return row


class MetricsSampler:
    """Periodic background snapshot sampler -> JSONL sink.

    ``start()`` launches a daemon thread that writes one `snapshot_row`
    immediately and then every ``period_s``; ``stop()`` joins it and
    writes one final row, so even a short run exports at least two
    samples (start + end state) and every counter's total delta.
    """

    def __init__(self, sink: JsonlSink,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 period_s: float = 5.0):
        self.sink = sink
        self.registry = registry or obs_metrics.get_registry()
        self.period_s = float(period_s)
        self.samples = 0
        self._prev: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def sample(self) -> dict:
        """Take one sample now (also usable without the thread)."""
        with self._lock:
            row = snapshot_row(self.registry.snapshot(), self._prev)
            self._prev = dict(row["counters"])
            self.sink.write(row)
            self.samples += 1
            return row

    def _loop(self) -> None:
        self.sample()
        while not self._stop.wait(self.period_s):
            self.sample()

    def start(self) -> "MetricsSampler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="repro-obs-sampler", daemon=True)
            self._thread.start()
        return self

    def stop(self, final: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(self.period_s * 2, 5))
            self._thread = None
        if final:
            self.sample()

    def __enter__(self) -> "MetricsSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ------------------------------------------------------ HTTP push sink
def _http_post(url: str, data: bytes, timeout_s: float) -> None:
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/x-ndjson"})
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        status = getattr(resp, "status", 200)
        if status >= 300:
            raise urllib.error.HTTPError(url, status, "push rejected",
                                         resp.headers, None)


class PushSink:
    """Push-gateway sink: bounded spool -> batched HTTP POST with the
    shared retry ladder.

    ``write(obj)`` only appends to an in-memory deque capped at
    ``max_spool`` rows (oldest dropped and counted in ``dropped`` —
    bounded memory beats complete telemetry). ``flush()`` drains the
    spool in ``batch``-row newline-delimited JSON posts; each post runs
    through `call_with_retries` with ``policy``, and a batch that still
    fails after the retry budget is re-spooled at the FRONT (so the next
    flush retries it first) with ``errors`` and the registry counter
    ``sink_errors_total{sink="push"}`` incremented — the caller never
    sees the exception. Pass ``post=`` to substitute the transport
    (tests use a local stdlib HTTP server or a plain callable).
    """

    def __init__(self, url: str, *, max_spool: int = 4096,
                 batch: int = 256, timeout_s: float = 5.0,
                 policy: Optional[RetryPolicy] = None,
                 post: Optional[Callable[[str, bytes, float], None]] = None,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 sleep: Callable[[float], None] = None):
        if max_spool < 1 or batch < 1:
            raise ValueError("max_spool and batch must be >= 1")
        self.url = url
        self.batch = int(batch)
        self.timeout_s = float(timeout_s)
        self.policy = policy or RetryPolicy(max_retries=3, base_s=0.05)
        self.pushed = 0
        self.posts = 0
        self.errors = 0
        self.dropped = 0
        self._post = post or _http_post
        self._sleep = sleep if sleep is not None else None
        self._spool: collections.deque = collections.deque(
            maxlen=int(max_spool))
        self._lock = threading.Lock()
        reg = registry or obs_metrics.get_registry()
        self._c_err = reg.counter(
            "sink_errors_total",
            "Telemetry push batches abandoned after the retry budget",
            labelnames=("sink",))
        self._c_drop = reg.counter(
            "sink_dropped_rows_total",
            "Telemetry rows evicted from a full push spool",
            labelnames=("sink",))

    def write(self, obj: Any) -> None:
        line = json.dumps(obj, separators=(",", ":"), default=_jsonable)
        with self._lock:
            if len(self._spool) == self._spool.maxlen:
                self.dropped += 1
                self._c_drop.inc(sink="push")
            self._spool.append(line)

    def write_many(self, objs: Sequence[Any]) -> None:
        for o in objs:
            self.write(o)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spool)

    def flush(self) -> None:
        while True:
            with self._lock:
                if not self._spool:
                    return
                rows = [self._spool.popleft()
                        for _ in range(min(self.batch, len(self._spool)))]
            payload = ("\n".join(rows) + "\n").encode("utf-8")

            def _do():
                self.posts += 1
                self._post(self.url, payload, self.timeout_s)

            kw = {} if self._sleep is None else {"sleep": self._sleep}
            try:
                call_with_retries(_do, self.policy, **kw)
                self.pushed += len(rows)
            except Exception:
                # swallowed by design: telemetry must never take the
                # campaign down. Re-spool at the front so the rows get
                # another chance on the next flush (the deque cap still
                # bounds memory if the gateway stays dark).
                self.errors += 1
                self._c_err.inc(sink="push")
                with self._lock:
                    self._spool.extendleft(reversed(rows))
                return

    def close(self) -> None:
        self.flush()

    def __enter__(self) -> "PushSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------- consume= hooks
def _walk_arrays(out: Any, prefix: str = "") -> List[tuple]:
    """Flatten a (possibly nested) dict of arrays to (dotted_key, array)
    leaves; non-dict payloads land under their prefix (or 'out')."""
    if isinstance(out, dict):
        leaves: List[tuple] = []
        for k, v in out.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            leaves.extend(_walk_arrays(v, key))
        return leaves
    return [(prefix or "out", np.asarray(out))]


def decision_consumer(sink: JsonlSink, mode: str = "summary",
                      fields: Optional[Sequence[str]] = None
                      ) -> Callable[[int, int, Any], None]:
    """Build a ``consume(lo, hi, out)`` hook that streams chunk results
    to ``sink`` and drops them — plug into ``ControlPlane.tick``,
    ``sim.sweep`` or ``executor.run_grid`` directly.

    ``mode="summary"`` writes ONE row per chunk with mean/min/max per
    field (bounded output regardless of campaign size);
    ``mode="rows"`` writes one row per run/tenant (full-resolution
    decision stream, still O(chunk) memory). ``fields`` restricts which
    (dotted) keys are exported."""
    if mode not in ("summary", "rows"):
        raise ValueError(f"mode must be 'summary' or 'rows', got {mode!r}")

    def consume(lo: int, hi: int, out: Any) -> None:
        leaves = [(k, np.asarray(a, dtype=np.float64))
                  for k, a in _walk_arrays(out)
                  if fields is None or k in fields]
        if mode == "summary":
            row: dict = {"lo": int(lo), "hi": int(hi), "n": int(hi - lo)}
            for k, a in leaves:
                a = a.reshape(a.shape[0], -1) if a.ndim > 1 else a
                row[k] = {"mean": float(np.mean(a)),
                          "min": float(np.min(a)),
                          "max": float(np.max(a))}
            sink.write(row)
        else:
            n = hi - lo
            for j in range(n):
                row = {"i": int(lo + j)}
                for k, a in leaves:
                    if a.shape and a.shape[0] >= n:
                        v = a[j]
                        row[k] = (float(v) if np.ndim(v) == 0
                                  else np.asarray(v).tolist())
                sink.write(row)

    return consume
