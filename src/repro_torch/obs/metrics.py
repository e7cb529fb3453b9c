"""Process-wide metrics registry: labeled counters / gauges / histograms
with JSON-snapshot and Prometheus-text exposition.

Port of `repro.obs.metrics`, copied line for line (it is stdlib only),
so the port's runtime publishes the same metric names, snapshot schema
and Prometheus text without importing the JAX package.

One default registry (`get_registry()`) serves the whole process, so the
runtime layers — ``NRM.control_step``, ``ControlPlane.tick``,
``TenantHeartbeatStore`` ingestion, ``executor.run_grid`` — publish into
a single place instead of each keeping ad-hoc one-off counters.  The
registry is numpy/stdlib only (no jax import) so it can never perturb
tracing, and every mutation takes the registry lock so concurrent
consume-callbacks / plane ticks stay safe.

Exposition:
  * ``snapshot()``  -> JSON-able dict (schema versioned; see
    ``validate_snapshot`` — CI fails on malformed exports)
  * ``to_prometheus()`` -> text format for scrape endpoints / promtool
    (= ``render_prometheus(snapshot())``, so a snapshot FILE renders the
    same text a live registry would — the ``repro.obs.serve`` CLI serves
    exported snapshots through the identical code path)

Prometheus conformance (exposition format): counters expose a
``_total``-suffixed sample name (appended when the registry name lacks
it), histograms always emit the ``le="+Inf"`` bucket, and HELP text /
label values are escaped (backslash, newline, quote).
``validate_prometheus_text`` checks exactly these invariants so CI
catches exposition drift when it scrapes a live server.
"""
from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

SNAPSHOT_SCHEMA = 1

DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_LabelKey = Tuple[str, ...]


def _label_key(labelnames: Sequence[str], labels: Dict[str, Any]) -> _LabelKey:
    if set(labels) != set(labelnames):
        raise ValueError(f"labels {sorted(labels)} != declared "
                         f"labelnames {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.RLock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._samples: Dict[_LabelKey, Any] = {}

    def _sample_dicts(self) -> List[Dict[str, Any]]:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + float(amount)

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return float(self._samples.get(key, 0.0))

    def _sample_dicts(self):
        return [{"labels": dict(zip(self.labelnames, k)), "value": v}
                for k, v in sorted(self._samples.items())]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._samples[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + float(amount)

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return float(self._samples.get(key, 0.0))

    _sample_dicts = Counter._sample_dicts


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        bs = tuple(float(b) for b in buckets)
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram {name}: buckets must be strictly "
                             f"increasing, got {bs}")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        v = float(value)
        with self._lock:
            st = self._samples.get(key)
            if st is None:
                st = {"counts": [0] * (len(self.buckets) + 1),
                      "sum": 0.0, "count": 0}
                self._samples[key] = st
            i = len(self.buckets)
            for j, b in enumerate(self.buckets):
                if v <= b:
                    i = j
                    break
            st["counts"][i] += 1
            st["sum"] += v
            st["count"] += 1

    def value(self, **labels) -> Dict[str, Any]:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            st = self._samples.get(key)
            return (dict(st, counts=list(st["counts"]))
                    if st else {"counts": [0] * (len(self.buckets) + 1),
                                "sum": 0.0, "count": 0})

    def _sample_dicts(self):
        return [{"labels": dict(zip(self.labelnames, k)),
                 "buckets": list(self.buckets),
                 "counts": list(st["counts"]),
                 "sum": st["sum"], "count": st["count"]}
                for k, st in sorted(self._samples.items())]


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, labelnames: Sequence[str],
             **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}{m.labelnames}, requested "
                        f"{cls.kind}{tuple(labelnames)}")
                return m
            m = cls(name, help, labelnames, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Drop every metric (tests / fresh bench runs)."""
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------- exposition
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "schema": SNAPSHOT_SCHEMA,
                "unix_time": time.time(),
                "metrics": {
                    name: {"type": m.kind, "help": m.help,
                           "labelnames": list(m.labelnames),
                           "samples": m._sample_dicts()}
                    for name, m in sorted(self._metrics.items())
                },
            }

    def write_snapshot(self, path) -> Dict[str, Any]:
        snap = self.snapshot()
        validate_snapshot(snap)
        with open(path, "w") as fh:
            json.dump(snap, fh, indent=1, sort_keys=True)
            fh.write("\n")
        return snap

    def to_prometheus(self) -> str:
        return render_prometheus(self.snapshot())


def exposition_name(name: str, kind: str) -> str:
    """Prometheus sample name for a registry metric: counters get the
    conventional ``_total`` suffix appended unless already present."""
    if kind == "counter" and not name.endswith("_total"):
        return name + "_total"
    return name


def render_prometheus(snap: Dict[str, Any]) -> str:
    """Render a registry snapshot dict as Prometheus exposition text —
    the one renderer behind both ``MetricsRegistry.to_prometheus()`` and
    file-backed serving (``repro.obs.serve --metrics FILE``)."""
    lines: List[str] = []
    for name, m in sorted(snap.get("metrics", {}).items()):
        kind = m["type"]
        ename = exposition_name(name, kind)
        if m.get("help"):
            lines.append(f"# HELP {ename} {_esc_help(m['help'])}")
        lines.append(f"# TYPE {ename} {kind}")
        for s in m["samples"]:
            if kind == "histogram":
                cum = 0
                for b, c in zip(s["buckets"], s["counts"]):
                    cum += c
                    lines.append(_prom_line(
                        f"{ename}_bucket",
                        dict(s["labels"], le=_fmt(b)), cum))
                lines.append(_prom_line(
                    f"{ename}_bucket", dict(s["labels"], le="+Inf"),
                    s["count"]))
                lines.append(_prom_line(f"{ename}_sum", s["labels"],
                                        s["sum"]))
                lines.append(_prom_line(f"{ename}_count", s["labels"],
                                        s["count"]))
            else:
                lines.append(_prom_line(ename, s["labels"], s["value"]))
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    s = repr(float(v))
    return s[:-2] if s.endswith(".0") else s


def _esc_help(s: str) -> str:
    return str(s).replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return (str(s).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_line(name: str, labels: Dict[str, str], value) -> str:
    if labels:
        body = ",".join(f'{k}="{_esc_label(v)}"'
                        for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {_fmt(float(value))}"
    return f"{name} {_fmt(float(value))}"


# ------------------------------------------------------------ validation
def validate_snapshot(snap: Any) -> None:
    """Raise ValueError unless ``snap`` is a well-formed registry export
    (the CI quick-benchmark step runs this against BENCH_metrics.json)."""
    if not isinstance(snap, dict):
        raise ValueError(f"snapshot must be a dict, got {type(snap).__name__}")
    if snap.get("schema") != SNAPSHOT_SCHEMA:
        raise ValueError(f"snapshot schema {snap.get('schema')!r} != "
                         f"{SNAPSHOT_SCHEMA}")
    metrics = snap.get("metrics")
    if not isinstance(metrics, dict):
        raise ValueError("snapshot['metrics'] must be a dict")
    for name, m in metrics.items():
        if not isinstance(m, dict):
            raise ValueError(f"metric {name!r}: body must be a dict")
        kind = m.get("type")
        if kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"metric {name!r}: bad type {kind!r}")
        lnames = m.get("labelnames")
        if not isinstance(lnames, list):
            raise ValueError(f"metric {name!r}: labelnames must be a list")
        samples = m.get("samples")
        if not isinstance(samples, list):
            raise ValueError(f"metric {name!r}: samples must be a list")
        for s in samples:
            if not isinstance(s, dict) or not isinstance(
                    s.get("labels"), dict):
                raise ValueError(f"metric {name!r}: malformed sample {s!r}")
            if set(s["labels"]) != set(lnames):
                raise ValueError(f"metric {name!r}: sample labels "
                                 f"{sorted(s['labels'])} != declared "
                                 f"{sorted(lnames)}")
            if kind == "histogram":
                if (not isinstance(s.get("buckets"), list)
                        or not isinstance(s.get("counts"), list)
                        or len(s["counts"]) != len(s["buckets"]) + 1
                        or "sum" not in s or "count" not in s):
                    raise ValueError(
                        f"metric {name!r}: malformed histogram sample")
                if sum(s["counts"]) != s["count"]:
                    raise ValueError(f"metric {name!r}: histogram counts "
                                     "do not sum to count")
            elif not isinstance(s.get("value"), (int, float)):
                raise ValueError(f"metric {name!r}: sample value must be "
                                 "numeric")


_LABEL_PAIR = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*"'
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+'
    r'(-?(?:[0-9.]+(?:[eE][+-]?[0-9]+)?)|[+-]Inf|NaN)$')
_LABELS_RE = re.compile(_LABEL_PAIR)
_LABEL_BODY_RE = re.compile(rf'{_LABEL_PAIR}(?:,{_LABEL_PAIR})*')


def validate_prometheus_text(text: str) -> int:
    """Raise ValueError unless ``text`` is well-formed Prometheus
    exposition output honoring the registry's conformance contract:
    parseable sample lines with properly quoted/escaped label values,
    a TYPE declaration for every sample family, counter samples named
    ``*_total``, and histograms whose ``le="+Inf"`` bucket is present
    and equal to the family's ``_count``, with cumulative bucket counts
    non-decreasing in ``le``. Returns the number of sample lines."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for n, line in enumerate(str(text).splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {n}: malformed TYPE line {line!r}")
            if parts[2] in types:
                raise ValueError(f"line {n}: duplicate TYPE for "
                                 f"{parts[2]!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue  # HELP / comment (single-line by construction)
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {n}: unparseable sample line {line!r}")
        name, body, val = m.group(1), m.group(2), m.group(3)
        if body:
            if not _LABEL_BODY_RE.fullmatch(body):
                raise ValueError(f"line {n}: malformed label body in "
                                 f"{line!r} (unescaped quote/newline?)")
            labels = dict((k, v) for k, v in
                          ((p.split("=", 1)[0],
                            p.split("=", 1)[1][1:-1])
                           for p in _LABELS_RE.findall(body)))
        else:
            labels = {}
        samples.append((name, labels,
                        float(val.replace("Inf", "inf"))))

    def family_of(name: str) -> Optional[str]:
        if name in types:
            return name
        for suf in ("_bucket", "_sum", "_count"):
            base = name[:-len(suf)] if name.endswith(suf) else None
            if base and types.get(base) in ("histogram", "summary"):
                return base
        return None

    for name, labels, _ in samples:
        fam = family_of(name)
        if fam is None:
            raise ValueError(f"sample {name!r} has no TYPE declaration")
        if types[fam] == "counter" and not name.endswith("_total"):
            raise ValueError(f"counter sample {name!r} must be exposed "
                             "with the _total suffix")
    for fam, kind in types.items():
        if kind != "histogram":
            continue
        groups: Dict[Tuple, List[Tuple[float, float]]] = {}
        counts: Dict[Tuple, float] = {}
        for name, labels, val in samples:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            if name == fam + "_bucket":
                le = labels.get("le")
                if le is None:
                    raise ValueError(f"histogram {fam!r}: bucket sample "
                                     "without le label")
                groups.setdefault(key, []).append(
                    (float(le.replace("Inf", "inf")), val))
            elif name == fam + "_count":
                counts[key] = val
        if not groups:
            continue  # a histogram family with no samples yet is fine
        for key, buckets in groups.items():
            les = [b[0] for b in buckets]
            if float("inf") not in les:
                raise ValueError(f'histogram {fam!r}: missing le="+Inf" '
                                 f"bucket for labels {dict(key)}")
            ordered = [v for _, v in sorted(buckets)]
            if any(b > a for a, b in zip(ordered[1:], ordered)):
                raise ValueError(f"histogram {fam!r}: bucket counts not "
                                 f"cumulative for labels {dict(key)}")
            if key in counts and ordered[-1] != counts[key]:
                raise ValueError(f"histogram {fam!r}: le=+Inf bucket != "
                                 f"_count for labels {dict(key)}")
    return len(samples)


# --------------------------------------------------------------- default
_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY
