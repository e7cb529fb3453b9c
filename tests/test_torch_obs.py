"""The port's observability twins (`repro_torch.obs`: metrics, trace,
retry) against the reference's modules: the same operations give the
same snapshot (up to its timestamp), the same Prometheus text, Chrome
traces of the same layout and the same backoff ladder; plus twins of
the reference's own registry and tracer tests (`tests/test_obs.py`)."""
import json
import random

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import retry as jretry  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402

from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import retry as obs_retry  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402


def _populate(mod):
    """One fixed sequence of registry operations on a fresh registry."""
    reg = mod.MetricsRegistry()
    c = reg.counter("ticks_total", "ticks", labelnames=("kind",))
    c.inc(kind="a")
    c.inc(2.5, kind="b")
    reg.counter("runs", 'runs "quoted"\nhelp').inc(3)
    g = reg.gauge("depth", "queue depth", labelnames=("q",))
    g.set(7.0, q="x\\y")
    g.inc(-2.0, q="x\\y")
    h = reg.histogram("lat", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 50.0):
        h.observe(v)
    reg.histogram("tick_s", "tick seconds").observe(0.2)
    return reg


def _no_time(snap):
    return {k: v for k, v in snap.items() if k != "unix_time"}


def test_snapshot_and_prometheus_equal_reference():
    mine, ref = _populate(obs_metrics), _populate(jmetrics)
    a, b = mine.snapshot(), ref.snapshot()
    assert _no_time(a) == _no_time(b)
    assert "unix_time" in a
    obs_metrics.validate_snapshot(b)   # each validates the other's
    jmetrics.validate_snapshot(a)
    assert mine.to_prometheus() == ref.to_prometheus()
    assert obs_metrics.render_prometheus(b) == jmetrics.render_prometheus(a)
    n = obs_metrics.validate_prometheus_text(mine.to_prometheus())
    assert n == jmetrics.validate_prometheus_text(ref.to_prometheus())
    assert obs_metrics.SNAPSHOT_SCHEMA == jmetrics.SNAPSHOT_SCHEMA
    for kind in ("counter", "gauge", "histogram"):
        assert (obs_metrics.exposition_name("x", kind)
                == jmetrics.exposition_name("x", kind))


def test_chrome_trace_layout_equals_reference(tmp_path):
    docs = []
    for mod in (obs_trace, jtrace):
        tr = mod.Tracer(enabled=True)
        with tr.span("executor/compute", chunk=1, devices=[0]):
            with tr.span("inner", tid=2):
                pass
        tr.instant("marker", note="hi")
        doc = tr.write(tmp_path / f"{mod.__name__}.json")
        docs.append(json.loads(
            (tmp_path / f"{mod.__name__}.json").read_text()))
        assert docs[-1] == doc
    for doc in docs:
        obs_trace.validate_chrome_trace(doc, require_spans=True)
        jtrace.validate_chrome_trace(doc, require_spans=True)

    def layout(doc):   # everything but the clock readings
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                for e in doc["traceEvents"]]

    assert layout(docs[0]) == layout(docs[1])
    assert {k: v for k, v in docs[0].items() if k != "traceEvents"} == {
        k: v for k, v in docs[1].items() if k != "traceEvents"}


def test_retry_backoff_equals_reference_under_a_seed():
    mine, ref = obs_retry.RetryPolicy(), jretry.RetryPolicy()
    assert obs_retry.RetryPolicy.__dataclass_fields__.keys() \
        == jretry.RetryPolicy.__dataclass_fields__.keys()
    for seed in (0, 7):
        random.seed(seed)
        a = [mine.backoff_s(i, random.Random(seed)) for i in range(12)]
        b = [ref.backoff_s(i, random.Random(seed)) for i in range(12)]
        assert a == b
        assert [mine.backoff_s(i) for i in range(12)] == [
            ref.backoff_s(i) for i in range(12)]

    def ladder(mod):
        calls, seen = [0], []

        def flaky():
            calls[0] += 1
            if calls[0] < 3:
                raise OSError("transient")
            return calls[0]

        out = mod.call_with_retries(
            flaky, mod.RetryPolicy(max_retries=4),
            on_retry=lambda a, d, e: seen.append((a, d, str(e))),
            sleep=lambda d: None, rng=random.Random(3))
        return out, seen

    assert ladder(obs_retry) == ladder(jretry)
    with pytest.raises(OSError):
        obs_retry.call_with_retries(
            lambda: (_ for _ in ()).throw(OSError("down")),
            obs_retry.RetryPolicy(max_retries=2), sleep=lambda d: None)


# ---- twins of tests/test_obs.py's registry and tracer cases ----------

def test_registry_counter_gauge_histogram_and_labels():
    reg = obs_metrics.MetricsRegistry()
    c = reg.counter("ticks_total", "ticks", labelnames=("kind",))
    c.inc(kind="a")
    c.inc(2.5, kind="b")
    assert c.value(kind="a") == 1.0 and c.value(kind="b") == 2.5
    with pytest.raises(ValueError):
        c.inc(-1.0, kind="a")
    g = reg.gauge("depth", "queue depth")
    g.set(7.0)
    g.inc(-2.0)
    assert g.value() == 5.0
    h = reg.histogram("lat", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(50.0)
    v = h.value()
    assert v["count"] == 3 and v["counts"] == [1, 1, 1]
    assert v["sum"] == pytest.approx(50.55)
    # re-registration returns the same object; a kind clash raises
    assert reg.counter("ticks_total", "ticks",
                       labelnames=("kind",)) is c
    with pytest.raises(ValueError):
        reg.gauge("ticks_total", "oops")


def test_registry_snapshot_validates_and_prometheus_renders():
    reg = obs_metrics.MetricsRegistry()
    reg.counter("runs_total", "runs", labelnames=("mode",)).inc(
        3, mode="quick")
    reg.histogram("tick_s", "tick seconds").observe(0.2)
    snap = reg.snapshot()
    obs_metrics.validate_snapshot(snap)  # must not raise
    text = reg.to_prometheus()
    assert "# TYPE runs_total counter" in text
    assert 'runs_total{mode="quick"} 3' in text
    assert "# TYPE tick_s histogram" in text
    for broken in [
        None,
        {},
        {"schema": 99, "metrics": {}},
        {"schema": 1, "metrics": {"x": {"type": "bogus", "help": "",
                                        "labelnames": [],
                                        "samples": []}}},
    ]:
        with pytest.raises(ValueError):
            obs_metrics.validate_snapshot(broken)


def test_registry_write_snapshot_roundtrip(tmp_path):
    reg = obs_metrics.MetricsRegistry()
    reg.gauge("x", "x").set(1.5)
    path = tmp_path / "m.json"
    reg.write_snapshot(path)
    snap = json.loads(path.read_text())
    obs_metrics.validate_snapshot(snap)
    assert snap["metrics"]["x"]["samples"][0]["value"] == 1.5


def test_tracer_disabled_is_noop_enabled_records_spans(tmp_path):
    tr = obs_trace.Tracer()
    with tr.span("off/span", chunk=0):
        pass
    assert tr.events() == []
    tr = obs_trace.Tracer(enabled=True)
    with tr.span("executor/compute", chunk=1, devices=[0]):
        pass
    tr.instant("marker", note="hi")
    doc = tr.to_chrome()
    obs_trace.validate_chrome_trace(doc, require_spans=True)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == 1
    assert spans[0]["name"] == "executor/compute"
    assert spans[0]["dur"] >= 0
    assert spans[0]["args"]["chunk"] == 1
    path = tmp_path / "t.json"
    tr.write(path)
    obs_trace.validate_chrome_trace(json.loads(path.read_text()))
    with pytest.raises(ValueError, match="no complete"):
        obs_trace.validate_chrome_trace(
            {"traceEvents": []}, require_spans=True)
    with pytest.raises(ValueError):
        obs_trace.validate_chrome_trace({"nope": 1})
