"""The port's live telemetry services on the CPU: the scrape endpoint
(`repro_torch.obs.serve`), the streaming sinks (`repro_torch.obs.sink`,
the push sink included), the validation CLI (`repro_torch.obs.validate`)
and the self-hosted perf-regression gate (`repro_torch.obs.regress`),
plus the Prometheus exposition contract and the bounded `EventLog`:
mirrors of the reference's `tests/test_obs_serve.py` (all but
`test_telemetry_history_row_sources_runtime_from_registry`, which needs
the benchmarks package) and of the three push-sink tests of
`tests/test_supervisor.py`, and the gate against the reference's on the
repo's BENCH_sim.json (the same report, alarms and exit codes).

The contracts worth the most scrutiny:

1. CONFORMANCE — /metrics output must satisfy the exposition format
   (counter ``_total`` suffix, ``le="+Inf"`` bucket, escaped labels) and
   `validate_prometheus_text` must actually reject violations, so the
   CI live-scrape check is a real gate.
2. NEUTRALITY — a run with the server + sampler armed must produce
   bitwise-identical engine results to a run without them.
3. SELF-HOSTING — `regress` must alarm on a synthetic headline step in
   the bad direction, stay silent on the repo's real BENCH_sim.json
   history, and classify good-direction changes as improvements.
"""
import http.server
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import events as evt  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import regress  # noqa: E402
from repro_torch.obs import serve as obs_serve  # noqa: E402
from repro_torch.obs import sink as obs_sink  # noqa: E402
from repro_torch.obs import validate  # noqa: E402
from repro_torch.obs.retry import RetryPolicy  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


# ---------------------------------------------------------------------------
# Prometheus exposition conformance
# ---------------------------------------------------------------------------

def test_prometheus_counter_total_suffix_and_escaping():
    reg = obs_metrics.MetricsRegistry()
    reg.counter("runs", "count of\nruns \\ total",
                labelnames=("who",)).inc(3, who='a"b\\c\nd')
    reg.counter("done_total", "already suffixed").inc(2)
    text = reg.to_prometheus()
    assert "# TYPE runs_total counter" in text
    assert 'runs_total{who="a\\"b\\\\c\\nd"} 3' in text
    # help escaped onto one line; already-suffixed name not doubled
    assert "count of\\nruns \\\\ total" in text
    assert "done_total_total" not in text and "done_total 2" in text
    assert obs_metrics.validate_prometheus_text(text) == 2


def test_prometheus_histogram_emits_inf_bucket():
    reg = obs_metrics.MetricsRegistry()
    h = reg.histogram("lat_s", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(50.0)
    text = reg.to_prometheus()
    assert 'lat_s_bucket{le="+Inf"} 2' in text
    assert 'lat_s_bucket{le="0.1"} 1' in text
    assert "lat_s_count 2" in text
    obs_metrics.validate_prometheus_text(text)


def test_validate_prometheus_text_rejects_violations():
    with pytest.raises(ValueError, match="_total"):
        obs_metrics.validate_prometheus_text(
            "# TYPE runs counter\nruns 3\n")
    with pytest.raises(ValueError, match=r'\+Inf'):
        obs_metrics.validate_prometheus_text(
            "# TYPE h histogram\n"
            'h_bucket{le="1"} 2\nh_sum 1\nh_count 2\n')
    with pytest.raises(ValueError, match="cumulative"):
        obs_metrics.validate_prometheus_text(
            "# TYPE h histogram\n"
            'h_bucket{le="1"} 3\nh_bucket{le="+Inf"} 2\n'
            "h_sum 1\nh_count 2\n")
    with pytest.raises(ValueError, match="no TYPE"):
        obs_metrics.validate_prometheus_text("orphan 1\n")
    with pytest.raises(ValueError, match="label"):
        obs_metrics.validate_prometheus_text(
            "# TYPE g gauge\n" 'g{bad="un"escaped"} 1\n')
    with pytest.raises(ValueError, match="_count"):
        obs_metrics.validate_prometheus_text(
            "# TYPE h histogram\n"
            'h_bucket{le="+Inf"} 2\nh_sum 1\nh_count 5\n')


# ---------------------------------------------------------------------------
# bounded EventLog: dropped counter + sink streaming
# ---------------------------------------------------------------------------

def test_eventlog_eviction_counts_dropped_and_resumes():
    log = evt.EventLog(capacity=3)
    for i in range(8):
        log.append(float(i), evt.EV_DETECTOR_ALARM, evt.SRC_DETECTOR, (i,))
    assert len(log) == 3 and log.total == 8 and log.dropped == 5
    assert [int(e.payload[0]) for e in log.events()] == [5, 6, 7]
    # snapshot/resume carries the drop count
    resumed = evt.EventLog()
    resumed.load_state_dict(log.state_dict())
    assert resumed.dropped == 5 and resumed.total == 8
    # legacy snapshots without the field derive it from total - rows
    legacy = log.state_dict()
    del legacy["dropped"]
    resumed2 = evt.EventLog()
    resumed2.load_state_dict(legacy)
    assert resumed2.dropped == 5


def test_eventlog_sink_streams_every_event_past_eviction(tmp_path):
    sink = obs_sink.JsonlSink(tmp_path / "events.jsonl")
    log = evt.EventLog(capacity=2, sink=sink)
    for i in range(5):
        log.append(float(i), evt.EV_GUARD_HOLD, evt.SRC_GUARD, (i,))
    sink.flush()
    rows = obs_sink.read_jsonl(tmp_path / "events.jsonl")
    # memory holds 2, disk holds all 5 — bounded memory, durable record
    assert len(log) == 2 and len(rows) == 5
    assert [int(r["payload"][0]) for r in rows] == [0, 1, 2, 3, 4]
    assert rows[0]["name"] == "guard_hold"


def test_eventlog_sink_failure_is_counted_never_raised():
    def broken(_row):
        raise OSError("disk on fire")
    log = evt.EventLog(capacity=4, sink=broken)
    log.append(1.0, evt.EV_PHASE_FLIP, evt.SRC_SCHEDULE)
    log.append(2.0, evt.EV_PHASE_FLIP, evt.SRC_SCHEDULE)
    assert log.sink_errors == 2 and log.total == 2 and len(log) == 2


# ---------------------------------------------------------------------------
# JSONL sink + sampler
# ---------------------------------------------------------------------------

def test_jsonl_sink_rotates_and_bounds_disk(tmp_path):
    p = tmp_path / "s.jsonl"
    with obs_sink.JsonlSink(p, max_bytes=300, max_files=3) as s:
        for i in range(50):
            s.write({"i": i, "pad": "x" * 24})
        assert s.written == 50 and s.rotations > 0
        files = s.files()
    assert [f.name for f in files] == ["s.jsonl", "s.jsonl.1", "s.jsonl.2"]
    for f in files:
        assert f.stat().st_size <= 300
    # newest rows live in the active file, in order
    tail = obs_sink.read_jsonl(p)
    idx = [r["i"] for r in tail]
    assert idx == sorted(idx) and idx[-1] == 49
    # total retained rows bounded by max_files * max_bytes
    total = sum(len(obs_sink.read_jsonl(f)) for f in files)
    assert total < 50


def test_metrics_sampler_rows_carry_counter_deltas(tmp_path):
    reg = obs_metrics.MetricsRegistry()
    c = reg.counter("work_total", "work")
    reg.gauge("temp", "t").set(7.0)
    sink = obs_sink.JsonlSink(tmp_path / "m.jsonl")
    sampler = obs_sink.MetricsSampler(sink, registry=reg, period_s=60)
    c.inc(4)
    sampler.sample()
    c.inc(3)
    sampler.sample()
    sink.flush()
    rows = obs_sink.read_jsonl(tmp_path / "m.jsonl")
    assert rows[0]["counters"]["work_total"] == 4.0
    # a counter's first appearance deltas from zero (= its value)
    assert rows[0]["deltas"]["work_total"] == 4.0
    assert rows[1]["counters"]["work_total"] == 7.0
    assert rows[1]["deltas"]["work_total"] == 3.0
    assert rows[1]["gauges"]["temp"] == 7.0


def test_metrics_sampler_thread_start_stop(tmp_path):
    reg = obs_metrics.MetricsRegistry()
    reg.counter("ticks_total", "t").inc()
    sink = obs_sink.JsonlSink(tmp_path / "m.jsonl")
    with obs_sink.MetricsSampler(sink, registry=reg, period_s=30):
        pass  # immediate sample on start, final sample on stop
    sink.flush()
    assert len(obs_sink.read_jsonl(tmp_path / "m.jsonl")) >= 2


def test_decision_consumer_summary_and_rows(tmp_path):
    sink = obs_sink.JsonlSink(tmp_path / "d.jsonl")
    consume = obs_sink.decision_consumer(sink, mode="summary")
    consume(0, 4, {"pcap": np.array([40.0, 50.0, 60.0, 70.0]),
                   "nested": {"flag": np.zeros(4)}})
    consume_rows = obs_sink.decision_consumer(
        sink, mode="rows", fields=["pcap"])
    consume_rows(4, 6, {"pcap": np.array([41.0, 42.0]),
                        "ignored": np.ones(2)})
    sink.flush()
    rows = obs_sink.read_jsonl(tmp_path / "d.jsonl")
    assert rows[0]["pcap"] == {"mean": 55.0, "min": 40.0, "max": 70.0}
    assert rows[0]["nested.flag"]["max"] == 0.0
    assert rows[0]["n"] == 4
    assert [r["i"] for r in rows[1:]] == [4, 5]
    assert rows[1]["pcap"] == 41.0 and "ignored" not in rows[1]
    with pytest.raises(ValueError, match="mode"):
        obs_sink.decision_consumer(sink, mode="bogus")


def test_plane_tick_streams_decisions_through_sink(tmp_path):
    from repro_torch.core.plane import ControlPlane

    sink = obs_sink.JsonlSink(tmp_path / "plane.jsonl")
    plane = ControlPlane(profile="gros", dt=1.0, **CPU)
    plane.add_tenants(6)
    t = 0.0
    for _ in range(3):
        t += 1.0
        for s in range(6):
            plane.ingest([s] * 3, [t - 1.0 + (j + 0.5) / 3
                                   for j in range(3)])
        plane.tick(consume=obs_sink.decision_consumer(sink),
                   chunk_size=3)
    sink.flush()
    rows = obs_sink.read_jsonl(tmp_path / "plane.jsonl")
    # the tick streams the plane's full CAPACITY in chunks of 3
    chunks_per_tick = -(-plane.capacity // 3)
    assert len(rows) == 3 * chunks_per_tick
    assert rows[0]["lo"] == 0 and rows[0]["hi"] == 3
    assert all("pcap" in r and "applied" in r for r in rows)


# ---------------------------------------------------------------------------
# scrape endpoint
# ---------------------------------------------------------------------------

def test_server_endpoints_roundtrip_through_validators():
    reg = obs_metrics.MetricsRegistry()
    reg.counter("jobs_total", "jobs", labelnames=("kind",)).inc(2, kind="a")
    reg.histogram("lat_s", "lat", buckets=(0.1,)).observe(0.01)
    log = evt.EventLog()
    log.append(1.0, evt.EV_PHASE_FLIP, evt.SRC_SCHEDULE, (3.0,))
    with obs_serve.start_server(registry=reg,
                                event_sources={"test": log}) as srv:
        health = json.loads(_get(srv.url + "/healthz"))
        assert health["status"] == "ok" and health["uptime_s"] >= 0
        text = _get(srv.url + "/metrics")
        obs_metrics.validate_prometheus_text(text)
        assert 'jobs_total{kind="a"} 2' in text
        snap = json.loads(_get(srv.url + "/metrics.json"))
        obs_metrics.validate_snapshot(snap)
        assert snap["metrics"]["jobs_total"]["samples"][0]["value"] == 2
        rows = [json.loads(ln) for ln in
                _get(srv.url + "/events").splitlines()]
        assert rows == [{"log": "test", **log.events()[0].as_dict()}]
        # tail limit + unknown source + 404
        log.append(2.0, evt.EV_PHASE_FLIP, evt.SRC_SCHEDULE)
        assert len(_get(srv.url + "/events?n=1").splitlines()) == 1
        assert _get(srv.url + "/events?log=nope") == ""
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.url + "/nope")
        assert ei.value.code == 404
        # scrapes are themselves observable
        assert reg.counter("obs_scrapes_total", "",
                           labelnames=("path",)).value(path="/metrics") >= 1


def test_server_file_mode_serves_exported_snapshot(tmp_path):
    reg = obs_metrics.MetricsRegistry()
    reg.gauge("exported", "e").set(5.0)
    snap_path = tmp_path / "snap.json"
    reg.write_snapshot(snap_path)
    ev_path = tmp_path / "events.jsonl"
    ev_path.write_text(json.dumps({"name": "x", "t": 1.0}) + "\n")
    srv = obs_serve.ObsServer(
        registry=obs_metrics.MetricsRegistry(),
        snapshot_fn=obs_serve._file_snapshot(snap_path),
        event_sources={"events": obs_serve._file_events(ev_path)})
    with srv:
        assert "exported 5" in _get(srv.url + "/metrics")
        snap = json.loads(_get(srv.url + "/metrics.json"))
        assert snap["metrics"]["exported"]["samples"][0]["value"] == 5.0
        row = json.loads(_get(srv.url + "/events"))
        assert row == {"log": "events", "name": "x", "t": 1.0}


def test_concurrent_scrape_while_publishing():
    """Registry thread-safety under fire: scraper threads hammer
    /metrics + /metrics.json while run_grid consume-callbacks publish
    into the same registry. Every scrape must return a valid payload."""
    from repro_torch.core import executor

    reg = obs_metrics.get_registry()
    errors: list = []
    stop = threading.Event()

    with obs_serve.start_server(registry=reg) as srv:
        def scrape():
            while not stop.is_set():
                try:
                    obs_metrics.validate_prometheus_text(
                        _get(srv.url + "/metrics"))
                    obs_metrics.validate_snapshot(
                        json.loads(_get(srv.url + "/metrics.json")))
                except Exception as e:  # pragma: no cover
                    errors.append(e)
                    return
        threads = [threading.Thread(target=scrape) for _ in range(3)]
        for t in threads:
            t.start()

        def consume(lo, hi, out):
            reg.counter("stress_chunks_total", "stress").inc()
            reg.gauge("stress_last_hi", "stress").set(hi)

        for _ in range(4):
            executor.run_grid(
                lambda b: {"y": b["x"] * 2.0},
                {"x": np.arange(64.0, dtype=np.float32)}, (), 64,
                chunk_size=8, consume=consume, **CPU)
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not errors
    assert reg.counter("stress_chunks_total", "stress").value() == 32


def test_plane_and_nrm_serve_attach_their_event_streams():
    from repro_torch.configs.base import PowerControlConfig
    from repro_torch.core.nrm import NRM
    from repro_torch.core.plane import ControlPlane

    plane = ControlPlane(profile="gros", dt=1.0, **CPU)
    plane.add_tenant("solo")
    srv = plane.serve()
    try:
        rows = [json.loads(ln) for ln in
                _get(srv.url + "/events?log=plane").splitlines()]
        assert any(r["name"] == "tenant_added" for r in rows)
    finally:
        srv.stop()

    nrm = NRM(PowerControlConfig(plant_profile="gros"), **CPU)
    srv = nrm.serve()
    try:
        assert json.loads(_get(srv.url + "/healthz"))["status"] == "ok"
        # flight source present (empty before any record_events= run)
        assert _get(srv.url + "/events?log=flight") == ""
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# neutrality + live progress
# ---------------------------------------------------------------------------

def test_serving_and_sampling_keep_engine_bitwise_identical(tmp_path):
    from repro_torch.core.sim import sweep

    kw = dict(total_work=500.0, max_time=500.0, collect_traces=False, **CPU)
    base = sweep("gros", (0.1, 0.2), range(2), **kw)
    sink = obs_sink.JsonlSink(tmp_path / "m.jsonl")
    with obs_serve.start_server():
        with obs_sink.MetricsSampler(sink, period_s=60):
            served = sweep("gros", (0.1, 0.2), range(2), **kw)
    np.testing.assert_array_equal(base.exec_time, served.exec_time)
    np.testing.assert_array_equal(base.energy, served.energy)


def test_run_grid_publishes_live_progress_per_chunk():
    from repro_torch.core import executor

    reg = obs_metrics.get_registry()
    seen: list = []

    def consume(lo, hi, out):
        # metrics are already current for this chunk INSIDE the run —
        # that is what makes the scrape endpoint live, not post-hoc
        seen.append((
            reg.gauge("executor_grid_chunks_done", "").value(),
            reg.gauge("executor_grid_chunks_planned", "").value()))

    executor.run_grid(lambda b: {"y": b["x"] + 1.0},
                      {"x": np.arange(12.0, dtype=np.float32)}, (), 12,
                      chunk_size=4, consume=consume, **CPU)
    # consume fires BEFORE done[ci] flips, so each callback sees the
    # count of previously completed chunks and the full plan
    assert seen == [(0.0, 3.0), (1.0, 3.0), (2.0, 3.0)]
    assert reg.gauge("executor_grid_chunks_done", "").value() == 3.0


# ---------------------------------------------------------------------------
# self-hosted regression gate
# ---------------------------------------------------------------------------

def test_detect_series_alarms_on_step_not_on_noise():
    noise = [5.0 + 0.05 * ((i * 7) % 3 - 1) for i in range(20)]
    assert regress.detect_series(noise, **CPU) == []
    stepped = noise[:14] + [2.5] * 6
    changes = regress.detect_series(stepped, **CPU)
    assert len(changes) == 1
    ch = changes[0]
    assert ch["index"] == 14 and ch["direction"] == -1
    assert ch["magnitude_pct"] == pytest.approx(-50.0, abs=2.0)
    # upward step alarms with direction +1
    up = regress.detect_series(noise[:14] + [10.0] * 6, **CPU)
    assert up and up[0]["direction"] == 1


def test_assess_classifies_by_headline_sense():
    def hist(key, vals, nested=None):
        rows = []
        for i, v in enumerate(vals):
            row = {"rev": f"r{i}", "quick": True}
            if nested:
                row[nested] = {key: v}
            else:
                row[key] = v
            rows.append(row)
        return {"history": rows}

    vals = [5.0] * 14 + [2.5] * 6
    # throughput drop = regression
    rep = regress.assess(hist("sweep", vals, nested="runs_per_sec"), **CPU)
    assert len(rep["regressions"]) == 1 and not rep["improvements"]
    assert rep["regressions"][0]["key"] == "runs_per_sec.sweep"
    assert rep["regressions"][0]["rev"] == "r14"
    # wall-time drop = improvement (same numbers, opposite sense)
    rep = regress.assess(hist("fig7_sweep", vals, nested="warm_s"), **CPU)
    assert len(rep["improvements"]) == 1 and not rep["regressions"]
    # short series are skipped, not analyzed
    rep = regress.assess(hist("chaos_guard_gain", [1.0, 2.0, 3.0]), **CPU)
    assert rep["skipped"] and not rep["series"]


def test_regress_clean_on_real_bench_history():
    """The gate must not cry wolf on the repo's actual trajectory."""
    bench = REPO / "BENCH_sim.json"
    if not bench.exists():  # pragma: no cover
        pytest.skip("no BENCH_sim.json in checkout")
    rc = regress.main([str(bench), "--soft", "--device", "cpu"])
    assert rc == 0
    report = regress.assess(json.loads(bench.read_text()), **CPU)
    assert report["regressions"] == []


def test_regress_cli_exit_codes(tmp_path, capsys):
    vals = [5.0] * 14 + [2.5] * 6
    hist = {"history": [{"rev": f"r{i}", "quick": True,
                         "runs_per_sec": {"sweep": v}}
                        for i, v in enumerate(vals)]}
    path = tmp_path / "B.json"
    path.write_text(json.dumps(hist))
    assert regress.main([str(path), "--device", "cpu"]) == 1  # hard gate trips
    out = capsys.readouterr().out
    assert "REGRESSION" in out and "runs_per_sec.sweep" in out
    assert regress.main([str(path), "--soft", "--device", "cpu"]) == 0
    assert "soft mode" in capsys.readouterr().out
    assert regress.main([str(tmp_path / "missing.json"), "--device",
                         "cpu"]) == 2
    # --json emits the machine-readable report
    assert regress.main([str(path), "--soft", "--json", "--device",
                         "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["regressions"][0]["rev"] == "r14"


def test_history_series_flattens_and_filters():
    data = {"history": [
        {"rev": "a", "quick": True, "date": "2026-01-01", "runtime_s": 9.0,
         "warm_s": {"x": 1.0}, "chaos_guard_gain": 40.0},
        {"rev": "b", "quick": False, "warm_s": {"x": 2.0}},
    ]}
    s = regress.history_series(data)
    assert s == {"warm_s.x": [("a", 1.0), ("b", 2.0)],
                 "chaos_guard_gain": [("a", 40.0)]}
    assert regress.history_series(data, quick=True) == {
        "warm_s.x": [("a", 1.0)], "chaos_guard_gain": [("a", 40.0)]}




def test_regress_matches_reference_on_bench_history(capsys):
    """The port's gate on BENCH_sim.json and on a synthetic 2x step: the
    reference's report (every series, change point, baseline and sigma),
    its printed verdict and its exit codes."""
    pytest.importorskip("jax")
    from repro.obs import regress as jregress
    bench = REPO / "BENCH_sim.json"
    vals = [5.0] * 14 + [2.5] * 6
    step = {"history": [{"rev": f"r{i}", "quick": True,
                         "runs_per_sec": {"sweep": v}, "warm_s": {"x": v}}
                        for i, v in enumerate(vals)]}
    for data in (json.loads(bench.read_text()), step):
        mine = regress.assess(data, **CPU)
        ref = jregress.assess(data)
        assert json.dumps(mine, sort_keys=True) == json.dumps(
            ref, sort_keys=True)
    assert mine["regressions"] and mine["improvements"]
    for argv in ([str(bench)], [str(bench), "--soft"]):
        rc_ref = jregress.main(argv)
        out_ref = capsys.readouterr().out
        assert regress.main(argv + ["--device", "cpu"]) == rc_ref
        assert capsys.readouterr().out == out_ref


# ---------------------------------------------------------------------------
# validation CLI
# ---------------------------------------------------------------------------

def test_validate_cli_over_port_exports(tmp_path, capsys):
    from repro_torch.obs import trace as obs_trace
    reg = obs_metrics.MetricsRegistry()
    reg.counter("jobs_total", "jobs").inc(3)
    reg.histogram("lat_s", "lat", buckets=(0.1,)).observe(0.05)
    reg.write_snapshot(tmp_path / "m.json")
    (tmp_path / "p.txt").write_text(reg.to_prometheus())
    tracer = obs_trace.Tracer(enabled=True)
    with tracer.span("work"):
        pass
    tracer.write(tmp_path / "t.json")
    assert validate.main(["--metrics", str(tmp_path / "m.json"),
                          "--trace", str(tmp_path / "t.json"),
                          "--prom", str(tmp_path / "p.txt")]) == 0
    assert capsys.readouterr().out.count("OK ") == 3
    (tmp_path / "bad.txt").write_text("# TYPE runs counter\nruns 3\n")
    assert validate.main(["--prom", str(tmp_path / "bad.txt")]) == 1
    assert validate.main(["--metrics", str(tmp_path / "none.json")]) == 1
    with pytest.raises(SystemExit):
        validate.main([])


# ---------------------------------------------------------------------------
# push sink (mirrors of tests/test_supervisor.py)
# ---------------------------------------------------------------------------

class _GatewayHandler(http.server.BaseHTTPRequestHandler):
    fail_first = 2
    posts = []
    bodies = []

    def do_POST(self):
        cls = _GatewayHandler
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        cls.posts.append(self.path)
        if len(cls.posts) <= cls.fail_first:
            self.send_response(503)
            self.end_headers()
            return
        cls.bodies.append(body)
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):  # quiet
        pass


@pytest.fixture
def gateway():
    _GatewayHandler.posts, _GatewayHandler.bodies = [], []
    srv = http.server.HTTPServer(("127.0.0.1", 0), _GatewayHandler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/push"
    srv.shutdown()
    th.join(timeout=5)


def test_push_sink_retries_through_failing_gateway(gateway):
    _GatewayHandler.fail_first = 2
    sink = obs_sink.PushSink(gateway, batch=64,
                             policy=RetryPolicy(max_retries=4, base_s=0.01),
                             sleep=lambda s: None)
    rows = [{"i": i, "v": float(i) * 0.5} for i in range(10)]
    sink.write_many(rows)
    assert len(sink) == 10
    sink.flush()
    assert len(sink) == 0 and sink.pushed == 10 and sink.errors == 0
    assert len(_GatewayHandler.posts) == 3
    got = [json.loads(ln) for ln in
           _GatewayHandler.bodies[0].decode().splitlines()]
    assert got == rows


def test_push_sink_swallows_exhausted_errors_and_respools():
    def dead_post(url, data, timeout):
        raise OSError("gateway down")

    sink = obs_sink.PushSink("http://x/push", max_spool=8, batch=4,
                             policy=RetryPolicy(max_retries=1, base_s=0.0),
                             post=dead_post, sleep=lambda s: None)
    for i in range(6):
        sink.write({"i": i})
    sink.flush()
    assert sink.errors == 1 and sink.pushed == 0
    assert len(sink) == 6


def test_push_sink_bounded_spool_drops_oldest():
    seen = []
    sink = obs_sink.PushSink("http://x/push", max_spool=4, batch=16,
                             post=lambda u, d, t: seen.append(d))
    for i in range(7):
        sink.write({"i": i})
    assert sink.dropped == 3
    sink.flush()
    got = [json.loads(ln) for ln in seen[0].decode().splitlines()]
    assert [r["i"] for r in got] == [3, 4, 5, 6]
