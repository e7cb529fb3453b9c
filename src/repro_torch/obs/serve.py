"""Live telemetry scrape endpoint: the registry/EventLog layer as an
HTTP service, so long campaigns are observable *while they run*.

Port of `repro.obs.serve`, copied line for line apart from the names it
imports (stdlib only; it serves the port's registry).

`start_server()` spins up a stdlib ``ThreadingHTTPServer`` on a daemon
thread (zero non-stdlib dependencies, never blocks the control path)
exposing:

  * ``/metrics``       — Prometheus exposition text
                         (`metrics.render_prometheus`)
  * ``/metrics.json``  — the schema-validated registry snapshot
  * ``/events``        — the attached host ``EventLog`` / decision-stream
                         tails as JSONL (``?n=`` limits rows per source,
                         ``?log=`` selects one source)
  * ``/healthz``       — liveness: ``ok`` + uptime

Attach points: ``ControlPlane.serve()`` / ``NRM.serve()`` start a server
with their decision streams wired in, and `repro_torch.launch.serve
--obs-port` exposes the serving loop's controller.
`executor.run_grid` needs no attach call — it publishes into the
process registry, which every server instance scrapes.

The CLI replays *exported* telemetry instead of a live process:

  PYTHONPATH=src python -m repro_torch.obs.serve --port 9099 \\
      --metrics BENCH_metrics.json --events telemetry/events.jsonl

File sources are re-read per request, so pointing ``--events`` at a
rotating `repro_torch.obs.sink.JsonlSink` output tails the live file.
Scrapes are themselves observable: each request increments
``obs_scrapes_total{path=}`` in the served registry.
"""
from __future__ import annotations

import argparse
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from repro_torch.obs import metrics as obs_metrics

logger = logging.getLogger("repro_torch.obs.serve")

DEFAULT_EVENT_TAIL = 256


def _source_rows(source: Any, n: int) -> List[Dict[str, Any]]:
    """Normalize one event source to a list of dicts (newest-last,
    tail-limited). Accepts an ``EventLog``, a callable returning
    events/dicts, or a plain list."""
    items = source() if callable(source) else source
    if hasattr(items, "events"):
        items = items.events()
    rows = [e.as_dict() if hasattr(e, "as_dict") else dict(e)
            for e in list(items)[-n:]]
    return rows


class ObsServer:
    """One scrape endpoint over a registry + named event sources."""

    def __init__(self, registry: Optional[obs_metrics.MetricsRegistry]
                 = None, host: str = "127.0.0.1", port: int = 0,
                 event_sources: Optional[Dict[str, Any]] = None,
                 snapshot_fn: Optional[Callable[[], dict]] = None):
        self.registry = registry or obs_metrics.get_registry()
        self.host = host
        self._want_port = int(port)
        self._sources: Dict[str, Any] = dict(event_sources or {})
        # override hook for file-backed serving: () -> snapshot dict
        self._snapshot_fn = snapshot_fn or self.registry.snapshot
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.time()

    # ------------------------------------------------------------ wiring
    def add_event_source(self, name: str, source: Any) -> None:
        """Register an ``EventLog`` / callable under ``name`` — its tail
        appears on ``/events`` tagged ``"log": name``."""
        self._sources[str(name)] = source

    def events_payload(self, n: int = DEFAULT_EVENT_TAIL,
                       log: Optional[str] = None) -> List[Dict[str, Any]]:
        rows: List[Dict[str, Any]] = []
        for name, src in self._sources.items():
            if log is not None and name != log:
                continue
            for r in _source_rows(src, n):
                rows.append({"log": name, **r})
        return rows

    # ----------------------------------------------------------- service
    def start(self) -> "ObsServer":
        if self._httpd is not None:
            return self
        server = self

        class _Handler(BaseHTTPRequestHandler):
            server_version = "repro-obs/1"
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: N802
                logger.debug("obs.serve %s", fmt % args)

            def _reply(self, status: int, body: str, ctype: str) -> None:
                data = body.encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                url = urlparse(self.path)
                q = parse_qs(url.query)
                server.registry.counter(
                    "obs_scrapes_total",
                    "scrape-endpoint requests served",
                    labelnames=("path",)).inc(path=url.path)
                try:
                    if url.path == "/healthz":
                        self._reply(200, json.dumps(
                            {"status": "ok",
                             "uptime_s": round(time.time() - server._t0,
                                               3)}) + "\n",
                            "application/json")
                    elif url.path == "/metrics":
                        snap = server._snapshot_fn()
                        self._reply(
                            200, obs_metrics.render_prometheus(snap),
                            "text/plain; version=0.0.4; charset=utf-8")
                    elif url.path == "/metrics.json":
                        snap = server._snapshot_fn()
                        obs_metrics.validate_snapshot(snap)
                        self._reply(200, json.dumps(snap) + "\n",
                                    "application/json")
                    elif url.path == "/events":
                        n = int(q.get("n", [DEFAULT_EVENT_TAIL])[0])
                        log = q.get("log", [None])[0]
                        rows = server.events_payload(max(n, 1), log)
                        body = "".join(
                            json.dumps(r, separators=(",", ":")) + "\n"
                            for r in rows)
                        self._reply(200, body, "application/x-ndjson")
                    else:
                        self._reply(404, "not found\n", "text/plain")
                except Exception as e:  # a broken payload is a 500,
                    logger.exception("obs.serve request failed")
                    self._reply(500, f"error: {e}\n", "text/plain")

        self._httpd = ThreadingHTTPServer((self.host, self._want_port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-obs-serve",
            daemon=True)
        self._thread.start()
        logger.info("obs.serve listening on %s", self.url)
        return self

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "ObsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def start_server(registry: Optional[obs_metrics.MetricsRegistry] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 event_sources: Optional[Dict[str, Any]] = None,
                 snapshot_fn: Optional[Callable[[], dict]] = None
                 ) -> ObsServer:
    """Start a scrape endpoint on a daemon thread; ``port=0`` binds a
    free port (read it back from ``.port`` / ``.url``). Returns the
    running `ObsServer` — call ``.stop()`` to halt it."""
    return ObsServer(registry, host=host, port=port,
                     event_sources=event_sources,
                     snapshot_fn=snapshot_fn).start()


# ------------------------------------------------------------------- CLI
def _file_snapshot(path: Path) -> Callable[[], dict]:
    def load() -> dict:
        with open(path) as fh:
            return json.load(fh)
    return load


def _file_events(path: Path) -> Callable[[], List[dict]]:
    def load() -> List[dict]:
        try:
            with open(path) as fh:
                lines = fh.readlines()
        except FileNotFoundError:
            return []
        return [json.loads(ln) for ln in lines[-DEFAULT_EVENT_TAIL:]
                if ln.strip()]
    return load


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9099)
    p.add_argument("--metrics", default=None,
                   help="serve this snapshot JSON (re-read per request) "
                        "instead of the live process registry")
    p.add_argument("--events", default=None, action="append",
                   help="JSONL event-sink file to tail on /events "
                        "(repeatable; re-read per request)")
    args = p.parse_args(argv)
    sources = {Path(f).stem: _file_events(Path(f))
               for f in (args.events or [])}
    srv = start_server(
        port=args.port, host=args.host, event_sources=sources,
        snapshot_fn=(_file_snapshot(Path(args.metrics))
                     if args.metrics else None))
    print(f"serving {srv.url}/metrics  /metrics.json  /events  /healthz")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
