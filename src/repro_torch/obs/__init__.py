"""Observability of the port; the stdlib part of `repro.obs` and its
flight recorder.

`metrics` (the process-wide registry with JSON-snapshot and Prometheus
exposition), `trace` (span tracing with Chrome trace-event export) and
`retry` (the shared backoff ladder) are copies of the reference's
modules, which import neither jax nor anything else of the JAX package.
`events` is the flight recorder: the event ring the scan engine carries
per run, its host-side decoders and `EventLog`. `serve` is the live
scrape endpoint, `sink` the streaming sinks (JSONL writer, metrics
sampler, push sink, decision consumer), `validate` the export-schema
CLI. The regression gate (`regress`) is not imported here: it pulls in
the engine's detector from `repro_torch.core`, which imports this
package; run it as ``python -m repro_torch.obs.regress`` or import it
explicitly.
"""
from repro_torch.obs import (events, metrics, retry, serve,  # noqa: F401
                             sink, trace)
from repro_torch.obs.events import (Event, EventLog,  # noqa: F401
                                    decode_grid, decode_ring,
                                    filter_events, ring_append, ring_init)
from repro_torch.obs.metrics import MetricsRegistry, get_registry  # noqa: F401
from repro_torch.obs.retry import RetryPolicy, call_with_retries  # noqa: F401
from repro_torch.obs.serve import ObsServer, start_server  # noqa: F401
from repro_torch.obs.sink import (JsonlSink, MetricsSampler,  # noqa: F401
                                  PushSink, decision_consumer, read_jsonl)
from repro_torch.obs.trace import Tracer, get_tracer  # noqa: F401

__all__ = ["events", "metrics", "trace", "retry", "serve", "sink", "Event",
           "EventLog", "decode_ring", "decode_grid", "filter_events",
           "ring_init", "ring_append", "MetricsRegistry", "get_registry",
           "Tracer", "get_tracer", "RetryPolicy", "call_with_retries",
           "ObsServer", "start_server", "JsonlSink", "MetricsSampler",
           "PushSink", "decision_consumer", "read_jsonl"]
