"""Observability of the port; the stdlib part of `repro.obs` and its
flight recorder.

`metrics` (the process-wide registry with JSON-snapshot and Prometheus
exposition), `trace` (span tracing with Chrome trace-event export) and
`retry` (the shared backoff ladder) are copies of the reference's
modules, which import neither jax nor anything else of the JAX package.
`events` is the flight recorder: the event ring the scan engine carries
per run, its host-side decoders and `EventLog`. The scrape endpoint
(`serve`), the sinks (`sink`), `validate` and the regression gate
(`regress`) come with ROADMAP Queue 1 item 8.
"""
from repro_torch.obs import events, metrics, retry, trace  # noqa: F401
from repro_torch.obs.events import (Event, EventLog,  # noqa: F401
                                    decode_grid, decode_ring,
                                    filter_events, ring_append, ring_init)
from repro_torch.obs.metrics import MetricsRegistry, get_registry  # noqa: F401
from repro_torch.obs.retry import RetryPolicy, call_with_retries  # noqa: F401
from repro_torch.obs.trace import Tracer, get_tracer  # noqa: F401

__all__ = ["events", "metrics", "trace", "retry", "Event", "EventLog",
           "decode_ring", "decode_grid", "filter_events", "ring_init",
           "ring_append", "MetricsRegistry", "get_registry", "Tracer",
           "get_tracer", "RetryPolicy", "call_with_retries"]
