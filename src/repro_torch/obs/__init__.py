"""Observability of the port; the stdlib part of `repro.obs`.

`metrics` (the process-wide registry with JSON-snapshot and Prometheus
exposition), `trace` (span tracing with Chrome trace-event export) and
`retry` (the shared backoff ladder) are copies of the reference's
modules, which import neither jax nor anything else of the JAX package.
The flight recorder (`events`), the scrape endpoint (`serve`), the sinks
(`sink`), `validate` and the regression gate (`regress`) come with
ROADMAP Queue 1 items 6 and 8.
"""
from repro_torch.obs import metrics, retry, trace  # noqa: F401
from repro_torch.obs.metrics import MetricsRegistry, get_registry  # noqa: F401
from repro_torch.obs.retry import RetryPolicy, call_with_retries  # noqa: F401
from repro_torch.obs.trace import Tracer, get_tracer  # noqa: F401

__all__ = ["metrics", "trace", "retry", "MetricsRegistry", "get_registry",
           "Tracer", "get_tracer", "RetryPolicy", "call_with_retries"]
