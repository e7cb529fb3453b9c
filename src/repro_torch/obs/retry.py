"""Shared retry/backoff ladder: one policy object, two consumers.

Port of `repro.obs.retry`, copied line for line (stdlib only).

The campaign supervisor (`repro.core.supervisor`) and the push-gateway
sink (`repro.obs.sink.PushSink`) both face the same problem — a flaky
downstream (an XLA chunk, an HTTP collector) whose transient failures
should be absorbed with exponential backoff + jitter under a bounded
retry budget, never by spinning or by giving up on the first hiccup.
`RetryPolicy` is that ladder as a frozen, picklable value (it rides the
supervisor's campaign spec through pickle); `call_with_retries` is the
simple synchronous driver for callers without their own orchestration
loop.

Stdlib only — importing this module can never perturb jax tracing, and
the sink layer keeps its no-jax guarantee.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff schedule with a bounded attempt budget.

    ``max_retries`` counts RETRIES, not attempts: a call may run at most
    ``1 + max_retries`` times. ``backoff_s(attempt)`` is the sleep after
    failed attempt number ``attempt`` (0-based):
    ``min(base_s * factor**attempt, max_s)``, scaled by a uniform
    ``1 +/- jitter`` factor when an ``rng`` is supplied — deterministic
    under a seeded `random.Random`, so chaos tests replay exactly.
    """
    max_retries: int = 3
    base_s: float = 0.05
    factor: float = 2.0
    max_s: float = 30.0
    jitter: float = 0.25

    def backoff_s(self, attempt: int,
                  rng: Optional[random.Random] = None) -> float:
        d = min(self.base_s * self.factor ** max(int(attempt), 0),
                self.max_s)
        if self.jitter and rng is not None:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(d, 0.0)


def call_with_retries(fn: Callable, policy: RetryPolicy, *,
                      retry_on: Tuple[Type[BaseException], ...]
                      = (Exception,),
                      on_retry: Optional[Callable] = None,
                      sleep: Callable[[float], None] = time.sleep,
                      rng: Optional[random.Random] = None):
    """Run ``fn()`` through the ladder: re-raise the last error once the
    budget is spent. ``on_retry(attempt, delay_s, exc)`` observes every
    backoff (the hook metrics publish through); ``sleep`` is injectable
    so tests never wait on the wall clock."""
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if attempt >= policy.max_retries:
                raise
            delay = policy.backoff_s(attempt, rng)
            if on_retry is not None:
                on_retry(attempt, delay, e)
            sleep(delay)
            attempt += 1
