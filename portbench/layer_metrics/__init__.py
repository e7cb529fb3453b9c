"""Readers of the per-layer metrics, one file a metric, named as the
metric. Each has ``read(ctx) -> float or None``: ``ctx`` holds the traced
stretch's ``trace`` summary (`portbench.trace`), the window's ``host``
series, the configuration's ``spec``, the ``traffic``, the frozen counts
``roofline`` and ``model``, and ``window_s``. A reader that finds nothing
to read returns None, and the metric is left out of the line. The
helpers below are shared."""
from __future__ import annotations

import statistics
from typing import List, Optional

from portbench.trace import in_range


def device_s(ctx, *names: str) -> float:
    """Device seconds of the traced kernels whose name holds any of
    ``names``."""
    return sum(d for n, _, d, _ in ctx["trace"]["events"]
               if any(s in n for s in names)) / 1e9


def range_s(ctx, name: str) -> float:
    """Device seconds of the kernels launched inside host range ``name``."""
    return sum(d for _, _, d, _ in in_range(ctx["trace"], name)) / 1e9


def untraced(ctx, key: str) -> List[float]:
    h = ctx["host"]
    return [v for v, t in zip(h[key], h["traced"]) if not t]


def loop_s(ctx) -> List[float]:
    """Each untraced step's host seconds: the step to its result on the
    host, and the NRM after it."""
    return [s + n / 1e3 for s, n in zip(untraced(ctx, "step_s"),
                                        untraced(ctx, "nrm_ms"))]


def share(bound_s: float, took_s: float) -> Optional[float]:
    """100 x bound / time, or None where nothing was timed."""
    return None if took_s <= 0 else 100.0 * bound_s / took_s


def mean(xs) -> Optional[float]:
    return statistics.fmean(xs) if xs else None


def layers_of(spec: dict, kind: str) -> int:
    P = spec["pattern"]
    return sum(P[i % len(P)][0] == kind for i in range(spec["num_layers"]))
