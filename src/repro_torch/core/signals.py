"""Progress signal from heartbeats (paper Eq. 1); port of the functional
part of `repro.core.signals`.

Applications emit heartbeats at times t_k. The progress metric at
control period t_i is the median of instantaneous heart rates over
[t_{i-1}, t_i):

    progress(t_i) = median_k 1 / (t_k - t_{k-1})

The median makes the signal robust to stragglers/outliers (paper §4.2).
Here: the batch version over one window of beat times
(`progress_from_times`) and the beat synthesizer the tests and examples
feed it (`synth_heartbeats`). The ingestion layer
(`TenantHeartbeatStore`, `HeartbeatAggregator`) comes with ROADMAP
Queue 1 item 7.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D float tensor, the two middle values averaged for an
    even length (``(lo + hi) * 0.5``, as ``jnp.median`` computes it;
    `torch.median` would return the lower one). NaN if ``x`` is empty or
    holds a NaN."""
    n = x.shape[0]
    if n == 0:
        return torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    s = torch.sort(x).values
    mid = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(), torch.full_like(mid, np.nan),
                       mid)


def progress_from_times(beat_times: Union[Sequence[float], torch.Tensor],
                        device: Union[None, str, torch.device] = None
                        ) -> torch.Tensor:
    """Batch Eq. 1 over a full window of beat times: the median heart rate,
    a float32 0-dim tensor on ``device`` (default: the times' device if
    they are a tensor, else CUDA, raising without one)."""
    if device is None and isinstance(beat_times, torch.Tensor):
        dev = beat_times.device
    else:
        dev = resolve_device(device)
    t = torch.as_tensor(beat_times, dtype=torch.float32, device=dev)
    dts = torch.diff(t)
    rates = torch.where(dts > 0, 1.0 / torch.clamp(dts, min=1e-9),
                        torch.zeros_like(dts))
    return median(rates)


def synth_heartbeats(rng: np.random.Generator, rate_hz: float,
                     duration: float, jitter: float = 0.1) -> List[float]:
    """Synthesize beat times at a given rate with lognormal jitter."""
    t, out = 0.0, []
    if rate_hz <= 0:
        return out
    mean_dt = 1.0 / rate_hz
    while t < duration:
        t += mean_dt * float(rng.lognormal(0.0, jitter))
        out.append(t)
    return out
