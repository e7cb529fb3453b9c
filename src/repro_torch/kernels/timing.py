"""Device time of short calls on the card, for `chip_smoke.py` and
`tools/attention_variants.py`.

A decode layer's kernels take less time on the card than the host takes
to enqueue them, so one call timed between two CUDA events reads the
host. `device_ms` enqueues calls back to back behind a spin kernel that
holds the card until the host has enqueued them all, so the events read
the card's own time per call.
"""
from __future__ import annotations

import time

import numpy as np


def device_ms(fn, reps=20, warmup=3, rounds=5):
    """Median device milliseconds per call of ``fn``. Each round enqueues
    ``reps`` calls back to back between two CUDA events, behind a spin
    kernel (`torch.cuda._sleep`) that holds the card while the host
    enqueues them, so the events time the card's work and not the host's
    enqueue, which takes longer than a decode layer's kernels. The spin is
    timed too, and lengthened until it outlasts the enqueue."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 1_000_000  # clock cycles
    times = []
    while len(times) < rounds:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(spin)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) < enqueue_ms:
            spin *= 2  # the card went idle before the last call: again
            continue
        times.append(ev[1].elapsed_time(ev[2]) / reps)
    return float(np.median(times))


def in_turns(kernel, library, **kw):
    """`device_ms` of a kernel and of its library yardstick, timed kernel,
    library, library, kernel on one card; the mean of each pair."""
    k1, l1, l2, k2 = (device_ms(f, **kw)
                      for f in (kernel, library, library, kernel))
    return (k1 + k2) / 2, (l1 + l2) / 2
