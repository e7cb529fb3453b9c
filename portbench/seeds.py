"""Sub-seeds: every draw of a run comes from ``--seed`` and a few words
naming what is drawn, so the same seed gives the same inputs, and a
part (one batch, one session) can be drawn again alone."""
from __future__ import annotations

import zlib

_M64 = (1 << 64) - 1


def sub(seed: int, *words) -> int:
    """A 63-bit seed from ``seed`` and ``words`` (ints or strings), by
    splitmix64's mixer folded over them."""
    h = 0x9E3779B97F4A7C15
    for w in (seed,) + words:
        w = zlib.crc32(w.encode()) if isinstance(w, str) else int(w)
        h = ((h ^ (w & _M64)) * 0xBF58476D1CE4E5B9) & _M64
        h = ((h ^ (h >> 31)) * 0x94D049BB133111EB) & _M64
        h ^= h >> 29
    return h >> 1


def generator(device, seed: int, *words):
    """A `torch.Generator` on ``device`` seeded by `sub`."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(sub(seed, *words))
    return g
