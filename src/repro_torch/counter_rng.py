"""Counter-based random bits in plain integer arithmetic.

Each value is a hash of a key and a counter (murmur3's 32-bit finalizer
in int64 torch arithmetic, masked to 32 bits), so the integer bits are
the same on every device and any slice of a stream can be made alone.
Used by the closed-loop noise streams (`kernels.closed_loop.ops.
draw_noise`) and the seeded model weights (`models.layers.materialize`).
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for 0 <= x < 2**32, in int64 without overflow
    (the multiplier is split into 16-bit halves)."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer: a bijection on [0, 2**32) with full
    avalanche."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def unit24(x: torch.Tensor) -> torch.Tensor:
    """32-bit words -> float32 uniforms in [0, 1) from their top 24 bits
    (exact: every value is a multiple of 2**-24)."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
