"""Fused multiply-add on float32 tensors: x * y + z with one rounding.

The reference's float32 arithmetic runs through XLA, which evaluates a
small dot product as a chain of fused multiply-adds (acc = fma(a_i, b_i,
acc)) and contracts a*b + c inside its fused loops into one. Where the
policies' arithmetic cancels (the RLS covariance update) or compares
(the offline-RL argmax), one rounding instead of two decides whether the
port follows the reference, so those expressions go through `fma`.

On CUDA it is `torch.addcmul`, whose kernel the compiler contracts into
an FMA instruction: one launch, where a product and a sum take two. On
the CPU, whose `addcmul` rounds the product first, the product and the
sum are formed in float64 (the product of two float32 values is exact
there) and rounded once to float32; that differs from a true FMA only
when the float64 sum lands on a float32 rounding midpoint.
"""
from __future__ import annotations

import torch


def fma(x: torch.Tensor, y, z) -> torch.Tensor:
    """x * y + z, float32, rounded once (``y``, ``z`` tensors or Python
    floats broadcasting against ``x``)."""
    if x.is_cuda:
        f = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                      device=x.device)
        return torch.addcmul(f(z), x, f(y))
    d = lambda v: torch.as_tensor(v, device=x.device).to(torch.float64)
    return (d(x) * d(y) + d(z)).to(torch.float32)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of ``x``."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)
