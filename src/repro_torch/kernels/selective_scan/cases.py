"""The shapes at which the selective-scan kernel is held to its plain
version, the inputs for them, and the bars.

Used by the CPU parity tests (`tests/test_torch_mamba.py`), the card tests
(`tests/test_torch_cuda.py`) and `chip_smoke.py`. `SCAN_CASES` are
`tests/test_kernels.py`'s (with the TPU kernel's ``block_d`` and ``chunk``,
which only the reference's interpret run reads); `SCAN_RAGGED` adds a state
size the kernel has no exact instance for, channels that do not fill a
block and a sequence that does not fill a tile; `SCAN_STEP` is one decode
step from a non-zero state and `SCAN_SERVE` the jamba-v0.1-52b prefill
(batch 8, 1,024 tokens, d_inner 8,192, d_state 16), both at the widths the
serving path gives the kernel.

Bars, and why. The kernel performs the plain version's operations in its
order (no fast math, no FMA contraction); only the sum over the N state
elements in ``y`` is taken in another order (16 terms: a few float32 ulps
of the largest term). Float32 ``y`` and every ``h_last``: 2e-5 absolute
and relative. Bfloat16 ``y``: rounding float32 values that differ by a few
ulps can land one bf16 ulp apart, 2^-7 of the value at most, so rtol 8e-3
with the same 2e-5 absolute.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# (B, S, d, N, dtype, block_d, chunk)
SCAN_CASES = [
    (2, 64, 32, 8, "float32", 16, 32),
    (1, 128, 64, 16, "float32", 32, 64),
    (2, 96, 48, 4, "float32", 16, 32),
    (1, 64, 32, 8, "bfloat16", 16, 16),
]
# (B, S, d, N, dtype)
SCAN_RAGGED = [
    (3, 70, 200, 5, "float32"),
    (2, 100, 300, 16, "bfloat16"),
]
SCAN_STEP = (8, 1, 8192, 16, "float32")
SCAN_SERVE = (8, 1024, 8192, 16, "float32")

F32_TOL = dict(atol=2e-5, rtol=2e-5)


def tolerance(dtype: str) -> dict:
    """The bar for ``y`` (``h_last`` is always float32: `F32_TOL`)."""
    return dict(atol=2e-5, rtol=8e-3) if dtype == "bfloat16" else F32_TOL


def scan_inputs(case, device, seed: int = 0, with_h0: bool = False
                ) -> Tuple[torch.Tensor, ...]:
    """(x, dt, A, Bc, Cc, D, h0) for a case ``(B, S, d, N, dtype, ...)``,
    drawn on the CPU from ``seed``: x normal, dt = softplus(normal),
    A = -exp(normal / 2), Bc, Cc, D normal, as `tests/test_kernels.py`
    draws them; h0 normal when ``with_h0``, else None."""
    B, S, d, N, dtype = case[:5]
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    dt_ = getattr(torch, dtype)
    x = randn(B, S, d).to(device, dt_)
    dt = torch.nn.functional.softplus(randn(B, S, d)).to(device, dt_)
    A = (-torch.exp(0.5 * randn(d, N))).to(device)
    Bc, Cc, D = randn(B, S, N).to(device), randn(B, S, N).to(device), \
        randn(d).to(device)
    h0: Optional[torch.Tensor] = randn(B, d, N).to(device) if with_h0 \
        else None
    return x, dt, A, Bc, Cc, D, h0
