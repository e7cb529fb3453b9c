"""The shapes at which the selective-scan kernel is held to its plain
version, the inputs for them, and the bars.

Used by the CPU parity tests (`tests/test_torch_mamba.py`), the card tests
(`tests/test_torch_cuda.py`) and `chip_smoke.py`. `SCAN_CASES` are
`tests/test_kernels.py`'s (with the TPU kernel's ``block_d`` and ``chunk``,
which only the reference's interpret run reads). `SCAN_RAGGED` takes the
sequence instance off its exact layouts: state sizes it has no exact
instance for (5, 12: the generic instance, states masked), channels that
do not fill a block (256 channels), rows of x whose bytes are not a
multiple of 16 (the generic instance again), sequences that do not fill a
tile; and the exact bf16 instance at N = 4. `SCAN_LONG` is a long
sequence of one row, where an error in the decay would accumulate step
after step. `SCAN_STEPS` are decode steps (S = 1, the step instance) from
a non-zero state: `SCAN_STEP`, jamba's decode shape, then bf16, one batch
row with ragged channels, a ragged state size, and N = 8 (2 lanes a
channel). `SCAN_SERVE` is the jamba-v0.1-52b prefill (batch 8, 1,024
tokens, d_inner 8,192, d_state 16) at the widths the serving path gives
the kernel. `exact_instance` says which cases take an exact instance.

Bars, and why. The kernel's dA is ex2.approx of dt * (A log2e), a few
float32 ulps from the plain version's exp(dt * A); its state update and
its sum over n are fused multiply-adds, rounded once where the plain
version rounds twice; and the sum over the N state elements in ``y`` is
taken in another order (in the step instance, within a lane, then across
the lanes of a channel). Each is a few ulps a step, and a decay below 1
keeps the state's error from growing: `SCAN_LONG` reads it over 4,096
steps. Float32 ``y``
and every ``h_last``: 2e-5 absolute and relative. Bfloat16 ``y``:
rounding float32 values that differ by a few ulps can land one bf16 ulp
apart, 2^-7 of the value at most, so rtol 8e-3 with the same 2e-5
absolute.
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
    (2, 45, 200, 12, "float32"),
    (1, 33, 136, 5, "bfloat16"),
    (2, 50, 200, 16, "bfloat16"),
    (3, 21, 72, 8, "float32"),
    (2, 37, 264, 4, "bfloat16"),
]
SCAN_LONG = (1, 4096, 512, 16, "float32")
SCAN_STEP = (8, 1, 8192, 16, "float32")
SCAN_STEPS = [
    SCAN_STEP,
    (8, 1, 8192, 16, "bfloat16"),
    (1, 1, 200, 16, "float32"),
    (2, 1, 96, 5, "float32"),
    (2, 1, 200, 8, "float32"),
]
SCAN_SERVE = (8, 1024, 8192, 16, "float32")

F32_TOL = dict(atol=2e-5, rtol=2e-5)


def tolerance(dtype: str) -> dict:
    """The bar for ``y`` (``h_last`` is always float32: `F32_TOL`)."""
    return dict(atol=2e-5, rtol=8e-3) if dtype == "bfloat16" else F32_TOL


def exact_instance(case) -> bool:
    """Whether the kernel runs a case ``(B, S, d, N, dtype, ...)`` on an
    exact instance, given the freshly allocated (so 16-byte aligned)
    tensors of `scan_inputs`: a state size of 4, 8 or 16 and, for S > 1,
    rows of x whose bytes are a multiple of 16. Every other case takes the
    masked generic instance."""
    _, S, d, N, dtype = case[:5]
    size = 2 if dtype == "bfloat16" else 4
    return N in (4, 8, 16) and (S == 1 or d * size % 16 == 0)


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
