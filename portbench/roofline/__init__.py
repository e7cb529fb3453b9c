"""Frozen operation and byte counts of the port's kernels and of a whole
step, from shapes alone, and the H100's data-sheet peaks. A kernel's
share of its roofline is the least time the chip could take (the larger
of operations over the peak rate and bytes over the HBM rate) over the
time it took; each input byte is counted read once and each output byte
written once."""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
BF16_PER_S = 989e12
TF32_PER_S = 495e12
FP32_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

# the selective scan's float32 operations: per state and step (exp's
# argument, the decay, the input's product, the update, the read-out
# product and sum) and per channel and step (dt x, the skip, its add)
SCAN_FLOPS_PER_STATE = 6
SCAN_FLOPS_PER_CHANNEL = 3

# the decode kernel's split of the cache (`decode_attention.kernel.
# default_chunk`): a wave of 2 blocks on each of the 132 SMs, 32-slot
# tiles
DECODE_TILE, DECODE_SMS, DECODE_BLOCKS_PER_SM = 32, 132, 2


def bound_s(flops: float, n_bytes: float, rate: float = BF16_PER_S) -> float:
    return max(flops / rate, n_bytes / HBM_BYTES_PER_S)


def pairs(S: int, causal: bool = True) -> float:
    """(query, key) pairs a head sees: S (S + 1) / 2 causal."""
    return S * (S + 1) / 2 if causal else float(S * S)


def flash_fwd(B, S, H, K, hd, causal=True, size=2):
    """The flash forward: Q K^T and P V over the visible pairs; q, k, v
    read, o written."""
    flops = 4 * B * H * hd * pairs(S, causal)
    n_bytes = (2 * B * S * H * hd + 2 * B * S * K * hd) * size
    return flops, n_bytes


def flash_bwd(B, S, H, K, hd, causal=True, size=2):
    """The flash backward: the five products dq, dk and dv need (S, dP,
    dV, dK, dQ) over the visible pairs; q, o, dO, dq and k, v, dk, dv at
    ``size`` bytes, the rows' float32 log-sum-exp."""
    flops = 5 * 2 * B * H * hd * pairs(S, causal)
    n_bytes = (4 * B * S * H * hd + 4 * B * S * K * hd) * size + B * H * S * 4
    return flops, n_bytes


def decode_splits(B: int, K: int, T: int) -> int:
    n = min(max(1, DECODE_BLOCKS_PER_SM * DECODE_SMS // max(B * K, 1)),
            max(1, math.ceil(T / DECODE_TILE)))
    chunk = math.ceil(math.ceil(T / n) / DECODE_TILE) * DECODE_TILE
    return math.ceil(T / chunk)


def decode_attn(B, T, H, K, hd, live, size=2):
    """One decode step of one layer, partials and combine: q read, the
    ``live`` K and V rows and the slots' positions read, the float32
    partials (m, l, acc) and o written."""
    n_split = decode_splits(B, K, T)
    flops = 4 * B * H * live * hd
    n_bytes = (2 * B * H * hd * size + 2 * B * live * K * hd * size + T * 4
               + B * H * n_split * (hd + 2) * 4)
    return flops, n_bytes


def scan(B, S, d, N, size=4, h0=False):
    """The selective scan: x, dt (``size`` bytes) and A, B, C, D (float32)
    read, y (``size``) and the last state written; h0 read when given."""
    flops = SCAN_FLOPS_PER_STATE * B * S * d * N \
        + SCAN_FLOPS_PER_CHANNEL * B * S * d
    n_bytes = (3 * B * S * d * size + (2 * B * S * N + d * N + d) * 4
               + B * d * N * 4 * (2 if h0 else 1))
    return flops, n_bytes
