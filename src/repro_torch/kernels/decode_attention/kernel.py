"""Wrapper of the split-KV decode-attention CUDA kernel
(``csrc/decode_attention.cu``), the Hopper counterpart of the TPU kernel
`_decode_kernel` / `decode_attention_blocks` in
`repro.kernels.decode_attention.kernel` together with the log-sum-exp
combine of `repro.kernels.decode_attention.ops`: one call launches the partials
kernel and the combine kernel, and returns both the per-split partials
and the combined output.

`decode_attention_cuda` checks its tensors, allocates the partials and
the output, launches on PyTorch's current stream, raises if the launch
was refused, and counts its launches in `LAUNCHES`. The library is built
at the first launch.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build, check_tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"

# KV slots per ring stage of the kernel; splits are multiples of it
TILE = 32
# the kernel's head_dim limit (its widest shared-memory row) and query
# heads per KV head (its widest register tile)
MAX_HEAD_DIM = 128
MAX_GROUP = 16
# the H100's streaming multiprocessors, and the blocks of the partials
# kernel per SM that `default_chunk` fills one wave with: 2, as fewer and
# longer blocks read the qwen3-8b serving cache fastest on the card
# (PERF.md). Constants, so that the CPU path splits as the card does.
N_SM = 132
BLOCKS_PER_SM = 2

# Launches of the kernel in this process; read and reset by callers that
# need to show a run went through it.
LAUNCHES = 0

_ptr = ctypes.c_void_p
_i = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_ptr, _ptr, _ptr, _ptr, _i, _i, _i, _i, _i, _i, _i,
                       _i, _i, ctypes.c_float, _ptr, _ptr, _ptr, _ptr, _i,
                       _ptr]
        fn.restype = ctypes.c_int
    return lib


def default_chunk(B: int, K: int, T: int) -> int:
    """Slots per split: as many splits as one wave of `BLOCKS_PER_SM`
    blocks on every SM holds (at least one, at most one per tile), each a
    whole number of tiles."""
    n = min(max(1, BLOCKS_PER_SM * N_SM // max(B * K, 1)),
            max(1, math.ceil(T / TILE)))
    return math.ceil(math.ceil(T / n) / TILE) * TILE


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, k_pos: torch.Tensor, pos: int,
                          chunk: int) -> Tuple[torch.Tensor, Tuple[
                              torch.Tensor, torch.Tensor, torch.Tensor]]:
    """q [B,H,hd]; k, v [B,T,K,hd] (float32 or bfloat16, all alike, rows
    of a multiple of 16 bytes, 16-byte aligned); k_pos [T] int32; all
    contiguous on one CUDA device; H % K == 0, H / K <= 16 -> (o [B,H,hd]
    in q's dtype, the partials (m [B,H,n], l [B,H,n], acc [B,H,n,hd])
    float32 of `ref.decode_partials_ref`, n = ceil(T / chunk)); o is
    `ops.combine` of the partials."""
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("q must be [B,H,hd] and k, v [B,T,K,hd]")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes float32 "
                        "or bfloat16")
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    vec = 16 // q.element_size()
    if K < 1 or H % K or H // K > MAX_GROUP or not 1 <= hd <= MAX_HEAD_DIM \
            or hd % vec:
        raise ValueError(f"need H % K == 0, H / K <= {MAX_GROUP} and hd <= "
                         f"{MAX_HEAD_DIM} a multiple of {vec}, got H={H}, "
                         f"K={K}, hd={hd}")
    if T < 1 or chunk < 1:
        raise ValueError(f"need T >= 1 and chunk >= 1, got {T}, {chunk}")
    dev = q.device
    check_tensor("q", q, (B, H, hd), (q.dtype,), dev)
    check_tensor("k", k, (B, T, K, hd), (q.dtype,), dev)
    check_tensor("v", v, (B, T, K, hd), (q.dtype,), dev)
    check_tensor("k_pos", k_pos, (T,), (torch.int32,), dev)
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the decode kernel needs q, k and v 16-byte "
                         "aligned")
    n = math.ceil(T / chunk)
    m = torch.empty((B, H, n), dtype=torch.float32, device=dev)
    l = torch.empty((B, H, n), dtype=torch.float32, device=dev)
    acc = torch.empty((B, H, n, hd), dtype=torch.float32, device=dev)
    o = torch.empty_like(q)
    if B == 0:
        return o, (m, l, acc)
    err = _lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
        int(pos), int(q.dtype == torch.bfloat16), B, T, H, K, hd,
        int(chunk), n, float(hd ** -0.5), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), o.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return o, (m, l, acc)
