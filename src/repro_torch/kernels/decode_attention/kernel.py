"""Wrapper of the split-KV decode-attention CUDA kernel
(``csrc/decode_attention.cu``), the Hopper counterpart of the TPU kernel
`_decode_kernel` / `decode_attention_blocks` in
`repro.kernels.decode_attention.kernel`.

`decode_partials_cuda` checks its tensors, allocates the partials,
launches on PyTorch's current stream, raises if the launch was refused,
and counts its launches in `LAUNCHES`. The library is built at the first
launch.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build, check_tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"

# KV slots per staged tile in the kernel; splits are multiples of it
TILE = 64
# the kernel's head_dim limit (its widest shared-memory row)
MAX_HEAD_DIM = 128
# the H100's streaming multiprocessors: `default_chunk` aims at two
# blocks per SM. A constant, so that the CPU path splits as the card does.
N_SM = 132

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
                       _i, _i, ctypes.c_float, _ptr, _ptr, _ptr, _i, _ptr]
        fn.restype = ctypes.c_int
    return lib


def default_chunk(B: int, K: int, T: int) -> int:
    """Slots per split: enough splits that B * K * splits fills about two
    blocks per SM, each split a whole number of tiles."""
    n = min(max(1, math.ceil(2 * N_SM / max(B * K, 1))),
            max(1, math.ceil(T / TILE)))
    return math.ceil(math.ceil(T / n) / TILE) * TILE


def decode_partials_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_pos: torch.Tensor, pos: int, chunk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """q [B,H,hd]; k, v [B,T,K,hd] (float32 or bfloat16, all alike);
    k_pos [T] int32; all contiguous on one CUDA device -> the partials
    (m [B,H,n], l [B,H,n], acc [B,H,n,hd]) float32 of `ref.
    decode_partials_ref`, n = ceil(T / chunk)."""
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"decode_partials_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("q must be [B,H,hd] and k, v [B,T,K,hd]")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes float32 "
                        "or bfloat16")
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if K < 1 or H % K or not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"need H % K == 0 and 1 <= hd <= {MAX_HEAD_DIM}, "
                         f"got H={H}, K={K}, hd={hd}")
    if T < 1 or chunk < 1:
        raise ValueError(f"need T >= 1 and chunk >= 1, got {T}, {chunk}")
    dev = q.device
    check_tensor("q", q, (B, H, hd), (q.dtype,), dev)
    check_tensor("k", k, (B, T, K, hd), (q.dtype,), dev)
    check_tensor("v", v, (B, T, K, hd), (q.dtype,), dev)
    check_tensor("k_pos", k_pos, (T,), (torch.int32,), dev)
    n = math.ceil(T / chunk)
    m = torch.empty((B, H, n), dtype=torch.float32, device=dev)
    l = torch.empty((B, H, n), dtype=torch.float32, device=dev)
    acc = torch.empty((B, H, n, hd), dtype=torch.float32, device=dev)
    if B == 0:
        return m, l, acc
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
        int(pos), int(q.dtype == torch.bfloat16), B, T, H, K, hd,
        int(chunk), n, float(hd ** -0.5), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return m, l, acc
