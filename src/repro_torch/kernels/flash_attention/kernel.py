"""Wrapper of the flash-attention forward CUDA kernel
(``csrc/flash_attention.cu``), the Hopper counterpart of the TPU kernel
`_fwd_kernel` / `flash_attention_fwd` in
`repro.kernels.flash_attention.kernel`.

`flash_attention_cuda` checks its tensors, allocates the output,
launches on PyTorch's current stream, raises if the launch was refused,
and counts its launches in `LAUNCHES`. The library is built at the first
launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build, check_tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# the kernel's head_dim limit (its widest register tile)
MAX_HEAD_DIM = 128

# Launches of the kernel in this process; read and reset by callers that
# need to show a run went through it.
LAUNCHES = 0

_ptr = ctypes.c_void_p
_i = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_ptr, _ptr, _ptr, _ptr, _i, _i, _i, _i, _i, _i, _i,
                       _i, _i, ctypes.c_float, _i, _ptr]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """q [B,S,H,hd]; k, v [B,T,K,hd], contiguous, all float32 or all
    bfloat16, on one CUDA device; H % K == 0, hd <= 128 -> o [B,S,H,hd]
    in q's dtype. Positions are 0..S-1 (queries) and 0..T-1 (keys)."""
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be [B,S,H,hd] and k, v [B,T,K,hd]")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes float32 "
                        "or bfloat16")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if K < 1 or H % K or not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"need H % K == 0 and 1 <= hd <= {MAX_HEAD_DIM}, "
                         f"got H={H}, K={K}, hd={hd}")
    dev = q.device
    check_tensor("q", q, (B, S, H, hd), (q.dtype,), dev)
    check_tensor("k", k, (B, T, K, hd), (q.dtype,), dev)
    check_tensor("v", v, (B, T, K, hd), (q.dtype,), dev)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(q.dtype == torch.bfloat16), B, S, T, H, K, hd, int(causal),
        int(window) if window is not None else 0, float(hd ** -0.5),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return o
