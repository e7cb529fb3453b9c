"""Wrappers of the flash-attention forward CUDA kernels, the Hopper
counterparts of the TPU kernel `_fwd_kernel` / `flash_attention_fwd` in
`repro.kernels.flash_attention.kernel`: ``csrc/flash_attention_wgmma.cu``
(tensor cores: wgmma fed by TMA, bf16) and ``csrc/flash_attention.cu``
(SIMT float32 FMAs, float32 and any other shape).

`route` picks the kernel from the dtype and head_dim alone: a static
rule, not a fallback. `flash_attention_cuda` checks its tensors,
allocates the output, launches the routed kernel on PyTorch's current
stream, raises if the launch was refused, and counts its launches in
`LAUNCHES` and, by route, in `ROUTE_LAUNCHES`. A library is built at its
kernel's first launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build, check_tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
WGMMA_SOURCE = SOURCE.with_name("flash_attention_wgmma.cu")

# the kernels' head_dim limit (their widest tile)
MAX_HEAD_DIM = 128

# Launches of either kernel in this process, and of each route; read and
# reset by callers that need to show a run went through them.
LAUNCHES = 0
ROUTE_LAUNCHES = {"wgmma": 0, "simt": 0}

_ptr = ctypes.c_void_p
_i = ctypes.c_int


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a call takes: "wgmma" (tensor cores) for bfloat16 with
    head_dim a multiple of 8 up to 128 (64, 96, 120 and 128: every arch),
    else "simt". float32 stays on the SIMT kernel, whose float32 FMAs hold
    the 2e-5 bar that TF32 tensor cores would not."""
    if dtype == torch.bfloat16 and hd % 8 == 0 and 8 <= hd <= MAX_HEAD_DIM:
        return "wgmma"
    return "simt"


def _fn(path: str):
    """The C launch function of a route's library, typed."""
    if path == "wgmma":
        fn = _build.load(WGMMA_SOURCE).flash_attention_wgmma_launch
        args = [_ptr, _ptr, _ptr, _ptr, _i, _i, _i, _i, _i, _i, _i, _i,
                ctypes.c_float, _i, _ptr]
    else:
        fn = _build.load(SOURCE).flash_attention_launch
        args = [_ptr, _ptr, _ptr, _ptr, _i, _i, _i, _i, _i, _i, _i, _i, _i,
                ctypes.c_float, _i, _ptr]
    if fn.argtypes is None:
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """q [B,S,H,hd]; k, v [B,T,K,hd], contiguous, all float32 or all
    bfloat16, on one CUDA device; H % K == 0, hd <= 128 -> o [B,S,H,hd]
    in q's dtype. Positions are 0..S-1 (queries) and 0..T-1 (keys). The
    kernel is `route(q.dtype, hd)`'s; the tensor-core kernel's tensor maps
    need 16-byte aligned q, k and v."""
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
    path = route(q.dtype, hd)
    if path == "wgmma" and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the tensor-core flash kernel needs q, k and v "
                         "16-byte aligned")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
    if path == "simt":
        head.append(int(q.dtype == torch.bfloat16))
    err = _fn(path)(
        *head, B, S, T, H, K, hd, int(causal),
        int(window) if window is not None else 0, float(hd ** -0.5),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {path} kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES += 1
    ROUTE_LAUNCHES[path] += 1
    return o
