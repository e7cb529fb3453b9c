"""Wrappers of the flash-attention CUDA kernels. The forward: the Hopper
counterparts of the TPU kernel `_fwd_kernel` / `flash_attention_fwd` in
`repro.kernels.flash_attention.kernel`, ``csrc/flash_attention_wgmma.cu``
(tensor cores: wgmma fed by TMA, bf16), ``csrc/flash_attention_tf32.cu``
(tensor cores in split TF32, float32) and ``csrc/flash_attention.cu``
(SIMT FMAs, a head_dim that is not a multiple of 8), which also write
the rows' log-sum-exp when given an ``lse`` tensor. The backward (D, dK /
dV and dQ, three launches a call), the port of the reference's recompute
VJP `_flash_bwd`: ``csrc/flash_attention_bwd_wgmma.cu`` (bf16),
``csrc/flash_attention_bwd_tf32.cu`` (float32, split TF32) and
``csrc/flash_attention_bwd.cu`` (SIMT FMAs) on the same routes.

`route` and `bwd_route` pick the kernels from the dtype and head_dim
alone: a static rule, not a fallback. `flash_attention_cuda` and
`flash_attention_bwd_cuda` check their tensors, allocate the outputs,
launch on PyTorch's current stream, raise if a launch was refused, and
count their calls: the forward in `LAUNCHES` and, by route, in
`ROUTE_LAUNCHES`; the backward in `BWD_LAUNCHES` and `BWD_ROUTE_LAUNCHES`.
A library is built at its kernel's first launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, check_tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
WGMMA_SOURCE = SOURCE.with_name("flash_attention_wgmma.cu")
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
BWD_WGMMA_SOURCE = SOURCE.with_name("flash_attention_bwd_wgmma.cu")
TF32_SOURCE = SOURCE.with_name("flash_attention_tf32.cu")
BWD_TF32_SOURCE = SOURCE.with_name("flash_attention_bwd_tf32.cu")

# the kernels' head_dim limit (their widest tile)
MAX_HEAD_DIM = 128

# Launches of the forward kernels in this process, and of each route; read
# and reset by callers that need to show a run went through them.
LAUNCHES = 0
ROUTE_LAUNCHES = {"wgmma": 0, "tf32x3": 0, "simt": 0}
# Calls of the backward (three kernel launches each), and of each route.
BWD_LAUNCHES = 0
BWD_ROUTE_LAUNCHES = {"wgmma": 0, "tf32x3": 0, "simt": 0}

# the keys a block of the tensor-core backward's dK / dV kernel owns, on
# the bf16 route and on the split-TF32 one
BWD_TILE = 128
BWD_TF32_TILE = 64
# its rows of -lse log2(e) and D are padded to a multiple of this
BWD_ROW_PAD = 64

# the head split's zeroed tickets, one buffer a (device, stream), grown as
# calls need: the dK / dV kernel leaves every ticket at 0 again
_TICKETS: dict = {}

_ptr = ctypes.c_void_p
_i = ctypes.c_int


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a call takes, for head_dim a multiple of 8 up to 128
    (every arch's: 16 to 128): "wgmma" (tensor cores) for bfloat16,
    "tf32x3" (tensor cores in split TF32: three TF32 products per float32
    product, which hold the 2e-5 bar that one TF32 product would not) for
    float32; "simt" (FMAs outside the tensor cores) for any other head_dim
    or dtype."""
    if hd % 8 == 0 and 8 <= hd <= MAX_HEAD_DIM:
        if dtype == torch.bfloat16:
            return "wgmma"
        if dtype == torch.float32:
            return "tf32x3"
    return "simt"


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The backward's kernels: those of the forward's route, "wgmma",
    "tf32x3" (both wgmma fed by TMA) or "simt"."""
    return route(dtype, hd)


def g_split(B: int, K: int, T: int, G: int, n_sm: int,
            tile: int = BWD_TILE) -> int:
    """How many groups the dK / dV kernel splits each KV head's G query
    heads into: the smallest divisor of G that gives the card one wave of
    its blocks (one resident a multiprocessor), else G. Each group's
    partial is summed in group order, so the split changes the summation
    order only. Of the rules "blocks >= n x the multiprocessors" (n = 1,
    2, 4), timed over every split at eight shapes of the tensor-core route
    by `tools/flash_bwd_variants.py` on an H100, n = 1 takes the fastest
    split at the three large ones (starcoder2-3b's training shape: 2 of G
    = 12; at batch 1: 6; qwen3-8b's widths: none) and is on average the
    nearest to the fastest; on the 4- to 6-block `FLASH_CASES` no split
    is fastest. ``tile`` is the keys a block owns (`BWD_TF32_TILE` on the
    split-TF32 route)."""
    blocks = B * K * -(-T // tile)
    for d in range(1, G + 1):
        if G % d == 0 and blocks * d >= n_sm:
            return d
    return G


def _fn(path: str):
    """The C launch function of a route's library, typed. The tensor-core
    routes of a direction share one signature."""
    if path in ("wgmma", "tf32x3"):
        lib = _build.load(WGMMA_SOURCE if path == "wgmma" else TF32_SOURCE)
        fn = (lib.flash_attention_wgmma_launch if path == "wgmma"
              else lib.flash_attention_tf32_launch)
        args = [_ptr, _ptr, _ptr, _ptr, _ptr, _i, _i, _i, _i, _i, _i, _i,
                _i, ctypes.c_float, _i, _ptr]
    elif path in ("bwd_wgmma", "bwd_tf32x3"):
        lib = _build.load(BWD_WGMMA_SOURCE if path == "bwd_wgmma"
                          else BWD_TF32_SOURCE)
        fn = (lib.flash_attention_bwd_wgmma_launch if path == "bwd_wgmma"
              else lib.flash_attention_bwd_tf32_launch)
        args = [_ptr] * 12 + [_i] * 8 + [ctypes.c_float, _i, _i, _ptr, _ptr]
    elif path == "bwd_simt":
        fn = _build.load(BWD_SOURCE).flash_attention_bwd_launch
        args = [_ptr] * 10 + [_i] * 9 + [ctypes.c_float, _i, _ptr, _ptr]
    else:
        fn = _build.load(SOURCE).flash_attention_launch
        args = [_ptr, _ptr, _ptr, _ptr, _ptr, _i, _i, _i, _i, _i, _i, _i,
                _i, _i, ctypes.c_float, _i, _ptr]
    if fn.argtypes is None:
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return fn


def _check_qkv(q, k, v, what: str):
    """Check q [B,S,H,hd] and k, v [B,T,K,hd] as both directions take
    them; returns (B, S, T, H, K, hd)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {q.device}")
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
    check_tensor("q", q, (B, S, H, hd), (q.dtype,), q.device)
    check_tensor("k", k, (B, T, K, hd), (q.dtype,), q.device)
    check_tensor("v", v, (B, T, K, hd), (q.dtype,), q.device)
    return B, S, T, H, K, hd


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _tickets(n: int, dev: torch.device, stream) -> torch.Tensor:
    key = (_device_index(dev), stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(n, dtype=torch.int32, device=dev)
    return t


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,S,H,hd]; k, v [B,T,K,hd], contiguous, all float32 or all
    bfloat16, on one CUDA device; H % K == 0, hd <= 128 -> o [B,S,H,hd]
    in q's dtype. Positions are 0..S-1 (queries) and 0..T-1 (keys). The
    kernel is `route(q.dtype, hd)`'s; the tensor-core kernels' tensor maps
    need 16-byte aligned q, k and v. Given ``lse`` (contiguous float32
    [B,H,S] on the same device), the kernel also writes each row's natural
    log-sum-exp of its scaled, masked scores there, for the backward."""
    global LAUNCHES
    B, S, T, H, K, hd = _check_qkv(q, k, v, "flash_attention_cuda")
    dev = q.device
    if lse is not None:
        check_tensor("lse", lse, (B, H, S), (torch.float32,), dev)
    path = route(q.dtype, hd)
    if path != "simt" and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the tensor-core flash kernels need q, k and v "
                         "16-byte aligned")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None]
    if path == "simt":
        head.append(int(q.dtype == torch.bfloat16))
    err = _fn(path)(
        *head, B, S, T, H, K, hd, int(causal),
        int(window) if window is not None else 0, float(hd ** -0.5),
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {path} kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES += 1
    ROUTE_LAUNCHES[path] += 1
    return o


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             events: Optional[Sequence] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The backward of `flash_attention_cuda`: q, o, do [B,S,H,hd] and k,
    v [B,T,K,hd] in one dtype (float32 or bfloat16), lse [B,H,S] float32
    (the forward's), all contiguous on one CUDA device -> (dq, dk, dv) in
    the inputs' dtype. Three kernel launches (`bwd_route`'s: D, dK / dV,
    dQ); the tensor-core routes' TMA maps need q, k, v, o and do 16-byte
    aligned. Counted once in `BWD_LAUNCHES` and in its route's count.
    Given ``events`` (four `torch.cuda.Event(enable_timing=True)`), they
    are recorded before D, after D, after dK / dV and after dQ, so that
    ``events[i].elapsed_time(events[i + 1])`` is each launch's device
    time once the stream has reached them."""
    global BWD_LAUNCHES
    B, S, T, H, K, hd = _check_qkv(q, k, v, "flash_attention_bwd_cuda")
    dev = q.device
    check_tensor("o", o, (B, S, H, hd), (q.dtype,), dev)
    check_tensor("do", do, (B, S, H, hd), (q.dtype,), dev)
    check_tensor("lse", lse, (B, H, S), (torch.float32,), dev)
    path = bwd_route(q.dtype, hd)
    if path != "simt" and any(x.data_ptr() % 16 for x in (q, k, v, o, do)):
        raise ValueError("the tensor-core flash backward needs q, k, v, o "
                         "and do 16-byte aligned")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if events is not None and len(events) != 4:
        raise ValueError(f"events must be four CUDA events, got "
                         f"{len(events)}")
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stream = torch.cuda.current_stream(dev)
    marks = None
    if events is not None:
        for e in events:  # creates each event on the stream
            e.record(stream)
        marks = (_ptr * 4)(*(e.cuda_event for e in events))
    mask = (int(causal), int(window) if window is not None else 0,
            float(hd ** -0.5))
    ptrs = [x.data_ptr() for x in (q, k, v, o, lse, do, dq, dk, dv)]
    if path != "simt":
        tile = BWD_TILE if path == "wgmma" else BWD_TF32_TILE
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        gsplit = g_split(B, K, T, H // K, n_sm, tile)
        # -lse log2(e) and D, rows padded for the dK / dV kernel's copies
        rows = torch.empty((2, B, H, -(-S // BWD_ROW_PAD) * BWD_ROW_PAD),
                           dtype=torch.float32, device=dev)
        ws = tickets = None
        if gsplit > 1:
            ws = torch.empty((gsplit, 2, B, T, K, hd), dtype=torch.float32,
                             device=dev)
            tickets = _tickets(B * K * -(-T // tile), dev, stream)
        err = _fn("bwd_" + path)(
            *ptrs, rows.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            tickets.data_ptr() if tickets is not None else None,
            B, S, T, H, K, hd, *mask, gsplit, _device_index(dev),
            stream.cuda_stream, marks)
    else:
        delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        err = _fn("bwd_simt")(
            *ptrs, delta.data_ptr(), int(q.dtype == torch.bfloat16), B, S, T,
            H, K, hd, *mask, _device_index(dev), stream.cuda_stream, marks)
    if err != 0:
        raise RuntimeError(f"flash_attention backward {path} kernel launch "
                           f"failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    BWD_ROUTE_LAUNCHES[path] += 1
    return dq, dk, dv
