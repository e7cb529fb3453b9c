"""Wrapper of the selective-scan CUDA kernel (``csrc/selective_scan.cu``),
the Hopper counterpart of the TPU kernel `_scan_kernel` /
`selective_scan_pallas` in `repro.kernels.selective_scan.kernel`.

The source holds two instances behind one C entry point, picked by the
sequence length alone (`route`): "step" for S == 1 (a decode step from
the cached state), "seq" for S > 1 (prefill). `selective_scan_cuda`
checks its tensors, allocates ``y`` and the final state, launches on
PyTorch's current stream, raises if the launch was refused, and counts
its launches in `LAUNCHES`, by instance in `ROUTE_LAUNCHES`, and in
`GENERIC_LAUNCHES` those the C entry reports as taken by the masked
generic template (a state size other than 4, 8 or 16, or a tensor not
16-byte aligned) rather than an exact one. The library is built at the
first launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, check_tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"

# the largest state size the kernel keeps in registers (16 on every arch)
MAX_STATE = 16

# Launches of the kernel in this process, of each instance, and of the
# generic template; read and reset by callers that need to show a run went
# through them.
LAUNCHES = 0
ROUTE_LAUNCHES = {"seq": 0, "step": 0}
GENERIC_LAUNCHES = 0

_ptr = ctypes.c_void_p
_i = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.selective_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _i, _i, _i,
                       _i, _i, _ptr, _ptr, _i, _ptr, ctypes.POINTER(_i)]
        fn.restype = ctypes.c_int
    res = lib.selective_scan_resources
    if res.argtypes is None:
        res.argtypes = [_i, _i, ctypes.POINTER(_i)]
        res.restype = ctypes.c_int
    return lib


def route(S: int) -> str:
    """The instance a call of sequence length ``S`` runs: "step" (no
    shared memory, one step from h0, a channel's states split across
    lanes) for S == 1, else "seq" (a thread a channel, tiles staged by
    cp.async)."""
    return "step" if S == 1 else "seq"


def resources(instance: str, device: torch.device) -> Dict[str, int]:
    """What the float32 instance at d_state 16 (the serving path's) takes
    on ``device``, "seq" or "step": registers and spilled (local) bytes a
    thread, static shared bytes a block, resident blocks an SM and
    channels a block."""
    out = (ctypes.c_int * 5)()
    err = _lib().selective_scan_resources(
        int(instance == "seq"), device.index if device.index is not None
        else torch.cuda.current_device(), out)
    if err != 0:
        raise RuntimeError(f"selective_scan resources query failed: CUDA "
                           f"error {err}")
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "blocks_per_sm", "channels_per_block"), out))


def selective_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                        h0: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt [B,S,d] (float32 or bfloat16, both alike); A [d,N], Bc, Cc
    [B,S,N], D [d] and h0 [B,d,N] (or None: zeros) float32; all contiguous
    on one CUDA device; 1 <= N <= 16; B, S, d >= 1 -> (y [B,S,d] in x's
    dtype, h_last [B,d,N] float32) of `ref.selective_scan_ref`, by the
    `route(S)` instance."""
    global LAUNCHES, GENERIC_LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan_cuda needs CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError("x, dt must be [B,S,d] and A [d,N]")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes float32 "
                        "or bfloat16")
    B, S, d = x.shape
    N = A.shape[1]
    if not 1 <= N <= MAX_STATE or min(B, S, d) < 1:
        raise ValueError(f"need 1 <= N <= {MAX_STATE} and B, S, d >= 1, "
                         f"got N={N}, x {tuple(x.shape)}")
    dev = x.device
    f32 = (torch.float32,)
    check_tensor("x", x, (B, S, d), (x.dtype,), dev)
    check_tensor("dt", dt, (B, S, d), (x.dtype,), dev)
    check_tensor("A", A, (d, N), f32, dev)
    check_tensor("Bc", Bc, (B, S, N), f32, dev)
    check_tensor("Cc", Cc, (B, S, N), f32, dev)
    check_tensor("D", D, (d,), f32, dev)
    if h0 is not None:
        check_tensor("h0", h0, (B, d, N), f32, dev)
    y = torch.empty((B, S, d), dtype=x.dtype, device=dev)
    h_last = torch.empty((B, d, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    generic = _i(0)
    err = _lib().selective_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), D.data_ptr(),
        h0.data_ptr() if h0 is not None else None,
        int(x.dtype == torch.bfloat16), B, S, d, N, y.data_ptr(),
        h_last.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream, ctypes.byref(generic))
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route(S)] += 1
    GENERIC_LAUNCHES += generic.value
    return y, h_last
