"""Wrapper of the fused closed-loop CUDA kernel (``csrc/closed_loop.cu``),
the Hopper counterpart of the TPU kernel `closed_loop_pallas` /
`_cl_kernel` in `repro.kernels.closed_loop.kernel`.

`closed_loop_cuda` checks its tensors, allocates every output, launches
on PyTorch's current stream and raises if the launch was refused. It
counts its launches in `LAUNCHES`, so a run can show that it went
through the kernel. The library is built at the first launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, check_tensor
from repro_torch.kernels.closed_loop import ref as R

SOURCE = Path(__file__).resolve().parent / "csrc" / "closed_loop.cu"

N_PROF = len(R.F)
N_GAIN = len(R.G)

# Rows of the (N_STATE, B) carry block, in `ref.init_state` order
# (histograms come back in their own blocks).
STATE_KEYS = ("progress_l", "dropped", "energy", "work", "prev_error",
              "prev_pcap_l", "pcap", "anchor_gap", "has_anchor", "t",
              "steps", "done", "count", "progress_sum",
              "progress_sq_sum", "power_sum")
N_STATE = len(STATE_KEYS)

# Launches of the kernel in this process; read and reset by callers that
# need to show a run went through it.
LAUNCHES = 0

_ptr = ctypes.c_void_p
_f = ctypes.c_float
_i = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.closed_loop_launch
    if fn.argtypes is None:
        fn.argtypes = [_ptr, _ptr, _i, _ptr, _f, _f, _f, _f, _i, _i, _i,
                       _ptr, _ptr, _ptr, _ptr, _i, _ptr]
        fn.restype = ctypes.c_int
    return lib


def unpack_final(state, phist, chist) -> Dict[str, torch.Tensor]:
    """(N_STATE, B) carry block + histogram blocks -> the `ref` final dict."""
    c = {k: state[i] for i, k in enumerate(STATE_KEYS)}
    c["progress_hist"] = phist.T
    c["pcap_hist"] = chist.T
    return c


def closed_loop_cuda(prof: torch.Tensor, gains: torch.Tensor,
                     noise: torch.Tensor, scalars: Sequence[float],
                     collect: bool = True
                     ) -> Tuple[Optional[Dict[str, torch.Tensor]],
                                Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]]:
    """prof (B, 14), gains (B, 9) float32 or bfloat16 (both the same),
    noise (T, 5, B) float32, scalars (total_work, max_time, dt,
    summary_from) -> (traces | None, (state, phist, chist)).

    Traces are (T, B) float32 per `ref.TRACE_KEYS`; state is (16, B) in
    `STATE_KEYS` order, phist (64, B) and chist (32, B): unpack with
    `unpack_final`. All tensors must be contiguous and on one CUDA
    device."""
    global LAUNCHES
    if prof.device.type != "cuda":
        raise ValueError(f"closed_loop_cuda needs CUDA tensors, got "
                         f"{prof.device}")
    dev = prof.device
    if prof.dim() != 2 or prof.shape[0] < 1:
        raise ValueError(f"prof must be (B, {N_PROF}) with B >= 1, got "
                         f"{tuple(prof.shape)}")
    if noise.dim() != 3:
        raise ValueError(f"noise must be (T, 5, B), got {tuple(noise.shape)}")
    B, T = prof.shape[0], noise.shape[0]
    row_types = (torch.float32, torch.bfloat16)
    check_tensor("prof", prof, (B, N_PROF), row_types, dev)
    check_tensor("gains", gains, (B, N_GAIN), (prof.dtype,), dev)
    check_tensor("noise", noise, (T, R.N_NOISE, B), (torch.float32,), dev)
    if len(scalars) != 4:
        raise ValueError("scalars are (total_work, max_time, dt, "
                         "summary_from)")
    tw, mt, dt, sf = (float(s) for s in scalars)

    state = torch.empty((N_STATE, B), dtype=torch.float32, device=dev)
    phist = torch.empty((R.PROG_BINS, B), dtype=torch.float32, device=dev)
    chist = torch.empty((R.CAP_BINS, B), dtype=torch.float32, device=dev)
    traces = (torch.empty((len(R.TRACE_KEYS), T, B), dtype=torch.float32,
                          device=dev) if collect else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().closed_loop_launch(
        prof.data_ptr(), gains.data_ptr(),
        int(prof.dtype == torch.bfloat16), noise.data_ptr(), tw, mt, dt,
        sf, T, B, int(collect), state.data_ptr(), phist.data_ptr(),
        chist.data_ptr(), traces.data_ptr() if collect else None,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream)
    if err != 0:
        raise RuntimeError(f"closed_loop kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    tr = (dict(zip(R.TRACE_KEYS, traces.unbind(0))) if collect else None)
    return tr, (state, phist, chist)
