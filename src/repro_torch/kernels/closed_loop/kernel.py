"""Wrapper of the fused closed-loop CUDA kernel (``csrc/closed_loop.cu``),
the Hopper counterpart of the TPU kernel `closed_loop_pallas` /
`_cl_kernel` in `repro.kernels.closed_loop.kernel`.

The kernel takes its noise from one of two sources. `closed_loop_seeds_cuda`
(the main path) takes each run's int64 seed and generates the streams of
`ops.draw_noise` inside the kernel; `closed_loop_cuda` takes a ready
(T, 5, B) noise tensor (the route on which the port is held to the JAX
reference's noise). Both check their tensors, allocate every output, launch
on PyTorch's current stream and raise if the launch was refused. They count
their launches in `LAUNCHES` and, by route, in `ROUTE_LAUNCHES`, so a run
can show that it went through the kernel and which way. The library is
built at the first launch.
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

# Launches of the kernel in this process, in all and by noise source; read
# and reset by callers that need to show a run went through it.
LAUNCHES = 0
ROUTE_LAUNCHES = {"seeds": 0, "noise": 0}

_ptr = ctypes.c_void_p
_f = ctypes.c_float
_i = ctypes.c_int

# Horizons from this many steps on count histogram bins in 32 bits (a
# 16-bit counter holds at most 65,535 steps).
WIDE_BINS_FROM = 1 << 16


def bin_bits(T: int) -> int:
    """Width of the kernel's histogram counters for a horizon of ``T``
    steps: 16 bits (768 runs resident per SM) below `WIDE_BINS_FROM`, else
    32 bits (twice the shared memory a run, 512 runs per SM)."""
    if T < 1:
        raise ValueError(f"the horizon must be at least 1 step, got {T}")
    return 16 if T < WIDE_BINS_FROM else 32


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.closed_loop_launch
    if fn.argtypes is None:
        fn.argtypes = [_ptr, _ptr, _i, _ptr, _ptr, _f, _f, _f, _f, _i, _i,
                       _i, _i, _ptr, _ptr, _ptr, _ptr, _i, _ptr]
        fn.restype = ctypes.c_int
        res = lib.closed_loop_resources
        res.argtypes = [_i, _i, _i, _i, _i, ctypes.POINTER(ctypes.c_int)]
        res.restype = ctypes.c_int
        cos = lib.closed_loop_cos_check
        cos.argtypes = [_ptr, _i, _ptr]
        cos.restype = ctypes.c_int
    return lib


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def resources(dtype: torch.dtype, seeds: bool, collect: bool, bits: int,
              device: torch.device) -> Dict[str, int]:
    """What one instance of the kernel takes on ``device``: registers and
    spilled (local) bytes a thread, resident blocks an SM, threads and
    dynamic shared bytes a block."""
    out = (ctypes.c_int * 5)()
    err = _lib().closed_loop_resources(int(dtype == torch.bfloat16),
                                       int(seeds), int(collect), bits,
                                       _device_index(device), out)
    if err != 0:
        raise RuntimeError(f"closed_loop resources query failed: CUDA error "
                           f"{err}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm",
                     "block_threads", "shared_bytes"), out))


def cos_mismatches(device: torch.device) -> int:
    """How many of the 2^24 arguments (2 pi) * u2 that the generator gives
    its Box-Muller cosine (u2 = i * 2^-24) read another float32 from the
    kernel's cosine than from libdevice's cosf, on ``device``: 0 when the
    written-out cosine is exact."""
    count = torch.zeros(1, dtype=torch.int32, device=device)
    err = _lib().closed_loop_cos_check(
        count.data_ptr(), _device_index(device),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"closed_loop cosine check failed: CUDA error "
                           f"{err}")
    return int(count.item())


def unpack_final(state, phist, chist) -> Dict[str, torch.Tensor]:
    """(N_STATE, B) carry block + histogram blocks -> the `ref` final dict."""
    c = {k: state[i] for i, k in enumerate(STATE_KEYS)}
    c["progress_hist"] = phist.T
    c["pcap_hist"] = chist.T
    return c


Result = Tuple[Optional[Dict[str, torch.Tensor]],
               Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _check_rows(prof, gains) -> torch.device:
    if prof.device.type != "cuda":
        raise ValueError(f"the closed-loop kernel needs CUDA tensors, got "
                         f"{prof.device}")
    if prof.dim() != 2 or prof.shape[0] < 1:
        raise ValueError(f"prof must be (B, {N_PROF}) with B >= 1, got "
                         f"{tuple(prof.shape)}")
    B = prof.shape[0]
    check_tensor("prof", prof, (B, N_PROF), (torch.float32, torch.bfloat16),
                 prof.device)
    check_tensor("gains", gains, (B, N_GAIN), (prof.dtype,), prof.device)
    return prof.device


def _launch(route, prof, gains, noise, seeds, T, scalars, collect) -> Result:
    global LAUNCHES
    if len(scalars) != 4:
        raise ValueError("scalars are (total_work, max_time, dt, "
                         "summary_from)")
    tw, mt, dt, sf = (float(s) for s in scalars)
    dev, B = prof.device, prof.shape[0]
    state = torch.empty((N_STATE, B), dtype=torch.float32, device=dev)
    phist = torch.empty((R.PROG_BINS, B), dtype=torch.float32, device=dev)
    chist = torch.empty((R.CAP_BINS, B), dtype=torch.float32, device=dev)
    traces = (torch.empty((len(R.TRACE_KEYS), T, B), dtype=torch.float32,
                          device=dev) if collect else None)
    err = _lib().closed_loop_launch(
        prof.data_ptr(), gains.data_ptr(),
        int(prof.dtype == torch.bfloat16),
        None if noise is None else noise.data_ptr(),
        None if seeds is None else seeds.data_ptr(), tw, mt, dt, sf, T, B,
        int(collect), bin_bits(T), state.data_ptr(), phist.data_ptr(),
        chist.data_ptr(), traces.data_ptr() if collect else None,
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"closed_loop kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    tr = (dict(zip(R.TRACE_KEYS, traces.unbind(0))) if collect else None)
    return tr, (state, phist, chist)


def closed_loop_seeds_cuda(prof: torch.Tensor, gains: torch.Tensor,
                           seeds: torch.Tensor, T: int,
                           scalars: Sequence[float], collect: bool = True
                           ) -> Result:
    """The seeds route: prof (B, 14), gains (B, 9) float32 or bfloat16
    (both the same), seeds (B,) int64, T steps, scalars (total_work,
    max_time, dt, summary_from) -> (traces | None, (state, phist, chist)),
    as `closed_loop_cuda` returns them. Each run's noise is
    `ops.draw_noise` of its seed, generated inside the kernel. All tensors
    must be contiguous and on one CUDA device."""
    dev = _check_rows(prof, gains)
    check_tensor("seeds", seeds, (prof.shape[0],), (torch.int64,), dev)
    return _launch("seeds", prof, gains, None, seeds, int(T), scalars,
                   collect)


def closed_loop_cuda(prof: torch.Tensor, gains: torch.Tensor,
                     noise: torch.Tensor, scalars: Sequence[float],
                     collect: bool = True) -> Result:
    """The noise-tensor route: prof (B, 14), gains (B, 9) float32 or
    bfloat16 (both the same), noise (T, 5, B) float32, scalars
    (total_work, max_time, dt, summary_from) -> (traces | None, (state,
    phist, chist)).

    Traces are (T, B) float32 per `ref.TRACE_KEYS`; state is (16, B) in
    `STATE_KEYS` order, phist (64, B) and chist (32, B): unpack with
    `unpack_final`. All tensors must be contiguous and on one CUDA
    device."""
    dev = _check_rows(prof, gains)
    if noise.dim() != 3:
        raise ValueError(f"noise must be (T, 5, B), got {tuple(noise.shape)}")
    T = noise.shape[0]
    check_tensor("noise", noise, (T, R.N_NOISE, prof.shape[0]),
                 (torch.float32,), dev)
    return _launch("noise", prof, gains, noise, None, T, scalars, collect)
