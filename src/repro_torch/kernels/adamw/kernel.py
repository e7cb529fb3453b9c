"""Wrapper of the AdamW CUDA kernels (``csrc/adamw.cu``): the gradients'
global norm and clip factor (`norm_and_clip`) and the in-place update of
many (param, grad, m, v) at once (`update`). They replace no TPU kernel
(the JAX package leaves AdamW to XLA); their plain version is
`repro_torch.optim.adamw` (`global_norm`, `_update`), which the CPU path
runs and which the update equals bit for bit for the same scalars.

Both check their tensors, pass the pointers and sizes to the C entry
points, which launch on PyTorch's current stream in groups of tensors
that fit the 4 KB kernel-argument limit, raise if a launch was refused,
and count the launches in `LAUNCHES` (and `update` the parameter
elements its launches took in `ELEMENTS`). Nothing is read back to the
host.
While a profiler records, the launches run inside the host ops
``adamw.norm`` and ``adamw.update`` (`kernels.host_op`), to which the
trace links their kernels. The library is built at the first launch.
"""
from __future__ import annotations

import ctypes
import functools
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import _build, host_op

SOURCE = Path(__file__).resolve().parent / "csrc" / "adamw.cu"

# the types the kernels take: params and grads bf16 or float32, m and v
# both bf16 or both float32
TYPES = (torch.bfloat16, torch.float32)

# Launches of the kernels in this process; read and reset by callers that
# need to show a run went through them.
LAUNCHES = 0
# Parameter elements the update launches of this process took, counted
# per group of quads handed to a launch; `optim.adamw`'s tally reads it.
ELEMENTS = 0

_ptr = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_ll = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if lib.adamw_update_launch.argtypes is None:
        lib.adamw_chunk.argtypes = []
        lib.adamw_chunk.restype = _ll
        lib.adamw_sumsq_launch.argtypes = [_i, _ptr, _ptr, _i, _ptr, _i, _ptr,
                                           ctypes.POINTER(_i)]
        lib.adamw_finalize_launch.argtypes = [_ptr, _i, _f, _ptr, _ptr, _i,
                                              _ptr]
        lib.adamw_update_launch.argtypes = (
            [_i] + [_ptr] * 5 + [_i] * 3 + [_ptr] * 4 + [_f] * 6
            + [_i, _ptr, ctypes.POINTER(_i)])
        for fn in (lib.adamw_sumsq_launch, lib.adamw_finalize_launch,
                   lib.adamw_update_launch):
            fn.restype = ctypes.c_int
    return lib


@functools.cache
def chunk() -> int:
    """Elements a block of either pass takes (the source's kChunk)."""
    return int(_lib().adamw_chunk())


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"adamw {what} launch failed: CUDA error {err}")


def _stream(dev: torch.device) -> Tuple[int, int]:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return idx, torch.cuda.current_stream(dev).cuda_stream


def _array(ctype, values):
    return (ctype * len(values))(*values)


def _on(dev: torch.device, name: str, x: torch.Tensor) -> None:
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")


def _scalar(name: str, x: torch.Tensor, dev: torch.device) -> None:
    """Raise unless ``x`` is one float32 value on ``dev``, which the
    kernel reads from device memory."""
    if not isinstance(x, torch.Tensor) or x.numel() != 1 \
            or x.dtype != torch.float32:
        raise TypeError(f"{name} must be a float32 tensor of one element")
    _on(dev, name, x)


def norm_and_clip(grads: Sequence[torch.Tensor], grad_clip: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the global norm sqrt(sum g^2) of ``grads``, the clip factor
    min(1, grad_clip / max(norm, 1e-9)), or 1 where ``grad_clip`` is 0):
    two 0-d float32 tensors on the grads' device, written by the kernels.
    ``grads``: contiguous CUDA tensors on one device, bf16 or float32."""
    global LAUNCHES
    if not grads:
        raise ValueError("norm_and_clip needs at least one gradient")
    dev = grads[0].device
    by_type: Dict[torch.dtype, List[torch.Tensor]] = defaultdict(list)
    for i, g in enumerate(grads):
        if g.device.type != "cuda":
            raise ValueError(f"grad {i} is on {g.device}; the kernels take "
                             "CUDA tensors")
        _on(dev, f"grad {i}", g)
        if g.dtype not in TYPES:
            raise TypeError(f"grad {i} has dtype {g.dtype}; the kernels "
                            "take bfloat16 or float32")
        if not g.is_contiguous():
            raise ValueError(f"grad {i} must be contiguous")
        if g.numel():
            by_type[g.dtype].append(g)
    lib, size = _lib(), chunk()
    blocks = {t: sum(-(-g.numel() // size) for g in gs)
              for t, gs in by_type.items()}
    partials = torch.empty(max(1, sum(blocks.values())), dtype=torch.float64,
                           device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    idx, stream = _stream(dev)
    at, launched = 0, _i(0)
    with host_op("adamw.norm"):
        for t, gs in by_type.items():
            _check(lib.adamw_sumsq_launch(
                len(gs), _array(_ptr, [g.data_ptr() for g in gs]),
                _array(_ll, [g.numel() for g in gs]),
                int(t == torch.bfloat16), partials.data_ptr() + 8 * at, idx,
                stream, ctypes.byref(launched)), "norm")
            LAUNCHES += launched.value
            at += blocks[t]
        _check(lib.adamw_finalize_launch(partials.data_ptr(), at,
                                         float(grad_clip), out.data_ptr(),
                                         out.data_ptr() + 4, idx, stream),
               "finalize")
    LAUNCHES += 1
    return out[0], out[1]


def group(quads: Sequence[Tuple[torch.Tensor, ...]]
          ) -> Dict[tuple, List[tuple]]:
    """The quads that hold elements, by their (p, g, m) dtypes, after the
    checks of everything but the device: p and g bf16 or float32, m and v
    both bf16 or both float32, all four contiguous and of p's size."""
    groups: Dict[tuple, List[tuple]] = defaultdict(list)
    for i, (p, g, m, v) in enumerate(quads):
        for name, x in (("p", p), ("g", g), ("m", m), ("v", v)):
            if x.dtype not in TYPES:
                raise TypeError(f"{name} of quad {i} has dtype {x.dtype}; "
                                "the kernels take bfloat16 or float32")
            if x.numel() != p.numel() or not x.is_contiguous():
                raise ValueError(f"quad {i}: {name} must be contiguous with "
                                 f"p's {p.numel()} elements")
        if m.dtype != v.dtype:
            raise TypeError(f"quad {i}: m is {m.dtype} and v {v.dtype}; the "
                            "kernels take both of one dtype")
        if p.numel():
            groups[(p.dtype, g.dtype, m.dtype)].append((p, g, m, v))
    return groups


def update(quads: Sequence[Tuple[torch.Tensor, ...]], clip: torch.Tensor,
           c1: torch.Tensor, c2: torch.Tensor, lr: torch.Tensor, b1: float,
           b2: float, eps: float, wd: float) -> None:
    """The AdamW update of each (p, g, m, v) in ``quads``, in place:
    `optim.adamw._update`'s arithmetic with the float32 scalars ``clip``,
    ``c1``, ``c2`` and ``lr`` (one element each, on the quads' device,
    read there by the kernel) and the Python floats ``b1``, ``b2``,
    ``eps`` and ``wd`` as PyTorch casts them to float32. The quads are
    on one CUDA device, as `group` checks them."""
    global LAUNCHES, ELEMENTS
    if not quads:
        return
    dev = quads[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"the AdamW kernels take CUDA tensors, got {dev}")
    for name, x in (("clip", clip), ("c1", c1), ("c2", c2), ("lr", lr)):
        _scalar(name, x, dev)
    for i, quad in enumerate(quads):
        for name, x in zip("pgmv", quad):
            _on(dev, f"{name} of quad {i}", x)
    groups = group(quads)
    lib = _lib()
    idx, stream = _stream(dev)
    consts = [_f(x) for x in (b1, 1.0 - b1, b2, 1.0 - b2, eps, wd)]
    launched = _i(0)
    for (tp, tg, tm), qs in groups.items():
        ptrs = [_array(_ptr, [q[j].data_ptr() for q in qs]) for j in range(4)]
        with host_op("adamw.update"):
            _check(lib.adamw_update_launch(
                len(qs), *ptrs, _array(_ll, [q[0].numel() for q in qs]),
                int(tp == torch.bfloat16), int(tg == torch.bfloat16),
                int(tm == torch.bfloat16), clip.data_ptr(), c1.data_ptr(),
                c2.data_ptr(), lr.data_ptr(), *consts, idx, stream,
                ctypes.byref(launched)), "update")
        LAUNCHES += launched.value
        ELEMENTS += sum(q[0].numel() for q in qs)
