"""PyTorch/CUDA port of `repro` (Cerf et al. 2021, the paper's closed
power-control loop), laid out module for module like the JAX package.

The port imports torch and numpy only, never jax nor anything of
`repro`. Its entry points run on CUDA unless the caller passes
``device="cpu"``; with ``device=None`` and no CUDA device they raise
instead of running quietly on the CPU.

Numerics: everything is float32, as in the reference. TF32 is switched
off here for matmuls and cuDNN so that no float32 op silently drops to
TF32's ~10-bit mantissa (the reference accumulates in full fp32).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

# fp32 means fp32: no TF32 in matmuls or cuDNN convolutions (see above)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HAS_CUDA = torch.cuda.is_available()


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA by default.

    ``None`` means CUDA and raises RuntimeError when no CUDA device is
    present; pass ``device="cpu"`` to run the plain PyTorch path."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch entry points run on the GPU "
                "by default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} asked for, but no CUDA "
                           "device is available")
    return dev
