"""Public selective-scan op; port of `repro.kernels.selective_scan.ops`,
with the initial and final state.

On a CUDA tensor it launches the CUDA kernel (`kernel.selective_scan_cuda`);
on a CPU tensor it takes the plain version (`ref.selective_scan_ref`); any
other device raises. There is no fallback from the kernel to `ref`.

The op is forward only, as the reference's: its Mamba blocks never
differentiate through the scan kernel, and training takes the chunked
scan (``ApplyOptions.scan_impl="chunked"``). Inputs that require grad
raise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.selective_scan.kernel import selective_scan_cuda
from repro_torch.kernels.selective_scan.ref import selective_scan_ref


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused Mamba S6 scan. x, dt: [B,S,d]; A: [d,N]; Bc, Cc: [B,S,N];
    D: [d]; h0: [B,d,N] or None (zeros) -> (y [B,S,d] in x's dtype,
    h_last [B,d,N] float32). ``dt`` is taken in x's dtype, the rest in
    float32, as the kernel takes them."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bc, Cc, D, h0)):
        raise RuntimeError(
            "selective_scan is forward only: train with "
            "scan_impl='chunked', as the reference's Mamba blocks do")
    if x.device.type == "cuda":
        def f32(t):
            return t.to(torch.float32).contiguous()
        return selective_scan_cuda(
            x.contiguous(), dt.to(x.dtype).contiguous(), f32(A), f32(Bc),
            f32(Cc), f32(D), None if h0 is None else f32(h0))
    if x.device.type == "cpu":
        return selective_scan_ref(x, dt.to(x.dtype), A, Bc, Cc, D, h0)
    raise ValueError(f"selective_scan runs on CUDA or CPU tensors, not "
                     f"{x.device}")
