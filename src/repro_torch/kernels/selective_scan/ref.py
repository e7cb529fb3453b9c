"""Plain PyTorch version of the Mamba (S6) selective scan; port of
`repro.kernels.selective_scan.ref`, with the initial and final state.

It is the CPU path of `ops.selective_scan` and the oracle of the CUDA
kernel, which performs the same operations in the same order."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: [B,S,d]; A: [d,N]; Bc, Cc: [B,S,N]; D: [d]; h0: [B,d,N]
    (zeros when None) -> (y [B,S,d] in x's dtype, h_last [B,d,N] float32).

    h_s = exp(dt_s A) h_{s-1} + dt_s x_s B_s ;  y_s = h_s . C_s + D x_s

    A sequential loop over S with the state in float32: the [B,S,d,N]
    discretised tensors are never formed. With ``h0=None`` ``y`` is the
    reference's `selective_scan_ref`; with S = 1 and ``h0`` the cache
    state, one step of its `mamba_decode`."""
    Bsz, S, d = x.shape
    N = A.shape[1]
    x32, dt32 = x.float(), dt.float()
    A32, B32, C32 = A.float(), Bc.float(), Cc.float()
    h = (torch.zeros((Bsz, d, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for s in range(S):
        dA = torch.exp(dt32[:, s, :, None] * A32)                 # [B,d,N]
        dBx = (dt32[:, s] * x32[:, s])[..., None] * B32[:, s, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, C32[:, s]))
    y = torch.stack(ys, dim=1) + x32 * D.float()
    return y.to(x.dtype), h
