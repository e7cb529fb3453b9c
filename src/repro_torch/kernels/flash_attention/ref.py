"""Plain PyTorch version of flash attention (GQA, causal, sliding
window); port of `repro.kernels.flash_attention.ref`. It is the CPU path
of `ops.flash_attention` and the oracle the CUDA kernel is held to."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,K,hd] with H % K == 0 -> [B,S,H,hd].
    Query and key positions are 0..S-1 and 0..T-1; scores and the
    weighted sum accumulate in float32."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * hd ** -0.5
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqt,bthd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)
