"""Plain PyTorch versions of single-token decode attention over a KV
cache; port of `repro.kernels.decode_attention.ref`, plus the per-split
partials that the CUDA kernel computes (the reference's
`decode_attention_blocks` contract)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _valid(k_pos: torch.Tensor, pos) -> torch.Tensor:
    return (k_pos >= 0) & (k_pos <= pos)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_pos: torch.Tensor, pos) -> torch.Tensor:
    """q: [B,H,hd]; k,v: [B,T,K,hd]; k_pos: [T] absolute positions
    (negative = never written); pos: current position -> [B,H,hd]."""
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * hd ** -0.5
    s = torch.where(_valid(k_pos, pos)[None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bthd->bhd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def decode_partials_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_pos: torch.Tensor, pos, chunk: int):
    """The CUDA kernel's function: q [B,H,hd]; k,v [B,T,K,hd]; k_pos [T]
    -> per split of ``chunk`` slots, (m [B,H,n], l [B,H,n],
    acc [B,H,n,hd]) float32 with n = ceil(T / chunk): the max score, the
    sum of exp(score - m) and the exp-weighted sum of V. Masked scores
    are -1e30; slots past T (a ragged last split) contribute nothing."""
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    n = math.ceil(T / chunk)
    pad = n * chunk - T
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad)).view(B, n, chunk, K, hd)
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad)).view(B, n, chunk, K, hd)
    qg = q.float().view(B, K, G, hd)
    s = torch.einsum("bkgd,bnckd->bkgnc", qg, kf) * hd ** -0.5
    valid = F.pad(_valid(k_pos, pos), (0, pad)).view(n, chunk)
    s = torch.where(valid, s, NEG_INF)
    inside = torch.arange(n * chunk, device=q.device).view(n, chunk) < T
    s = torch.where(inside, s, -math.inf)
    m = s.amax(-1)                                   # [B,K,G,n]
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgnc,bnckd->bkgnd", p, vf)
    return (m.reshape(B, H, n), l.reshape(B, H, n),
            acc.reshape(B, H, n, hd))
