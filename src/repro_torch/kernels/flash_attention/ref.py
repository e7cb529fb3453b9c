"""Plain PyTorch version of flash attention (GQA, causal, sliding
window); port of `repro.kernels.flash_attention.ref`. It is the CPU path
of `ops.flash_attention` and the oracle the CUDA kernels are held to:
`attention_ref` the forward's, `attention_lse_ref` the forward's with the
rows' log-sum-exp, `attention_bwd_ref` the backward kernels'."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _scores(q, k, causal, window):
    """Scaled, masked float32 scores [B,H,S,T] (masked: -1e30), with k
    repeated to every query head; query and key positions 0..S-1 and
    0..T-1."""
    S, T, hd = q.shape[1], k.shape[1], q.shape[-1]
    G = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(G, dim=2) if G > 1 else k
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * hd ** -0.5
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return torch.where(mask[None, None], s, NEG_INF)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,K,hd] with H % K == 0 -> [B,S,H,hd].
    Query and key positions are 0..S-1 and 0..T-1; scores and the
    weighted sum accumulate in float32."""
    G = q.shape[2] // k.shape[2]
    if G > 1:
        v = v.repeat_interleave(G, dim=2)
    p = torch.softmax(_scores(q, k, causal, window), dim=-1)
    o = torch.einsum("bhqt,bthd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): o is `attention_ref`'s; lse [B,H,S] float32 is the
    natural log-sum-exp of each row's scaled, masked scores, what the
    forward kernels write for the backward."""
    o = attention_ref(q, k, v, causal=causal, window=window)
    return o, torch.logsumexp(_scores(q, k, causal, window), dim=-1)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      *, causal: bool = True, window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The FlashAttention-2 backward, written plainly on whole matrices:
    q, o, do [B,S,H,hd]; k, v [B,T,K,hd]; lse [B,H,S] -> (dq, dk, dv) in
    the inputs' dtype, every product in float32.

    P = exp(scale s - lse) where the mask lets a key through, else 0;
    D = rowsum(dO o); dS = P (dP - D) with dP = dO v^T; dq = scale dS k;
    dk = scale dS^T q and dv = P^T dO, each summed over the G query heads
    of a KV head. P is rounded to v's dtype for dv, as `attention_ref`
    rounds it for its P V product."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G, scale = H // K, hd ** -0.5
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    # masked scores are -1e30, so their P is exactly 0
    p = torch.exp(_scores(q, k, causal, window) - lse[..., None])
    dof = do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)  # [B,H,S]
    dp = torch.einsum("bqhd,bthd->bhqt", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqt,bthd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqt,bqhd->bthd", ds, q.float()) * scale
    dv = torch.einsum("bhqt,bqhd->bthd", p.to(v.dtype).float(), dof)
    dk = dk.reshape(B, T, K, G, hd).sum(3)
    dv = dv.reshape(B, T, K, G, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
