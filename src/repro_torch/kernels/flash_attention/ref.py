"""Plain PyTorch version of flash attention (GQA, causal, sliding
window); port of `repro.kernels.flash_attention.ref`. It is the CPU path
of `ops.flash_attention` and the oracle the CUDA kernels are held to:
`attention_ref` the forward's, `attention_lse_ref` the forward's with the
rows' log-sum-exp, `attention_bwd_ref` the backward kernels'.

`tf32_split`, `mm_tf32x3`, `attention_tf32x3_ref` and
`attention_tf32x3_bwd_ref` model the arithmetic of the float32 route's
tensor-core kernels (split TF32, ``csrc/flash_attention_tf32.cu`` and
``csrc/flash_attention_bwd_tf32.cu``), so that the tests can show on the
CPU that it holds the float32 bars; nothing else calls them."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30

# the low mantissa bits a float32 drops to become a TF32 value (10 of its
# 23 mantissa bits kept)
TF32_DROPPED_BITS = 13


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


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest TF32 value, ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds it: on the bit pattern, half of the
    dropped unit added to the magnitude, then the low 13 bits cleared (a
    carry moves into the exponent as it should). Infinities and NaNs are
    left as they are."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    half = 1 << (TF32_DROPPED_BITS - 1)
    keep = ~((1 << TF32_DROPPED_BITS) - 1) & 0xFFFFFFFF
    rounded = torch.where(mag >= 0x7F800000, mag, (mag + half) & keep)
    out = sign | rounded
    out = torch.where(out >= 1 << 31, out - (1 << 32), out)
    return out.to(torch.int32).view(torch.float32).reshape(x.shape)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), float32 tensors that hold TF32 values: hi is x rounded to
    the nearest TF32 value, lo the nearest TF32 value to x - hi (which
    float32 holds exactly), as the kernels split each operand. hi + lo is
    within 2^-22 |x| of x (lo keeps 11 of the up to 13 significant bits of
    x - hi), and |lo| <= 2^-11 |x|."""
    x = x.float()
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def mm_tf32x3(a: torch.Tensor, b: torch.Tensor, terms: int = 3
              ) -> torch.Tensor:
    """a @ b in float32 as the split-TF32 kernels compute it: with a = a_hi
    + a_lo and b = b_hi + b_lo (`tf32_split`), a_hi b_lo + a_lo b_hi +
    a_hi b_hi, each product of TF32 values exact in float32 and the sums in
    float32. ``terms=1`` keeps a_hi b_hi alone: one TF32 product, for the
    tests that show the float32 bars catch it."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if terms == 1:
        return ah @ bh
    return (ah @ bl + al @ bh) + ah @ bh


def _heads_first(q, k, v):
    """q [B,S,H,hd] and k, v [B,T,K,hd] as float32 [B,H,S,hd] and
    [B,H,T,hd], k and v repeated to every query head."""
    G = q.shape[2] // k.shape[2]
    k, v = (x.float().repeat_interleave(G, dim=2) if G > 1 else x.float()
            for x in (k, v))
    return (q.float().transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))


def _mask(S, T, causal, window, device):
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def attention_tf32x3_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None, terms: int = 3
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-TF32 forward's arithmetic: `attention_lse_ref` with S = Q
    K^T and O = P V through `mm_tf32x3` -> (o [B,S,H,hd] float32, lse
    [B,H,S])."""
    qh, kh, vh = _heads_first(q, k, v)
    S, T, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = mm_tf32x3(qh, kh.transpose(-1, -2), terms) * hd ** -0.5
    s = torch.where(_mask(S, T, causal, window, q.device), s, NEG_INF)
    o = mm_tf32x3(torch.softmax(s, dim=-1), vh, terms)
    return o.transpose(1, 2), torch.logsumexp(s, dim=-1)


def attention_tf32x3_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None, terms: int = 3
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The split-TF32 backward's arithmetic: `attention_bwd_ref` with its
    five products (S, dP, dQ, dK, dV) through `mm_tf32x3` -> (dq, dk, dv)
    float32."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G, scale = H // K, hd ** -0.5
    qh, kh, vh = _heads_first(q, k, v)
    doh = do.float().transpose(1, 2)
    s = mm_tf32x3(qh, kh.transpose(-1, -2), terms) * scale
    mask = _mask(S, T, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)  # [B,H,S]
    dp = mm_tf32x3(doh, vh.transpose(-1, -2), terms)
    ds = p * (dp - delta[..., None])
    dq = mm_tf32x3(ds, kh, terms) * scale
    dk = mm_tf32x3(ds.transpose(-1, -2), qh, terms) * scale
    dv = mm_tf32x3(p.transpose(-1, -2), doh, terms)
    dk = dk.transpose(1, 2).reshape(B, T, K, G, hd).sum(3)
    dv = dv.transpose(1, 2).reshape(B, T, K, G, hd).sum(3)
    return dq.transpose(1, 2), dk, dv
