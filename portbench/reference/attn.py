"""Grouped-query attention with RoPE over the whole causal sequence."""
from __future__ import annotations

import torch

from portbench.reference.ops import mm, q, rms, rope

BLOCK = 256  # query rows a block of scores


def _proj(p, h, spec, prec):
    B, S, D = h.shape
    H, K, hd = spec["num_heads"], spec["num_kv_heads"], spec["head_dim"]
    qq = mm(h, p["mix.wq"].reshape(D, H * hd), prec).view(B, S, H, hd)
    k = mm(h, p["mix.wk"].reshape(D, K * hd), prec).view(B, S, K, hd)
    v = mm(h, p["mix.wv"].reshape(D, K * hd), prec).view(B, S, K, hd)
    return qq, k, v


def _out(p, o, spec, prec):
    B, S, H, hd = o.shape
    return mm(o.reshape(B, S, H * hd), p["mix.wo"].reshape(H * hd, -1), prec)


def _attend(qg, k, v, q_pos, k_pos, window, prec):
    """qg [B, s, K, G, hd]; k, v [B, t, K, hd], already in ``prec`` ->
    [B, s, K, G, hd]; a key is seen by a query at or after it (and within
    the window)."""
    scale = qg.shape[-1] ** -0.5
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k) * scale
    ok = k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    s = s.masked_fill(~ok, float("-inf"))
    pr = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqt,btkd->bqkgd", q(pr, prec), v)


def seq(p, x, spec, prec):
    """x [B, S, D] -> (y [B, S, D], {"k", "v"} [B, S, K, hd], rotated)."""
    B, S, _ = x.shape
    H, K, hd = spec["num_heads"], spec["num_kv_heads"], spec["head_dim"]
    h = rms(x, p["mix.ln"], spec["norm_eps"])
    qq, k, v = _proj(p, h, spec, prec)
    pos = torch.arange(S, device=x.device)
    qq, k = rope(qq, pos, spec["rope_theta"]), rope(k, pos, spec["rope_theta"])
    qq, k, v = q(qq, prec), q(k, prec), q(v, prec)  # one scale a tensor
    qg = qq.view(B, S, K, H // K, hd)
    o = torch.cat([_attend(qg[:, i:i + BLOCK], k[:, :i + BLOCK],
                           v[:, :i + BLOCK], pos[i:i + BLOCK],
                           pos[:i + BLOCK], spec["sliding_window"], prec)
                   for i in range(0, S, BLOCK)], dim=1)
    return _out(p, o.reshape(B, S, H, hd), spec, prec), {"k": k, "v": v}

