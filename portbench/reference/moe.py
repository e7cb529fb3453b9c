"""Top-k experts with capacity, as the configuration runs them: tokens in
dispatch groups of ``group_size`` in batch order; slot k gives each token
its k-th best expert, tokens in group order, after every token's earlier
slots; a token past an expert's capacity loses that expert; the kept
gate values are renormalised to sum to 1. Each expert is a SwiGLU (or
GELU) MLP over the tokens it keeps."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.ops import gelu_tanh, mm, rms


def groups(tokens: int, group_size: int):
    """(groups, tokens a group): the largest group of at most
    ``group_size`` tokens that divides ``tokens``."""
    gsz = min(group_size, tokens)
    while tokens % gsz:
        gsz -= 1
    return tokens // gsz, gsz


def capacity(gsz: int, top_k: int, n_experts: int, factor: float) -> int:
    """Slots an expert has in a group: gsz * top_k * factor / n_experts,
    plus one, at least 4, rounded up to a multiple of 4, at most gsz."""
    cap = max(4, int(gsz * top_k * factor / n_experts) + 1)
    return min(gsz, (cap + 3) // 4 * 4)


def route(gates: torch.Tensor, top_k: int, cap: int):
    """gates [G, s, E] -> (experts [k, G, s], weights [k, G, s]); a
    dropped choice has weight 0."""
    G, s, E = gates.shape
    remaining = gates.clone()
    counts = gates.new_zeros(G, 1, E)
    idx, val, keep = [], [], []
    for _ in range(top_k):
        e = torch.argmax(remaining, dim=-1)                   # [G, s]
        onehot = F.one_hot(e, E).float()
        v = torch.gather(remaining, -1, e[..., None])[..., 0]
        remaining = remaining.masked_fill(onehot.bool(), 0.0)
        before = torch.cumsum(onehot, dim=1) - onehot + counts  # [G, s, E]
        counts = counts + onehot.sum(dim=1, keepdim=True)
        slot = torch.gather(before, -1, e[..., None])[..., 0]
        idx.append(e)
        val.append(v)
        keep.append(slot < cap)
    idx, val, keep = torch.stack(idx), torch.stack(val), torch.stack(keep)
    w = val * keep
    return idx, w / w.sum(0, keepdim=True).clamp(min=1e-9)


def ff(p: dict, x, spec: dict, prec: str):
    m = spec["moe"]
    B, S, D = x.shape
    T = B * S
    G, gsz = groups(T, m["group_size"])
    cap = capacity(gsz, m["top_k"], m["num_experts"], m["capacity_factor"])
    h = rms(x, p["ff.ln"], spec["norm_eps"]).reshape(T, D)
    gates = torch.softmax(mm(h, p["ff.router"], prec), dim=-1)
    idx, w = route(gates.view(G, gsz, -1), m["top_k"], cap)
    idx, w = idx.reshape(m["top_k"], T), w.reshape(m["top_k"], T)
    y = torch.zeros(T, D, dtype=torch.float32, device=x.device)
    tok = torch.arange(T, device=x.device)
    for e in range(m["num_experts"]):
        sel = (idx == e) & (w > 0)
        if not bool(sel.any()):
            continue
        rows = tok.expand_as(idx)[sel]
        he = h[rows]
        up = mm(he, p["ff.w_up"][e], prec)
        if m["gated"]:
            act = F.silu(mm(he, p["ff.w_gate"][e], prec)) * up
        else:
            act = gelu_tanh(up)
        y.index_add_(0, rows, mm(act, p["ff.w_down"][e], prec)
                     * w[sel][:, None])
    return y.view(B, S, D)
