"""Top-k MoE with GShard-style capacity dispatch; port of
`repro.models.moe`.

Tokens are reshaped into dispatch groups ``[G, gsz, D]``; dispatch and
combine are one-hot einsums, so the layer is matmuls (the reference lies
outside any Pallas kernel, and so does this port). Returns the
load-balancing auxiliary loss (Switch-style) alongside outputs.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDef, rms_norm, rms_norm_def


def moe_defs(cfg: ModelConfig) -> dict:
    mo = cfg.moe
    D, E, Fd = cfg.d_model, mo.num_experts, mo.d_ff
    defs = {
        "ln": rms_norm_def(D, "d_model"),
        "router": ParamDef((D, E), ("d_model", None)),
        "w_up": ParamDef((E, D, Fd), ("experts", "d_model", "moe_ff")),
        "w_down": ParamDef((E, Fd, D), ("experts", "moe_ff", "d_model")),
    }
    if mo.gated:
        defs["w_gate"] = ParamDef((E, D, Fd), ("experts", "d_model",
                                               "moe_ff"))
    return defs


def _group_tokens(tokens: int, group_size: int) -> Tuple[int, int]:
    """Pick (G, gsz) with G*gsz == tokens, gsz <= group_size, G maximal-ish."""
    gsz = min(group_size, tokens)
    while tokens % gsz:
        gsz -= 1
    return tokens // gsz, gsz


def _capacity(gsz: int, top_k: int, num_experts: int, cf: float) -> int:
    cap = int(gsz * top_k * cf / num_experts) + 1
    cap = max(4, cap)
    return min(gsz, (cap + 3) // 4 * 4)  # round up to 4, never above gsz


def _route(gates: torch.Tensor, top_k: int, capacity: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k slot-by-slot capacity assignment (GShard), the reference's
    order: slot k takes each token's k-th best expert, tokens in group
    order, after every token's earlier slots. gates [G, s, E] float32 ->
    (dispatch, combine) [G, s, E, C] float32; a token past an expert's
    capacity C gets no slot there (its mass is dropped)."""
    G, s, E = gates.shape
    remaining = gates
    counts = gates.new_zeros((G, 1, E))
    dispatch = gates.new_zeros((G, s, E, capacity))
    combine = gates.new_zeros((G, s, E, capacity))
    slots = torch.arange(capacity, device=gates.device)
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)  # [G, s], first of ties
        onehot = F.one_hot(idx, E).to(torch.float32)  # [G, s, E]
        val = torch.sum(remaining * onehot, dim=-1)  # [G, s]
        remaining = remaining * (1.0 - onehot)
        pos = torch.cumsum(onehot, dim=1) - onehot + counts  # [G, s, E]
        counts = counts + torch.sum(onehot, dim=1, keepdim=True)
        keep = onehot * (pos < capacity)  # capacity-dropped tokens vanish
        # one_hot(pos, C) as the reference's jax.nn.one_hot: a zero row for
        # pos >= C (torch's one_hot would raise there)
        slot = (pos.long()[..., None] == slots).to(torch.float32)
        d = keep[..., None] * slot  # [G, s, E, C]
        dispatch = dispatch + d
        combine = combine + d * val[..., None, None]
    # normalize combine weights over the selected experts
    denom = torch.sum(combine, dim=(-1, -2), keepdim=True)
    return dispatch, combine / torch.clamp(denom, min=1e-9)


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y, aux_loss)."""
    mo = cfg.moe
    B, S, D = x.shape
    E, K = mo.num_experts, mo.top_k
    G, gsz = _group_tokens(B * S, mo.group_size)
    C = _capacity(gsz, K, E, mo.capacity_factor)

    h = rms_norm(x, p["ln"], cfg.norm_eps) if "ln" in p else x
    xg = h.reshape(G, gsz, D)

    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"].float())
    gates = torch.softmax(logits, dim=-1)  # [G, s, E] fp32
    dispatch, combine = _route(gates, K, C)

    cdt = getattr(torch, cfg.compute_dtype)
    # The reference pads the experts to a multiple of its TPU mesh's model
    # axis (`_expert_padding`), and only when mesh rules are active. One
    # card has no mesh, so E is never padded.
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch.to(cdt), xg)
    up = torch.einsum("egcd,edf->egcf", expert_in, p["w_up"])
    if mo.gated:
        act = F.silu(torch.einsum("egcd,edf->egcf", expert_in, p["w_gate"]))
        hmid = act * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        hmid = F.gelu(up, approximate="tanh")
    expert_out = torch.einsum("egcf,efd->egcd", hmid, p["w_down"])
    y = torch.einsum("gsec,egcd->gsd", combine.to(cdt), expert_out)

    # Switch-style load-balance loss: E * sum_e f_e * P_e
    frac = torch.mean(dispatch.sum(-1), dim=(0, 1))  # tokens routed per expert
    prob = torch.mean(gates, dim=(0, 1))
    aux = E * torch.sum(frac / torch.clamp(frac.sum(), min=1e-9) * prob)
    return y.reshape(B, S, D), aux.to(torch.float32)
