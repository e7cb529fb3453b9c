"""Top-k MoE with GShard-style capacity dispatch; port of
`repro.models.moe`.

Tokens are reshaped into dispatch groups ``[G, gsz, D]`` (G sharded with
the batch); dispatch and combine are one-hot einsums, so the layer is
matmuls (the reference lies outside any Pallas kernel, and so does this
port). Experts are sharded on the ``model`` axis, padded to its multiple
when they do not divide it. The routing (argmax, one-hot, cumsum) has no
DTensor rule and runs on each rank's groups under `local_map`
(`sharding.local_call`). Returns the load-balancing auxiliary loss
(Switch-style) alongside outputs. A call is the span ``moe.apply``
(`obs.trace`); while spans record, the calls tally their expert slots
(`SLOTS`, `slot_fill`).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (current_rules, is_dtensor,
                                              local_call, mesh_axes, shard)
from repro_torch.models.layers import ParamDef, rms_norm, rms_norm_def
from repro_torch.obs import trace as obs_trace

# Expert slots of the calls made while spans record (`obs.trace`): slots
# filled by routed tokens (a device tensor, read to the host only by
# `slot_fill`) and slots computed (G x E_pad x C), summed over the calls.
SLOTS = {"filled": None, "computed": 0}


def slot_fill() -> Tuple[int, int]:
    """(slots filled, slots computed) over the calls tallied so far."""
    filled = SLOTS["filled"]
    return (0 if filled is None else int(filled)), SLOTS["computed"]


def _tally(frac_tokens: torch.Tensor, computed: int) -> None:
    """Adds a call's filled slots (the nonzero entries of its dispatch:
    ``frac_tokens`` holds 0 or 1 a token and expert, so the float32 sum
    is exact below 2**24) and its ``computed`` slots to `SLOTS`, on the
    device."""
    n = frac_tokens.detach().sum()
    if is_dtensor(n):
        n = n.full_tensor()
    n = n.to(torch.int64)
    if SLOTS["filled"] is None:
        SLOTS["filled"] = n
    else:
        SLOTS["filled"].add_(n.to(SLOTS["filled"].device))
    SLOTS["computed"] += computed


def _expert_padding(E: int) -> int:
    """Experts padded to the model-axis multiple so they shard.

    granite's 40 experts do not divide a 16-way model axis; padding
    40->48 dummy experts (zero dispatch mass) makes E shardable, so the
    expert products are local to each rank, for +20 % expert flops. No
    padding without rules or on a model axis of one rank."""
    rules = current_rules()
    if rules is None:
        return E
    names, sizes = mesh_axes(rules.mesh)
    m = dict(zip(names, sizes)).get("model", 1)
    if m <= 1 or E % m == 0:
        return E
    return ((E + m - 1) // m) * m


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
    with obs_trace.span("moe.apply"):
        return _moe_apply(cfg, p, x)


def _moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    mo = cfg.moe
    B, S, D = x.shape
    E, K = mo.num_experts, mo.top_k
    G, gsz = _group_tokens(B * S, mo.group_size)
    C = _capacity(gsz, K, E, mo.capacity_factor)

    h = rms_norm(x, p["ln"], cfg.norm_eps) if "ln" in p else x
    xg = h.reshape(G, gsz, D)
    xg = shard(xg, "act_batch", None, None)

    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"].float())
    gates = torch.softmax(logits, dim=-1)  # [G, s, E] fp32
    grp = ("act_batch", None, None, None)
    dispatch, combine = local_call(
        lambda g: _route(g, K, C), (gates,), (("act_batch", None, None),),
        (grp, grp), ((G, gsz, E, C),) * 2)

    cdt = getattr(torch, cfg.compute_dtype)
    # aux loss from the unpadded dispatch (padding never routes mass)
    frac_tokens = dispatch.sum(-1)  # [G, s, E]

    # pad the experts so E shards on the model axis (no-op when E already
    # divides it, on one rank, or without rules)
    E_pad = _expert_padding(E)
    if obs_trace.recording():
        _tally(frac_tokens, G * E_pad * C)
    if E_pad != E:
        dispatch = F.pad(dispatch, (0, 0, 0, E_pad - E))
        combine = F.pad(combine, (0, 0, 0, E_pad - E))
        pad_w = lambda w: shard(F.pad(w, (0, 0, 0, 0, 0, E_pad - E)),
                                "act_experts", None, None)
        w_up, w_down = pad_w(p["w_up"]), pad_w(p["w_down"])
        w_gate = pad_w(p["w_gate"]) if mo.gated else None
    else:
        w_up, w_down, w_gate = p["w_up"], p["w_down"], p.get("w_gate")

    dispatch_c = shard(dispatch.to(cdt), "act_batch", None, None, None)
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch_c, xg)
    expert_in = shard(expert_in, "act_experts", "act_batch", None, None)
    up = torch.einsum("egcd,edf->egcf", expert_in, w_up)
    if mo.gated:
        act = F.silu(torch.einsum("egcd,edf->egcf", expert_in, w_gate))
        hmid = act * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        hmid = F.gelu(up, approximate="tanh")
    hmid = shard(hmid, "act_experts", "act_batch", None, "act_dff")
    expert_out = torch.einsum("egcf,efd->egcd", hmid, w_down)
    expert_out = shard(expert_out, "act_experts", "act_batch", None, None)
    y = torch.einsum("gsec,egcd->gsd", combine.to(cdt), expert_out)
    y = shard(y.reshape(B, S, D), "act_batch", "act_seq_res", None)

    # Switch-style load-balance loss: E * sum_e f_e * P_e
    frac = torch.mean(frac_tokens, dim=(0, 1))  # tokens routed per expert
    prob = torch.mean(gates, dim=(0, 1))
    aux = E * torch.sum(frac / torch.clamp(frac.sum(), min=1e-9) * prob)
    return y, aux.to(torch.float32)
