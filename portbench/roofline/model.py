"""Model operations and bytes of a whole step, from the configuration's
``as_run`` widths: the matrix products' parameters (the embedding is a
row lookup and counts none), 2 operations a parameter a token forward
and 6 in training (the remat recompute is not counted), plus causal
attention's products."""
from __future__ import annotations

from portbench.roofline import pairs


def _mix_params(spec: dict, kind: str) -> int:
    D = spec["d_model"]
    if kind == "attn":
        H, K, hd = spec["num_heads"], spec["num_kv_heads"], spec["head_dim"]
        return D * (H + 2 * K) * hd + H * hd * D
    if kind == "mamba":
        m = spec["mamba"]
        d_in = m["expand"] * D
        return (D * 2 * d_in + d_in * (m["dt_rank"] + 2 * m["d_state"])
                + m["dt_rank"] * d_in + d_in * D)
    raise ValueError(kind)


def _ff_params(spec: dict, kind: str, active: bool) -> int:
    D = spec["d_model"]
    if kind == "dense":
        return (3 if spec["mlp"] == "swiglu" else 2) * D * spec["d_ff"]
    if kind == "moe":
        m = spec["moe"]
        n = m["top_k"] if active else m["num_experts"]
        return D * m["num_experts"] + n * (3 if m["gated"] else 2) * D \
            * m["d_ff"]
    return 0


def _layers(spec):
    P = spec["pattern"]
    return [P[i % len(P)] for i in range(spec["num_layers"])]


def matmul_params(spec: dict, active: bool = True) -> int:
    """Parameters of the blocks' matrix products (experts: the active
    ones), the LM head apart (`head_params`)."""
    return sum(_mix_params(spec, m) + _ff_params(spec, f, active)
               for m, f in _layers(spec))


def head_params(spec: dict) -> int:
    return spec["d_model"] * spec["vocab_size"]


def attn_layers(spec: dict) -> int:
    return sum(m == "attn" for m, _ in _layers(spec))


def attn_flops(spec: dict, B: int, S: int) -> float:
    """Causal attention's forward products (Q K^T, P V) over all
    attention layers."""
    return 4 * B * spec["num_heads"] * spec["head_dim"] * pairs(S) \
        * attn_layers(spec)


def train_step_flops(spec: dict, B: int, S: int) -> float:
    """6 N per token, N the products' parameters and the head's, plus
    attention's forward and its backward (twice the forward)."""
    N = matmul_params(spec) + head_params(spec)
    return 6 * N * B * S + 3 * attn_flops(spec, B, S)


def prefill_flops(spec: dict, B: int, S: int) -> float:
    """2 N_active per prompt token, the head on each prompt's last token,
    plus attention."""
    return 2 * matmul_params(spec) * B * S + 2 * head_params(spec) * B \
        + attn_flops(spec, B, S)


def weight_bytes(spec: dict, size: int = 2) -> float:
    """Every weight a step reads, but the embedding table: all experts
    (a batch of many tokens reaches each of them)."""
    return (matmul_params(spec, active=False) + head_params(spec)) * size

