"""jamba-v0.1-52b [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Mamba + attention interleaved 1:7 (one attention layer per 8), MoE on every
other layer. Hybrid -> long_500k RUNS (Mamba state is O(1); the 4 attention
layers keep a full KV cache, linear in context).
"""
from repro_torch.configs.base import (AttnConfig, BlockConfig, MambaConfig,
                                ModelConfig, MoEConfig)

# Repeating unit of 8 layers: attention at position 3, Mamba elsewhere;
# MoE replaces the MLP on odd positions (every other layer), as in the paper.
_PATTERN = tuple(
    BlockConfig("attn" if i == 3 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                    rope_theta=10_000.0),
    pattern=_PATTERN,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=14336),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    sub_quadratic=True,
    sharding_recipe="fsdp_tp",
    notes="Mamba:attn 7:1 interleave; MoE every 2nd layer; 52B total params.",
)
