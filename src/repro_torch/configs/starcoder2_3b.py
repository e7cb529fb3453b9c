"""starcoder2-3b [arXiv:2402.19173].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152, GQA + RoPE,
non-gated (GELU) MLP. Full attention -> long_500k skipped.
24 heads do not divide the 16-way model axis -> seq-sharded attention.
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    d_ff=12288,
    vocab_size=49152,
    attn=AttnConfig(num_heads=24, num_kv_heads=2, head_dim=128,
                    rope_theta=999_999.0),
    pattern=(BlockConfig("attn", "dense"),),
    mlp_gated=False,
    sub_quadratic=False,
    sharding_recipe="tp",
    notes="kv=2 extreme GQA; plain GELU MLP.",
)
