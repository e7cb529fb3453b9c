"""qwen3-8b [hf:Qwen/Qwen3-8B].

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936, qk_norm.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    d_ff=12288,
    vocab_size=151936,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                    rope_theta=1_000_000.0, qk_norm=True),
    pattern=(BlockConfig("attn", "dense"),),
    sub_quadratic=False,
    sharding_recipe="tp",
    notes="qk-norm GQA; 152k vocab dominates embedding/LM-head memory.",
)
