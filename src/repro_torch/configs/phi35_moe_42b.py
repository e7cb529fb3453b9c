"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2.
Full attention -> long_500k skipped (noted in DESIGN.md).
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    d_ff=6400,
    vocab_size=32064,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                    rope_theta=10_000.0),
    pattern=(BlockConfig("attn", "moe"),),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=6400),
    sub_quadratic=False,
    sharding_recipe="fsdp_tp",
    notes="16-expert top-2 MoE on every layer; experts sharded on model axis.",
)
