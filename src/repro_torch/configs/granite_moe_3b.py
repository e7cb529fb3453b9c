"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base family].

32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert) vocab=49155,
MoE 40 experts top-8. Full attention -> long_500k skipped.
num_heads=24 does not divide the 16-way model axis: attention activations use
sequence sharding on 'model'; expert d_ff=512 is TP-sharded (40 % 16 != 0).
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    d_ff=512,
    vocab_size=49155,
    attn=AttnConfig(num_heads=24, num_kv_heads=8, head_dim=64,
                    rope_theta=10_000.0),
    pattern=(BlockConfig("attn", "moe"),),
    # group_size 256 (§Perf iteration "moe_small_groups"): dispatch/combine
    # one-hot einsum flops scale with the per-group capacity C, which scales
    # with the group size at fixed capacity_factor -> 4x less dispatch
    # compute + 4x smaller dispatch tensors than the 1024 default.
    moe=MoEConfig(num_experts=40, top_k=8, d_ff=512, group_size=256),
    sub_quadratic=False,
    sharding_recipe="tp",
    notes="40e top-8 fine-grained MoE; 24 heads -> seq-sharded attention.",
)
