"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct].

32L d_model=3072 32H (kv=32 -> MHA) d_ff=8192 vocab=32064; phi3-mini backbone
+ CLIP frontend. The CLIP tower is a STUB: input_specs() provides precomputed
patch embeddings (B, S, d_model); the backbone is what we build and shard.
Full attention -> long_500k skipped. head_dim=96 (3072/32).
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab_size=32064,
    attn=AttnConfig(num_heads=32, num_kv_heads=32, head_dim=96,
                    rope_theta=10_000.0),
    pattern=(BlockConfig("attn", "dense"),),
    input_mode="embeds",
    sub_quadratic=False,
    sharding_recipe="tp",
    notes="VLM backbone; CLIP patch embeddings stubbed via input_specs().",
)
