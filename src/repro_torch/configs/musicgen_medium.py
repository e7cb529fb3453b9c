"""musicgen-medium [arXiv:2306.05284].

48L d_model=1536 24H (kv=24 -> MHA) d_ff=6144 vocab=2048; decoder-only over
EnCodec tokens. Modality frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, S, d_model); labels are EnCodec codes.
Full attention -> long_500k skipped. Non-gated (GELU) MLP.
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    d_ff=6144,
    vocab_size=2048,
    attn=AttnConfig(num_heads=24, num_kv_heads=24, head_dim=64,
                    rope_theta=10_000.0),
    pattern=(BlockConfig("attn", "dense"),),
    input_mode="embeds",
    mlp_gated=False,
    sub_quadratic=False,
    sharding_recipe="tp",
    notes="Audio backbone; EnCodec frontend stubbed as frame embeddings.",
)
