"""llama3-405b [arXiv:2407.21783].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
Full attention -> long_500k skipped. 405B params require FSDP+TP:
params/optimizer sharded over both 'data' and 'model' axes.
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    d_ff=53248,
    vocab_size=128256,
    attn=AttnConfig(num_heads=128, num_kv_heads=8, head_dim=128,
                    rope_theta=500_000.0),
    pattern=(BlockConfig("attn", "dense"),),
    sub_quadratic=False,
    sharding_recipe="fsdp_tp",
    notes="Largest assigned arch; ZeRO-1 + FSDP mandatory to fit 16 GiB/chip.",
)
