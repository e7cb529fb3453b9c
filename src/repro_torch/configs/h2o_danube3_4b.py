"""h2o-danube-3-4b [arXiv:2401.16818 family].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, llama+mistral mix
with sliding-window attention (window 4096). SWA is sub-quadratic ->
long_500k RUNS for this arch (decode attends to a 4096-token ring buffer).
head_dim=120 (3840/32) is not 128-aligned; see EXPERIMENTS.md (perf note).
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    d_ff=10240,
    vocab_size=32000,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=120,
                    rope_theta=10_000.0, sliding_window=4096),
    pattern=(BlockConfig("attn", "dense"),),
    sub_quadratic=True,
    sharding_recipe="tp",
    notes="Sliding-window attention (4096); long_500k uses ring-buffer KV.",
)
