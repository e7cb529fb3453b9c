"""xlstm-350m [arXiv:2405.04517].

24L d_model=1024 4H d_ff=0 vocab=50304; sLSTM + mLSTM blocks (7:1 mLSTM-heavy
pattern). Blocks carry their own up/down projections (d_ff=0: no separate
MLP). Recurrent -> long_500k RUNS (O(1) state decode).
350M params: data-parallel + sequence sharding; model-axis TP is applied to
the mLSTM inner dim.
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig, XLSTMConfig

# Unit of 8: 7 mLSTM + 1 sLSTM (xLSTM[7:1]), x3 -> 24 layers.
_PATTERN = tuple(
    BlockConfig("slstm" if i == 7 else "mlstm", "none") for i in range(8)
)

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    d_ff=0,
    vocab_size=50304,
    attn=AttnConfig(num_heads=4, num_kv_heads=4, head_dim=256),  # unused: ssm
    pattern=_PATTERN,
    xlstm=XLSTMConfig(num_heads=4, mlstm_expand=2),
    sub_quadratic=True,
    sharding_recipe="dp",
    notes="Pure recurrent arch; attention config present but unused.",
)
