"""The LM substrate's models; port of `repro.models` (attention, Mamba,
mLSTM and sLSTM blocks with dense or MoE feed-forward; serving and
training)."""
from repro_torch.models.model import (  # noqa: F401
    cache_defs,
    decode_step,
    forward,
    init_params,
    input_defs,
    loss_fn,
    model_defs,
    prefill,
)
from repro_torch.models.types import ApplyOptions  # noqa: F401
