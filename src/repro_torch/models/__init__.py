"""The LM substrate's models; port of `repro.models` (attention and
Mamba blocks with dense or MoE feed-forward, serving path)."""
from repro_torch.models.model import (  # noqa: F401
    cache_defs,
    decode_step,
    forward,
    init_params,
    input_defs,
    model_defs,
    prefill,
)
from repro_torch.models.types import ApplyOptions  # noqa: F401
