"""Flash attention: `ref.py` (plain PyTorch versions, the CPU path:
forward, forward with the rows' log-sum-exp, backward), `kernel.py`
(wrappers of the CUDA kernels in `csrc/`: wgmma + TMA for bf16 and SIMT
for float32, forward and backward), `ops.py` (the public differentiable `flash_attention` op in the
model's layout)."""
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

__all__ = ["flash_attention", "attention_ref", "attention_lse_ref",
           "attention_bwd_ref"]
