"""Flash attention: `ref.py` (plain PyTorch versions, the CPU path:
forward, forward with the rows' log-sum-exp, backward; and the model of
the float32 route's split-TF32 arithmetic), `kernel.py` (wrappers of the
CUDA kernels in `csrc/`: wgmma + TMA for bf16 and, in split TF32, for
float32, SIMT for other head dims, forward and backward), `ops.py` (the
public differentiable `flash_attention` op in the model's layout)."""
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

__all__ = ["flash_attention", "attention_ref", "attention_lse_ref",
           "attention_bwd_ref"]
