"""Flash-attention forward: `ref.py` (plain PyTorch version, the CPU
path), `kernel.py` (wrappers of the two CUDA kernels in `csrc/`: wgmma +
TMA for bf16, SIMT for float32), `ops.py` (the public `flash_attention`
op in the model's layout)."""
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "attention_ref"]
