"""Split-KV decode attention: `ref.py` (plain PyTorch versions, the CPU
path and the oracle), `kernel.py` (wrapper of the CUDA kernels in
`csrc/`: partials and the log-sum-exp combine), `ops.py` (the public
`decode_attention` op)."""
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref"]
