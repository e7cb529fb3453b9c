"""Public flash-attention op in the model's layout; port of
`repro.kernels.flash_attention.ops` (forward only: the recompute
backward through `ref` comes with training).

On a CUDA tensor it launches a CUDA kernel (`kernel.flash_attention_cuda`:
the tensor-core kernel for bf16, the SIMT one for float32, as
`kernel.route` says); on a CPU tensor it takes the plain version
(`ref.attention_ref`); any other device raises. There is no fallback
from a kernel to `ref`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos=None, k_pos=None, *, causal: bool = True,
                    window: Optional[int] = None,
                    block: int = 512) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,K,hd] -> [B,S,H,hd].

    Positions are 0..S-1 and 0..T-1 (train / prefill): ``q_pos`` and
    ``k_pos`` are dropped, as the reference drops them. ``block`` is the
    reference's TPU tile; the CUDA kernel tiles by its own sizes."""
    del q_pos, k_pos, block
    if q.device.type == "cuda":
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                     f"{q.device}")
