"""Public decode-attention op: split-KV partials + log-sum-exp combine;
port of `repro.kernels.decode_attention.ops`.

On a CUDA tensor one launch of the CUDA kernel
(`kernel.decode_attention_cuda`) computes the partials and combines them;
on a CPU tensor the plain version does (`ref.decode_partials_ref`, then
`combine`, which is also the kernel's oracle for the combine); any other
device raises. There is no fallback from the kernel to `ref`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.kernel import (decode_attention_cuda,
                                                         default_chunk)
from repro_torch.kernels.decode_attention.ref import decode_partials_ref


def combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """Partials (m, l [B,H,n], acc [B,H,n,hd]) -> [B,H,hd] in ``dtype``."""
    m_all = m.amax(-1, keepdim=True)                      # [B,H,1]
    corr = torch.exp(m - m_all)                           # [B,H,n]
    l_all = (l * corr).sum(-1)                            # [B,H]
    o = torch.einsum("bhn,bhnd->bhd", corr, acc) / torch.clamp(
        l_all, min=1e-30)[..., None]
    return o.to(dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_pos: torch.Tensor, pos, *,
                     block_k: Optional[int] = None) -> torch.Tensor:
    """q: [B,H,hd]; k,v: [B,T,K,hd]; k_pos: [T]; pos scalar -> [B,H,hd].
    ``block_k`` is the number of cache slots per split (default:
    `kernel.default_chunk`)."""
    B, H, _ = q.shape
    T, K = k.shape[1], k.shape[2]
    chunk = block_k or default_chunk(B, K, T)
    pos = int(pos)
    k_pos = k_pos.to(torch.int32)
    if q.device.type == "cuda":
        return decode_attention_cuda(q.contiguous(), k.contiguous(),
                                     v.contiguous(), k_pos.contiguous(), pos,
                                     chunk)[0]
    if q.device.type == "cpu":
        return combine(*decode_partials_ref(q, k, v, k_pos, pos, chunk),
                       q.dtype)
    raise ValueError(f"decode_attention runs on CUDA or CPU tensors, not "
                     f"{q.device}")
