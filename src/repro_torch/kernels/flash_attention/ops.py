"""Public flash-attention op in the model's layout; port of
`repro.kernels.flash_attention.ops`, differentiable.

On a CUDA tensor the forward launches a CUDA kernel
(`kernel.flash_attention_cuda`: the tensor-core kernel for bf16, the SIMT
one for float32, as `kernel.route` says); on a CPU tensor it takes the
plain version (`ref.attention_ref`); any other device raises. There is
no fallback from a kernel to `ref`.

The backward is the reference's ``custom_vjp``: it saves only
``(q, k, v)`` and differentiates a recompute through `ref.attention_ref`
(the reference's backward is XLA's VJP of its jnp oracle and reaches no
Pallas kernel, so on the card too it is plain PyTorch).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


def _forward(q, k, v, causal, window):
    if q.device.type == "cuda":
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                     f"{q.device}")


class _Flash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = attention_ref(q, k, v, causal=ctx.causal, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos=None, k_pos=None, *, causal: bool = True,
                    window: Optional[int] = None,
                    block: int = 512) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,K,hd] -> [B,S,H,hd].

    Positions are 0..S-1 and 0..T-1 (train / prefill): ``q_pos`` and
    ``k_pos`` are dropped, as the reference drops them. ``block`` is the
    reference's TPU tile; the CUDA kernel tiles by its own sizes."""
    del q_pos, k_pos, block
    return _Flash.apply(q, k, v, causal, window)
