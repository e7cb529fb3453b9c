"""Public flash-attention op in the model's layout; port of
`repro.kernels.flash_attention.ops`, differentiable.

On a CUDA tensor the forward launches a CUDA kernel
(`kernel.flash_attention_cuda`: the tensor-core kernels for bf16 and, in
split TF32, for float32, the SIMT one for a head_dim that is not a
multiple of 8, as `kernel.route` says) and, where a gradient is wanted,
has it write the rows' log-sum-exp; the backward launches the backward
kernels (`kernel.flash_attention_bwd_cuda`) on the saved ``(q, k, v, o,
lse)``. On a CPU tensor the forward takes the plain version
(`ref.attention_ref`) and the backward is the reference's ``custom_vjp``:
it saves only ``(q, k, v)`` and differentiates a recompute through
`ref.attention_ref` (the reference's backward is XLA's VJP of its jnp
oracle). Any other device raises. There is no fallback from a kernel to
`ref`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import attention_ref


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned, as the kernels take it (a
    copy only where it is not)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


class _Flash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, needs_grad):
        ctx.causal, ctx.window = causal, window
        if q.device.type == "cuda":
            q, k, v = _aligned(q), _aligned(k), _aligned(v)
            if not needs_grad:
                return flash_attention_cuda(q, k, v, causal=causal,
                                            window=window)
            B, S, H, _ = q.shape
            lse = torch.empty((B, H, S), dtype=torch.float32,
                              device=q.device)
            o = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     lse=lse)
            ctx.save_for_backward(q, k, v, o, lse)
            return o
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return attention_ref(q, k, v, causal=causal, window=window)
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                         f"{q.device}")

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors  # unpacked once (remat recomputes here)
        if len(saved) == 5:  # the CUDA forward's
            q, k, v, o, lse = saved
            dq, dk, dv = flash_attention_bwd_cuda(
                q, k, v, o, lse, _aligned(g), causal=ctx.causal,
                window=ctx.window)
            return dq, dk, dv, None, None, None
        q, k, v = (t.detach().requires_grad_() for t in saved)
        with torch.enable_grad():
            o = attention_ref(q, k, v, causal=ctx.causal, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos=None, k_pos=None, *, causal: bool = True,
                    window: Optional[int] = None,
                    block: int = 512) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,K,hd] -> [B,S,H,hd].

    Positions are 0..S-1 and 0..T-1 (train / prefill): ``q_pos`` and
    ``k_pos`` are dropped, as the reference drops them. ``block`` is the
    reference's TPU tile; the CUDA kernel tiles by its own sizes."""
    del q_pos, k_pos, block
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _Flash.apply(q, k, v, causal, window, needs_grad)
