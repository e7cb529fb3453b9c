"""Gradient compression: int8 quantization with error feedback; port of
`repro.optim.compression`.

Before a data-parallel all-reduce, gradients are quantized to int8 with a
per-tensor scale; the quantization error is carried in an error-feedback
buffer so the compressed SGD stays convergent (Karimireddy et al.,
2019). On one card there is no all-reduce: the step applies the same
arithmetic, so its updates equal the reference's.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers import (ParamDef, is_def, tree_leaves_with_path,
                                       tree_map)


def ef_init_defs(param_defs) -> dict:
    return tree_map(
        lambda d: ParamDef(d.shape, d.axes, init="zeros", dtype="float32"),
        param_defs, is_leaf=is_def)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _compress_one(g: torch.Tensor, e: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf -> (the decompressed gradient in g's dtype, the new error
    buffer)."""
    x = g.float() + e
    deq = _dequantize(*_quantize(x))
    return deq.to(g.dtype), x - deq


def compress_grads(grads, ef_state):
    """Returns (decompressed grads as seen post-allreduce, new ef_state),
    trees of the structure of ``grads``."""
    pairs = [_compress_one(g, e) for (_, g), (_, e) in
             zip(tree_leaves_with_path(grads),
                 tree_leaves_with_path(ef_state))]
    new_g, new_e = iter([g for g, _ in pairs]), iter([e for _, e in pairs])
    return (tree_map(lambda _: next(new_g), grads),
            tree_map(lambda _: next(new_e), grads))
