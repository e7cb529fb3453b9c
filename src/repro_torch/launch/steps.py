"""Step-function builders for serving: prefill and decode; port of
`repro.launch.steps`.

The reference returns ``(fn, args_abstract, in_shardings,
out_shardings)`` for ``jax.jit``. On one card there are no shardings and
PyTorch runs eagerly, so each builder returns the step callable alone.
`make_train_step` comes with training (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.types import ApplyOptions


def make_prefill_step(cfg: ModelConfig, opts: ApplyOptions) -> Callable:
    """-> prefill_step(params, batch) -> (last-token logits [B,V], cache)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        return M.prefill(cfg, opts, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig, opts: ApplyOptions) -> Callable:
    """-> decode_step(params, cache, batch) -> (logits [B,V], cache); the
    cache's KV tensors are updated in place."""

    @torch.no_grad()
    def decode_step(params, cache, batch):
        return M.decode_step(cfg, opts, params, cache, batch)

    return decode_step
