"""Step-function builders: train, prefill and decode; port of
`repro.launch.steps`.

The reference returns ``(fn, args_abstract, in_shardings,
out_shardings)`` for ``jax.jit`` and binds its TPU mesh's sharding rules
(``use_rules``, ZeRO-1's ``fsdp_tp`` rules for the optimizer state) at
trace time. Those are shardings, not computation: on one card there are
none, and PyTorch runs eagerly, so each builder returns the step
callable alone.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves_with_path, tree_map
from repro_torch.models.types import ApplyOptions
from repro_torch.optim.adamw import apply_adamw
from repro_torch.optim.compression import compress_grads
from repro_torch.optim.schedule import lr_schedule


def _leaves(tree) -> list:
    return [x for _, x in tree_leaves_with_path(tree)]


def _fill(tree, leaves):
    """``tree``'s structure with ``leaves`` (in its leaf order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def value_and_grads(cfg: ModelConfig, opts: ApplyOptions, params: dict,
                    batch: dict):
    """`M.loss_fn` and its gradients, taken layer by layer: the blocks'
    stacked parameters enter the loss as per-layer leaves
    (`M.unstack_blocks`), so no gradient of a whole stack is formed per
    layer. Returns (loss, metrics, grads): 0-d float32 tensors detached
    from the graph, and one gradient per leaf of
    ``M.unstack_blocks(cfg, params)`` in its leaf order."""
    per_layer = M.unstack_blocks(cfg, params)
    leaves = [p.detach().requires_grad_() for p in _leaves(per_layer)]
    loss, metrics = M.loss_fn(cfg, opts, _fill(per_layer, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    opts: ApplyOptions) -> Callable:
    """-> train_step(params, opt_state, batch, ef_state=None) ->
    (params, opt_state, metrics) or, with ``tcfg.grad_compression ==
    "int8_ef"``, (params, opt_state, metrics, ef_state).

    One optimizer step as the reference's: gradients of `M.loss_fn`
    (`value_and_grads`; accumulated over ``tcfg.microbatch``-row
    microbatches in ``tcfg.accum_dtype`` when it is set below the batch),
    int8 error feedback, the lr schedule at the pre-step count, and
    AdamW, which applies each layer's gradient to its slice of the
    stacked leaf. Params and moments are updated in place and returned
    (the reference donates them). Metrics are 0-d float32 tensors on the
    params' device: ``loss``, ``grad_norm`` (before clipping), ``lr``,
    ``ce``, ``aux``."""
    use_ef = tcfg.grad_compression == "int8_ef"
    accum_dt = getattr(torch, tcfg.accum_dtype)

    def train_step(params, opt_state, batch, ef_state=None):
        if use_ef and ef_state is None:
            raise ValueError("grad_compression='int8_ef' needs ef_state")
        lr = lr_schedule(tcfg, opt_state["step"])
        B = next(iter(batch.values())).shape[0]
        mb = tcfg.microbatch
        if mb and mb < B:
            n_micro = B // mb
            acc, loss_sum = None, None
            for i in range(n_micro):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, _, g = value_and_grads(cfg, opts, params, micro)
                g = [x.to(accum_dt) for x in g]
                acc = g if acc is None else [a.add_(x)
                                             for a, x in zip(acc, g)]
                loss_sum = loss if loss_sum is None else loss_sum + loss
            grads = [a / n_micro for a in acc]
            loss = loss_sum / n_micro
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, metrics, grads = value_and_grads(cfg, opts, params, batch)

        per_layer = [M.unstack_blocks(cfg, t) for t in
                     (params, opt_state["m"], opt_state["v"])]
        if use_ef:
            # the per-tensor int8 scale is the whole stacked leaf's
            g_tree = _fill(per_layer[0], grads)
            g_tree = {k: (tree_map(lambda *ts: torch.stack(ts),
                                   *g_tree["layers"]) if k == "blocks"
                          else g_tree[k]) for k in params}
            g_tree, ef_state = compress_grads(g_tree, ef_state)
            quads = list(zip(_leaves(params), _leaves(g_tree),
                             _leaves(opt_state["m"]),
                             _leaves(opt_state["v"])))
        else:
            p_l, m_l, v_l = (_leaves(t) for t in per_layer)
            quads = list(zip(p_l, grads, m_l, v_l))
        step = opt_state["step"].add_(1)
        gnorm = apply_adamw(tcfg, quads, step, lr)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr, **metrics}
        if use_ef:
            return params, opt_state, out, ef_state
        return params, opt_state, out

    return train_step


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
