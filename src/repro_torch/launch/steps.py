"""Step-function builders: train, prefill and decode; port of
`repro.launch.steps`.

`make_train_step`, `make_prefill_step` and `make_decode_step` return the
step callable; given ``rules`` (`repro_torch.distributed.sharding`) each
step runs under ``use_rules(rules)``, so the model code's ``shard(...)``
calls resolve against the mesh. `make_step` is the reference's builder:
``(fn, args_abstract, in_placements, out_placements, donate)``, where
the arguments are meta tensors (`layers.abstract`) for the dry-run and
the placements are trees of DTensor placements (the reference's
``in_shardings`` / ``out_shardings``). ZeRO-1: optimizer state maps
through the ``fsdp_tp`` rules even when params use ``tp``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed.sharding import (Rules, is_dtensor, make_rules,
                                              use_rules)
from repro_torch.models import model as M
from repro_torch.models.layers import (abstract, tree_leaves_with_path,
                                       tree_map)
from repro_torch.models.types import ApplyOptions
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.adamw import adamw_init_defs, apply_adamw
from repro_torch.optim.compression import compress_grads, ef_init_defs
from repro_torch.optim.schedule import lr_schedule


def _leaves(tree) -> list:
    return [x for _, x in tree_leaves_with_path(tree)]


def _fill(tree, leaves):
    """``tree``'s structure with ``leaves`` (in its leaf order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def rules_for(cfg: ModelConfig, mesh) -> Rules:
    return make_rules(cfg.sharding_recipe, mesh)


def opt_rules_for(cfg: ModelConfig, tcfg: TrainConfig, mesh) -> Rules:
    if tcfg.zero1:
        return make_rules("fsdp_tp", mesh)
    return rules_for(cfg, mesh)


def _bound(rules: Optional[Rules]):
    return use_rules(rules) if rules is not None else contextlib.nullcontext()


def _rows(t: torch.Tensor, i: int, mb: int) -> torch.Tensor:
    """Microbatch ``i`` of ``mb`` rows. On a batch-sharded DTensor each
    rank takes its own rows ``i * mb / n`` onwards (n ranks on the batch),
    so no rank gathers the batch; a microbatch is then another set of
    rows than the reference's, and the step's mean over microbatches the
    same up to float32 summation order."""
    if not is_dtensor(t):
        return t[i * mb:(i + 1) * mb]
    from torch.distributed.tensor import DTensor
    local = t.to_local()
    n = t.shape[0] // local.shape[0]
    ml = mb // n
    return DTensor.from_local(local[i * ml:(i + 1) * ml], t.device_mesh,
                              t.placements, run_check=False,
                              shape=(mb,) + tuple(t.shape[1:]),
                              stride=local[:ml].stride())


def value_and_grads(cfg: ModelConfig, opts: ApplyOptions, params: dict,
                    batch: dict):
    """`M.loss_fn` and its gradients, taken layer by layer: the blocks'
    stacked parameters enter the loss as per-layer leaves
    (`M.unstack_blocks`), so no gradient of a whole stack is formed per
    layer. Returns (loss, metrics, grads): 0-d float32 tensors detached
    from the graph, and one gradient per leaf of
    ``M.unstack_blocks(cfg, params)`` in its leaf order. The loss and the
    gradients are the spans ``steps.forward`` and ``steps.backward``
    (`obs.trace`; the backward's on the calling thread, which waits while
    autograd's own runs)."""
    per_layer = M.unstack_blocks(cfg, params)
    leaves = [p.detach().requires_grad_() for p in _leaves(per_layer)]
    with obs_trace.span("steps.forward"):
        loss, metrics = M.loss_fn(cfg, opts, _fill(per_layer, leaves), batch)
    with obs_trace.span("steps.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    opts: ApplyOptions, rules: Optional[Rules] = None,
                    micro_hook: Optional[Callable] = None) -> Callable:
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
    ``ce``, ``aux``. With ``rules`` the step runs under them: on DTensor
    params the gradients are reduced into the optimizer state's layout,
    and the updated params gathered back into theirs (`apply_adamw`).
    ``micro_hook(i, n_micro)``, when given, is called before microbatch
    ``i``; once it returns False the remaining microbatches are not run
    (the dry-run traces two and counts the others as repeats). A step is
    the span ``steps.train_step`` (`obs.trace`)."""
    use_ef = tcfg.grad_compression == "int8_ef"
    accum_dt = getattr(torch, tcfg.accum_dtype)

    def train_step(params, opt_state, batch, ef_state=None):
        with _bound(rules), obs_trace.span("steps.train_step"):
            return _train_step(params, opt_state, batch, ef_state)

    def _train_step(params, opt_state, batch, ef_state):
        if use_ef and ef_state is None:
            raise ValueError("grad_compression='int8_ef' needs ef_state")
        lr = lr_schedule(tcfg, opt_state["step"])
        B = next(iter(batch.values())).shape[0]
        mb = tcfg.microbatch
        if mb and mb < B:
            n_micro = B // mb
            acc, loss_sum = None, None
            for i in range(n_micro):
                if micro_hook is not None and not micro_hook(i, n_micro):
                    break
                micro = {k: _rows(v, i, mb) for k, v in batch.items()}
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


def make_prefill_step(cfg: ModelConfig, opts: ApplyOptions,
                      rules: Optional[Rules] = None) -> Callable:
    """-> prefill_step(params, batch) -> (last-token logits [B,V], cache)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        with _bound(rules):
            return M.prefill(cfg, opts, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig, opts: ApplyOptions,
                     rules: Optional[Rules] = None) -> Callable:
    """-> decode_step(params, cache, batch) -> (logits [B,V], cache); the
    cache's KV tensors are updated in place."""

    @torch.no_grad()
    def decode_step(params, cache, batch):
        with _bound(rules):
            return M.decode_step(cfg, opts, params, cache, batch)

    return decode_step


# ---------------------------------------------------------------------------
# The reference's builder: step, meta arguments and placements
# ---------------------------------------------------------------------------


def _logits_placements(rules: Rules, cfg: ModelConfig, shape: ShapeConfig):
    return rules.placements(("act_batch", "act_vocab"),
                            (shape.global_batch, cfg.vocab_size))


def make_step(cfg: ModelConfig, opts: ApplyOptions, mesh,
              shape: ShapeConfig, tcfg: Optional[TrainConfig] = None, *,
              micro_hook: Optional[Callable] = None):
    """Dispatch on ``shape.mode`` -> ``(fn, args_abstract, in_placements,
    out_placements, donate)``, the reference's tuple: ``args_abstract``
    are meta tensors (DTensors on a mesh of several ranks;
    `layers.abstract`), the placements are trees of per-leaf DTensor
    placements, and ``donate`` names the arguments the step updates in
    place. ``micro_hook`` goes to `make_train_step`."""
    rules = rules_for(cfg, mesh)
    param_defs = M.model_defs(cfg)
    in_defs = M.input_defs(cfg, shape)
    meta = lambda defs, dt: abstract(defs, dt, rules)
    params = meta(param_defs, cfg.param_dtype)
    batch = meta(in_defs, cfg.compute_dtype)
    param_pl = rules.param_placements(param_defs)
    in_pl = rules.param_placements(in_defs)
    if shape.mode == "train":
        tcfg = tcfg or TrainConfig()
        opt_rules = opt_rules_for(cfg, tcfg, mesh)
        opt_defs = adamw_init_defs(param_defs, tcfg.moment_dtype)
        opt = abstract(opt_defs, "float32", opt_rules)
        opt_pl = opt_rules.param_placements(opt_defs)
        repl = rules.replicated()
        metrics_pl = {k: repl for k in ("loss", "grad_norm", "lr", "ce",
                                        "aux")}
        fn = make_train_step(cfg, tcfg, opts, rules, micro_hook)
        args, in_p, out_p = ((params, opt, batch), (param_pl, opt_pl, in_pl),
                             (param_pl, opt_pl, metrics_pl))
        if tcfg.grad_compression == "int8_ef":
            ef_defs = ef_init_defs(param_defs)
            args += (meta(ef_defs, "float32"),)
            in_p += (rules.param_placements(ef_defs),)
            out_p += (rules.param_placements(ef_defs),)
        return fn, args, in_p, out_p, (0, 1)
    logits_pl = _logits_placements(rules, cfg, shape)
    cache_defs = M.cache_defs(cfg, shape.global_batch, shape.seq_len)
    cache_pl = rules.param_placements(cache_defs)
    if shape.mode == "prefill":
        fn = make_prefill_step(cfg, opts, rules)
        return (fn, (params, batch), (param_pl, in_pl),
                (logits_pl, cache_pl), ())
    cache = meta(cache_defs, cfg.compute_dtype)
    # the port's decode reads the position on the host (`M.decode_step`)
    cache["pos"] = 0
    fn = make_decode_step(cfg, opts, rules)
    return (fn, (params, cache, batch), (param_pl, cache_pl, in_pl),
            (logits_pl, cache_pl), (1,))
