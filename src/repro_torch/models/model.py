"""Model assembly: embed -> repeated block pattern -> head, and the loss;
port of `repro.models.model` for attention, Mamba, mLSTM and sLSTM
blocks with dense or MoE feed-forward.

Parameters, caches and step inputs are described by ParamDef trees with
the reference's structure: per-repeat parameters are stacked on a
leading axis, so a reference parameter tree carries across leaf for leaf
(`repro_torch.convert.params_from_reference`). The reference's scan over
repeats is a Python loop here. A parameter tree may instead carry its
blocks unstacked, as ``params["layers"]``: one tree of per-layer tensors
a repeat (`unstack_blocks`), which a train step differentiates layer by
layer.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import BlockConfig, ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (current_rules, fsdp_gather,
                                              is_dtensor, shard, shard_grad,
                                              use_rules)
from repro_torch.models import attention, mamba, moe, xlstm
from repro_torch.models.layers import (ParamDef, materialize, mlp_apply,
                                       mlp_defs, rms_norm, rms_norm_def,
                                       stack_defs, tree_map)
from repro_torch.models.types import ApplyOptions


class _Mixer(NamedTuple):
    """A block kind's sequence mixer."""
    defs: Callable
    apply: Callable
    prefill: Callable
    decode: Callable


_MIX = {
    "attn": _Mixer(attention.attn_defs, attention.attn_apply,
                   attention.attn_prefill, attention.attn_decode),
    "mamba": _Mixer(mamba.mamba_defs, mamba.mamba_apply,
                    mamba.mamba_prefill, mamba.mamba_decode),
    "mlstm": _Mixer(xlstm.mlstm_defs, xlstm.mlstm_apply,
                    xlstm.mlstm_prefill, xlstm.mlstm_decode),
    "slstm": _Mixer(xlstm.slstm_defs, xlstm.slstm_apply,
                    xlstm.slstm_prefill, xlstm.slstm_decode),
}


def _mix(blk: BlockConfig) -> _Mixer:
    if blk.kind not in _MIX:
        raise ValueError(blk.kind)
    return _MIX[blk.kind]


# ---------------------------------------------------------------------------
# Parameter / cache / input definitions
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig, blk: BlockConfig) -> dict:
    d = {"mix": _mix(blk).defs(cfg)}
    if blk.ff == "dense":
        d["ff"] = {"ln": rms_norm_def(cfg.d_model, "d_model"),
                   **mlp_defs(cfg.d_model, cfg.d_ff, cfg.mlp_gated)}
    elif blk.ff == "moe":
        d["ff"] = moe.moe_defs(cfg)
    return d


def model_defs(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab_size
    defs = {
        "blocks": tuple(
            stack_defs(block_defs(cfg, blk), cfg.num_repeats)
            for blk in cfg.pattern
        ),
        "final_ln": rms_norm_def(D, "d_model"),
        "lm_head": ParamDef((D, V), ("d_model", "vocab")),
    }
    if cfg.input_mode == "tokens":
        defs["embed"] = ParamDef((V, D), ("vocab", "d_model"), scale=1.0)
    else:
        defs["in_proj"] = ParamDef((D, D), (None, "d_model"))
    return defs


def init_params(cfg: ModelConfig, seed: int, device=None,
                rules=None) -> dict:
    """Random weights from ``seed`` on ``device``, CUDA unless the caller
    passes ``device="cpu"`` (see `layers.materialize`); DTensors placed by
    ``rules`` on a mesh of several ranks."""
    return materialize(model_defs(cfg), seed, cfg.param_dtype, device,
                       rules=rules)


def block_cache_defs(cfg: ModelConfig, blk: BlockConfig, batch: int,
                     seq_len: int) -> dict:
    if blk.kind == "attn":
        return attention.attn_cache_defs(cfg, batch, seq_len)
    if blk.kind == "mamba":
        return mamba.mamba_cache_defs(cfg, batch)
    if blk.kind == "mlstm":
        return xlstm.mlstm_cache_defs(cfg, batch)
    if blk.kind == "slstm":
        return xlstm.slstm_cache_defs(cfg, batch)
    raise ValueError(blk.kind)


def cache_defs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    return {
        "blocks": tuple(
            stack_defs(block_cache_defs(cfg, blk, batch, seq_len),
                       cfg.num_repeats)
            for blk in cfg.pattern
        ),
        "pos": ParamDef((), (), init="zeros", dtype="int32"),
    }


def input_defs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    tok_axes = ("act_batch", None)
    if shape.mode == "decode":
        S = 1  # one new token against a cache of length seq_len
    if cfg.input_mode == "tokens":
        d = {"tokens": ParamDef((B, S), tok_axes, dtype="int32")}
    else:
        d = {"embeds": ParamDef((B, S, cfg.d_model),
                                ("act_batch", None, None),
                                dtype=cfg.compute_dtype)}
    if shape.mode == "train":
        d["labels"] = ParamDef((B, S), tok_axes, dtype="int32")
    return d


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _apply_ff(cfg: ModelConfig, blk: BlockConfig, p: dict,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (delta, aux)."""
    if blk.ff == "moe":
        return moe.moe_apply(cfg, p, x)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    h = shard(h, "act_batch", None, None)
    return shard_grad(mlp_apply(p, h, cfg.mlp_gated), "act_batch", None,
                      None), _zero(x)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _gathered(cfg, blk, p):
    """The block's weights, FSDP-gathered under ``fsdp_tp`` rules."""
    return fsdp_gather(p, lambda: block_defs(cfg, blk))


def _block_apply(cfg, opts, blk, p, x):
    p = _gathered(cfg, blk, p)
    x = x + _mix(blk).apply(cfg, opts, p["mix"], x)
    x = shard(x, "act_batch", "act_seq_res", "act_dmodel")
    aux = _zero(x)
    if "ff" in p:
        delta, aux = _apply_ff(cfg, blk, p["ff"], x)
        x = shard(x + delta, "act_batch", "act_seq_res", "act_dmodel")
    return x, aux


def _block_apply_prefill(cfg, opts, blk, p, x):
    """Like _block_apply but also returns the block's populated cache."""
    p = _gathered(cfg, blk, p)
    dx, cache = _mix(blk).prefill(cfg, opts, p["mix"], x)
    x = shard(x + dx, "act_batch", None, None)
    if "ff" in p:
        x = shard(x + _apply_ff(cfg, blk, p["ff"], x)[0], "act_batch", None,
                  None)
    return x, cache


def _block_apply_decode(cfg, opts, blk, p, x, cache, pos):
    """The block's cache tensors are updated in place (see
    `attention.attn_decode`, `mamba.mamba_decode` and `xlstm`)."""
    p = _gathered(cfg, blk, p)
    dx, _ = _mix(blk).decode(cfg, opts, p["mix"], x, cache, pos)
    x = x + dx
    if "ff" in p:
        x = x + _apply_ff(cfg, blk, p["ff"], x)[0]
    return shard(x, "act_batch", None, "act_dmodel")


def _repeat(stacked, r: int):
    """Repeat ``r``'s slice of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[r], stacked)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _top(cfg: ModelConfig, params: dict, *names: str):
    """The model's top-level weights ``names``, FSDP-gathered under
    ``fsdp_tp`` rules."""
    return fsdp_gather({k: params[k] for k in names},
                       lambda: {k: model_defs(cfg)[k] for k in names})


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict
                  ) -> torch.Tensor:
    cdt = getattr(torch, cfg.compute_dtype)
    params = _top(cfg, params, "embed" if cfg.input_mode == "tokens"
                  else "in_proj")
    if cfg.input_mode == "tokens" and is_dtensor(params["embed"]):
        # a sharded table: the reference's one-hot contraction over
        # act_vocab, whose partial sums the shard below reduces
        tok = batch["tokens"].long()
        onehot = (tok[..., None] == torch.arange(
            cfg.vocab_size, device=tok.device)).to(cdt)
        onehot = shard(onehot, "act_batch", None, "act_vocab")
        x = torch.einsum("bsv,vd->bsd", onehot, params["embed"].to(cdt))
    elif cfg.input_mode == "tokens":
        # a row lookup: equal to the reference's one-hot einsum, without a
        # [B, S, vocab] one-hot
        x = F.embedding(batch["tokens"].long(), params["embed"]).to(cdt)
    else:
        x = batch["embeds"].to(cdt) @ params["in_proj"].to(cdt)
    return shard(x, "act_batch", "act_seq_res", "act_dmodel")


def unstack_blocks(cfg: ModelConfig, params: dict) -> dict:
    """``params`` with its stacked blocks as ``"layers"``: a list, one
    entry a repeat, of the pattern's per-layer trees, views of the
    stacked tensors (no copies). `apply_blocks` reads either form."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["layers"] = [_repeat(params["blocks"], r)
                     for r in range(cfg.num_repeats)]
    return out


def _unit(cfg, opts, x, sl):
    """One repeat of the block pattern -> (x, the unit's router aux)."""
    aux = _zero(x)
    for j, blk in enumerate(cfg.pattern):
        x, a = _block_apply(cfg, opts, blk, sl[j], x)
        aux = aux + a
    return x, aux


# plain matrix products: what the reference's remat="dots" saves
# (`dots_with_no_batch_dims_saveable`); batched products (einsum's bmm)
# and everything else are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(cfg: ModelConfig, fn):
    """The reference's `_maybe_remat` around one repeat unit: "full"
    saves only the unit's inputs and recomputes it in the backward,
    "dots" saves its plain matrix products, "none" saves everything.
    Without autograd (serving) there is nothing to save."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    rules = current_rules()
    if rules is not None:
        # the recompute runs in the backward, on the autograd engine's
        # thread for a device tensor: it must see the forward's rules
        inner = fn

        def fn(*args):
            with use_rules(rules):
                return inner(*args)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def apply_blocks(cfg: ModelConfig, opts: ApplyOptions, params: dict,
                 x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, the router aux loss summed over the blocks), summed
    unit by unit as the reference's scan carries it; each unit under
    ``cfg.remat``."""
    unit = _maybe_remat(cfg, lambda x_, sl: _unit(cfg, opts, x_, sl))
    aux = _zero(x)
    for r in range(cfg.num_repeats):
        sl = (params["layers"][r] if "layers" in params
              else _repeat(params["blocks"], r))
        x, a = unit(x, sl)
        aux = aux + a
    return x, aux


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head: x [B, S, D] -> logits [B, S, V] sharded on
    the vocab, or x [B, D] (the last token) -> [B, V]."""
    params = _top(cfg, params, "final_ln", "lm_head")
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    mid = (None,) * (x.dim() - 2)
    x = shard(x, "act_batch", *mid, None)  # the bf16 boundary
    logits = x @ params["lm_head"].to(x.dtype)
    return shard(logits, "act_batch", *mid, "act_vocab")


def forward(cfg: ModelConfig, opts: ApplyOptions, params: dict,
            batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits [B,S,V], moe_aux)."""
    x = _embed_inputs(cfg, params, batch)
    x, aux = apply_blocks(cfg, opts, params, x)
    logits = _head(cfg, params, x)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits, aux


def loss_fn(cfg: ModelConfig, opts: ApplyOptions, params: dict,
            batch: dict) -> Tuple[torch.Tensor, dict]:
    """Mean next-token cross entropy plus the weighted router aux loss ->
    (loss, {"ce", "aux"}), float32."""
    logits, aux = forward(cfg, opts, params, batch)
    labels = batch["labels"].long()
    if is_dtensor(logits):
        # vocab-sharded logits: the reference's own contraction, a one-hot
        # sharded on act_vocab (each rank builds its slice) whose partial
        # sums are reduced over the vocab shards, and a log-sum-exp from a
        # max and a sum over them, so no rank gathers [B, S, vocab]
        # Each statistic is reduced whole on every rank (all-reduces of
        # [B, S]); DTensor would otherwise reduce-scatter it over the
        # sequence, and its backward could not place the LM head's grad.
        lf = logits.float()
        m = shard(torch.amax(lf, dim=-1, keepdim=True), "act_batch", None,
                  None).detach()
        z = shard(torch.sum(torch.exp(lf - m), dim=-1), "act_batch", None)
        lse = m[..., 0] + torch.log(z)
        onehot = (labels[..., None] == torch.arange(
            cfg.vocab_size, device=labels.device)).to(logits.dtype)
        onehot = shard(onehot, "act_batch", None, "act_vocab")
        # a product and a sum: DTensor's einsum would fold b and s into
        # one strided dim
        picked = shard(torch.sum(logits * onehot, dim=-1), "act_batch",
                       None).float()
    else:
        lse = torch.logsumexp(logits.float(), dim=-1)  # [B,S]
        # the label's logit by a gather: the reference's one-hot einsum has
        # a single non-zero term, an exact product (logit x 1), so both
        # give the same value, without a [B, S, vocab] one-hot
        picked = torch.gather(logits, -1, labels[..., None])[..., 0].float()
    ce = torch.mean(lse - picked)
    aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    return ce + aux_w * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, opts: ApplyOptions, params: dict,
            batch: dict) -> Tuple[torch.Tensor, dict]:
    """Run the prompt, return (last-token logits [B,V], cache)."""
    x = _embed_inputs(cfg, params, batch)
    S = x.shape[1]
    per_rep = []
    for r in range(cfg.num_repeats):
        sl = _repeat(params["blocks"], r)
        caches = []
        for j, blk in enumerate(cfg.pattern):
            x, c = _block_apply_prefill(cfg, opts, blk, sl[j], x)
            caches.append(c)
        per_rep.append(tuple(caches))
    caches = tree_map(lambda *ts: torch.stack(ts), *per_rep)
    logits = _head(cfg, params, x[:, -1])
    return logits, {"blocks": caches, "pos": S}


def decode_step(cfg: ModelConfig, opts: ApplyOptions, params: dict,
                cache: dict, batch: dict) -> Tuple[torch.Tensor, dict]:
    """One decode step. Returns (logits [B,V], updated cache). The tensors
    of ``cache`` (attention KV, Mamba conv and ssm states) are updated in
    place, through the per-repeat views of the stacked cache; ``pos`` may
    be an int or a 0-d tensor."""
    x = _embed_inputs(cfg, params, batch)
    pos = int(cache["pos"])
    for r in range(cfg.num_repeats):
        sl_p = _repeat(params["blocks"], r)
        sl_c = _repeat(cache["blocks"], r)
        for j, blk in enumerate(cfg.pattern):
            x = _block_apply_decode(cfg, opts, blk, sl_p[j], x, sl_c[j], pos)
    logits = _head(cfg, params, x[:, 0])
    return logits, {"blocks": cache["blocks"], "pos": pos + 1}
