"""Model assembly: embed -> repeated block pattern -> head; port of
`repro.models.model` for attention and Mamba blocks with dense or MoE
feed-forward.

Parameters, caches and step inputs are described by ParamDef trees with
the reference's structure: per-repeat parameters are stacked on a
leading axis, so a reference parameter tree carries across leaf for leaf
(`repro_torch.convert.params_from_reference`). The reference's scan over
repeats is a Python loop here.

mLSTM and sLSTM blocks are not ported yet and raise NotImplementedError;
so does training (loss, remat).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import BlockConfig, ModelConfig, ShapeConfig
from repro_torch.models import attention, mamba, moe
from repro_torch.models.layers import (ParamDef, materialize, mlp_apply,
                                       mlp_defs, rms_norm, rms_norm_def,
                                       stack_defs, tree_map)
from repro_torch.models.types import ApplyOptions

_LATER = {"mlstm": "mLSTM blocks", "slstm": "sLSTM blocks"}


def _check_block(blk: BlockConfig) -> None:
    if blk.kind in _LATER:
        raise NotImplementedError(
            f"{_LATER[blk.kind]} not ported yet: ROADMAP Queue 1 item 10")
    if blk.kind not in ("attn", "mamba"):
        raise ValueError(blk.kind)


# ---------------------------------------------------------------------------
# Parameter / cache / input definitions
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig, blk: BlockConfig) -> dict:
    _check_block(blk)
    if blk.kind == "attn":
        d = {"mix": attention.attn_defs(cfg)}
    else:
        d = {"mix": mamba.mamba_defs(cfg)}
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


def init_params(cfg: ModelConfig, seed: int, device=None) -> dict:
    """Random weights from ``seed`` on ``device``, CUDA unless the caller
    passes ``device="cpu"`` (see `layers.materialize`)."""
    return materialize(model_defs(cfg), seed, cfg.param_dtype, device)


def block_cache_defs(cfg: ModelConfig, blk: BlockConfig, batch: int,
                     seq_len: int) -> dict:
    _check_block(blk)
    if blk.kind == "attn":
        return attention.attn_cache_defs(cfg, batch, seq_len)
    return mamba.mamba_cache_defs(cfg, batch)


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
    return mlp_apply(p, h, cfg.mlp_gated), _zero(x)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _block_apply(cfg, opts, blk, p, x):
    if blk.kind == "attn":
        x = x + attention.attn_apply(cfg, opts, p["mix"], x)
    else:
        x = x + mamba.mamba_apply(cfg, opts, p["mix"], x)
    aux = _zero(x)
    if "ff" in p:
        delta, aux = _apply_ff(cfg, blk, p["ff"], x)
        x = x + delta
    return x, aux


def _block_apply_prefill(cfg, opts, blk, p, x):
    """Like _block_apply but also returns the block's populated cache."""
    if blk.kind == "attn":
        dx, cache = attention.attn_prefill(cfg, opts, p["mix"], x)
    else:
        dx, cache = mamba.mamba_prefill(cfg, opts, p["mix"], x)
    x = x + dx
    if "ff" in p:
        x = x + _apply_ff(cfg, blk, p["ff"], x)[0]
    return x, cache


def _block_apply_decode(cfg, opts, blk, p, x, cache, pos):
    """The block's cache tensors are updated in place (see
    `attention.attn_decode` and `mamba.mamba_decode`)."""
    if blk.kind == "attn":
        dx, _ = attention.attn_decode(cfg, opts, p["mix"], x, cache, pos)
    else:
        dx, _ = mamba.mamba_decode(cfg, opts, p["mix"], x, cache, pos)
    x = x + dx
    if "ff" in p:
        x = x + _apply_ff(cfg, blk, p["ff"], x)[0]
    return x


def _repeat(stacked, r: int):
    """Repeat ``r``'s slice of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[r], stacked)


def _check(cfg: ModelConfig) -> None:
    for blk in cfg.pattern:
        _check_block(blk)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict
                  ) -> torch.Tensor:
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.input_mode == "tokens":
        # a row lookup: equal to the reference's one-hot einsum, without a
        # [B, S, vocab] one-hot
        return F.embedding(batch["tokens"].long(), params["embed"]).to(cdt)
    return batch["embeds"].to(cdt) @ params["in_proj"].to(cdt)


def apply_blocks(cfg: ModelConfig, opts: ApplyOptions, params: dict,
                 x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, the router aux loss summed over the blocks), summed
    unit by unit as the reference's scan carries it."""
    _check(cfg)
    aux = _zero(x)
    for r in range(cfg.num_repeats):
        sl = _repeat(params["blocks"], r)
        unit = _zero(x)
        for j, blk in enumerate(cfg.pattern):
            x, a = _block_apply(cfg, opts, blk, sl[j], x)
            unit = unit + a
        aux = aux + unit
    return x, aux


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype)


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


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, opts: ApplyOptions, params: dict,
            batch: dict) -> Tuple[torch.Tensor, dict]:
    """Run the prompt, return (last-token logits [B,V], cache)."""
    _check(cfg)
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
    _check(cfg)
    x = _embed_inputs(cfg, params, batch)
    pos = int(cache["pos"])
    for r in range(cfg.num_repeats):
        sl_p = _repeat(params["blocks"], r)
        sl_c = _repeat(cache["blocks"], r)
        for j, blk in enumerate(cfg.pattern):
            x = _block_apply_decode(cfg, opts, blk, sl_p[j], x, sl_c[j], pos)
    logits = _head(cfg, params, x[:, 0])
    return logits, {"blocks": cache["blocks"], "pos": pos + 1}
