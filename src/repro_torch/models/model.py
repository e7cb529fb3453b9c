"""Model assembly: embed -> repeated block pattern -> head; port of
`repro.models.model` for attention blocks with dense feed-forward.

Parameters, KV caches and step inputs are described by ParamDef trees
with the reference's structure: per-repeat parameters are stacked on a
leading axis, so a reference parameter tree carries across leaf for leaf
(`repro_torch.convert.params_from_reference`). The reference's scan over
repeats is a Python loop here.

Mamba, mLSTM, sLSTM and MoE blocks are not ported yet and raise
NotImplementedError; so does training (loss, remat).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import BlockConfig, ModelConfig, ShapeConfig
from repro_torch.models import attention
from repro_torch.models.layers import (ParamDef, materialize, mlp_apply,
                                       mlp_defs, rms_norm, rms_norm_def,
                                       stack_defs, tree_map)
from repro_torch.models.types import ApplyOptions

_LATER = {
    "mamba": "Mamba blocks (with the selective-scan kernel, ROADMAP Queue "
             "2 item 4)",
    "mlstm": "mLSTM blocks",
    "slstm": "sLSTM blocks",
    "moe": "MoE feed-forward",
}


def _not_ported(what: str):
    raise NotImplementedError(
        f"{_LATER.get(what, what)} not ported yet: ROADMAP Queue 1 item 10")


def _check_block(blk: BlockConfig) -> None:
    if blk.kind != "attn":
        if blk.kind in _LATER:
            _not_ported(blk.kind)
        raise ValueError(blk.kind)
    if blk.ff == "moe":
        _not_ported("moe")


# ---------------------------------------------------------------------------
# Parameter / cache / input definitions
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig, blk: BlockConfig) -> dict:
    _check_block(blk)
    d = {"mix": attention.attn_defs(cfg)}
    if blk.ff == "dense":
        d["ff"] = {"ln": rms_norm_def(cfg.d_model, "d_model"),
                   **mlp_defs(cfg.d_model, cfg.d_ff, cfg.mlp_gated)}
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
    return attention.attn_cache_defs(cfg, batch, seq_len)


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


def _apply_ff(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return mlp_apply(p, h, cfg.mlp_gated)


def _block_apply(cfg, opts, p, x):
    x = x + attention.attn_apply(cfg, opts, p["mix"], x)
    if "ff" in p:
        x = x + _apply_ff(cfg, p["ff"], x)
    return x


def _block_apply_prefill(cfg, opts, p, x):
    """Like _block_apply but also returns the block's populated cache."""
    dx, cache = attention.attn_prefill(cfg, opts, p["mix"], x)
    x = x + dx
    if "ff" in p:
        x = x + _apply_ff(cfg, p["ff"], x)
    return x, cache


def _block_apply_decode(cfg, opts, p, x, cache, pos):
    dx, new_cache = attention.attn_decode(cfg, opts, p["mix"], x, cache, pos)
    x = x + dx
    if "ff" in p:
        x = x + _apply_ff(cfg, p["ff"], x)
    return x, new_cache


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
    _check(cfg)
    for r in range(cfg.num_repeats):
        sl = _repeat(params["blocks"], r)
        for j in range(len(cfg.pattern)):
            x = _block_apply(cfg, opts, sl[j], x)
    # no MoE block runs here, so the router's aux loss is 0
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


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
        for j in range(len(cfg.pattern)):
            x, c = _block_apply_prefill(cfg, opts, sl[j], x)
            caches.append(c)
        per_rep.append(tuple(caches))
    caches = tree_map(lambda *ts: torch.stack(ts), *per_rep)
    logits = _head(cfg, params, x[:, -1])
    return logits, {"blocks": caches, "pos": S}


def decode_step(cfg: ModelConfig, opts: ApplyOptions, params: dict,
                cache: dict, batch: dict) -> Tuple[torch.Tensor, dict]:
    """One decode step. Returns (logits [B,V], updated cache). The KV
    tensors of ``cache`` are updated in place (see `attention.attn_decode`);
    ``pos`` may be an int or a 0-d tensor."""
    _check(cfg)
    x = _embed_inputs(cfg, params, batch)
    pos = int(cache["pos"])
    for r in range(cfg.num_repeats):
        sl_p = _repeat(params["blocks"], r)
        sl_c = _repeat(cache["blocks"], r)
        for j in range(len(cfg.pattern)):
            x, _ = _block_apply_decode(cfg, opts, sl_p[j], x, sl_c[j], pos)
    logits = _head(cfg, params, x[:, 0])
    return logits, {"blocks": cache["blocks"], "pos": pos + 1}
