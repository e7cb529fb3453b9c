"""GQA attention: train/prefill (full sequence) + decode with a KV cache;
port of `repro.models.attention`.

Sharding modes, picked from the active rules as the reference picks
them (`repro_torch.distributed.sharding`):

* **head-TP** — query heads divide the ``model`` axis: heads sharded,
  KV repeated to every head and sharded with them (classic Megatron TP).
* **kvseq-TP** — heads do not divide the axis (24-head / 4-head archs),
  no rules are active, or we are decoding: the KV sequence dim is
  sharded on ``model``, and the softmax contraction over KV is
  reduced across it by DTensor.

Each ``shard(...)`` is a DTensor redistribute on a mesh of several
ranks and the identity otherwise; on one rank (or with no rules) the
math is the reference's single-device math. The kernels see local
shards only: on DTensor inputs each kernel call runs under `local_map`
with the layout of its branch (`_flash_local`, `_decode_local`).

``opts.attn_impl`` selects the implementation of the full-sequence core:
``"reference"`` (one full score block), ``"blocked"`` (a loop over query
blocks) or ``"cuda"`` (the flash-attention kernel, and in decode the
split-KV decode kernel; their plain versions on CPU tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (dim_shardable, is_dtensor,
                                              local_call, shard, write_index)
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (ParamDef, apply_rope, rms_norm,
                                       rms_norm_def)
from repro_torch.models.types import ApplyOptions

NEG_INF = -1e30

IMPLS = ("reference", "blocked", "cuda")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig) -> dict:
    a = cfg.attn
    D = cfg.d_model
    defs = {
        "ln": rms_norm_def(D, "d_model"),
        "wq": ParamDef((D, a.num_heads, a.head_dim),
                       ("d_model", "heads", "head_dim")),
        "wk": ParamDef((D, a.num_kv_heads, a.head_dim),
                       ("d_model", "kv_heads", "head_dim")),
        "wv": ParamDef((D, a.num_kv_heads, a.head_dim),
                       ("d_model", "kv_heads", "head_dim")),
        "wo": ParamDef((a.num_heads, a.head_dim, D),
                       ("heads", "head_dim", "d_model")),
    }
    if a.qk_norm:
        defs["q_norm"] = rms_norm_def(a.head_dim, None)
        defs["k_norm"] = rms_norm_def(a.head_dim, None)
    return defs


def attn_cache_defs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """KV-cache ParamDefs for one attention block (SWA: ring buffer)."""
    a = cfg.attn
    window = a.sliding_window
    T = min(seq_len, window) if window else seq_len
    kv_shape = (batch, T, a.num_kv_heads, a.head_dim)
    axes = ("act_kv_batch", "act_kvseq", "act_kv_heads", None)
    dt = cfg.compute_dtype
    return {
        "k": ParamDef(kv_shape, axes, init="zeros", dtype=dt),
        "v": ParamDef(kv_shape, axes, init="zeros", dtype=dt),
    }


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int],
          causal: bool) -> torch.Tensor:
    """[Sq, Tk] bool validity mask."""
    q = q_pos[:, None]
    k = k_pos[None, :]
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k <= q
    if window is not None:
        m &= (q - k) < window
    m &= k >= 0  # ring-buffer slots that never held data
    return m


def _softmax(s: torch.Tensor, axes: tuple) -> torch.Tensor:
    """Softmax over the last dim of scores laid out by ``axes``. On a
    DTensor it is written as a max, an exp and a sum whose statistics are
    all-reduced across a sharded KV dim (as GSPMD does); DTensor's own
    softmax would gather the scores whole."""
    if not is_dtensor(s):
        return torch.softmax(s, dim=-1)
    stat = axes[:-1] + (None,)
    e = torch.exp(s - shard(torch.amax(s, dim=-1, keepdim=True), *stat))
    return e / shard(torch.sum(e, dim=-1, keepdim=True), *stat)


def _score_block(qb: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 qpos_b: torch.Tensor, k_pos: torch.Tensor,
                 window: Optional[int], causal: bool, scale: float,
                 kvseq_tp: bool = True) -> torch.Tensor:
    """qb: [B, blk, H, hd]; k/v: [B, T, H, hd] -> [B, blk, H, hd].
    Products in the input dtype, softmax in float32 (the reference's
    dtype boundaries)."""
    s = torch.einsum("bqhd,bthd->bhqt", qb, k).float() * scale
    axes = (("act_batch", None, None, "act_kvseq") if kvseq_tp
            else ("act_batch", "act_heads", None, None))
    s = shard(s, *axes)
    m = _mask(qpos_b, k_pos, window, causal)
    s = torch.where(m[None, None, :, :], s, NEG_INF)
    p = _softmax(s, axes)
    return torch.einsum("bhqt,bthd->bqhd", p.to(v.dtype), v).to(v.dtype)


def _score_block_grouped(qb: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         qpos_b: torch.Tensor, k_pos: torch.Tensor,
                         window: Optional[int], causal: bool, scale: float,
                         kvseq_tp: bool = True) -> torch.Tensor:
    """GQA without materializing repeated K/V.
    qb: [B, blk, H, hd]; k, v: [B, T, K, hd] -> [B, blk, H, hd]."""
    B, blk, H, hd = qb.shape
    K = k.shape[2]
    G = H // K
    qg = qb.reshape(B, blk, K, G, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k).float() * scale
    axes = ("act_batch", None, None, None, "act_kvseq" if kvseq_tp else None)
    if kvseq_tp:
        s = shard(s, *axes)
    m = _mask(qpos_b, k_pos, window, causal)
    s = torch.where(m[None, None, None, :, :], s, NEG_INF)
    p = _softmax(s, axes)
    o = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), v)
    return o.reshape(B, blk, H, hd).to(v.dtype)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                   window: Optional[int], causal: bool,
                   opts: ApplyOptions, kvseq_tp: bool = True
                   ) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,K,hd]; q_pos: [S]; k_pos: [T] -> [B,S,H,hd]."""
    if opts.attn_impl not in IMPLS:
        raise ValueError(f"attn_impl {opts.attn_impl!r} not in {IMPLS}")
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = hd ** -0.5
    blk = opts.block_q
    # Without rules (and on a one-rank mesh) the reference always takes its
    # kvseq_tp layout, whose grouped einsum (attention.py:145) returns
    # before its kernel call for G > 1. That branch is a choice of TPU
    # sharding layout, not of math: the flash kernel maps query head h to
    # KV head h // G itself and computes the same function, so "cuda"
    # takes it for every G.
    if opts.attn_impl == "cuda" and S > blk and S % blk == 0:
        return _flash_local(q, k, v, q_pos, k_pos, window, causal, blk,
                            kvseq_tp)
    if kvseq_tp and G > 1:
        # grouped einsum: no K/V repeat
        k = shard(k, "act_batch", "act_kvseq", None, None)
        v = shard(v, "act_batch", "act_kvseq", None, None)
        score = _score_block_grouped
    else:
        if G > 1:
            k = torch.repeat_interleave(k, G, dim=2)
            v = torch.repeat_interleave(v, G, dim=2)
        if kvseq_tp:
            k = shard(k, "act_batch", "act_kvseq", None, None)
            v = shard(v, "act_batch", "act_kvseq", None, None)
        else:
            k = shard(k, "act_batch", None, "act_heads", None)
            v = shard(v, "act_batch", None, "act_heads", None)
        score = _score_block
    whole = opts.attn_impl == "reference" or S <= blk or S % blk != 0

    def blocks(q, k, v, q_pos, k_pos):
        if whole:
            return score(q, k, v, q_pos, k_pos, window, causal, scale,
                         kvseq_tp)
        return torch.cat([score(q[:, i:i + blk], k, v, q_pos[i:i + blk],
                                k_pos, window, causal, scale, kvseq_tp)
                          for i in range(0, S, blk)], dim=1)

    if kvseq_tp:
        return blocks(q, k, v, q_pos, k_pos)
    # head-TP: every head's scores are its own rank's; DTensor would merge
    # the batch and head shards into one strided dim of its batched
    # product, which it cannot place, so the blocks run on the local shards
    heads = ("act_batch", None, "act_heads", None)
    return local_call(blocks, (q, k, v, q_pos, k_pos),
                      (heads, heads, heads, None, None), (heads,),
                      (q.shape,))


def _flash_local(q, k, v, q_pos, k_pos, window, causal, blk, kvseq_tp):
    """The flash kernel on the local shards. Head-TP: q sharded on its
    heads and K/V repeated to every head and sharded with them (the
    reference's ``k_rep`` layout), so each rank's heads pair with their
    own KV heads. kvseq-TP: the kernel needs every KV position of its
    queries, so heads and KV stay whole on ``model`` and only the batch
    is split (``act_batch``), as for the reference's kernel call, which
    GSPMD cannot split either."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    if not kvseq_tp and G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    heads = None if kvseq_tp else "act_heads"
    qa = ("act_batch", None, heads, None)
    kva = ("act_batch", None, heads, None)
    return local_call(
        lambda q_, k_, v_, qp, kp: flash_attention(
            q_, k_, v_, qp, kp, window=window, causal=causal, block=blk),
        (q, k, v, q_pos, k_pos), (qa, kva, kva, None, None),
        (qa,), (q.shape,))


# ---------------------------------------------------------------------------
# Block apply: train / prefill
# ---------------------------------------------------------------------------


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    a = cfg.attn
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    # the bf16 boundary: the seq all-gather moves h, not the fp32 internals
    h = shard(h, "act_batch", None, None)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    if a.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)
    return q, k, v


def _full_sequence(cfg: ModelConfig, opts: ApplyOptions, p: dict,
                   x: torch.Tensor):
    a = cfg.attn
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions.expand(B, S))
    kvseq_tp = not dim_shardable("act_heads", a.num_heads)
    o = attention_core(q, k, v, positions, positions,
                       window=a.sliding_window, causal=a.causal, opts=opts,
                       kvseq_tp=kvseq_tp)
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return shard(y, "act_batch", "act_seq_res", None), k, v


def attn_apply(cfg: ModelConfig, opts: ApplyOptions, p: dict,
               x: torch.Tensor) -> torch.Tensor:
    """Full-sequence (train/prefill) attention. x: [B, S, D]."""
    return _full_sequence(cfg, opts, p, x)[0]


def attn_prefill(cfg: ModelConfig, opts: ApplyOptions, p: dict,
                 x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Prefill: like attn_apply but also returns the populated KV cache."""
    a = cfg.attn
    S = x.shape[1]
    y, k, v = _full_sequence(cfg, opts, p, x)
    if a.sliding_window and S > a.sliding_window:
        w = a.sliding_window
        # ring buffer: slot i holds the latest position p = i (mod w)
        start = S - w
        roll = start % w
        k_cache = torch.roll(k[:, start:], shifts=roll, dims=1)
        v_cache = torch.roll(v[:, start:], shifts=roll, dims=1)
    else:
        k_cache, v_cache = k, v
    cache = {
        "k": shard(k_cache, "act_batch", "act_kvseq", "act_kv_heads", None),
        "v": shard(v_cache, "act_batch", "act_kvseq", "act_kv_heads", None),
    }
    return y, cache


# ---------------------------------------------------------------------------
# Block apply: decode (single new token, cache of length T)
# ---------------------------------------------------------------------------


def attn_decode(cfg: ModelConfig, opts: ApplyOptions, p: dict,
                x: torch.Tensor, cache: dict, pos: int
                ) -> Tuple[torch.Tensor, dict]:
    """x: [B, 1, D]; cache k/v: [B, T, K, hd]; pos: current index.

    The new token's K and V are written into ``cache`` in place (the
    reference returns an updated copy); the returned cache holds the
    same tensors."""
    a = cfg.attn
    B = x.shape[0]
    T = cache["k"].shape[1]
    dev = x.device
    q, k_new, v_new = _project_qkv(cfg, p, x,
                                   torch.full((B, 1), pos, device=dev))

    window = a.sliding_window
    slot = (pos % window) if window else pos
    k, v = cache["k"], cache["v"]
    write_index(k, k_new[:, 0], slot, dim=1)
    write_index(v, v_new[:, 0], slot, dim=1)

    slots = torch.arange(T, device=dev)
    if window:
        # absolute position held by ring slot i (negative -> never written)
        k_pos = pos - torch.remainder(pos - slots, window)
    else:
        k_pos = torch.where(slots <= pos, slots, -1)

    if opts.attn_impl == "cuda":
        # split-KV decode kernel (repro_torch.kernels.decode_attention)
        o = _decode_local(q[:, 0], k, v, k_pos.to(torch.int32), pos)[:, None]
    else:
        o = attention_core(q, k, v, torch.full((1,), pos, device=dev),
                           k_pos, window=window, causal=a.causal,
                           opts=dataclasses.replace(opts,
                                                    attn_impl="reference"),
                           kvseq_tp=True)
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return shard(y, "act_batch", None, None), {"k": k, "v": v}


def _decode_local(q, k, v, k_pos, pos):
    """The split-KV decode kernel on the local shards: the batch split
    as the cache's (``act_kv_batch``), every KV position and head whole
    on each rank (the kernel's combine runs within one call)."""
    qa = ("act_kv_batch", None, None)
    kva = ("act_kv_batch", None, None, None)
    return local_call(
        lambda q_, k_, v_, kp: decode_attention(q_, k_, v_, kp, pos),
        (q, k, v, k_pos), (qa, kva, kva, None), (qa,), (q.shape,))
