"""Mamba (S6) block: full-sequence apply, prefill and single-token decode;
port of `repro.models.mamba`.

The inner dim is sharded on ``model`` (the reference's ``shard(...)``
calls, DTensor redistributes on a mesh of several ranks and the identity
on one). ``opts.scan_impl`` selects the recurrence:

- ``"chunked"``: the reference's `_mamba_seq`, with the discretised
  [B, S, d_inner, N] tensors formed in memory, a log-depth scan of
  `_scan_op` inside each chunk and a carry across chunks;
- ``"cuda"``: the selective-scan kernel (`repro_torch.kernels.
  selective_scan`), which never forms them; its plain version on a CPU
  tensor. Decode takes the kernel too, at S = 1 from the cached state.
  On DTensor inputs it runs on each rank's channels (`_scan_local`).

Everything inside the recurrence is float32, as in the reference.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import local_call, shard
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models.layers import ParamDef, rms_norm, rms_norm_def
from repro_torch.models.types import ApplyOptions

IMPLS = ("chunked", "cuda")


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    dt_rank = m.dt_rank or math.ceil(cfg.d_model / 16)
    return d_in, m.d_state, m.d_conv, dt_rank


def mamba_defs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    d_in, N, d_conv, dt_rank = _dims(cfg)
    return {
        "ln": rms_norm_def(D, "d_model"),
        "in_proj": ParamDef((D, 2 * d_in), ("d_model", "d_inner")),
        "conv_w": ParamDef((d_conv, d_in), (None, "d_inner")),
        "x_proj": ParamDef((d_in, dt_rank + 2 * N), ("d_inner", None)),
        "dt_w": ParamDef((dt_rank, d_in), (None, "d_inner")),
        "dt_bias": ParamDef((d_in,), ("d_inner",), init="zeros"),
        "a_log": ParamDef((d_in, N), ("d_inner", None), init="ssm_a_log"),
        "d_skip": ParamDef((d_in,), ("d_inner",), init="ones"),
        "out_proj": ParamDef((d_in, D), ("d_inner", "d_model")),
    }


def mamba_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    d_in, N, d_conv, _ = _dims(cfg)
    return {
        "conv": ParamDef((batch, d_conv - 1, d_in),
                         ("act_batch", None, "act_dinner"),
                         init="zeros", dtype=cfg.compute_dtype),
        "ssm": ParamDef((batch, d_in, N), ("act_batch", "act_dinner", None),
                        init="zeros", dtype="float32"),
    }


def _check_impl(opts: ApplyOptions) -> None:
    if opts.scan_impl not in IMPLS:
        raise ValueError(f"scan_impl {opts.scan_impl!r} not in {IMPLS}")


def _split_in(cfg, p, x):
    """ln -> in_proj -> (x_part, z). x: [B, S, D]."""
    d_in = _dims(cfg)[0]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    h = shard(h, "act_batch", None, None)  # the bf16 boundary
    xz = h @ p["in_proj"]
    xz = shard(xz, "act_batch", None, "act_dinner")
    return xz[..., :d_in], xz[..., d_in:]


def _ssm_inputs(cfg, p, xa):
    """xa: [B, S, d_in] (post conv+silu) -> dt, Bc, Cc (fp32)."""
    _, N, _, dt_rank = _dims(cfg)
    dbc = (xa @ p["x_proj"]).float()
    dt_in, Bc, Cc = torch.split(dbc, [dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_in @ p["dt_w"].float() + p["dt_bias"].float())
    return dt, Bc, Cc  # [B,S,d_in], [B,S,N], [B,S,N]


def _causal_conv(xp: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv as the reference's shifted sum.
    xp: [B,S,d_in]; w: [d_conv, d_in]."""
    d_conv = w.shape[0]
    if state is None:
        pad = xp.new_zeros(xp.shape[:1] + (d_conv - 1,) + xp.shape[2:])
    else:
        pad = state.to(xp.dtype)
    xpad = torch.cat([pad, xp], dim=1)
    out = sum(xpad[:, i:i + xp.shape[1]] * w[i] for i in range(d_conv))
    new_state = xpad[:, -(d_conv - 1):] if d_conv > 1 else pad
    return out, new_state


def _scan_op(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _associative_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1):
    """Inclusive scan of `_scan_op` along ``dim`` in log2(n) rounds
    (Hillis-Steele): element t combines with element t - 2^k. Products of
    decays that underflow stay 0; nothing is divided."""
    n, off = a.shape[dim], 1
    while off < n:
        a_new, b_new = _scan_op(
            (a.narrow(dim, 0, n - off), b.narrow(dim, 0, n - off)),
            (a.narrow(dim, off, n - off), b.narrow(dim, off, n - off)))
        a = torch.cat([a.narrow(dim, 0, off), a_new], dim=dim)
        b = torch.cat([b.narrow(dim, 0, off), b_new], dim=dim)
        off *= 2
    return a, b


def _chunked_scan(cfg: ModelConfig, xa32, dt, A, Bc, Cc):
    """The reference's chunked recurrence -> (h . C [B,S,d_in], h_last)."""
    B, S, d_in = xa32.shape
    N = A.shape[1]
    chunk = min(cfg.mamba.chunk, S)
    while S % chunk:
        chunk -= 1
    # discretize: Abar [B,S,d_in,N], Bx [B,S,d_in,N]
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * xa32)[..., None] * Bc[:, :, None, :]
    h = torch.zeros((B, d_in, N), dtype=torch.float32, device=xa32.device)
    ys = []
    for c0 in range(0, S, chunk):
        a_cum, b_cum = _associative_scan(dA[:, c0:c0 + chunk],
                                         dBx[:, c0:c0 + chunk])
        h_all = a_cum * h[:, None] + b_cum  # [B, chunk, d_in, N]
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all, Cc[:, c0:c0 + chunk]))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def _mamba_seq(cfg: ModelConfig, opts: ApplyOptions, p: dict,
               x: torch.Tensor):
    """Full-sequence apply. Returns (out, final_conv_state, final_ssm_state)."""
    _check_impl(opts)
    xp, z = _split_in(cfg, p, x)
    xc, conv_state = _causal_conv(xp, p["conv_w"])
    xa = F.silu(xc)
    dt, Bc, Cc = _ssm_inputs(cfg, p, xa)
    A = -torch.exp(p["a_log"].float())  # [d_in, N]

    xa32 = xa.float()
    if opts.scan_impl == "cuda":
        # float32 x, so y (with D x added in the kernel) stays float32
        # until the gate, as in the reference
        y, h_last = _scan_local(xa32, dt, A, Bc, Cc, p["d_skip"])
    else:
        y, h_last = _chunked_scan(cfg, xa32, dt, A, Bc, Cc)
        y = y + xa32 * p["d_skip"].float()
    y = (y * F.silu(z.float())).to(x.dtype)
    y = shard(y, "act_batch", None, "act_dinner")
    out = shard(y @ p["out_proj"], "act_batch", "act_seq_res", None)
    return out, conv_state, h_last


# the selective scan's layout: channels (d_inner) split on ``model``, the
# batch on ``data``; B and C are shared by every channel, so whole
_X = ("act_batch", None, "act_dinner")
_BC = ("act_batch", None, None)
_A = ("act_dinner", None)
_H = ("act_batch", "act_dinner", None)


def _scan_local(x, dt, A, Bc, Cc, d_skip, h0=None):
    """The selective-scan kernel on the local shards: every channel's
    recurrence is independent, so each rank scans its own channels."""
    args = (x, dt, A, Bc, Cc, d_skip) + (() if h0 is None else (h0,))
    axes = (_X, _X, _A, _BC, _BC, ("act_dinner",)) + (
        () if h0 is None else (_H,))
    B, S, d_in = x.shape
    return local_call(
        lambda *a: selective_scan(*a[:6], h0=a[6] if len(a) > 6 else None),
        args, axes, (_X, _H), ((B, S, d_in), (B, d_in, A.shape[1])))


def mamba_apply(cfg: ModelConfig, opts: ApplyOptions, p: dict,
                x: torch.Tensor) -> torch.Tensor:
    return _mamba_seq(cfg, opts, p, x)[0]


def mamba_prefill(cfg: ModelConfig, opts: ApplyOptions, p: dict,
                  x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    out, conv_state, h_last = _mamba_seq(cfg, opts, p, x)
    cache = {"conv": conv_state.to(getattr(torch, cfg.compute_dtype)),
             "ssm": h_last}
    return out, cache


def mamba_decode(cfg: ModelConfig, opts: ApplyOptions, p: dict,
                 x: torch.Tensor, cache: dict, pos
                 ) -> Tuple[torch.Tensor, dict]:
    """Single-token apply. x: [B, 1, D]; cache: conv state + ssm state.

    The new states are written into ``cache``'s tensors in place (the
    reference returns updated copies); the returned cache holds the same
    tensors."""
    del pos
    _check_impl(opts)
    xp, z = _split_in(cfg, p, x)
    xc, conv_state = _causal_conv(xp, p["conv_w"], state=cache["conv"])
    xa = F.silu(xc)
    dt, Bc, Cc = _ssm_inputs(cfg, p, xa)
    A = -torch.exp(p["a_log"].float())

    xa32 = xa.float()
    if opts.scan_impl == "cuda":
        y, h = _scan_local(xa32, dt, A, Bc, Cc, p["d_skip"],
                           h0=cache["ssm"])
    else:
        dA = torch.exp(dt[:, 0, :, None] * A)  # [B, d_in, N]
        dBx = (dt[:, 0] * xa32[:, 0])[..., None] * Bc[:, 0, None, :]
        h = dA * cache["ssm"] + dBx
        y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])[:, None]
        y = y + xa32 * p["d_skip"].float()
    y = (y * F.silu(z.float())).to(x.dtype)
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(h)
    return shard(y @ p["out_proj"], "act_batch", None, None), cache
