"""xLSTM blocks: chunkwise-parallel mLSTM + sequential sLSTM; port of
`repro.models.xlstm`.

mLSTM (matrix memory) runs in the reference's GLA-style chunkwise-parallel
form: within a chunk, decayed attention-like scores (matrix products);
across chunks a loop carries the matrix state C [B,H,dh,dh] and the
normalizer n [B,H,dh]. Input gates are softcapped, so the exponential
gating stays in fp32 range without a running-max stabilizer (the
reference's deviation from the paper's m_t stabilizer).

sLSTM (scalar memory, new-memory mixing) is sequential: a loop over time
with the paper's m_t stabilizer.

The inner dim is sharded on ``model`` (the reference's ``shard(...)``
calls: DTensor redistributes on a mesh of several ranks, the identity on
one). The sLSTM's per-step loop and the mLSTM's chunk loop run on
whatever layout DTensor propagates; no sharded run of either has been
checked against the one-rank port yet. Decode writes
the new states into the cache's tensors in place, as the port's other
blocks do; the returned cache holds the same tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models.layers import ParamDef, rms_norm, rms_norm_def
from repro_torch.models.types import ApplyOptions

_SOFTCAP = 15.0


def _softcap(x, cap=_SOFTCAP):
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    x = cfg.xlstm
    d_in = x.mlstm_expand * cfg.d_model
    return d_in, x.num_heads, d_in // x.num_heads


def mlstm_defs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    d_in, NH, _ = _mlstm_dims(cfg)
    return {
        "ln": rms_norm_def(D, "d_model"),
        "up_proj": ParamDef((D, 2 * d_in), ("d_model", "d_inner")),
        "wq": ParamDef((d_in, d_in), ("d_inner", None)),
        "wk": ParamDef((d_in, d_in), ("d_inner", None)),
        "wv": ParamDef((d_in, d_in), ("d_inner", None)),
        "w_if": ParamDef((d_in, 2 * NH), ("d_inner", None)),
        "gn": rms_norm_def(d_in, "d_inner"),
        "down_proj": ParamDef((d_in, D), ("d_inner", "d_model")),
    }


def mlstm_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    _, NH, dh = _mlstm_dims(cfg)
    return {
        "C": ParamDef((batch, NH, dh, dh), ("act_batch", None, None, None),
                      init="zeros", dtype="float32"),
        "n": ParamDef((batch, NH, dh), ("act_batch", None, None),
                      init="zeros", dtype="float32"),
    }


def _mlstm_qkv_gates(cfg, p, x):
    d_in, NH, dh = _mlstm_dims(cfg)
    B, S, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    up = shard(h @ p["up_proj"], "act_batch", None, "act_dinner")
    xi, z = up[..., :d_in], up[..., d_in:]
    q = (xi @ p["wq"]).reshape(B, S, NH, dh)
    k = (xi @ p["wk"]).reshape(B, S, NH, dh) * (dh ** -0.5)
    v = (xi @ p["wv"]).reshape(B, S, NH, dh)
    gates = (xi @ p["w_if"]).float()  # [B,S,2*NH]
    li = _softcap(gates[..., :NH])  # log input gate
    lf = F.logsigmoid(gates[..., NH:])  # log forget gate
    return q, k, v, li, lf, z


def _mlstm_chunk(C, n, q32, k32, v32, lic, lfc):
    """One chunk of the recurrence. C [B,NH,dh,dh], n [B,NH,dh]; q/k/v
    [B,chunk,NH,dh] float32; lic, lfc [B,chunk,NH] -> (y_c, C', n')."""
    chunk = q32.shape[1]
    Fc = torch.cumsum(lfc, dim=1)  # [B,chunk,NH] inclusive log-decay
    # intra-chunk: D_ts = exp(F_t - F_s + li_s), s <= t
    lD = Fc[:, :, None, :] - Fc[:, None, :, :] + lic[:, None, :, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q32.device))
    lD = torch.where(tri[None, :, :, None], lD, -torch.inf)
    Dm = torch.exp(lD)  # [B,t,s,NH]
    scores = torch.einsum("bthd,bshd->btsh", q32, k32) * Dm
    intra = torch.einsum("btsh,bshd->bthd", scores, v32)
    # inter-chunk from the carried state
    decay_t = torch.exp(Fc)  # [B,chunk,NH]
    inter = torch.einsum("bthd,bhde->bthe", q32, C) * decay_t[..., None]
    # normalizer
    n_intra = torch.einsum("btsh,bshd->bthd", Dm, k32)
    n_t = decay_t[..., None] * n[:, None] + n_intra
    denom = torch.clamp(
        torch.abs(torch.einsum("bthd,bthd->bth", q32, n_t)), min=1.0)
    y_c = (intra + inter) / denom[..., None]
    # carry update
    rev = torch.exp(Fc[:, -1:, :] - Fc + lic)  # decay from s to chunk end
    last = torch.exp(Fc[:, -1])
    C_new = last[..., None, None] * C + torch.einsum(
        "bshd,bshe->bhde", rev[..., None] * k32, v32)
    n_new = last[..., None] * n + torch.einsum("bsh,bshd->bhd", rev, k32)
    return y_c, C_new, n_new


def _mlstm_seq(cfg: ModelConfig, opts: ApplyOptions, p: dict,
               x: torch.Tensor):
    B, S, D = x.shape
    d_in, NH, dh = _mlstm_dims(cfg)
    chunk = min(cfg.xlstm.chunk, S)
    while S % chunk:
        chunk -= 1

    q, k, v, li, lf, z = _mlstm_qkv_gates(cfg, p, x)
    C = torch.zeros((B, NH, dh, dh), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, NH, dh), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        y_c, C, n = _mlstm_chunk(C, n, q[:, sl].float(), k[:, sl].float(),
                                 v[:, sl].float(), li[:, sl], lf[:, sl])
        ys.append(y_c.to(x.dtype))
    y = torch.cat(ys, dim=1).reshape(B, S, d_in)
    y = rms_norm(y, p["gn"], cfg.norm_eps) * F.silu(z)
    y = shard(y, "act_batch", None, "act_dinner")
    return shard(y @ p["down_proj"], "act_batch", "act_seq_res", None), C, n


def mlstm_apply(cfg: ModelConfig, opts: ApplyOptions, p: dict,
                x: torch.Tensor) -> torch.Tensor:
    return _mlstm_seq(cfg, opts, p, x)[0]


def mlstm_prefill(cfg: ModelConfig, opts: ApplyOptions, p: dict,
                  x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    out, C_f, n_f = _mlstm_seq(cfg, opts, p, x)
    return out, {"C": C_f, "n": n_f}


def mlstm_decode(cfg: ModelConfig, opts: ApplyOptions, p: dict,
                 x: torch.Tensor, cache: dict, pos
                 ) -> Tuple[torch.Tensor, dict]:
    del pos
    B = x.shape[0]
    d_in, NH, dh = _mlstm_dims(cfg)
    q, k, v, li, lf, z = _mlstm_qkv_gates(cfg, p, x)
    q32, k32, v32 = (t[:, 0].float() for t in (q, k, v))
    i_g = torch.exp(li[:, 0])[..., None]  # [B,NH,1]
    f_g = torch.exp(lf[:, 0])[..., None]
    C = f_g[..., None] * cache["C"] + i_g[..., None] * torch.einsum(
        "bhd,bhe->bhde", k32, v32)
    n = f_g * cache["n"] + i_g * k32
    num = torch.einsum("bhd,bhde->bhe", q32, C)
    denom = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", q32, n)),
                        min=1.0)
    y = (num / denom[..., None]).reshape(B, 1, d_in).to(x.dtype)
    y = rms_norm(y, p["gn"], cfg.norm_eps) * F.silu(z)
    cache["C"].copy_(C)
    cache["n"].copy_(n)
    return shard(y @ p["down_proj"], "act_batch", None, None), cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_defs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    h = int(cfg.xlstm.slstm_proj_factor * D)
    return {
        "ln": rms_norm_def(D, "d_model"),
        "w_x": ParamDef((D, 4 * D), ("d_model", None)),
        "w_h": ParamDef((D, 4 * D), ("d_model", None)),
        "bias": ParamDef((4 * D,), (None,), init="zeros"),
        "gn": rms_norm_def(D, "d_model"),
        "up": ParamDef((D, h), ("d_model", "d_ff")),
        "down": ParamDef((h, D), ("d_ff", "d_model")),
    }


_SLSTM_STATE = ("c", "n", "h", "m")


def slstm_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    D = cfg.d_model
    return {
        k: ParamDef((batch, D), ("act_batch", None), init="zeros",
                    dtype="float32")
        for k in _SLSTM_STATE
    }


def _slstm_step(p, carry, x_t):
    """x_t: [B, 4D] precomputed input projection; carry: (c, n, h, m)."""
    c, n, h, m = carry
    gates = (x_t + h.to(x_t.dtype) @ p["w_h"] + p["bias"]).float()
    li, lf_raw, z_raw, o_raw = torch.chunk(gates, 4, dim=-1)
    li = _softcap(li)
    lf = F.logsigmoid(lf_raw)
    m_new = torch.maximum(lf + m, li)
    c_new = (torch.exp(lf + m - m_new) * c
             + torch.exp(li - m_new) * torch.tanh(z_raw))
    n_new = torch.exp(lf + m - m_new) * n + torch.exp(li - m_new)
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_out(cfg, p, y):
    y = rms_norm(y, p["gn"], cfg.norm_eps)
    return F.gelu(y @ p["up"], approximate="tanh") @ p["down"]


def _slstm_seq(cfg: ModelConfig, opts: ApplyOptions, p: dict,
               x: torch.Tensor):
    B, S, D = x.shape
    hx = rms_norm(x, p["ln"], cfg.norm_eps)
    x_proj = hx @ p["w_x"]  # [B, S, 4D], hoisted out of the loop
    zeros = torch.zeros((B, D), dtype=torch.float32, device=x.device)
    carry = (zeros, zeros, zeros, zeros - 1e30)
    hs = []
    for t in range(S):
        carry, h_t = _slstm_step(p, carry, x_proj[:, t])
        hs.append(h_t)
    y = torch.stack(hs, dim=1).to(x.dtype)  # [B, S, D]
    return shard(_slstm_out(cfg, p, y), "act_batch", "act_seq_res", None
                 ), carry


def slstm_apply(cfg: ModelConfig, opts: ApplyOptions, p: dict,
                x: torch.Tensor) -> torch.Tensor:
    return _slstm_seq(cfg, opts, p, x)[0]


def slstm_prefill(cfg: ModelConfig, opts: ApplyOptions, p: dict,
                  x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    y, carry = _slstm_seq(cfg, opts, p, x)
    return y, dict(zip(_SLSTM_STATE, carry))


def slstm_decode(cfg: ModelConfig, opts: ApplyOptions, p: dict,
                 x: torch.Tensor, cache: dict, pos
                 ) -> Tuple[torch.Tensor, dict]:
    del pos
    hx = rms_norm(x, p["ln"], cfg.norm_eps)
    x_proj = (hx @ p["w_x"])[:, 0]
    carry, h_out = _slstm_step(p, tuple(cache[k] for k in _SLSTM_STATE),
                               x_proj)
    for k, t in zip(_SLSTM_STATE, carry):
        cache[k].copy_(t)
    return shard(_slstm_out(cfg, p, h_out[:, None].to(x.dtype)),
                 "act_batch", None, None), cache
