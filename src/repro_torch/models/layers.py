"""Parameter definitions and common layers; port of `repro.models.layers`.

Parameters are described by a tree (nested dicts and tuples) of
:class:`ParamDef`; the same tree materializes tensors (`materialize`),
makes storage-free ones for the dry-run (`abstract`) and counts parameters.
Logical axis names are mapped to mesh axes by the active sharding
recipe (`repro_torch.distributed.sharding`): on a mesh of several ranks
each leaf becomes a DTensor with its rules' placements.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.counter_rng import M32, mix32, unit24

# ---------------------------------------------------------------------------
# Trees of dicts and tuples
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf=None) -> Any:
    """Apply ``fn`` to the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure of dicts and tuples)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Any, is_leaf=None, path: str = ""
                          ) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs; a path reads like ``['blocks'][0]['mix']['wq']``
    (the reference's ``jax.tree_util.keystr``)."""
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [pl for k in tree for pl in tree_leaves_with_path(
            tree[k], is_leaf, f"{path}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [pl for i, t in enumerate(tree) for pl in
                tree_leaves_with_path(t, is_leaf, f"{path}[{i}]")]
    return [(path, tree)]


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones | ssm_a_log
    scale: Optional[float] = None  # stddev override for "normal"
    dtype: Optional[str] = None  # None -> the materialize() default dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def _leaf_seed(seed: int, path: str) -> int:
    # stable across processes, unlike the reference's abs(hash(path))
    return (seed * 0x9E3779B1 + zlib.crc32(path.encode())) % (2 ** 63)


def _materialize_one(d: ParamDef, seed: int, path: str, dtype,
                     device: torch.device) -> torch.Tensor:
    dtype = _dtype(d.dtype) if d.dtype is not None else dtype
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "ssm_a_log":
        # S4/Mamba A init: A = -(1..d_state) broadcast over channels.
        a = torch.arange(1, d.shape[-1] + 1, dtype=torch.float32,
                         device=device).expand(d.shape)
        return torch.log(a).to(dtype)
    std = d.scale if d.scale is not None else 0.02
    x = _trunc_normal(int(np.prod(d.shape)), _leaf_seed(seed, path), device)
    return x.mul_(std).to(dtype).view(d.shape)


# the standard normal's CDF at -2 and +2: the truncation's bounds
_PHI_LO, _PHI_HI = 0.022750131948179195, 0.9772498680518208
# int64 elements per temporary while drawing
_CHUNK = 1 << 25


def _trunc_normal(n: int, key: int, device: torch.device) -> torch.Tensor:
    """n float32 draws of a standard normal truncated to [-2, 2], by the
    inverse CDF of counter-based uniforms (`repro_torch.counter_rng`):
    the same integer bits on every device, so the same seed gives the
    same weights on the CPU and on the card (to an ulp of erfinv)."""
    k0, k1 = key & M32, (key >> 32) & M32
    out = torch.empty(n, dtype=torch.float32, device=device)
    for i0 in range(0, n, _CHUNK):
        i = torch.arange(i0, min(n, i0 + _CHUNK), dtype=torch.int64,
                         device=device)
        h = mix32((i & M32) ^ k0)
        h = mix32((h + (i >> 32) + k1) & M32)
        u = unit24(h) + 2.0 ** -25                     # in (0, 1)
        p = _PHI_LO + (_PHI_HI - _PHI_LO) * u
        out[i0:i0 + i.numel()] = (2.0 ** 0.5 * torch.erfinv(2.0 * p - 1.0)
                                  ).clamp_(-2.0, 2.0)
    return out


def local_part(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of a whole tensor ``t`` as a DTensor (no
    communication: every rank made the same ``t``)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import local_shape_and_offset
    shape, offset = local_shape_and_offset(tuple(t.shape), mesh, placements)
    local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _sharded(rules) -> bool:
    from repro_torch.distributed.sharding import mesh_size
    return rules is not None and mesh_size(rules.mesh) > 1


def materialize(defs, seed: int, dtype,
                device: Union[None, str, torch.device] = None,
                rules=None) -> dict:
    """ParamDef tree -> tensor tree on ``device`` (CUDA unless the caller
    passes ``device="cpu"``; see `repro_torch.resolve_device`). Each leaf
    is a counter-based stream keyed by ``seed`` and the CRC-32 of the
    leaf's path, so a leaf's values depend neither on the other leaves
    nor on the device.

    With ``rules`` on a mesh of several ranks each leaf is a DTensor
    placed by ``rules.placements`` (the reference's ``param_shardings``):
    every rank draws the whole leaf and keeps its shard, so the values
    equal the unsharded ones. On one rank (or without rules) the leaves
    are plain tensors, so a one-rank step pays no DTensor dispatch."""
    dtype = _dtype(dtype)
    device = resolve_device(device)
    # tree_map visits the leaves in tree_leaves_with_path's order
    paths = iter(p for p, _ in tree_leaves_with_path(defs, is_def))
    if not _sharded(rules):
        return tree_map(lambda d: _materialize_one(d, seed, next(paths),
                                                   dtype, device),
                        defs, is_leaf=is_def)
    return tree_map(lambda d: local_part(
        _materialize_one(d, seed, next(paths), dtype, device), rules.mesh,
        rules.placements(d.axes, d.shape)), defs, is_leaf=is_def)


def place(tree, defs, rules):
    """A tree of whole tensors (the structure of ``defs``) as DTensors
    placed by ``rules``; the tree itself when ``rules`` span one rank."""
    if not _sharded(rules):
        return tree
    return tree_map(lambda d, t: local_part(
        t, rules.mesh, rules.placements(d.axes, d.shape)), defs, tree,
        is_leaf=is_def)


def abstract(defs, dtype, rules=None) -> dict:
    """ParamDef tree -> meta tensors (shapes and dtypes, no storage), the
    counterpart of the reference's ``ShapeDtypeStruct`` stand-ins. With
    ``rules`` on a mesh of several ranks each leaf is a DTensor whose
    local shard has the shape its placements give this rank."""
    dtype = _dtype(dtype)

    def one(d: ParamDef):
        dt = _dtype(d.dtype) if d.dtype is not None else dtype
        if not _sharded(rules):
            return torch.empty(d.shape, dtype=dt, device="meta")
        from torch.distributed.tensor import DTensor
        from repro_torch.distributed.sharding import local_shape_and_offset
        pl = rules.placements(d.axes, d.shape)
        shape, _ = local_shape_and_offset(tuple(d.shape), rules.mesh, pl)
        whole = torch.empty(d.shape, dtype=dt, device="meta")
        return DTensor.from_local(torch.empty(shape, dtype=dt, device="meta"),
                                  rules.mesh, pl, run_check=False,
                                  shape=whole.shape, stride=whole.stride())

    return tree_map(one, defs, is_leaf=is_def)


def count_params(defs) -> int:
    return int(sum(np.prod(d.shape) for _, d in
                   tree_leaves_with_path(defs, is_def)))


def stack_defs(defs, n: int, axis_name: str = "layers"):
    """Add a leading stacking axis (per-repeat parameters)."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, (axis_name,) + d.axes, d.init,
                           d.scale, d.dtype),
        defs, is_leaf=is_def)


# ---------------------------------------------------------------------------
# Common layers
# ---------------------------------------------------------------------------


class _RMSNorm(torch.autograd.Function):
    """The reference's ``custom_vjp`` of `rms_norm`: fp32 internals, and
    cotangents in the dtypes of ``x`` and ``scale`` (a bf16 residual
    stream gets bf16 cotangents)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        xf = x.float()
        inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, scale, inv)
        return (xf * inv * scale.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale, inv = ctx.saved_tensors
        xhat = x.float() * inv
        gx_hat = g.float() * scale.float()
        # d/dx of x * rsqrt(mean(x^2) + eps) * scale
        dx = inv * (gx_hat - xhat * (gx_hat * xhat).mean(-1, keepdim=True))
        dscale = (g.float() * xhat).sum(dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMSNorm with fp32 internals, output in x's dtype; differentiable,
    with input-dtype cotangents (`_RMSNorm`)."""
    return _RMSNorm.apply(x, scale, eps)


def rms_norm_def(dim: int, axis: Optional[str]) -> ParamDef:
    return ParamDef((dim,), (axis,), init="ones")


def rope_freqs(head_dim: int, theta: float,
               device: Union[str, torch.device, None] = None
               ) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings; fp32, [head_dim//2]."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to
    [..., seq]. Each head is split into halves (not interleaved); an odd
    head_dim keeps its last channel unrotated."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    # [:half]: for an odd head_dim rope_freqs has one entry too many (the
    # reference's own apply_rope fails to broadcast there)
    freqs = rope_freqs(head_dim, theta, x.device)[:half]
    angles = positions[..., :, None].float() * freqs  # [..., S, half]
    cos = torch.cos(angles)[..., :, None, :]  # [..., S, 1, half]
    sin = torch.sin(angles)[..., :, None, :]
    x1f = x[..., :half].float()
    x2f = x[..., half:2 * half].float()
    parts = [x1f * cos - x2f * sin, x2f * cos + x1f * sin]
    if head_dim % 2:
        parts.append(x[..., 2 * half:].float())
    return torch.cat(parts, dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Dense MLP (gated SwiGLU or plain GELU)
# ---------------------------------------------------------------------------


def mlp_defs(d_model: int, d_ff: int, gated: bool) -> dict:
    defs = {
        "w_up": ParamDef((d_model, d_ff), ("d_model", "d_ff")),
        "w_down": ParamDef((d_ff, d_model), ("d_ff", "d_model")),
    }
    if gated:
        defs["w_gate"] = ParamDef((d_model, d_ff), ("d_model", "d_ff"))
    return defs


def mlp_apply(p: dict, x: torch.Tensor, gated: bool) -> torch.Tensor:
    up = x @ p["w_up"]
    if gated:
        act = F.silu(x @ p["w_gate"]) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        act = F.gelu(up, approximate="tanh")
    return act @ p["w_down"]
