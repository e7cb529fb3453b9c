"""AdamW with fp32 moments and global-norm clipping; port of
`repro.optim.adamw`.

Optimizer state is described with ParamDefs derived from the parameter
defs (same logical axes). ZeRO-1 (``TrainConfig.zero1``) places this
state by the ``fsdp_tp`` rules (`launch.steps`): on DTensor leaves each
gradient is reduced into its moments' layout, the update runs on the
local shards, and the new parameter is gathered back into its own
layout. On plain tensors (one rank) nothing moves.

The arithmetic is the reference's, in fp32, in place (the reference
donates params and state), under `torch.no_grad`. Where every gradient
is a plain CUDA tensor, the norm, the clip and the update are the
multi-tensor kernels of `repro_torch.kernels.adamw` (a few launches a
step; the update equals `_update` bit for bit for the same scalars), and
a CUDA tensor of a type they do not take raises. CPU tensors take the
plain version, `global_norm` and `_update`, leaf by leaf over pieces of
at most `PIECE` elements along a leaf's leading axis: a stacked leaf one
layer slice at a time, so the fp32 temporaries stay bounded whatever the
leaf's size. DTensor leaves keep `global_norm` and update their local
shards by the kernel on CUDA, one quad at a time. While spans record,
`FUSED` tallies the elements updated (`fused_tally`).
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.kernels.adamw import kernel as adamw_kernel
from repro_torch.models.layers import (ParamDef, is_def, tree_leaves_with_path,
                                       tree_map)
from repro_torch.obs import trace as obs_trace

# elements of a leaf updated at once (256 MB of one fp32 temporary)
PIECE = 1 << 26

# Elements updated by the `apply_adamw` calls made while spans record
# (`obs.trace`): by the CUDA kernels' launches (`adamw_kernel.ELEMENTS`),
# and in all; host integers.
FUSED = {"kernel": 0, "all": 0}


def fused_tally() -> Tuple[int, int]:
    """(elements the kernels updated, elements updated) over the calls
    tallied so far."""
    return FUSED["kernel"], FUSED["all"]


def adamw_init_defs(param_defs, moment_dtype: str = "float32") -> dict:
    """ParamDef tree for optimizer state (m, v moments + step counter)."""
    moment = lambda d: ParamDef(d.shape, d.axes, init="zeros",
                                dtype=moment_dtype)
    return {
        "m": tree_map(moment, param_defs, is_leaf=is_def),
        "v": tree_map(moment, param_defs, is_leaf=is_def),
        "step": ParamDef((), (), init="zeros", dtype="int32"),
    }


def _is_dtensor(t) -> bool:
    from repro_torch.distributed.sharding import is_dtensor
    return is_dtensor(t)


def pieces(t: torch.Tensor) -> Sequence[torch.Tensor]:
    """Views of ``t`` along its leading axis, each of at most `PIECE`
    elements (a whole row of the leading axis at least). A DTensor is
    one piece: its local shard is what a rank holds."""
    if t.dim() == 0 or t.numel() <= PIECE or _is_dtensor(t):
        return (t,)
    rows = max(1, PIECE // (t.numel() // t.shape[0]))
    return torch.split(t, rows, dim=0)


def global_norm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    total = None
    for x in leaves:
        for piece in pieces(x):
            s = torch.sum(torch.square(piece.float()))
            total = s if total is None else total + s
    return torch.sqrt(total)


def _route(quads) -> str:
    """Where the quads' gradients lie: "cuda" (plain CUDA tensors, the
    kernels), "cpu" (the plain version) or "dtensor"; a mix raises."""
    kinds = {"dtensor" if _is_dtensor(g) else g.device.type
             for _, g, _, _ in quads}
    if len(kinds) != 1 or not kinds <= {"cuda", "cpu", "dtensor"}:
        raise ValueError(f"AdamW takes gradients of one kind: all CUDA, all "
                         f"CPU or all DTensor, got {sorted(kinds)}")
    return kinds.pop()


@torch.no_grad()
def apply_adamw(cfg: TrainConfig, quads: List[Tuple[torch.Tensor, ...]],
                step: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
    """The AdamW update of each (param, grad, m, v) in ``quads`` (leaves or
    slices of leaves; params, m and v are written in place) at the
    incremented ``step`` -> the pre-clip global grad norm. A DTensor
    gradient is first reduced into its moments' layout, once. The whole
    update is the span ``adamw.apply`` (`obs.trace`)."""
    with obs_trace.span("adamw.apply"):
        launched = adamw_kernel.ELEMENTS
        quads = [(p, g.redistribute(m.device_mesh, m.placements), m, v)
                 if _is_dtensor(g) else (p, g, m, v) for p, g, m, v in quads]
        route = _route(quads)
        b1, b2 = cfg.beta1, cfg.beta2
        c1 = 1.0 - b1 ** step.to(torch.float32)
        c2 = 1.0 - b2 ** step.to(torch.float32)
        if route == "cuda":
            quads = [(p, g.contiguous(), m, v) for p, g, m, v in quads]
            gnorm, clip = adamw_kernel.norm_and_clip(
                [g for _, g, _, _ in quads], cfg.grad_clip)
            adamw_kernel.update(quads, clip, c1, c2, lr, b1, b2, cfg.eps,
                                cfg.weight_decay)
        else:
            gnorm = plain_apply(cfg, quads, step, lr, c1, c2)
        _tally(quads, adamw_kernel.ELEMENTS - launched)
        return gnorm


def plain_apply(cfg: TrainConfig, quads, step, lr, c1, c2) -> torch.Tensor:
    """`apply_adamw`'s plain version on already reduced ``quads``, given
    the bias corrections ``c1`` and ``c2``: `global_norm`, the clip, and
    `_update` piece by piece (DTensor quads by `_update_sharded`) -> the
    norm. The route of CPU tensors and DTensors."""
    gnorm = global_norm(g for _, g, _, _ in quads)
    if cfg.grad_clip > 0:
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                           max=1.0)
    else:
        clip = torch.ones_like(gnorm)
    if any(_is_dtensor(t) for t in (gnorm, step, lr)):
        # replicated scalars: each rank's local value is the whole one
        clip, c1, c2, lr_l = (_whole(t) for t in (clip, c1, c2, lr))
    else:
        lr_l = lr
    for quad in quads:
        if _is_dtensor(quad[0]):
            _update_sharded(cfg, quad, clip, c1, c2, lr_l)
            continue
        for p, g, m, v in zip(*(pieces(t) for t in quad)):
            _update(cfg, p, g, m, v, clip, c1, c2, lr)
    return gnorm


def _tally(quads, by_kernel: int) -> None:
    """Adds to `FUSED` while spans record: ``by_kernel``, the elements the
    update kernel's launches took in this call, and the elements this
    rank updated in all (a DTensor quad's local shard)."""
    if not obs_trace.recording():
        return
    FUSED["kernel"] += by_kernel
    FUSED["all"] += sum((m.to_local() if _is_dtensor(m) else m).numel()
                        for _, _, m, _ in quads)


def _whole(t) -> torch.Tensor:
    from torch.distributed.tensor import Replicate
    if not _is_dtensor(t):
        return t
    return t.redistribute(t.device_mesh,
                          [Replicate()] * t.device_mesh.ndim).to_local()


def _update(cfg: TrainConfig, p, g, m, v, clip, c1, c2, lr) -> None:
    """One AdamW update of plain tensors, in place."""
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
    g = g.float() * clip
    mf = b1 * m.float() + (1.0 - b1) * g
    vf = b2 * v.float() + (1.0 - b2) * torch.square(g)
    delta = (mf / c1) / (torch.sqrt(vf / c2) + eps) + wd * p.float()
    p.copy_(p.float() - lr * delta)
    m.copy_(mf)
    v.copy_(vf)


def _update_sharded(cfg: TrainConfig, quad, clip, c1, c2, lr) -> None:
    """The update of DTensor leaves in the moments' layout: the gradient
    is reduced into it (a reduce-scatter from partial sums, a slice from
    a replicated gradient), the parameter sliced into it, the update run
    on the local shards, and the new parameter gathered back into its own
    layout (ZeRO-1's all-gather when the moments are sharded finer). The
    local update is the kernel's on CUDA, `_update` on the CPU."""
    from torch.distributed.tensor import DTensor
    p, g, m, v = quad
    mesh, pl = m.device_mesh, tuple(m.placements)
    g_l = g.redistribute(mesh, pl).to_local()
    same = tuple(p.placements) == pl
    p_m = p if same else p.redistribute(mesh, pl)
    p_l = p_m.to_local() if same else p_m.to_local().clone()
    m_l, v_l = m.to_local(), v.to_local()
    if p_l.is_cuda:
        adamw_kernel.update([(p_l, g_l.contiguous(), m_l, v_l)], clip, c1, c2,
                            lr, cfg.beta1, cfg.beta2, cfg.eps,
                            cfg.weight_decay)
    else:
        _update(cfg, p_l, g_l, m_l, v_l, clip, c1, c2, lr)
    if not same:
        new = DTensor.from_local(p_l, mesh, pl, run_check=False,
                                 shape=p.shape, stride=p.stride())
        p.to_local().copy_(new.redistribute(mesh, p.placements).to_local())


def adamw_update(cfg: TrainConfig, params, grads, opt_state,
                 lr: torch.Tensor) -> Tuple[dict, dict, torch.Tensor]:
    """Returns (params, opt_state, pre-clip grad norm): ``params`` and
    ``opt_state``'s tensors are updated in place and returned, the step
    counter incremented."""
    leaves = lambda t: [x for _, x in tree_leaves_with_path(t)]
    step = opt_state["step"].add_(1)
    quads = list(zip(leaves(params), leaves(grads), leaves(opt_state["m"]),
                     leaves(opt_state["v"])))
    gnorm = apply_adamw(cfg, quads, step, torch.as_tensor(
        lr, dtype=torch.float32, device=step.device))
    return params, opt_state, gnorm
