"""Weights from the seed, on the device, in the type they are served in,
laid out as the port's parameter tree (the stacked ``blocks`` of
`repro_torch.models.model.model_defs`).

Every leaf is a view of one flat buffer. The normal leaves lie first and
are drawn by one `normal_` call of a `torch.Generator` on the device;
each is then scaled to its standard deviation; norms' scales are ones,
Mamba's ``a_log`` is log(1..N), biases are zeros and ``d_skip`` ones.
The same seed gives the same bits, so a run can make its initial
weights again after the port has updated them in place (training)."""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from portbench.seeds import generator

STD = 0.02


def leaves(cfg) -> List[Tuple[str, object]]:
    """(path, ParamDef) of the port's parameter tree, in tree order."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import is_def, tree_leaves_with_path
    return tree_leaves_with_path(M.model_defs(cfg), is_def)


def make(cfg, seed: int, device) -> dict:
    """The port's parameter tree for ``cfg``, drawn from ``seed``."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import is_def, tree_map
    dtype = getattr(torch, cfg.param_dtype)
    defs = leaves(cfg)
    normal = [d for _, d in defs if d.init == "normal"]
    n_normal = sum(math.prod(d.shape) for d in normal)
    total = sum(math.prod(d.shape) for _, d in defs)
    flat = torch.empty(total, dtype=dtype, device=device)
    flat[:n_normal].normal_(0.0, 1.0, generator=generator(device, seed,
                                                           "weights"))
    off_normal, off_rest = 0, n_normal
    views = {}
    for path, d in defs:
        n = math.prod(d.shape)
        if d.init == "normal":
            v = flat[off_normal:off_normal + n].view(d.shape)
            off_normal += n
            v.mul_(d.scale if d.scale is not None else STD)
        else:
            v = flat[off_rest:off_rest + n].view(d.shape)
            off_rest += n
            if d.init == "zeros":
                v.zero_()
            elif d.init == "ones":
                v.fill_(1.0)
            elif d.init == "ssm_a_log":
                v.copy_(torch.log(torch.arange(
                    1, d.shape[-1] + 1, dtype=torch.float32,
                    device=device)).expand(d.shape))
            else:
                raise ValueError(f"{path}: init {d.init!r}")
        views[path] = v
    it = iter(views[p] for p, _ in defs)
    return tree_map(lambda _: next(it), M.model_defs(cfg), is_leaf=is_def)


def layer(params: dict, pattern_len: int, index: int) -> dict:
    """Layer ``index``'s weights as a flat dict (``mix.wq``, ``ff.w_up``,
    ...) of views of the stacked tree."""
    blk = params["blocks"][index % pattern_len]
    r = index // pattern_len
    return {f"{part}.{k}": t[r] for part, sub in blk.items()
            for k, t in sub.items()}
