"""The numbers that decide ``correct``, each a scale-free reading that a
sound run keeps small."""
from __future__ import annotations

import statistics
from typing import Dict

import torch


def token_gap(ref_logits: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
    """How far each served token's reference logit lies below the
    reference's best, in standard deviations of that row's reference
    logits: ref_logits [N, V] float32, tokens [N] -> [N]."""
    r = ref_logits.float()
    picked = torch.gather(r, -1, tokens.long().view(-1, 1))[:, 0]
    return (r.amax(-1) - picked) / r.std(-1)


TAU = 0.25  # a served token this many deviations below the best differs


def gap_share(gaps: torch.Tensor) -> float:
    """The share of served tokens whose gap exceeds `TAU`."""
    return float((gaps > TAU).float().mean())


def row_errs(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """||got - ref|| / ||ref|| of each row (the last dim), float64."""
    ref = ref.double()
    return (got.double() - ref).norm(dim=-1) / ref.norm(dim=-1).clamp(
        min=1e-300)


def rows(t: torch.Tensor, key: str) -> torch.Tensor:
    """A cache tensor as rows: a token's K or V ([..., heads, head_dim]),
    a sequence and channel's SSM state ([..., d_state]) or convolution
    window (the channel's last d_conv - 1 inputs)."""
    if key == "conv":  # [B, d_conv - 1, d_in]
        t = t.transpose(-1, -2)
    dims = 2 if key in ("k", "v") else 1
    return t.reshape(-1, *t.shape[t.dim() - dims:]).flatten(1)


def cache_err(got: dict, ref: dict, keys) -> float:
    """The largest over a layer's cache tensors ``keys`` of the median
    relative error of a row (`rows`): steady where a few tokens or
    sequences take another path."""
    return max((float(row_errs(rows(got[k], k), rows(ref[k], k)).median())
                for k in keys if k in ref), default=0.0)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref||, in float64."""
    ref = ref.double()
    return float((got.double() - ref).norm() / ref.norm().clamp(min=1e-300))


def norm_gap(got: Dict[str, float], ref: Dict[str, float],
             grad: Dict[str, float]) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    the median leaf's. Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out: they move by round-off
    alone."""
    floor = 1e-3 * statistics.median(grad.values())
    med = statistics.median(ref.values())
    return max(abs(got[n] - ref[n]) / max(ref[n], med, 1e-300)
               for n in ref if grad[n] >= floor)
