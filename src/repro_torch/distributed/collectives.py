"""Collective census of a step: what it communicates; port of
`repro.distributed.collectives`.

The reference parses post-SPMD HLO text for ``all-reduce`` /
``all-gather`` / ``reduce-scatter`` / ``all-to-all`` /
``collective-permute`` ops. A PyTorch step has no HLO: DTensor issues
functional collectives (``_c10d_functional``) on the local shards as it
redistributes, and `CollectiveRecorder` (a ``TorchDispatchMode``) logs
each one as it runs: its kind (under the reference's names), the bytes
of its result and its group size. `collective_stats` weighs each with
the reference's ring-algorithm factor to estimate per-device link bytes:

  all-reduce:          2 * size * (n-1)/n      (reduce-scatter + all-gather)
  all-gather:          size * (n-1)/n          (size = gathered result)
  reduce-scatter:      size * (n-1)            (size = the scattered piece)
  all-to-all:          size * (n-1)/n
  collective-permute:  size
  broadcast:           size                    (no reference counterpart)

The census runs eagerly, so every executed collective counts (each layer,
each microbatch), where the reference's HLO counts a While body's
collectives once.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# functional collective -> the reference's kind
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


class Collective(NamedTuple):
    """One logged collective: kind (the reference's name), bytes of its
    result (summed over a coalesced op's tensors), group size."""
    kind: str
    result_bytes: int
    group_size: int


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


def _group_size(name: str, args) -> int:
    # group_size is an argument of the gathers and scatters; the others
    # name their group last
    if name.startswith(("all_gather", "reduce_scatter")):
        return int(args[-2])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


class CollectiveRecorder(TorchDispatchMode):
    """Logs every functional collective run while the mode is active
    (``with CollectiveRecorder() as rec: ...``; then ``rec.log``)."""

    def __init__(self):
        super().__init__()
        self.log: List[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            # let DTensor desugar into local ops first; they come back here
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        ns, _, name = func._schema.name.partition("::")
        if ns == "_c10d_functional" and name in _KINDS:
            self.log.append(Collective(_KINDS[name], _nbytes(out),
                                       _group_size(name, args)))
        return out


def collective_stats(log: Iterable[Collective]) -> Dict[str, Dict[str, float]]:
    """Per-collective-kind {count, result_bytes, link_bytes} from a
    recorder's log."""
    stats: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "result_bytes": 0.0, "link_bytes": 0.0})
    for kind, size, group in log:
        n = max(2, group)
        ring = (n - 1) / n
        if kind == "all-reduce":
            link = 2.0 * size * ring
        elif kind == "reduce-scatter":
            link = size * (n - 1)  # result is the scattered piece
        elif kind in ("collective-permute", "broadcast"):
            link = float(size)
        else:  # all-gather, all-to-all
            link = size * ring
        s = stats[kind]
        s["count"] += 1
        s["result_bytes"] += size
        s["link_bytes"] += link
    return dict(stats)


def total_collective_bytes(log: Iterable[Collective]) -> float:
    return sum(s["link_bytes"] for s in collective_stats(log).values())


def summarize(stats: Dict[str, Dict[str, float]]) -> str:
    if not stats:
        return "(no collectives)"
    parts = []
    for kind in sorted(stats):
        s = stats[kind]
        parts.append(f"{kind}: n={int(s['count'])} "
                     f"link={s['link_bytes'] / 1e6:.1f}MB")
    return "; ".join(parts)
