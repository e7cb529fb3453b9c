"""Logical-axis sharding rules -> per-dimension mesh axes and DTensor
placements, with divisibility fallback; port of
`repro.distributed.sharding`.

Two namespaces share one rules table:

* **weight axes** — names used in :class:`repro_torch.models.layers.ParamDef`
  (``d_model``, ``d_ff``, ``heads``, ``vocab``, ``experts``, ...).
* **activation axes** — ``act_*`` names used by model code via
  :func:`shard` (``act_batch``, ``act_heads``, ``act_kvseq``, ...).

A rule maps a logical axis to a *tuple* of mesh axes (e.g. batch over
``('pod', 'data')``). :meth:`Rules.spec` drops mesh axes that do not divide
the dimension (prefix fallback) and never assigns one mesh axis twice within
a spec — so the same recipe degrades gracefully across all 10 archs
(24-head models, 40-expert MoE, batch-1 decode, ...).

The reference's ``PartitionSpec`` is a tuple here, entry for entry the
same (``None``, one mesh axis name, or a tuple of names).
:meth:`Rules.placements` turns it into one ``torch.distributed.tensor``
placement per mesh dimension (``Shard(d)`` or ``Replicate()``), and
:func:`shard` is ``DTensor.redistribute`` where the reference has
``with_sharding_constraint``.

Recipes:

* ``dp``      — replicated weights (vocab dims still TP), batch-parallel.
* ``tp``      — megatron-style tensor parallel on the ``model`` axis.
* ``fsdp_tp`` — ``tp`` + weight ``d_model`` dims sharded over ``data``
  (FSDP / ZeRO-3-style), required for the 42B/52B/405B archs.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

Spec = Tuple[Any, ...]


def _is_def(x):  # lazy to avoid a circular import with repro_torch.models
    from repro_torch.models.layers import is_def
    return is_def(x)


# logical axis -> preferred mesh axes, per recipe
_RECIPES: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "dp": {
        "vocab": ("model",),
        "act_batch": ("pod", "data"),
        "act_kv_batch": ("pod", "data"),
        "act_vocab": ("model",),
        "act_dinner": ("model",),
        "act_kvseq": ("model",),
    },
    "tp": {
        "act_kv_batch": ("pod", "data"),
        "d_ff": ("model",),
        "moe_ff": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        "d_inner": ("model",),
        "act_batch": ("pod", "data"),
        "act_heads": ("model",),
        "act_kv_heads": ("model",),
        "act_dff": ("model",),
        "act_vocab": ("model",),
        "act_experts": ("model",),
        "act_seq_tp": ("model",),
        "act_kvseq": ("model",),
        "act_dinner": ("model",),
    },
    "fsdp_tp": {
        "act_kv_batch": ("pod", "data"),
        "d_model": ("data",),
        "d_ff": ("model",),
        "moe_ff": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        "d_inner": ("model",),
        "act_batch": ("pod", "data"),
        "act_heads": ("model",),
        "act_kv_heads": ("model",),
        "act_dff": ("model",),
        "act_vocab": ("model",),
        "act_experts": ("model",),
        "act_seq_tp": ("model",),
        "act_kvseq": ("model",),
        "act_dinner": ("model",),
        # Megatron-SP: the residual stream between blocks is seq-sharded on
        # 'model', so the per-layer activations saved for backward shrink
        # by the TP degree. Blocks all-gather on entry.
        "act_seq_res": ("model",),
    },
}

# decode-time recipe for fsdp_tp archs: weights stay sharded over
# (data x model) — they must, to fit — but the activations' d_model is
# sharded over 'data' so matmuls contract over a sharded dim and emit
# partial-sum all-reduces of tiny single-token activations instead of
# all-gathering the weights per decoded token.
_RECIPES["decode_2d"] = dict(_RECIPES["fsdp_tp"])
_RECIPES["decode_2d"]["act_batch"] = ("pod",)
_RECIPES["decode_2d"]["act_dmodel"] = ("data",)
_RECIPES["decode_2d"]["act_kv_batch"] = ("pod", "data")


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, axis sizes) of a ``DeviceMesh`` or of any object with
    ``mesh_dim_names`` and ``shape`` (the tests' duck meshes)."""
    return tuple(mesh.mesh_dim_names), tuple(int(s) for s in mesh.shape)


def mesh_size(mesh) -> int:
    return math.prod(mesh_axes(mesh)[1])


@dataclasses.dataclass(frozen=True)
class Rules:
    mesh: Any
    table: Dict[str, Tuple[str, ...]]
    recipe: str

    # ---- resolution -----------------------------------------------------
    def _axis_size(self, name: str) -> int:
        return dict(zip(*mesh_axes(self.mesh)))[name]

    def _resolve_dim(self, logical: Optional[str], dim: int,
                     used: set) -> Optional[Tuple[str, ...]]:
        if logical is None or logical not in self.table:
            return None
        names = mesh_axes(self.mesh)[0]
        want = [a for a in self.table[logical]
                if a in names and a not in used]
        # prefix fallback: keep the longest prefix whose product divides dim
        while want:
            prod = 1
            for a in want:
                prod *= self._axis_size(a)
            if prod > 1 and dim % prod == 0:
                for a in want:
                    used.add(a)
                return tuple(want)
            want = want[:-1]
        return None

    def spec(self, axes: Tuple[Optional[str], ...],
             shape: Tuple[int, ...]) -> Spec:
        """The reference's ``PartitionSpec`` as a tuple: per tensor dim,
        ``None``, one mesh axis name, or a tuple of names."""
        used: set = set()
        entries = []
        for logical, dim in zip(axes, shape):
            got = self._resolve_dim(logical, dim, used)
            if got is None:
                entries.append(None)
            elif len(got) == 1:
                entries.append(got[0])
            else:
                entries.append(got)
        return tuple(entries)

    def spec_placements(self, spec: Spec) -> tuple:
        """One placement per mesh dimension: ``Shard(d)`` where a mesh
        axis carries tensor dim ``d``, else ``Replicate()``. A tuple entry
        (``("pod", "data")``) puts ``Shard(d)`` on several mesh dims, in
        the mesh's major-to-minor order, as the reference's does."""
        from torch.distributed.tensor import Replicate, Shard
        names = mesh_axes(self.mesh)[0]
        out = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            for a in ((entry,) if isinstance(entry, str) else entry):
                out[names.index(a)] = Shard(d)
        return tuple(out)

    def placements(self, axes: Tuple[Optional[str], ...],
                   shape: Tuple[int, ...]) -> tuple:
        return self.spec_placements(self.spec(tuple(axes), tuple(shape)))

    def dim_shardable(self, logical: str, dim: int) -> bool:
        return self.spec((logical,), (dim,)) != (None,)

    def shard(self, x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
        """``x`` redistributed to the layout of ``axes``, and its gradient
        likewise in the backward (as the transpose of the reference's
        ``with_sharding_constraint`` constrains the cotangent); the
        identity for a plain tensor or on a one-rank mesh."""
        if not is_dtensor(x) or mesh_size(self.mesh) == 1:
            return x
        return _Constrain.apply(x, self.placements(tuple(axes),
                                                   tuple(x.shape)))

    # ---- pytree helpers --------------------------------------------------
    def param_specs(self, defs):
        """ParamDef tree -> spec tree."""
        from repro_torch.models.layers import tree_map
        return tree_map(lambda d: self.spec(d.axes, d.shape), defs,
                        is_leaf=_is_def)

    def param_placements(self, defs):
        """ParamDef tree -> placements tree (the reference's
        ``param_shardings``)."""
        from repro_torch.models.layers import tree_map
        return tree_map(lambda d: self.placements(d.axes, d.shape), defs,
                        is_leaf=_is_def)

    def replicated(self) -> tuple:
        """Every mesh dim ``Replicate()``: the reference's ``named(P())``."""
        return self.spec_placements(())


class _Constrain(torch.autograd.Function):
    """Redistribute to ``placements``; in the backward the gradient is
    first brought to ``placements`` too (the transpose of the reference's
    ``with_sharding_constraint`` constrains the cotangent), then to the
    input's layout, as DTensor's redistribute sends it back. Without the
    first step a partial-sum gradient would flow on unreduced, and the
    next product gather a weight instead of reducing it (Megatron's
    backward all-reduce)."""

    @staticmethod
    def forward(ctx, x, placements):
        from torch.distributed.tensor import Partial, Replicate
        ctx.placements = placements
        ctx.back = tuple(Replicate() if isinstance(p, Partial) else p
                         for p in x.placements)
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        for pl in (ctx.placements, ctx.back):
            if tuple(g.placements) != pl:
                g = g.redistribute(g.device_mesh, pl)
        return g, None


class _GradLayout(torch.autograd.Function):
    """The identity, and the gradient redistributed to ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def shard_grad(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``x`` as it is, and its gradient in the layout of ``axes``: for a
    partial sum added to the sequence-sharded residual stream (Megatron
    SP), whose reduce-scatter stays in the forward while the backward
    all-gathers the gradient before the product's transpose (which
    DTensor would otherwise run on a strided sequence shard). The
    identity without rules, for a plain tensor or on one rank."""
    rules = _CURRENT.get()
    if rules is None or not is_dtensor(x) or mesh_size(rules.mesh) == 1:
        return x
    return _GradLayout.apply(x, rules.placements(tuple(axes),
                                                 tuple(x.shape)))


def make_rules(recipe: str, mesh) -> Rules:
    if recipe not in _RECIPES:
        raise KeyError(f"unknown sharding recipe {recipe!r}")
    return Rules(mesh=mesh, table=dict(_RECIPES[recipe]), recipe=recipe)


# ---------------------------------------------------------------------------
# Ambient rules (set by step functions; model code calls shard())
# ---------------------------------------------------------------------------

_CURRENT: contextvars.ContextVar[Optional[Rules]] = contextvars.ContextVar(
    "repro_torch_sharding_rules", default=None
)


def current_rules() -> Optional[Rules]:
    return _CURRENT.get()


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    """Bind ``rules`` for the model code's `shard` / `dim_shardable`. On
    a mesh of several ranks it also lets plain tensors (positions, masks,
    index ranges that every rank builds whole) meet DTensors as
    replicated ones (``implicit_replication``)."""
    tok = _CURRENT.set(rules)
    try:
        if rules is not None and mesh_size(rules.mesh) > 1:
            with _implicit_replication():
                yield rules
        else:
            yield rules
    finally:
        _CURRENT.reset(tok)


@contextlib.contextmanager
def _implicit_replication():
    """``implicit_replication`` that restores the flag it found, so
    nested `use_rules` (a remat recompute's) keep the outer one's."""
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    old = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = old


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Apply a logical layout if rules are active, else no-op."""
    rules = _CURRENT.get()
    if rules is None:
        return x
    return rules.shard(x, *axes)


def dim_shardable(logical: str, dim: int) -> bool:
    rules = _CURRENT.get()
    if rules is None:
        return False
    return rules.dim_shardable(logical, dim)


def fsdp_gather(params, defs_fn):
    """A block's weights for use: under a recipe that shards weight
    ``d_model`` dims over ``data`` (``fsdp_tp``) each DTensor leaf is
    all-gathered over them on entry, the rest of its layout kept, and its
    gradient reduce-scattered back in the backward (FSDP). GSPMD does the
    same for the reference; DTensor would otherwise pick a layout for
    each product by itself, and may split a head dim it cannot split.
    ``defs_fn()`` gives the ParamDef tree of ``params``; the identity
    without rules, on one rank, for other recipes and for ``decode_2d``
    (which contracts over the sharded dim instead)."""
    rules = _CURRENT.get()
    if (rules is None or "d_model" not in rules.table
            or "act_dmodel" in rules.table or mesh_size(rules.mesh) == 1):
        return params
    from repro_torch.models.layers import tree_map
    table = {k: v for k, v in rules.table.items() if k != "d_model"}
    use = Rules(rules.mesh, table, rules.recipe)
    return tree_map(lambda d, w: _Constrain.apply(
        w, use.placements(d.axes, d.shape)) if is_dtensor(w) else w,
        defs_fn(), params, is_leaf=_is_def)


# ---------------------------------------------------------------------------
# Local regions: kernels and ops DTensor has no rule for
# ---------------------------------------------------------------------------


_DTENSOR = None


def is_dtensor(x) -> bool:
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor
        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


def local_shape_and_offset(shape, mesh, placements):
    """This rank's shard of a tensor of ``shape`` placed by ``placements``
    -> (local shape, offset of its first element), the rules' even
    sharding (every split divides). Several mesh dims on one tensor dim
    split it in mesh order, major to minor, as DTensor does. Plain
    integers, so it runs under a fake tensor mode too."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    shape, offset = list(shape), [0] * len(shape)
    for mdim, p in enumerate(placements):
        if isinstance(p, Shard):
            size = shape[p.dim] // mesh.size(mdim)
            offset[p.dim] += coord[mdim] * size
            shape[p.dim] = size
    return tuple(shape), tuple(offset)


def local_call(fn, args: tuple, in_axes: tuple, out_axes: tuple,
               out_shapes: tuple):
    """``fn(*args)`` on the local shards: the counterpart of the
    reference's ``shard_map``. Without rules, or when no argument is a
    DTensor, it is ``fn(*args)``. Otherwise it runs under
    ``torch.distributed.tensor.experimental.local_map``: each DTensor
    argument is redistributed to the placements of its logical axes
    (``in_axes``; ``None`` for an argument passed as it is, such as a
    plain index tensor every rank holds whole), and each output
    ``j`` is a DTensor with the placements of ``out_axes[j]`` on the
    global shape ``out_shapes[j]``. One output -> a tensor, several ->
    a tuple."""
    rules = _CURRENT.get()
    dts = [a for a in args if is_dtensor(a)]
    if rules is None or not dts:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    in_pl = tuple(None if ax is None or not is_dtensor(a)
                  else rules.placements(ax, tuple(a.shape))
                  for a, ax in zip(args, in_axes))
    out_pl = tuple(rules.placements(ax, tuple(sh))
                   for ax, sh in zip(out_axes, out_shapes))
    # one output: its placements as a list (a tuple reads as one entry an
    # output)
    mapped = local_map(fn, out_placements=list(out_pl[0]) if len(out_pl) == 1
                       else out_pl, in_placements=in_pl,
                       device_mesh=dts[0].device_mesh,
                       redistribute_inputs=True)
    return mapped(*args)


def write_index(dst: torch.Tensor, src: torch.Tensor, index: int,
                dim: int) -> None:
    """``dst.select(dim, index).copy_(src)`` in place. On a DTensor
    ``dst`` the write lands in the local shard that holds ``index`` (the
    reference's ``dynamic_update_slice`` on a sharded dim): ``src`` is
    redistributed to ``dst``'s layout with ``dim`` taken out, and no
    rank gathers ``dst``."""
    if not is_dtensor(dst):
        dst.select(dim, index).copy_(src)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = dst.device_mesh, tuple(dst.placements)
    src_pl = tuple(
        Replicate() if isinstance(p, Shard) and p.dim == dim
        else Shard(p.dim - (p.dim > dim)) if isinstance(p, Shard) else p
        for p in pl)
    src_local = (src.redistribute(mesh, src_pl).to_local()
                 if is_dtensor(src) else src)
    shape, offset = local_shape_and_offset(tuple(dst.shape), mesh, pl)
    lo = offset[dim]
    if lo <= index < lo + shape[dim]:
        dst.to_local().select(dim, index - lo).copy_(src_local)
