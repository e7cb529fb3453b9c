"""Carry the reference's arrays across to the port.

`from_reference` takes numpy arrays in the JAX package's packing —
``np.asarray(repro.core.sim.profile_values(p))`` rows, ``np.asarray(
repro.core.plane.gains_values(g))`` rows, and optionally a (T, 5, B)
noise array from the reference's ``draw_noise`` — and returns the
port's tensors, so both packages compute from identical inputs.
`params_from_reference` and `cache_from_reference` do the same for the
LM substrate's parameter and KV-cache trees (dicts and tuples of
arrays), `carry_from_reference` for the scan engine's per-run state
(the reference's typed-PI ``_Carry``), and `static_fit_from_reference`
for an identified static characteristic. Nothing here imports the
reference: it only reads arrays through ``np.asarray`` and fields by
name.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.layers import tree_map


def _tensor(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    # the reference's bf16 rows arrive as ml_dtypes.bfloat16: widen to
    # float32 (exact) and narrow again in torch, keeping the dtype bucket
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # a copy: the reference's arrays may be read-only views
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def from_reference(prof_vals, gains_vals, noise=None,
                   device: Union[None, str, torch.device] = None
                   ) -> Union[Tuple[torch.Tensor, torch.Tensor],
                              Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]]:
    """(B, 14) profile rows, (B, 9) gain rows [, (T, 5, B) noise] as
    numpy arrays of the reference's packing -> the same as tensors on
    ``device`` (CUDA unless told otherwise). Float32 rows stay float32;
    bfloat16 rows stay bfloat16; noise is float32."""
    dev = resolve_device(device)
    prof = _tensor(prof_vals, dev)
    gains = _tensor(gains_vals, dev)
    if noise is None:
        return prof, gains
    return prof, gains, _tensor(noise, dev).to(torch.float32)


def params_from_reference(tree, device: Union[None, str, torch.device] = None
                          ) -> dict:
    """The reference's parameter tree (`repro.models.init_params`; leaves
    float32 or bfloat16 arrays) -> the port's, with the same structure,
    dtypes and values, on ``device`` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)


def cache_from_reference(cache, device: Union[None, str, torch.device] = None
                         ) -> dict:
    """The reference's cache tree (``{"blocks": ..., "pos": int32}``) ->
    the port's: KV tensors on ``device``, ``pos`` a Python int."""
    dev = resolve_device(device)
    return {"blocks": tree_map(lambda a: _tensor(a, dev), cache["blocks"]),
            "pos": int(np.asarray(cache["pos"]))}


def carry_from_reference(carry, device: Union[None, str, torch.device] = None
                         ):
    """The reference's scan-engine carry (`repro.core.sim._Carry` on its
    typed fixed-gain PI path; (B,) leaves, or scalars for one run) -> the
    port's `repro_torch.core.sim._Carry` on ``device``, with the same
    dtypes: bool flags, int32 step counts, float32 otherwise."""
    from repro_torch.core import sim
    from repro_torch.core.controller import PIState
    from repro_torch.core.plant import PlantState
    dev = resolve_device(device)

    def leaf(x):
        a = np.array(np.asarray(x))
        if a.dtype == np.bool_ or a.dtype == np.int32:
            return torch.from_numpy(a).to(dev)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    def group(cls, nt):
        return cls(*(leaf(getattr(nt, f)) for f in cls._fields))

    return sim._Carry(
        plant=group(PlantState, carry.plant), pol=group(PIState, carry.pol),
        summ=group(sim._Summary, carry.summ),
        **{f: leaf(getattr(carry, f)) for f in sim._Carry._fields
           if f not in ("plant", "pol", "summ")})


def static_fit_from_reference(fit):
    """The reference's `repro.core.identify.StaticFit` -> the port's."""
    from repro_torch.core.identify import StaticFit
    return StaticFit(**{f: float(getattr(fit, f))
                        for f in StaticFit.__dataclass_fields__})
