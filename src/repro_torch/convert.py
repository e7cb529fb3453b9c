"""Carry the reference's arrays across to the port.

`from_reference` takes numpy arrays in the JAX package's packing —
``np.asarray(repro.core.sim.profile_values(p))`` rows, ``np.asarray(
repro.core.plane.gains_values(g))`` rows, and optionally a (T, 5, B)
noise array from the reference's ``draw_noise`` — and returns the
port's tensors, so both packages compute from identical inputs.
`params_from_reference` and `cache_from_reference` do the same for the
LM substrate's parameter and KV-cache trees (dicts and tuples of
arrays), `train_state_from_reference` for a train step's params,
optimizer state and error-feedback buffers, `carry_from_reference` for
the scan engine's per-run state (the reference's ``_Carry``, typed PI or
packed policy state),
`rows_from_reference` (alias `policy_values_from_reference`) for packed
rows (policy values, detector rows, the guard vector, recorder rings),
`schedule_from_reference` and `faults_from_reference` for packed
schedules and fault rows, `static_fit_from_reference` for an
identified static characteristic, `plane_snapshot_from_reference` for a
whole control plane's `PlaneSnapshot`, and `fleet_args_from_reference`
for a fleet's packed per-node rows. Nothing here imports the
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


def train_state_from_reference(params, opt_state, ef_state=None,
                               device: Union[None, str,
                                             torch.device] = None):
    """The reference's train state (`repro.models.init_params` params, its
    AdamW state ``{"m", "v", "step"}`` and, for ``int8_ef``, its
    error-feedback tree) -> the port's ``(params, opt_state, ef_state)``
    on ``device`` (CUDA unless told otherwise), with the same structure,
    dtypes and values; ``step`` is a 0-d int32 tensor. So a step of both
    packages starts from identical state."""
    dev = resolve_device(device)
    leaf = lambda a: _tensor(a, dev)
    opt = {"m": tree_map(leaf, opt_state["m"]),
           "v": tree_map(leaf, opt_state["v"]),
           "step": torch.tensor(int(np.asarray(opt_state["step"])),
                                dtype=torch.int32, device=dev)}
    ef = None if ef_state is None else tree_map(leaf, ef_state)
    return tree_map(leaf, params), opt, ef


def cache_from_reference(cache, device: Union[None, str, torch.device] = None
                         ) -> dict:
    """The reference's cache tree (``{"blocks": ..., "pos": int32}``) ->
    the port's: KV tensors on ``device``, ``pos`` a Python int."""
    dev = resolve_device(device)
    return {"blocks": tree_map(lambda a: _tensor(a, dev), cache["blocks"]),
            "pos": int(np.asarray(cache["pos"]))}


def carry_from_reference(carry, device: Union[None, str, torch.device] = None
                         ):
    """The reference's scan-engine carry (`repro.core.sim._Carry`; (B,)
    leaves, or scalars for one run) -> the port's
    `repro_torch.core.sim._Carry` on ``device``, with the same dtypes:
    bool flags, int32 step counts, float32 otherwise. Its policy state is
    the typed `PIState` of the fixed-gain PI fast path or the packed (B,
    POLICY_STATE_DIM) vector; the detector, fault, guard and recorder
    fields come across as float32 rows, or None where the reference's are
    None."""
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

    pol = (group(PIState, carry.pol) if hasattr(carry.pol, "_fields")
           else leaf(carry.pol))
    opt = lambda x: None if x is None else leaf(x)
    return sim._Carry(
        plant=group(PlantState, carry.plant), pol=pol,
        summ=group(sim._Summary, carry.summ),
        **{f: opt(getattr(carry, f, None)) for f in sim._Carry._fields
           if f not in ("plant", "pol", "summ")})


def rows_from_reference(vals, device: Union[None, str, torch.device] = None
                        ) -> torch.Tensor:
    """Packed float32 rows of the reference (policy values,
    `detector_values` rows, a `guard_values` vector, flight-recorder
    rings; any leading shape) -> the same values as a float32 tensor on
    ``device`` (CUDA unless told otherwise)."""
    return _tensor(vals, resolve_device(device))


def schedule_from_reference(sv, device: Union[None, str,
                                              torch.device] = None):
    """The reference's packed `ScheduleValues` (one schedule or stacked
    per run) -> the port's `ScheduleValues` on ``device``."""
    from repro_torch.core.workloads.schedule import ScheduleValues
    dev = resolve_device(device)
    return ScheduleValues(*(_tensor(getattr(sv, f), dev)
                            for f in ScheduleValues._fields))


def faults_from_reference(fv, device: Union[None, str, torch.device] = None):
    """The reference's packed `FaultValues` (one schedule or stacked per
    run) -> the port's `FaultValues` on ``device``."""
    from repro_torch.core.faults import FaultValues
    dev = resolve_device(device)
    return FaultValues(*(_tensor(getattr(fv, f), dev)
                         for f in FaultValues._fields))


# the reference's packed policy values (`repro.core.policies.
# policy_values` rows, kinds at slot 0) are rows like any other
policy_values_from_reference = rows_from_reference


def static_fit_from_reference(fit):
    """The reference's `repro.core.identify.StaticFit` -> the port's."""
    from repro_torch.core.identify import StaticFit
    return StaticFit(**{f: float(getattr(fit, f))
                        for f in StaticFit.__dataclass_fields__})


def plane_snapshot_from_reference(snap):
    """The reference's `repro.core.plane.PlaneSnapshot` (numpy rows and
    host metadata) -> the port's `PlaneSnapshot`, field by field: float32
    rows, a bool ``alive`` mask, the heartbeat store's float64 / int64
    buffers, the event log's state as it is. A fingerprinted snapshot gets
    the port's fingerprint of the carried rows (the reference hashes its
    tree through its own executor's digest); `ControlPlane.restore` then
    checks it and the rows' finiteness."""
    from repro_torch.core.plane import PlaneSnapshot
    f32 = lambda x: None if x is None else np.array(np.asarray(x),
                                                    np.float32)
    store = {k: (np.array(np.asarray(v)) if isinstance(v, np.ndarray)
                 else v) for k, v in snap.store_state.items()}
    out = PlaneSnapshot(
        capacity=int(snap.capacity), n_tenants=int(snap.n_tenants),
        t=float(snap.t), dt=float(snap.dt), branches=tuple(snap.branches),
        slots=dict(snap.slots), free=[int(i) for i in snap.free],
        gains=f32(snap.gains), pvals=f32(snap.pvals),
        pstate=f32(snap.pstate), det_vals=f32(snap.det_vals),
        det_state=f32(snap.det_state), det_on=f32(snap.det_on),
        pcap=f32(snap.pcap), alive=np.array(np.asarray(snap.alive), bool),
        store_state=store, max_beats=int(snap.max_beats),
        guard_vals=f32(snap.guard_vals), guard_state=f32(snap.guard_state),
        guard_on=f32(snap.guard_on),
        events=None if snap.events is None else dict(snap.events))
    if snap.fingerprint:
        out.fingerprint = out.digest()
    return out


def fleet_args_from_reference(args, device: Union[None, str,
                                                  torch.device] = None):
    """The reference fleet's packed per-node rows
    (`repro.core.hierarchy._fleet_args`' last item: profile rows, gain
    rows, policy rows, class ids, per-node `ScheduleValues` or None) ->
    the port's ``(pv, gv, av, cls, sv)`` on ``device``, the rows
    `repro_torch.core.hierarchy._fleet_core` takes."""
    pv, gv, av, cls, sv = args
    dev = resolve_device(device)
    return (_tensor(pv, dev), _tensor(gv, dev), _tensor(av, dev),
            torch.from_numpy(np.asarray(cls).astype(np.int64)).to(dev),
            None if sv is None else schedule_from_reference(sv, dev))
