"""The control plane's packing and its single control-law step; the part
of `repro.core.plane` that the scan engine needs (the batched
multi-tenant plane, `tick_fn` and `ControlPlane`, is a later slice of the
port)."""
from __future__ import annotations

import torch

from repro_torch.core import policies as pol
from repro_torch.core.controller import PIGains

# Canonical packing order for gain / actuator-context parameters (Eq. 2
# transform, actuator range, setpoint, PI gains).
GAIN_FIELDS = ("k_p", "k_i", "setpoint", "pcap_min", "pcap_max",
               "a", "b", "alpha", "beta")
GAIN_DIM = len(GAIN_FIELDS)


def gains_values(gains: PIGains) -> torch.Tensor:
    """Pack a PIGains into the canonical (GAIN_DIM,) float32 vector."""
    return torch.tensor([getattr(gains, f) for f in GAIN_FIELDS],
                        dtype=torch.float32)


def unpack_gains(vals) -> PIGains:
    """Inverse of `gains_values`: a (..., GAIN_DIM) vector or batch of
    rows -> a PIGains whose fields are (...) tensors (0-dim for one
    vector)."""
    return PIGains(**{f: vals[..., i] for i, f in enumerate(GAIN_FIELDS)})


def plane_step(gains: PIGains, policy, policy_vals, state, pcap_applied,
               progress, power, dt, *, det_vals=None, det_state=None,
               det_on=None, guard_vals=None, guard_state=None,
               guard_on=None):
    """One control period over a batch of tenants (runs): the policy step
    through the `repro_torch.core.policies` contract (``policy`` is a
    branch tuple or Policy; with more than one branch each row runs the
    branch of its kind, ``policy_vals[..., 0]``).

    This is the detector-free, guard-free core of the reference's
    `plane_step`: ``det_vals`` / ``det_on`` raise NotImplementedError
    (ROADMAP Queue 1 item 5), ``guard_vals`` / ``guard_on`` likewise (item
    6). ``pcap_applied`` is the detector's input and unused here.

    Returns ``(new_state, det_state, pcap, change)`` with ``change`` 0.0:
    no detector, no alarm."""
    if det_vals is not None or det_on is not None:
        raise NotImplementedError(
            "plane_step's change-point detector is not ported yet: ROADMAP "
            "Queue 1 item 5 (phased workloads and detection)")
    if guard_vals is not None or guard_on is not None:
        raise NotImplementedError(
            "plane_step's guard is not ported yet: ROADMAP Queue 1 item 6 "
            "(faults, guard and flight recorder)")
    obs = pol.PolicyObs(progress=progress, power=power, dt=dt, gains=gains)
    new_state, pcap = pol.branch_step(policy)(policy_vals, state, obs)
    return new_state, det_state, pcap, 0.0
