"""Gains packing of the control plane; the part of `repro.core.plane`
that the closed-loop path needs (the batched plane itself is a later
slice of the port)."""
from __future__ import annotations

import torch

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
    """Inverse of `gains_values` (fields become 0-dim tensors)."""
    return PIGains(**{f: vals[i] for i, f in enumerate(GAIN_FIELDS)})
