"""DDCM-style duty-cycle power policy (cf. nrm-legacy's DDCMPolicy); port
of `repro.core.policies.dutycycle`.

Dynamic Duty Cycle Modulation (Bhalachandra et al., IPDPSW'15) steps a
discrete duty-cycle level down while a cpu is ahead of the critical path
and resets it up when it falls behind. Transplanted onto the paper's
power-cap actuator: the level index quantizes [pcap_min, pcap_max] into
``n_levels`` steps; progress above the setpoint (with a deadband) walks
the level down by ``down_step`` (save energy), progress below walks it up
by the larger ``up_step`` (the DDCM "reset" flavour: recover performance
fast, shed power slowly).

State: [0] = current level in [min_level, n_levels]. Params: [n_levels,
min_level, deadband, down_step, up_step].
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.controller import PIGains
from repro_torch.core.plant import PlantProfile
from repro_torch.core.policies.base import (POLICY_STATE_DIM, Policy,
                                            pack_values, register_branch)


def _dc_step(vals, state, obs):
    n_lv, min_lv, dead, down, up = (vals[..., i] for i in range(1, 6))
    level = state[..., 0]
    p_rel = obs.progress / torch.clamp(
        torch.as_tensor(obs.gains.setpoint, dtype=torch.float32), min=1e-9)
    level = torch.where(p_rel > 1.0 + dead, level - down,
                        torch.where(p_rel < 1.0 - dead, level + up, level))
    # torch.round, like jnp.round, rounds half to even
    level = torch.clamp(torch.round(level), min_lv, n_lv)
    u = (level - min_lv) / torch.clamp(n_lv - min_lv, min=1.0)
    g = obs.gains
    pcap = g.pcap_min + u * (g.pcap_max - g.pcap_min)
    return torch.cat([level[..., None], state[..., 1:]], -1), pcap


def _dc_init(vals, gains):
    # start at the top level = pcap_max, like every other policy
    level = vals[..., 1:2]
    return torch.cat([level, level.new_zeros(
        level.shape[:-1] + (POLICY_STATE_DIM - 1,))], -1)


def _dc_extras(state):
    return {"dc_level": state[..., 0]}


register_branch("dutycycle", _dc_step, _dc_init, _dc_extras)


@dataclasses.dataclass(frozen=True)
class DutyCyclePolicy(Policy):
    """Discrete-level duty-cycle modulation of the power cap."""
    n_levels: int = 16
    min_level: int = 1
    deadband: float = 0.02   # relative band around the setpoint
    down_step: float = 1.0   # levels shed per period when ahead
    up_step: float = 4.0     # levels recovered per period when behind

    @property
    def branch(self) -> str:
        return "dutycycle"

    def values(self, profile: PlantProfile, gains: PIGains) -> torch.Tensor:
        return pack_values(float(self.n_levels), float(self.min_level),
                           self.deadband, self.down_step, self.up_step)
