"""PI controller on the linearized plant (paper Eq. 4 + pole placement);
port of `repro.core.controller`.

Gains from the identified model (K_L, tau) and the user-chosen closed-loop
time constant tau_obj (paper: 10 s, "non-aggressive"):

    K_P = tau / (K_L * tau_obj)
    K_I = 1 / (K_L * tau_obj)

Velocity form (Eq. 4):

    pcap_L(t_i) = (K_I dt + K_P) e(t_i) - K_P e(t_{i-1}) + pcap_L(t_{i-1})

with e = (1-eps) * progress_max - progress. The command is computed in the
linearized coordinate and inverted through Eq. 2; clamping the *linearized*
command to the feasible image of [pcap_min, pcap_max] provides anti-windup.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.plant import PlantProfile


def _f32(x, device=None) -> torch.Tensor:
    if device is not None and isinstance(x, (int, float)):
        # filled on the device: a copy from the host would sync
        return torch.full((), x, dtype=torch.float32, device=device)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class PIGains:
    k_p: float
    k_i: float
    setpoint: float       # target progress [Hz]
    pcap_min: float
    pcap_max: float
    # Eq. 2 transform parameters (from the identified model)
    a: float
    b: float
    alpha: float
    beta: float
    # where tensors made from scalar fields live (None: beside the tensor
    # fields, or the CPU); a runtime on a card sets its device
    device: Optional[str] = None

    @classmethod
    def from_model(cls, profile: PlantProfile, epsilon: float,
                   tau_obj: float = 10.0, device=None) -> "PIGains":
        k_p = profile.tau / (profile.K_L * tau_obj)
        k_i = 1.0 / (profile.K_L * tau_obj)
        setpoint = (1.0 - epsilon) * profile.progress_max
        return cls(k_p=k_p, k_i=k_i, setpoint=setpoint,
                   pcap_min=profile.pcap_min, pcap_max=profile.pcap_max,
                   a=profile.a, b=profile.b, alpha=profile.alpha,
                   beta=profile.beta,
                   device=None if device is None else str(device))

    def with_gains(self, k_p, k_i) -> "PIGains":
        """Same setpoint/range/transform, new (K_P, K_I)."""
        return dataclasses.replace(self, k_p=k_p, k_i=k_i)

    # ---- Eq. 2 and inverse ------------------------------------------------
    def linearize(self, pcap):
        return -torch.exp(_f32(-self.alpha
                               * (self.a * pcap + self.b - self.beta),
                               self.device))

    def delinearize(self, pcap_l):
        pcap_l = torch.clamp(_f32(pcap_l, self.device),
                             self.linearize(self.pcap_min),
                             self.linearize(self.pcap_max))
        power = self.beta - torch.log(-pcap_l) / self.alpha
        return (power - self.b) / self.a


class PIState(NamedTuple):
    prev_error: torch.Tensor
    prev_pcap_l: torch.Tensor


def pi_init(gains: PIGains, pcap0: float | None = None) -> PIState:
    pcap0 = gains.pcap_max if pcap0 is None else pcap0
    return PIState(prev_error=_f32(0.0, gains.device),
                   prev_pcap_l=_f32(gains.linearize(pcap0)))


def pi_step(gains: PIGains, state: PIState, progress, dt
            ) -> Tuple[PIState, torch.Tensor]:
    """One Eq. 4 update. Returns (new_state, pcap command in watts)."""
    error = gains.setpoint - progress
    pcap_l = ((gains.k_i * dt + gains.k_p) * error
              - gains.k_p * state.prev_error + state.prev_pcap_l)
    # anti-windup: keep the carried linearized command inside the image of
    # the actuator range under Eq. 2
    lo = gains.linearize(gains.pcap_min)
    hi = gains.linearize(gains.pcap_max)
    pcap_l = torch.clamp(pcap_l, lo, hi)
    pcap = gains.delinearize(pcap_l)
    return PIState(prev_error=_f32(error, gains.device),
                   prev_pcap_l=_f32(pcap_l)), pcap


class PIController:
    """Stateful wrapper for a runtime loop."""

    def __init__(self, gains: PIGains, pcap0: float | None = None):
        self.gains = gains
        self.state = pi_init(gains, pcap0)

    def step(self, progress: float, dt: float) -> float:
        self.state, pcap = pi_step(self.gains, self.state, progress, dt)
        return float(pcap)

    def reset(self, pcap0: float | None = None) -> None:
        self.state = pi_init(self.gains, pcap0)
