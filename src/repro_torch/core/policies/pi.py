"""PI and adaptive-PI (RLS gain-scheduled) policies — the paper's Eq. 4
controller as a policy branch; port of `repro.core.policies.pi`.

Two branches share the PI slots of the packed state vector:

* ``pi``      — fixed gains. State: [prev_error, prev_pcap_l, 0...].
* ``pi_rls``  — RLS gain scheduling (§5.2 extension). State: PI slots +
  the 14-slot packed `RLSState` (see `repro_torch.core.adaptive.rls_pack`).
  Param slots [1:7] carry `rls_values` (lam, dwell, kl_clamp, kl_ref,
  tau_obj, p_trace_max).

The step functions call the same `pi_step` / RLS arithmetic in the same
order as the typed engine path, so PI-via-policy reproduces the typed
path's trajectories bit for bit. Each step builds its new packed state
with one `torch.stack` / `torch.cat`: the scan engine's loop is bound by
its launches, and a clone plus a slot write per field would add one
launch per field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.adaptive import (RLS_STATE_SIZE, RLSConfig, rls_init,
                                       rls_pack, rls_update, rls_values)
from repro_torch.core.controller import PIGains, PIState, pi_init, pi_step
from repro_torch.core.plant import PlantProfile
from repro_torch.core.policies.base import (BRANCH_TAG_SLOT,
                                            POLICY_STATE_DIM, Policy,
                                            pack_values, register_branch)

# state layout: [0]=prev_error [1]=prev_pcap_l, then the packed RLSState
# block, then the branch tag
PI_RLS_LO = 2
PI_RLS_HI = PI_RLS_LO + RLS_STATE_SIZE
assert PI_RLS_HI == BRANCH_TAG_SLOT, \
    "PI+RLS slots must end exactly at the branch tag slot"
_RLS_LO, _RLS_HI = PI_RLS_LO, PI_RLS_HI


def pi_pack(pi: PIState, rls_block=None) -> torch.Tensor:
    """(prev_error, prev_pcap_l) (...) float32 tensors and an optional
    (..., 14) RLS block -> (..., POLICY_STATE_DIM) rows; the RLS slots
    (when no block is given) and the tag zero."""
    e = pi.prev_error
    if rls_block is None:
        rls_block = e.new_zeros(e.shape + (RLS_STATE_SIZE,))
    return torch.cat([e[..., None], pi.prev_pcap_l[..., None], rls_block,
                      torch.zeros_like(e)[..., None]], -1)


def _pi_state(state) -> PIState:
    return PIState(prev_error=state[..., 0], prev_pcap_l=state[..., 1])


def _pi_step(vals, state, obs):
    pi2, pcap = pi_step(obs.gains, _pi_state(state), obs.progress, obs.dt)
    return torch.cat([pi2.prev_error[..., None], pi2.prev_pcap_l[..., None],
                      state[..., PI_RLS_LO:]], -1), pcap


def _pi_init(vals, gains):
    pl = pi_init(gains).prev_pcap_l
    return pi_pack(PIState(prev_error=torch.zeros_like(pl),
                           prev_pcap_l=pl))


def _pi_rls_step(vals, state, obs):
    # the estimator sees the PREVIOUS linearized command (prev_pcap_l)
    # beside this period's aggregated progress, then the PI runs on the
    # (possibly re-placed) gains
    col = lambda i: state[..., _RLS_LO + i]
    (th0, th1, q00, q01, q10, q11, f0, f1, since, k_p, k_i, tau_hat,
     kl_hat) = rls_update(vals[..., 1:7], (col(0), col(1)),
                          (col(2), col(3), col(4), col(5)),
                          (col(6), col(7)), col(8) > 0.5, col(9), col(10),
                          col(11), obs.progress, state[..., 1], obs.dt)
    g = obs.gains.with_gains(k_p, k_i)
    pi2, pcap = pi_step(g, _pi_state(state), obs.progress, obs.dt)
    new = torch.stack([pi2.prev_error, pi2.prev_pcap_l, th0, th1, q00, q01,
                       q10, q11, f0, f1, torch.ones_like(since), since,
                       k_p, k_i, tau_hat, kl_hat,
                       state[..., BRANCH_TAG_SLOT]], -1)
    return new, pcap


def _pi_rls_init(vals, gains):
    rls = rls_init(vals[..., 1:7], gains.k_p, gains.k_i)
    pl = pi_init(gains).prev_pcap_l
    return pi_pack(PIState(prev_error=torch.zeros_like(pl), prev_pcap_l=pl),
                   rls_pack(rls))


def _pi_rls_extras(state):
    col = lambda i: state[..., _RLS_LO + i]
    return {"k_p": col(10), "k_i": col(11), "tau_hat": col(12),
            "kl_hat": col(13), "theta1": col(0), "theta2": col(1)}


def _pi_rls_on_change(vals, state):
    # phase change detected: the identified model is stale. Blow the
    # covariance back to its fresh-init value (the estimator re-converges
    # at init speed), drop the old-phase regressor, and force the next
    # step to re-place the PI gains immediately (since_update >= dwell)
    # instead of waiting out the dwell window.
    s = lambda i: state[..., i]
    z = torch.zeros_like(s(0))
    return torch.stack([s(0), s(1), s(2), s(3), z + 1e2, z, z, z + 1e2,
                        s(8), s(9), z, vals[..., 2]
                        + z] + [s(i) for i in range(12, POLICY_STATE_DIM)],
                       -1)


register_branch("pi", _pi_step, _pi_init)
register_branch("pi_rls", _pi_rls_step, _pi_rls_init, _pi_rls_extras,
                on_change=_pi_rls_on_change)

# default probe length for the runtime re-identification recipe below
REEXCITE_K = 4


def reexcite_cap(pcap: float, step_i: int, frac: float,
                 lo: float, hi: float) -> float:
    """Post-alarm re-excitation: the runtime half of the
    re-identification recipe whose in-engine half is `_pi_rls_on_change`.

    The on_change hook blows the covariance and forces re-placement, but
    a freshly-reset estimator staring at steady-state operation learns
    nothing — the regressor barely moves. For the first few healthy
    windows after an alarm, alternate the commanded cap +/- ``frac`` of
    the actuation range (persistent excitation), clipped to the
    actuator's limits."""
    span = float(frac) * (float(hi) - float(lo))
    sign = 1.0 if int(step_i) % 2 == 0 else -1.0
    return float(min(max(float(pcap) + sign * span, float(lo)),
                     float(hi)))


@dataclasses.dataclass(frozen=True)
class PIPolicy(Policy):
    """Eq. 4 PI, optionally RLS gain-scheduled (`adaptive=RLSConfig()`).

    ``design`` names the plant model the initial gains were placed on
    (gain-shift scenarios); the estimator linearizes against it. Defaults
    to the profile the policy runs on.
    """
    adaptive: Optional[RLSConfig] = None
    design: Optional[PlantProfile] = None

    @property
    def branch(self) -> str:
        return "pi_rls" if self.adaptive is not None else "pi"

    def values(self, profile: PlantProfile, gains: PIGains) -> torch.Tensor:
        if self.adaptive is None:
            return pack_values()
        return pack_values(*rls_values(self.adaptive,
                                       self.design or profile,
                                       gains).tolist())
