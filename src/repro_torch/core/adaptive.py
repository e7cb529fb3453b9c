"""Adaptive control (beyond the paper; its §5.2 'natural direction');
port of `repro.core.adaptive`.

The paper's PI gains are fixed by the offline-identified (K_L, tau). Under
phase changes (compute-bound <-> memory-bound) the true static gain drifts
and fixed gains become too aggressive or too sluggish. Recursive least
squares (RLS, forgetting factor lambda) on the first-order model in the
*linearized* coordinates

    progress_L[i+1] = theta1 * pcap_L[i] + theta2 * progress_L[i]

gives online estimates tau_hat = dt*theta2/(1-theta2) and
K_L_hat = theta1*(dt+tau_hat)/dt; the PI gains are re-placed each period
(gain scheduling) with clamping and a dwell time to avoid chattering.

Two implementations of the same estimator:

* `RLSState` / `rls_init` / `rls_step` — batched PyTorch over runs
  (leading axes ``...``): theta (..., 2), P (..., 2, 2), prev_phi
  (..., 2), the scalars (...). The 2-vector and 2x2 products are written
  out elementwise in the reference's association order ((phi @ P) @
  phi, (P @ phi) / denom, (P - outer(k, phi @ P)) / lam), each dot a
  fused multiply-add chain as XLA evaluates it (`repro_torch.core.fma`),
  so a step is a few dozen elementwise launches and no 2x2 matmul.
* `RLSAdapter` — the numpy per-step version, the equivalence oracle.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.controller import PIGains
from repro_torch.core.fma import fma
from repro_torch.core.plant import PlantProfile

# Clip bounds for theta2 when converting to (tau_hat, K_L_hat); shared by
# both implementations so they stay comparable.
_TH2_LO, _TH2_HI = 1e-3, 1.0 - 1e-3


@dataclasses.dataclass(frozen=True)
class RLSConfig:
    """Estimator hyperparameters — the sweep axis of the adaptive grid."""
    lam: float = 0.995      # forgetting factor
    dwell: int = 5          # min periods between gain re-placements
    kl_clamp: float = 4.0   # K_L_hat within [K_L_ref/c, K_L_ref*c]
    # divergence guard: cap on trace(P). A spike-corrupted regressor can
    # inflate the covariance geometrically (1/lam per period) until the
    # gain computation overflows f32; rescaling P back to this trace
    # bounds the estimator's worst-case step without touching theta.
    p_trace_max: float = 1e6


# Packing order of the estimator's parameters. `kl_ref` is the DESIGN
# model's K_L (the adapter linearizes against the model the gains were
# placed on, not the true plant); `tau_obj` is the closed-loop time
# constant implied by the original design, tau_obj = 1 / (kl_ref * k_i0).
RLS_FIELDS = ("lam", "dwell", "kl_clamp", "kl_ref", "tau_obj",
              "p_trace_max")


def rls_values(cfg: RLSConfig, design: PlantProfile, gains0: PIGains
               ) -> torch.Tensor:
    """The (6,) float32 parameter vector in `RLS_FIELDS` order."""
    tau_obj = 1.0 / (design.K_L * gains0.k_i)
    return torch.tensor([cfg.lam, float(cfg.dwell), cfg.kl_clamp,
                         design.K_L, tau_obj, cfg.p_trace_max],
                        dtype=torch.float32)


class RLSState(NamedTuple):
    """Estimator + scheduled-gain state, batched over runs."""
    theta: torch.Tensor         # (..., 2) [theta1, theta2]
    P: torch.Tensor             # (..., 2, 2) inverse covariance
    prev_phi: torch.Tensor      # (..., 2) regressor [pcap_L, progress_L]
    has_prev: torch.Tensor      # bool: a regressor has been recorded
    since_update: torch.Tensor  # periods since the last gain re-placement
    k_p: torch.Tensor           # scheduled proportional gain
    k_i: torch.Tensor           # scheduled integral gain
    tau_hat: torch.Tensor       # current time-constant estimate [s]
    kl_hat: torch.Tensor        # current static-gain estimate [Hz]


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def rls_init(rls_vals, gains_vals_kp, gains_vals_ki) -> RLSState:
    """Fresh estimator around the design model packed in ``rls_vals``
    (..., 6); the design gains broadcast against its leading axes."""
    kl_ref = rls_vals[..., 3]
    kp = _f32(gains_vals_kp, kl_ref)
    ki = _f32(gains_vals_ki, kl_ref)
    tau0 = rls_vals[..., 4] * kl_ref * kp  # tau = k_p * kl * tau_obj
    lead = kl_ref.shape
    P = torch.eye(2, dtype=torch.float32, device=kl_ref.device) * 1e2
    zero = torch.zeros_like(kl_ref)
    return RLSState(
        theta=torch.stack([kl_ref * 0.5, zero + 0.5], -1),
        P=P.expand(lead + (2, 2)).clone(),
        prev_phi=torch.zeros(lead + (2,), dtype=torch.float32,
                             device=kl_ref.device),
        has_prev=torch.zeros(lead, dtype=torch.bool, device=kl_ref.device),
        since_update=zero,
        k_p=kp.expand(lead).clone(), k_i=ki.expand(lead).clone(),
        tau_hat=tau0, kl_hat=kl_ref.clone())


def rls_update(v, theta, P, phi, has_prev, since, k_p, k_i, progress,
               pcap_l, dt):
    """The estimator's step on its components (each (...) tensor; theta,
    P and phi as tuples of them, P row-major): RLS update, trace clamp,
    (tau_hat, K_L_hat) and the dwell-gated gain re-placement. Returns the
    new components in `rls_pack` order, has_prev excepted:
    (theta1, theta2, P00, P01, P10, P11, phi1, phi2, since, k_p, k_i,
    tau_hat, kl_hat).

    The products are the reference's, in its association order, each
    2-term dot a fused multiply-add chain (`fma`) as XLA evaluates it:
    P's update cancels ~99.6 out of ~100 on the first periods, so the
    rounding of each term decides the digits that remain."""
    lam, dwell, kl_clamp, kl_ref, tau_obj, p_max = (v[..., i]
                                                    for i in range(6))
    th0, th1 = theta
    p00, p01, p10, p11 = P
    f0, f1 = phi
    y = progress - kl_ref  # progress_L against the design model
    err = y - fma(f1, th1, f0 * th0)                  # y - phi @ theta
    # phi @ P, then (phi @ P) @ phi
    fp0 = fma(f1, p10, f0 * p00)
    fp1 = fma(f1, p11, f0 * p01)
    denom = lam + fma(fp1, f1, fp0 * f0)
    # k = (P @ phi) / denom
    k0 = fma(p01, f1, p00 * f0) / denom
    k1 = fma(p11, f1, p10 * f0) / denom
    th0 = torch.where(has_prev, fma(k0, err, th0), th0)
    th1 = torch.where(has_prev, fma(k1, err, th1), th1)
    # (P - outer(k, phi @ P)) / lam
    q00 = torch.where(has_prev, fma(-k0, fp0, p00) / lam, p00)
    q01 = torch.where(has_prev, fma(-k0, fp1, p01) / lam, p01)
    q10 = torch.where(has_prev, fma(-k1, fp0, p10) / lam, p10)
    q11 = torch.where(has_prev, fma(-k1, fp1, p11) / lam, p11)
    # covariance trace clamp (divergence guard): rescaling keeps the
    # covariance's shape and bounds its magnitude; untriggered, each
    # entry is the where's untouched operand, P itself
    tr = q00 + q11
    over = tr > p_max
    scale = p_max / tr
    q00, q01, q10, q11 = (torch.where(over, q * scale, q)
                          for q in (q00, q01, q10, q11))

    th2 = torch.clamp(th1, _TH2_LO, _TH2_HI)
    num, den = dt * th2, 1.0 - th2
    tau_hat = num / den
    kl_hat = torch.clamp(th0 * (dt + tau_hat) / dt, kl_ref / kl_clamp,
                         kl_ref * kl_clamp)

    since = since + 1.0
    place = since >= dwell
    # tau_hat / (kl_hat * tau_obj), as XLA simplifies (a / b) / c to
    # a / (b * c)
    k_p = torch.where(place, num / (den * (kl_hat * tau_obj)), k_p)
    k_i = torch.where(place, 1.0 / (kl_hat * tau_obj), k_i)
    since = torch.where(place, 0.0, since)
    return (th0, th1, q00, q01, q10, q11, pcap_l, y, since, k_p, k_i,
            tau_hat, kl_hat)


def rls_step(rls_vals, s: RLSState, progress, pcap_l, dt) -> RLSState:
    """One RLS update + dwell-gated gain re-placement over a batch.

    Mirrors `RLSAdapter.update`: the regressor lags one period, theta is
    stored unclipped, theta2 is clipped only for the (tau_hat, K_L_hat)
    conversion, and gains move every `dwell`-th call."""
    (th0, th1, q00, q01, q10, q11, f0, f1, since, k_p, k_i, tau_hat,
     kl_hat) = rls_update(
        rls_vals, (s.theta[..., 0], s.theta[..., 1]),
        (s.P[..., 0, 0], s.P[..., 0, 1], s.P[..., 1, 0], s.P[..., 1, 1]),
        (s.prev_phi[..., 0], s.prev_phi[..., 1]), s.has_prev,
        s.since_update, s.k_p, s.k_i, progress, pcap_l, dt)
    lead = th0.shape
    f0 = torch.broadcast_to(_f32(f0, th0), lead)
    return RLSState(theta=torch.stack([th0, th1], -1),
                    P=torch.stack([q00, q01, q10, q11], -1).reshape(
                        lead + (2, 2)),
                    prev_phi=torch.stack([f0, f1], -1),
                    has_prev=torch.ones(lead, dtype=torch.bool,
                                        device=th0.device),
                    since_update=since, k_p=k_p, k_i=k_i, tau_hat=tau_hat,
                    kl_hat=kl_hat)


# Flat packing of RLSState for the uniform policy-state vector carried by
# the scan engine (repro_torch.core.policies): theta(2) P(4) prev_phi(2)
# has_prev(1) since_update(1) k_p k_i tau_hat kl_hat.
RLS_STATE_SIZE = 14


def rls_pack(s: RLSState) -> torch.Tensor:
    """RLSState -> (..., RLS_STATE_SIZE) float32 rows."""
    lead = s.since_update.shape
    return torch.cat([
        s.theta, s.P.reshape(lead + (4,)), s.prev_phi,
        torch.stack([s.has_prev.to(torch.float32), s.since_update, s.k_p,
                     s.k_i, s.tau_hat, s.kl_hat], -1)], -1)


def rls_unpack(v) -> RLSState:
    """Inverse of `rls_pack` (has_prev round-trips through a 0/1 float)."""
    return RLSState(theta=v[..., 0:2],
                    P=v[..., 2:6].reshape(v.shape[:-1] + (2, 2)),
                    prev_phi=v[..., 6:8], has_prev=v[..., 8] > 0.5,
                    since_update=v[..., 9], k_p=v[..., 10], k_i=v[..., 11],
                    tau_hat=v[..., 12], kl_hat=v[..., 13])


@dataclasses.dataclass
class RLSAdapter:
    """Numpy reference estimator (equivalence oracle for `rls_step`)."""
    gains0: PIGains
    profile: PlantProfile
    lam: float = 0.995          # forgetting factor
    dwell: int = 5              # min periods between gain updates
    kl_clamp: float = 4.0       # K_L_hat within [K_L/c, K_L*c]
    p_trace_max: float = 1e6    # covariance trace clamp (divergence guard)

    def __post_init__(self):
        self.theta = np.array([self.profile.K_L * 0.5, 0.5])
        self.P = np.eye(2) * 1e2
        self._prev: tuple | None = None
        self._since_update = 0
        self.tau_hat = self.profile.tau
        self.kl_hat = self.profile.K_L

    def on_change(self) -> None:
        """Phase-change reaction (mirrors the engine-side pi_rls
        `on_change` hook): the identified model is stale, so blow the
        covariance back to its fresh-init value, drop the old-phase
        regressor, and re-place the gains at the very next update."""
        self.P = np.eye(2) * 1e2
        self._prev = None
        self._since_update = self.dwell

    def update(self, gains: PIGains, progress: float, pcap_l: float,
               dt: float) -> PIGains:
        y = progress - self.profile.K_L  # progress_L
        if self._prev is not None:
            phi = np.array(self._prev)  # [pcap_L, progress_L] at i-1
            err = y - phi @ self.theta
            denom = self.lam + phi @ self.P @ phi
            k = (self.P @ phi) / denom
            self.theta = self.theta + k * err
            self.P = (self.P - np.outer(k, phi @ self.P)) / self.lam
            tr = float(np.trace(self.P))
            if tr > self.p_trace_max:
                self.P = self.P * (self.p_trace_max / tr)
        self._prev = (pcap_l, y)

        th1, th2 = self.theta
        th2 = float(np.clip(th2, _TH2_LO, _TH2_HI))
        tau_hat = dt * th2 / (1.0 - th2)
        kl_hat = th1 * (dt + tau_hat) / dt
        lo, hi = (self.profile.K_L / self.kl_clamp,
                  self.profile.K_L * self.kl_clamp)
        kl_hat = float(np.clip(kl_hat, lo, hi))
        self.tau_hat, self.kl_hat = tau_hat, kl_hat

        self._since_update += 1
        if self._since_update < self.dwell:
            return gains
        self._since_update = 0
        # re-place poles with the adapted model, keep tau_obj implied by the
        # original design: tau_obj = 1 / (K_L0 * K_I0)
        tau_obj = 1.0 / (self.profile.K_L * self.gains0.k_i)
        return dataclasses.replace(
            gains,
            k_p=tau_hat / (kl_hat * tau_obj),
            k_i=1.0 / (kl_hat * tau_obj),
        )
