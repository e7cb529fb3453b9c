"""Online phase-change detection on progress-model residuals; port of
`repro.core.workloads.detect`.

The detector replays the DESIGN model (the Eq. 3 first-order plant the
PI gains were placed on) alongside the real plant: each control period
it advances a deterministic prediction of linearized progress from the
applied cap and forms the residual r = progress - prediction. A phase
change moves the residual's LEVEL; the detector therefore runs a
two-sided Page-Hinkley / CUSUM test on the normalized deviation from a
slow EWMA of the residual,

    z = (r - level) / sigma,
    sigma^2 = noise_ref^2 + max(prediction, 1) / dt + (slack * level)^2,

so a plant that merely differs from its design model (persistent bias)
is absorbed into the level while a CHANGE — knee shift, gain shift,
data/compute movement — accumulates and alarms.

On an alarm the level jumps to the new residual, the statistics reset,
and a refractory window (`min_gap`) re-arms the detector; the scan
engine forwards the alarm to the active policy's `on_change` hook and
exposes it to every policy via `PolicyObs.phase_change`.

State and parameters pack into fixed-width float32 rows, (..., 8) each,
one row per run, so the detector rides the engine's carry like the
packed policy state.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.fma import fma, sqrt_rn
from repro_torch.core.plant import PlantProfile

# Canonical packing order of the detector parameters.
DET_PARAM_FIELDS = ("kl_ref", "tau_ref", "noise_ref", "drift",
                    "threshold", "min_gap", "level_eta", "level_slack")
DET_PARAM_DIM = len(DET_PARAM_FIELDS)
# state slots: model replay, residual level, the two PH statistics, the
# refractory countdown and two counters
DET_PRED_L, DET_LEVEL, DET_M_POS, DET_M_NEG, DET_COOLDOWN, \
    DET_N_DETECT, DET_SINCE = range(7)
DET_STATE_DIM = 8  # one spare slot


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Page-Hinkley knobs, in residual-sigma units.

    ``drift`` is the per-period slack subtracted from |z| (tolerated
    wander); ``threshold`` the alarm level of the accumulated statistic;
    ``min_gap`` the refractory window in control periods — also the
    initial arming delay, so the PH statistic never accumulates the
    (re)start transient. ``level_eta`` is the EWMA gain of the residual
    level tracker; ``level_slack`` widens sigma by that fraction of the
    tracked level (a plant far from its design model wanders with the
    moving cap, so tolerance scales with the mismatch)."""
    drift: float = 0.25
    threshold: float = 12.0
    min_gap: int = 10
    level_eta: float = 0.05
    level_slack: float = 0.5


def detector_values(cfg: DetectorConfig, design: PlantProfile,
                    device: Union[None, str, torch.device] = None
                    ) -> torch.Tensor:
    """Pack (config, design model) -> (DET_PARAM_DIM,) float32 on
    ``device`` (CUDA unless told otherwise)."""
    noise_ref = design.noise_scale * float(np.sqrt(design.n_sockets))
    return torch.tensor([design.K_L, design.tau, noise_ref, cfg.drift,
                         cfg.threshold, float(cfg.min_gap), cfg.level_eta,
                         cfg.level_slack], dtype=torch.float32,
                        device=resolve_device(device))


def detect_init(vals, gains, pcap0=None) -> torch.Tensor:
    """Fresh detector state (..., DET_STATE_DIM) for (..., DET_PARAM_DIM)
    ``vals``: model anchored at the starting cap's steady state (every
    run starts at pcap_max, like the plant), level at zero, refractory
    window running."""
    kl = vals[..., 0]
    pcap0 = gains.pcap_max if pcap0 is None else pcap0
    z = torch.zeros_like(kl)
    pred = (kl * gains.linearize(pcap0)).to(torch.float32)
    return torch.stack([pred, z, z, z, vals[..., 5], z, z, z], -1)


def detect_step(vals, state, progress, pcap_l, dt
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One control period: advance the model, accumulate PH, maybe alarm.

    ``pcap_l`` is the cap applied THIS period, linearized through the
    design transform (`gains.linearize`). Batched over the leading axes
    of ``vals`` / ``state`` ((..., 8) each) and ``progress`` / ``pcap_l``
    ((...)). Returns (new_state, detected: bool (...)).

    The model replay, the last term of sigma's sum of squares and the
    level EWMA are multiply-adds that XLA on the CPU contracts into
    single-rounding FMAs, and its square root is correctly rounded; they
    go through `repro_torch.core.fma`. XLA's contraction of sigma's first
    square varies with the fusion it lands in, so sigma (and with it the
    Page-Hinkley sums) can sit an ulp off the reference's."""
    kl, tau, sig0, drift, thresh, min_gap, eta, slack = (
        vals[..., i] for i in range(8))
    s = lambda i: state[..., i]
    w = dt / (dt + tau)
    pred_l = fma(kl * w, pcap_l, (1.0 - w) * s(DET_PRED_L))
    pred = pred_l + kl
    resid = progress - pred
    level0 = s(DET_LEVEL)
    y = slack * level0
    sigma = sqrt_rn(fma(y, y, sig0 * sig0 + torch.clamp(pred, min=1.0)
                        / dt))
    z = (resid - level0) / torch.clamp(sigma, min=1e-6)
    armed = s(DET_COOLDOWN) <= 0.0
    zero = torch.zeros_like(z)
    # the PH statistics only run while armed: the refractory window
    # (post-alarm or post-init) feeds the level tracker, not the alarm
    m_pos = torch.where(armed, torch.clamp(s(DET_M_POS) + z - drift,
                                           min=0.0), zero)
    m_neg = torch.where(armed, torch.clamp(s(DET_M_NEG) - z - drift,
                                           min=0.0), zero)
    detected = armed & ((m_pos > thresh) | (m_neg > thresh))
    det_f = detected.to(torch.float32)
    level = torch.where(detected, resid,
                        fma(1.0 - eta, level0, eta * resid))
    new = torch.stack([
        pred_l,
        level,
        m_pos * (1.0 - det_f),
        m_neg * (1.0 - det_f),
        torch.where(detected, min_gap,
                    torch.clamp(s(DET_COOLDOWN) - 1.0, min=0.0)),
        s(DET_N_DETECT) + det_f,
        torch.where(detected, zero, s(DET_SINCE) + 1.0),
        zero,
    ], -1)
    return new, detected
