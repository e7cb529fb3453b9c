"""Phase/bottleneck classification: couples the roofline to the controller;
port of `repro.core.phases`.

From cost figures (or runtime counters on real hardware) the three
roofline terms classify a workload cell:

* collective- or memory-bound -> strongly saturating power-to-progress
  curve (the paper's STREAM regime): large energy headroom, deep epsilon OK.
* compute-bound -> near-linear curve: little headroom (paper §5.2 predicts
  exactly this), the controller should keep caps high.

`profile_for_cell` turns a bottleneck classification into a plant profile
whose knee (alpha, beta) reflects it.

The chip rates below are the NVIDIA H100 SXM data-sheet peaks (bf16
dense tensor-core rate, HBM3 bandwidth, NVLink bandwidth per direction),
the card the port runs on. They are data-sheet figures, not
measurements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.plant import PROFILES, PlantProfile

H100_PEAK_FLOPS = 989e12    # bf16 dense, flop/s per card (data sheet)
H100_HBM_BW = 3.35e12       # HBM3 bytes/s per card (data sheet)
H100_NVLINK_BW = 450e9      # NVLink bytes/s per direction (data sheet)


def roofline_terms(flops: float, bytes_hbm: float, bytes_ici: float,
                   chips: int) -> Dict[str, float]:
    """Seconds of compute, memory traffic and interconnect traffic for a
    cell spread over ``chips`` cards (``bytes_ici``: bytes over the
    card-to-card links)."""
    return {
        "compute_s": flops / (chips * H100_PEAK_FLOPS),
        "memory_s": bytes_hbm / (chips * H100_HBM_BW),
        "collective_s": bytes_ici / (chips * H100_NVLINK_BW),
    }


def bottleneck(terms: Dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k])


def saturation_ratio(terms: Dict[str, float]) -> float:
    """How memory/comm-bound the cell is: (non-compute) / compute time."""
    nc = max(terms["memory_s"], terms["collective_s"])
    return nc / max(terms["compute_s"], 1e-12)


def knee_for_saturation(profile: PlantProfile, sat: float) -> PlantProfile:
    """Plant variant whose knee (alpha, beta) encodes a saturation ratio.

    Memory-bound (sat >> 1, the STREAM regime) saturates at lower power
    (beta down, alpha up): progress stops responding to power earlier —
    more energy to harvest. Compute-bound (sat << 1, DGEMM) gets a
    shallow knee: progress ~ linear in power, little headroom. sat is
    clamped to [0.3, 3]; the same mapping seeds roofline cells
    (`profile_for_cell`) and phase-schedule generators
    (`repro_torch.core.workloads.schedule`)."""
    s = max(0.3, min(3.0, sat))
    return dataclasses.replace(profile, name=f"{profile.name}-sat{s:.2f}",
                               alpha=profile.alpha * s,
                               beta=profile.beta * (1.2 - 0.2 * s))


def profile_for_cell(terms: Dict[str, float],
                     base: str = "v5e-chip") -> PlantProfile:
    """Plant profile whose knee encodes the cell's boundedness."""
    return knee_for_saturation(PROFILES[base], saturation_ratio(terms))
