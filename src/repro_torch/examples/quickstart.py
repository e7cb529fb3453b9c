"""Quickstart: the paper's control loop in 60 lines; port of
`examples/quickstart.py`.

1. Identify a cluster plant (static characterization, Table 2 recovery).
2. Design the PI controller by pole placement.
3. Run closed-loop: hold progress at (1-eps) of max while saving energy.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The reference splits a `jax.random` key each period; the port draws
period ``t`` of the example from `ops.draw_noise` of one seed at step
``t`` (the campaign's 9 x 40 periods, then the loop's 60), as
`SimulatedPowerActuator.advance` draws its periods. Each step takes its
noise as a tensor, so any stream (the reference's own draws included)
can be handed in.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (PROFILES, PIGains, PlantState, fit_static,
                              pi_init, pi_step, plant_init, plant_step,
                              simulate)
from repro_torch.examples._cli import device_arg
from repro_torch.kernels.closed_loop import ops

PROFILE = "gros"
SEED = 0
LEVELS = 9
CAMPAIGN_STEPS = 40
WARMUP = 5           # periods left out of each level's means
EPS = 0.10
TAU_OBJ = 10.0
PERIODS = 60


def port_noise(seed: int, periods: int, device) -> torch.Tensor:
    """(periods, 4) plant draws: `draw_noise` of ``seed`` at steps
    0 .. periods - 1, the channels `plant_step` reads."""
    return ops.draw_noise([seed], periods, device=device)[:, :4, 0]


def campaign(prof, caps: Sequence[float], noise: torch.Tensor):
    """Constant-cap open-loop runs of ``CAMPAIGN_STEPS`` periods, one per
    cap, run i on ``noise[i]`` (levels, steps, 4). Returns (caps, mean
    power, mean progress) after the first ``WARMUP`` periods, each mean
    taken by numpy in float32 as the reference takes it."""
    powers, progress = [], []
    for pcap, nz in zip(caps, noise):
        tr = simulate(prof, torch.full((nz.shape[0],), float(pcap),
                                       device=nz.device), 1.0, nz)
        powers.append(float(np.mean(tr["power"][WARMUP:].cpu().numpy())))
        progress.append(float(np.mean(
            tr["progress"][WARMUP:].cpu().numpy())))
    return [float(c) for c in caps], powers, progress


def closed_loop(prof, gains: PIGains, noise: torch.Tensor):
    """The PI loop against the plant, one period per row of ``noise``
    (T, 4), starting at full power. Returns, per period, the measured
    progress, the cap the controller commands after it and the measured
    power as float lists, and the energy summed from the measured power
    on the host in period order, as the reference sums it."""
    dev = noise.device
    ps = PlantState(*(x.to(dev) for x in plant_init(prof)))
    cs = pi_init(gains)
    pcap = prof.pcap_max
    rows = []
    for nz in noise:
        ps, meas = plant_step(prof, ps, pcap, 1.0, nz)
        cs, pcap = pi_step(gains, cs, meas["progress"], 1.0)
        rows.append(torch.stack([meas["progress"], pcap, meas["power"]]))
    progress, pcaps, power = torch.stack(rows).T.cpu().tolist()  # one sync
    energy = 0.0
    for p in power:  # not `sum`, which compensates (Python >= 3.12)
        energy += p
    return progress, pcaps, power, energy


def run(noise: torch.Tensor, device=None) -> dict:
    """The quickstart on ``noise`` (LEVELS * CAMPAIGN_STEPS + PERIODS, 4):
    the campaign's periods level by level, then the loop's."""
    dev = resolve_device(device)
    noise = noise.to(dev)
    prof = PROFILES[PROFILE]

    # --- 1. static characterization (constant-cap campaign, Fig. 4) -----
    n_camp = LEVELS * CAMPAIGN_STEPS
    caps, powers, progress = campaign(
        prof, np.linspace(prof.pcap_min, prof.pcap_max, LEVELS),
        noise[:n_camp].reshape(LEVELS, CAMPAIGN_STEPS, -1))
    fit = fit_static(caps, powers, progress, device=dev)
    print(f"identified: a={fit.a:.2f} b={fit.b:.1f} K_L={fit.K_L:.1f} "
          f"alpha={fit.alpha:.3f} beta={fit.beta:.1f} (R2={fit.r2:.3f})")

    # --- 2. controller design (pole placement, eps = 10%) ----------------
    gains = PIGains.from_model(prof, epsilon=EPS, tau_obj=TAU_OBJ,
                               device=dev)
    print(f"PI gains: K_P={gains.k_p:.2e} K_I={gains.k_i:.2e} "
          f"setpoint={gains.setpoint:.1f} Hz")

    # --- 3. closed loop ---------------------------------------------------
    prog, pcaps, power, energy_ctrl = closed_loop(prof, gains,
                                                  noise[n_camp:])
    for i in range(0, PERIODS, 10):
        print(f"  t={i:3d}s progress={prog[i]:6.2f} pcap={pcaps[i]:6.1f} W")
    base_power = float(prof.power_of_pcap(prof.pcap_max)) * PERIODS
    saved = 100 * (1 - energy_ctrl / base_power)
    print(f"energy: controlled={energy_ctrl:.0f} J vs full-power="
          f"{base_power:.0f} J ({saved:.1f}% saved at eps={EPS:.0%})")
    return {"caps": caps, "power_means": powers, "progress_means": progress,
            "fit": fit, "gains": gains, "progress": prog, "pcap": pcaps,
            "power": power, "energy_controlled": energy_ctrl,
            "energy_full_power": base_power, "saved_pct": saved}


def main(device=None) -> dict:
    dev = resolve_device(device)
    return run(port_noise(SEED, LEVELS * CAMPAIGN_STEPS + PERIODS, dev),
               dev)


if __name__ == "__main__":
    main(device_arg(__doc__))
