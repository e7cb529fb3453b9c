"""Full paper workflow on all three clusters + the beyond-paper pieces;
port of `examples/identify_and_control.py`:

1. static + dynamic identification per cluster (Table 2),
2. epsilon-sweep -> time/energy trade-off (Fig. 7 in miniature),
3. adaptive (RLS) controller surviving a plant-gain shift (beyond paper),
4. hierarchical fleet control: 256 nodes under a global power budget.

Run:  PYTHONPATH=src python -m repro_torch.examples.identify_and_control [--device cpu]

The identification draws its noise as the quickstart does (`draw_noise`
of one seed, the period as its step: the campaign's 9 x 40 periods,
then the schedule's 300); `identify` takes that noise as a tensor. The
sweep, the NRM and the fleet draw the port's own streams from their
seeds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import PowerControlConfig
from repro_torch.core import (NRM, PROFILES, SimulatedPowerActuator,
                              fit_dynamics, fit_static, pcap_linearize,
                              simulate, sweep)
from repro_torch.core.hierarchy import FleetConfig, simulate_fleet
from repro_torch.examples._cli import device_arg
from repro_torch.examples.quickstart import (CAMPAIGN_STEPS, LEVELS,
                                             campaign, port_noise)

CLUSTERS = ("gros", "dahu", "yeti")
SEED = 1
SCHEDULE_CAPS = 100      # random caps, each held SCHEDULE_HOLD periods
SCHEDULE_HOLD = 3
SCHEDULE_PERIODS = SCHEDULE_CAPS * SCHEDULE_HOLD
IDENTIFY_PERIODS = LEVELS * CAMPAIGN_STEPS + SCHEDULE_PERIODS
EPS_GRID = (0.0, 0.05, 0.10, 0.20)
FLEET_NODES = 256
FLEET_STEPS = 120
FLEET_SHARE = 0.7        # the global budget as a share of peak power
FLEET_SKIP = 30          # leading steps left out of the fleet's means


def identify(name: str, noise: torch.Tensor) -> dict:
    """Table 2 recovery for one cluster on ``noise`` (IDENTIFY_PERIODS,
    4): the static fit from a 9-level campaign at 40-120 W, then tau
    from a 300-period random schedule (caps from ``default_rng(0)``)."""
    prof = PROFILES[name]
    n_camp = LEVELS * CAMPAIGN_STEPS
    caps, powers, progs = campaign(
        prof, np.linspace(40, 120, LEVELS),
        noise[:n_camp].reshape(LEVELS, CAMPAIGN_STEPS, -1))
    fit = fit_static(caps, powers, progs, device=noise.device)
    rng = np.random.default_rng(0)
    sched = np.repeat(rng.uniform(40, 120, SCHEDULE_CAPS),
                      SCHEDULE_HOLD).astype(np.float32)
    sched_t = torch.from_numpy(sched).to(noise.device)
    tr = simulate(prof, sched_t, 1.0, noise[n_camp:])
    pl = pcap_linearize(prof, sched_t).cpu().numpy()
    yl = tr["progress_clean"].cpu().numpy() - prof.K_L
    tau, _ = fit_dynamics(pl, yl, 1.0)
    print(f"  {name:5s}: K_L={fit.K_L:6.1f} alpha={fit.alpha:.3f} "
          f"beta={fit.beta:5.1f} R2={fit.r2:.3f} tau={tau:.2f}s")
    return {"fit": fit, "tau": tau, "caps": caps, "power_means": powers,
            "progress_means": progs}


def eps_sweep(name: str = "gros", device=None) -> dict:
    """Time and energy over EPS_GRID, the mean of 3 seeds: one all-PI
    `sweep`, so one closed-loop kernel launch on the card."""
    print(f"epsilon sweep on {name} (total work fixed, one batched sweep):")
    res = sweep(name, EPS_GRID, seeds=range(3), total_work=2000.0,
                device=device)
    t = np.asarray(res.exec_time).mean(axis=1)
    e = np.asarray(res.energy).mean(axis=1)
    for i, eps in enumerate(EPS_GRID):
        print(f"  eps={eps:4.2f}: time={t[i]:6.1f}s energy={e[i]:7.0f}J"
              f" (mean of 3 seeds)")
    return {"eps": list(EPS_GRID), "time": t.tolist(), "energy": e.tolist()}


def shift_run(adaptive: bool, seed: int, run_seed: int, device=None,
              max_time: float = 3600.0):
    """One NRM (gros design, eps 0.1, fixed or RLS-adaptive gains)
    against a gros plant with K_L doubled, driven by a
    `SimulatedPowerActuator` of ``seed`` through ``run_simulated(1500,
    seed=run_seed)``. Returns (mean tracking error after the first 20
    periods, completion time)."""
    prof = PROFILES["gros"]
    nrm = NRM(PowerControlConfig(epsilon=0.1, plant_profile="gros",
                                 adaptive=adaptive), device=device)
    # shift the true plant gain mid-run (phase change)
    shifted = dataclasses.replace(prof, K_L=prof.K_L * 2.0)
    nrm.actuator = SimulatedPowerActuator(shifted, seed=seed, device=device)
    tr = nrm.run_simulated(total_work=1500.0, max_time=max_time,
                           seed=run_seed)
    err = float(np.abs(tr["progress"][20:] - nrm.gains.setpoint).mean())
    return err, float(tr["t"][-1])


def adaptive_demo(device=None, max_time: float = 3600.0) -> dict:
    """Fixed gains against RLS-adaptive gains under a 2x plant-gain
    shift (`shift_run` of seeds 3 and 4)."""
    print("adaptive (RLS) vs fixed gains under a 2x plant-gain shift:")
    out = {}
    for adaptive in (False, True):
        err, t = shift_run(adaptive, 3, 4, device, max_time)
        print(f"  adaptive={adaptive}: mean tracking error "
              f"{err:6.2f} Hz, time={t:6.1f}s")
        out[adaptive] = {"error": err, "time": t}
    return out


def fleet_demo(device=None) -> dict:
    """256 dahu nodes for 120 steps under a budget of 70% of peak."""
    print(f"hierarchical fleet: {FLEET_NODES} nodes, global budget = "
          f"{FLEET_SHARE:.0%} of peak:")
    prof = PROFILES["dahu"]
    peak = float(prof.power_of_pcap(prof.pcap_max)) * FLEET_NODES
    fc = FleetConfig(n_nodes=FLEET_NODES, epsilon=0.1,
                     power_budget=FLEET_SHARE * peak)
    tr = simulate_fleet(prof, fc, steps=FLEET_STEPS, seed=0, device=device)
    prog = float(np.mean(np.asarray(tr["progress_med"])[FLEET_SKIP:]))
    power = float(np.mean(np.asarray(tr["power"])[FLEET_SKIP:]))
    energy = float(tr["energy_total"])
    print(f"  fleet progress (median): {prog:6.1f} Hz; power "
          f"{power / 1e3:6.1f} kW (budget {FLEET_SHARE * peak / 1e3:.1f} kW);"
          f" energy={energy / 1e6:.2f} MJ")
    return {"progress_med": prog, "power": power,
            "budget": FLEET_SHARE * peak, "energy_total": energy}


def main(device=None) -> dict:
    dev = resolve_device(device)
    print("identification (Table 2 recovery):")
    noise = port_noise(SEED, IDENTIFY_PERIODS, dev)
    out = {"identify": {name: identify(name, noise) for name in CLUSTERS}}
    out["eps_sweep"] = eps_sweep(device=dev)
    out["adaptive"] = adaptive_demo(dev)
    out["fleet"] = fleet_demo(dev)
    return out


if __name__ == "__main__":
    main(device_arg(__doc__))
