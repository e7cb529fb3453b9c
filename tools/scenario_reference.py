#!/usr/bin/env python3
"""The reference's beyond-the-paper scenarios at their `--full` sizes on
the CPU, and the port's on the same grids: the yardstick of phase 13 of
`chip_smoke.py`.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/scenario_reference.py \
        [--no-port]

Needs the reference (jax) and, unless ``--no-port``, the port (torch); no
card. It calls `repro.core.sim.sweep` with the arguments of
`benchmarks/fig8_phases.py` and `benchmarks/fig9_chaos.py` (it does not
call their `run()`, which writes BENCH_sim.json), then the port's `sweep`
on the CPU with the same arguments. Prints, per package:

1. Fig. 8 (`--full`): offline RL fitted (100 iterations) on PI traces of
   gros and dahu x 2 seeds (work 2,000, 1,024 s); then PI, RLS-adaptive
   PI, offline RL and duty-cycle x gros, dahu x eps 0.1 x 20 seeds on the
   STREAM -> DGEMM -> STREAM schedule (dwell 250 s, 750 s, warm-up 30),
   without and with `DetectorConfig()`: per (arm, profile, policy) the
   mean energy, J/work, median progress over the setpoint and alarms per
   run, with the standard error of the mean energy over seeds.
2. Fig. 9 (`--full`'s grid at half its horizon): gros, eps 0.1, blackout
   rates 0 / 0.02 / 0.05 / 0.10 / 0.15 / 0.25 as the F axis x PI,
   RLS-adaptive PI and duty-cycle x 16 seeds x 2,000 s (five 400 s chaos
   cycles; `--full` runs 4,000 s, ten, which the scan engine's host-bound
   step loop makes the smoke's longest part), unguarded and with
   `GuardConfig(hold_k=3, failsafe_k=60)`: per (arm, policy, rate) the
   tracking error, its ratio to the clean error, J/work and the time in
   fail-safe, with the standard error of the tracking error over seeds.

These are simulated joules, seconds and ratios, not timings. The two
packages draw different random streams, so they agree within their
seed-to-seed spread, not digit for digit.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

EPS = 0.10
F8_PROFS, F8_DWELL, F8_TIME, F8_SEEDS = ("gros", "dahu"), 250.0, 750.0, 20
F9_PROF, F9_PERIOD, F9_START, F9_TIME, F9_SEEDS = "gros", 400.0, 80.0, \
    2000.0, 16
F9_RATES = (0.0, 0.02, 0.05, 0.10, 0.15, 0.25)
STREAM = {"alpha": 3.0, "beta": 0.6}
DGEMM = {"alpha": 0.3, "beta": 1.14, "K_L": 2.0}
F8_NAMES = ("pi", "pi_rls", "offline_rl", "dutycycle")
F9_NAMES = ("pi", "pi_rls", "dutycycle")


def _pkg(which):
    """The modules of one package under common names."""
    if which == "reference":
        from repro.core import faults, policies, sim, workloads
        from repro.core.adaptive import RLSConfig
        from repro.core.plant import PROFILES
        kw = {}
    else:
        from repro_torch.core import faults, policies, sim, workloads
        from repro_torch.core.adaptive import RLSConfig
        from repro_torch.core.plant import PROFILES
        kw = {"device": "cpu"}
    return dict(faults=faults, policies=policies, sim=sim, wl=workloads,
                RLSConfig=RLSConfig, PROFILES=PROFILES, kw=kw)


def fig8(m, tag):
    sim, pol, wl = m["sim"], m["policies"], m["wl"]
    t0 = time.time()
    har = sim.sweep(F8_PROFS, [EPS], range(2), total_work=2000.0,
                    max_time=1024.0, backend="scan", **m["kw"])
    parts = [pol.build_dataset({k: np.asarray(v)[i] for k, v in
                                har.traces.items()},
                               m["PROFILES"][p], EPS)
             for i, p in enumerate(F8_PROFS)]
    data = {k: np.concatenate([d[k] for d in parts]) for k in parts[0]}
    rl = pol.fit_offline_rl(data, n_iters=100, **m["kw"])
    policies = [pol.PIPolicy(), pol.PIPolicy(adaptive=m["RLSConfig"]()), rl,
                pol.DutyCyclePolicy()]
    sched = wl.PhaseSchedule((wl.Phase(F8_DWELL, scale=STREAM),
                              wl.Phase(F8_DWELL, scale=DGEMM),
                              wl.Phase(F8_DWELL, scale=STREAM)),
                             name="stream-dgemm-x3")
    print(f"[{tag}] fig8: {len(data['s'])} harvested transitions, offline "
          f"RL w = " + ", ".join(f"{w:.4f}" for w in
                                  np.asarray(rl.weights)))
    for arm, det in (("no_detector", None),
                     ("detector", wl.DetectorConfig())):
        res = sim.sweep(F8_PROFS, [EPS], range(F8_SEEDS),
                        total_work=1e12, max_time=F8_TIME,
                        policies=policies, workloads=sched,
                        collect_traces=False, summary_warmup=30,
                        detector=det, **m["kw"])
        energy, work = np.asarray(res.energy), np.asarray(res.work)
        for a, name in enumerate(F8_NAMES):
            for p, prof in enumerate(F8_PROFS):
                sp = (1.0 - EPS) * m["PROFILES"][prof].progress_max
                med = sim.hist_quantile(
                    np.asarray(res.summary["progress_hist"])[p, 0, a],
                    np.asarray(res.summary["progress_edges"])[p], 0.5)
                e = energy[p, 0, a]
                alarms = (0.0 if res.detections is None else
                          float(np.asarray(res.detections)[p, 0, a].mean()))
                print(f"[{tag}] fig8 {arm} {name} {prof}: energy "
                      f"{e.mean():.2f} J (se {e.std(ddof=1) / np.sqrt(len(e)):.2f}),"
                      f" J/work {e.mean() / work[p, 0, a].mean():.5f},"
                      f" progress/setpoint {np.median(med) / sp:.5f},"
                      f" alarms {alarms:.3f}")
    print(f"[{tag}] fig8 in {time.time() - t0:.1f} s")


def chaos_schedule(faults, rate):
    windows = []
    if rate > 0:
        d = rate * F9_PERIOD
        windows = [faults.FaultWindow("hb_dropout", F9_START, d, p1=1.0),
                   faults.FaultWindow("meter_freeze", F9_START, d)]
    return faults.FaultSchedule(windows, period=F9_PERIOD,
                                name=f"chaos-{rate:g}")


def fig9(m, tag):
    sim, pol, flt = m["sim"], m["policies"], m["faults"]
    t0 = time.time()
    policies = [pol.PIPolicy(), pol.PIPolicy(adaptive=m["RLSConfig"]()),
                pol.DutyCyclePolicy()]
    setpoint = (1.0 - EPS) * m["PROFILES"][F9_PROF].progress_max
    for arm, g in (("unguarded", None),
                   ("guarded", flt.GuardConfig(hold_k=3, failsafe_k=60))):
        res = sim.sweep(F9_PROF, [EPS], range(F9_SEEDS), total_work=1e12,
                        max_time=F9_TIME, policies=policies,
                        faults=[chaos_schedule(flt, r) for r in F9_RATES],
                        guard=g, collect_traces=False, summary_warmup=60,
                        **m["kw"])
        energy, work = np.asarray(res.energy)[0], np.asarray(res.work)[0]
        t = np.asarray(res.exec_time)[0]
        n = np.asarray(res.n_steps)[0]
        err = np.abs(work / np.maximum(t, 1e-9) - setpoint) / setpoint
        for a, name in enumerate(F9_NAMES):
            clean = float(err[a, 0].mean())
            for f, r in enumerate(F9_RATES):
                e = err[a, f]
                line = (f"[{tag}] fig9 {arm} {name} rate {r:g}: err "
                        f"{e.mean():.6f} (se "
                        f"{e.std(ddof=1) / np.sqrt(len(e)):.6f}), "
                        f"err/clean {e.mean() / max(clean, 1e-12):.4f}, "
                        f"J/work {(energy[a, f] / np.maximum(work[a, f], 1e-9)).mean():.5f}")
                if res.guard_state is not None:
                    gs = np.asarray(res.guard_state)[0]
                    line += (", failsafe "
                             f"{(gs[a, f, :, flt.G_N_FAILSAFE] / np.maximum(n[a, f], 1)).mean():.5f}")
                print(line)
    print(f"[{tag}] fig9 in {time.time() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-port", action="store_true",
                    help="run the reference only")
    args = ap.parse_args(argv)
    for which in ("reference",) + (() if args.no_port else ("port",)):
        m = _pkg(which)
        fig8(m, which)
        fig9(m, which)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
