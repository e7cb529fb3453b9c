"""Energy accounting + time/energy Pareto analysis (paper §5.2, Fig. 7);
copy of `repro.core.energy` (numpy only)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RunSummary:
    epsilon: float
    exec_time: float  # [s]
    energy: float     # [J]
    mean_progress: float
    mean_power: float
    # energy efficiency: joules spent per unit of work completed — the
    # signal efficiency-driven fleet water-filling ranks nodes by
    joules_per_work: float = float("nan")
    completed: bool = True


def summarize_run(epsilon: float, dt: float, progress: np.ndarray,
                  power: np.ndarray, completed_work: float | None = None,
                  total_work: float | None = None) -> RunSummary:
    """Run-level time/energy/efficiency statistics from traces.

    ``completed_work`` is the work units actually done (the engine's
    `work` trace tail); when omitted it is recovered as the integral of
    the progress trace. ``total_work`` marks the run's target, so
    `completed` records whether the run finished or hit its horizon."""
    progress = np.asarray(progress)
    power = np.asarray(power)
    exec_time = dt * len(progress)
    energy = float(np.sum(power) * dt)
    work = (float(completed_work) if completed_work is not None
            else float(np.sum(progress) * dt))
    return RunSummary(
        epsilon=float(epsilon),
        exec_time=float(exec_time),
        energy=float(energy),
        mean_progress=float(progress.mean()),
        mean_power=float(power.mean()),
        joules_per_work=energy / work if work > 0 else float("nan"),
        completed=(True if total_work is None
                   else work >= float(total_work) * (1.0 - 1e-6)),
    )


def pareto_front(points: Sequence[Tuple[float, float]]) -> List[int]:
    """Indices of the non-dominated (time, energy) points (min-min)."""
    idx = sorted(range(len(points)), key=lambda i: points[i])
    front: List[int] = []
    best_energy = float("inf")
    for i in idx:
        t, e = points[i]
        if e < best_energy - 1e-12:
            front.append(i)
            best_energy = e
    return front


def tradeoff_table(runs: Sequence[RunSummary]) -> Dict[float, dict]:
    """Per-epsilon mean time/energy/efficiency, normalized to the eps=0
    baseline. ``joules_per_work`` rows carry NaN when no run at that
    epsilon had work accounting (pre-efficiency traces)."""
    by_eps: Dict[float, List[RunSummary]] = {}
    for r in runs:
        by_eps.setdefault(r.epsilon, []).append(r)

    def _jpw(rs):
        vals = [r.joules_per_work for r in rs
                if np.isfinite(r.joules_per_work)]
        return float(np.mean(vals)) if vals else float("nan")

    base = by_eps.get(0.0) or by_eps[min(by_eps)]
    t0 = float(np.mean([r.exec_time for r in base]))
    e0 = float(np.mean([r.energy for r in base]))
    j0 = _jpw(base)
    out = {}
    for eps in sorted(by_eps):
        rs = by_eps[eps]
        t = float(np.mean([r.exec_time for r in rs]))
        e = float(np.mean([r.energy for r in rs]))
        j = _jpw(rs)
        out[eps] = {
            "time_s": t,
            "energy_j": e,
            "time_increase": t / t0 - 1.0,
            "energy_saving": 1.0 - e / e0,
            "joules_per_work": j,
            # efficiency gain over the baseline: J/work saved per unit
            "efficiency_gain": (1.0 - j / j0
                                if np.isfinite(j) and np.isfinite(j0)
                                and j0 > 0 else float("nan")),
            "n": len(rs),
        }
    return out
