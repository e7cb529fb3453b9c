"""Closed-loop simulation front end (paper Figs. 5-7 at fleet scale);
port of the fixed-gain-PI path of `repro.core.sim`.

The paper's evaluation is thousands of closed-loop runs sweeping the
degradation grid eps across clusters and seeds. Every run here goes
through the fused closed-loop op (`repro_torch.kernels.closed_loop`):
on CUDA the hand-written kernel, which generates each run's noise stream
(`ops.draw_noise` of its seed) inside the kernel, so no noise tensor
exists; on the CPU its plain PyTorch version on `draw_noise`. That op is
the reference's ``backend="pallas"`` path: static plant, fixed-gain PI,
rounded-Gaussian heartbeats, per-run noise streams.

Entry points:

* `simulate_closed_loop(profile, ...)` — one run; trimmed numpy traces.
* `sweep(profiles, epsilons, seeds, ...)` — the profiles x epsilons x
  seeds grid as one batch of runs, in trace or summary mode.

Runs finish by early-exit-by-mask: once accumulated work reaches
`total_work` (or time reaches `max_time`) a run's state freezes; the
`valid` trace marks live steps. With ``collect_traces=False`` no
per-step output exists: the kernel reduces the runs online (count,
progress/power moments, progress and cap histograms), which is what
makes 100k-run grids fit; `hist_quantile` turns the histograms into
median/p95-style statistics.

What the reference offers beyond this path raises NotImplementedError
naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.controller import PIGains, PIState
from repro_torch.core.plane import gains_values
from repro_torch.core.plant import (PROFILE_FIELDS, PROFILES, PlantProfile,
                                    PlantState)
from repro_torch.kernels.closed_loop import ops
from repro_torch.kernels.closed_loop.ref import (CAP_BINS, PROG_BINS,
                                                 PROG_HIST_SPAN)

# ROADMAP items that bring what this path does not cover yet.
_TODO = {
    "adaptive": "Queue 1 item 4 (policies and adaptation)",
    "policies": "Queue 1 item 4 (policies and adaptation)",
    "policy": "Queue 1 item 4 (policies and adaptation)",
    "design": "Queue 1 item 4 (policies and adaptation)",
    "workloads": "Queue 1 item 5 (phased workloads and detection)",
    "workload": "Queue 1 item 5 (phased workloads and detection)",
    "detector": "Queue 1 item 5 (phased workloads and detection)",
    "faults": "Queue 1 item 6 (faults, guard and flight recorder)",
    "guard": "Queue 1 item 6 (faults, guard and flight recorder)",
    "record_events": "Queue 1 item 6 (faults, guard and flight recorder)",
    "chunk_size": "Queue 1 item 7 (execution and runtime)",
    "devices": "Queue 1 item 7 (execution and runtime)",
    "durable": "Queue 1 item 7 (execution and runtime)",
    "campaign": "Queue 1 item 7 (execution and runtime)",
    "consume": "Queue 1 item 7 (execution and runtime)",
    "init": "Queue 1 item 3 (resume_init and the Poisson scan engine)",
    "typed_pi": "Queue 1 item 3 (resume_init and the Poisson scan engine)",
}


def _reject(**given) -> None:
    """Raise for the first argument outside the closed-loop kernel's
    capability (the reference's `pallas_ok` check)."""
    for name, value in given.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}= is not ported yet: ROADMAP {_TODO[name]}")


def _check_backend(backend: str) -> None:
    if backend == "scan":
        raise NotImplementedError(
            "backend='scan' (the Poisson-heartbeat scan engine) is not "
            f"ported yet: ROADMAP {_TODO['init']}")
    if backend != "kernel":
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         "backend='kernel' (the fused closed-loop op)")


def profile_values(profile: PlantProfile) -> torch.Tensor:
    """Pack a PlantProfile into the canonical (14,) float32 row."""
    return torch.tensor([getattr(profile, f) for f in PROFILE_FIELDS],
                        dtype=torch.float32)


def _resolve(profile: Union[str, PlantProfile]) -> PlantProfile:
    return PROFILES[profile] if isinstance(profile, str) else profile


def _hist_edges(profile: PlantProfile) -> Dict[str, np.ndarray]:
    return {
        "progress_edges": np.linspace(0.0, PROG_HIST_SPAN * profile.K_L,
                                      PROG_BINS + 1, dtype=np.float32),
        "pcap_edges": np.linspace(profile.pcap_min, profile.pcap_max,
                                  CAP_BINS + 1, dtype=np.float32),
    }


def hist_quantile(hist, edges, q: float = 0.5) -> np.ndarray:
    """Quantile estimate from an online histogram (bin-center rule).

    `hist` has shape (..., N); `edges` is (N+1,) or (P, N+1) with P
    matching hist's leading axis (the sweep's profile axis). Accurate to
    half a bin width — PROG_HIST_SPAN*K_L/PROG_BINS for progress.

    Edge cases: an all-empty histogram yields NaN; q=0 / q=1 return the
    centers of the lowest / highest occupied bins (a single-count
    histogram therefore answers that bin for every q)."""
    hist = np.asarray(hist, np.float64)
    edges = np.asarray(edges, np.float64)
    centers = 0.5 * (edges[..., :-1] + edges[..., 1:])
    if centers.ndim == 2:  # per-profile edges -> broadcast over inner axes
        centers = centers.reshape(
            (centers.shape[0],) + (1,) * (hist.ndim - 2)
            + (centers.shape[-1],))
    c = hist.cumsum(-1)
    total = c[..., -1:]
    # strictly positive threshold so q=0 lands on the first OCCUPIED bin
    # (empty leading bins satisfy c >= 0 but not c >= tiny)
    thresh = np.maximum(q * total, np.finfo(np.float64).tiny)
    idx = (c >= thresh).argmax(-1)
    out = np.take_along_axis(np.broadcast_to(centers, hist.shape),
                             idx[..., None], -1)[..., 0]
    return np.where(total[..., 0] > 0, out, np.nan)


def _summary_dict(final: Dict[str, np.ndarray],
                  edges: Dict[str, np.ndarray]) -> Dict:
    """Online summaries of a kernel-final dict (numpy, any leading shape)."""
    n = np.maximum(final["count"], 1.0)
    mean = final["progress_sum"] / n
    var = np.maximum(final["progress_sq_sum"] / n - mean * mean, 0.0)
    return {"progress_mean": mean,
            "progress_std": np.sqrt(var),
            "power_mean": final["power_sum"] / n,
            "progress_hist": final["progress_hist"],
            "pcap_hist": final["pcap_hist"],
            **edges}


@dataclasses.dataclass(frozen=True)
class SimResult:
    """One closed-loop run, trimmed to the completed steps."""
    traces: Dict[str, np.ndarray]  # t, progress, pcap, power, energy, work
    exec_time: float
    energy: float
    work: float
    completed: bool
    n_steps: int
    pi_state: PIState
    plant_state: PlantState
    pcap: float
    summary: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Batched runs over profiles x epsilons x seeds.

    Arrays have shape (P, E, S) — traces (P, E, S, T) — with the P axis
    squeezed away when a single profile was passed. Frozen
    (post-completion) steps carry `valid == False`. In summary mode
    (`collect_traces=False`) `traces` is None and only `summary` (plus
    the scalar reductions) is materialized."""
    traces: Optional[Dict[str, np.ndarray]]
    exec_time: np.ndarray
    energy: np.ndarray
    work: np.ndarray
    completed: np.ndarray
    n_steps: np.ndarray
    summary: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)

    def masked_mean(self, key: str) -> np.ndarray:
        """Per-run mean of a trace over its live steps. For 'progress'
        and 'power' in summary mode use summary['progress_mean'] /
        summary['power_mean'] instead."""
        if self.traces is None:
            raise ValueError(
                "no traces collected (summary mode); use "
                "summary['progress_mean'] / summary['power_mean']")
        x = np.asarray(self.traces[key])
        m = np.asarray(self.traces["valid"])
        return (x * m).sum(-1) / np.maximum(m.sum(-1), 1)


def _run_rows(prof, gains, seeds, *, total_work, max_time, dt,
              summary_warmup, collect_traces, device):
    """Flat batch of runs -> (traces (N, T) | None, final) as numpy."""
    dev = resolve_device(device)
    traces, final = ops.closed_loop_sim(
        prof.to(dev), gains.to(dev), seeds.to(dev),
        total_work=float(total_work),
        max_time=float(max_time), dt=float(dt),
        summary_from=float(summary_warmup), collect=collect_traces)
    final = {k: v.cpu().numpy() for k, v in final.items()}
    if traces is not None:
        traces = {k: v.T.cpu().numpy() for k, v in traces.items()}
        traces["valid"] = traces["valid"] > 0.5
    return traces, final


def simulate_closed_loop(profile: Union[str, PlantProfile],
                         epsilon: Optional[float] = None, *,
                         gains: Optional[PIGains] = None,
                         total_work: float,
                         max_time: float = 3600.0,
                         dt: float = 1.0,
                         seed: int = 0,
                         tau_obj: float = 10.0,
                         collect_traces: bool = True,
                         summary_warmup: int = 0,
                         device: Union[None, str, torch.device] = None,
                         init=None, adaptive=None, design=None,
                         policy=None, workload=None, detector=None,
                         faults=None, guard=None, record_events=None
                         ) -> SimResult:
    """One closed-loop run through the fused closed-loop op.

    Pass either `epsilon` (gains placed from the profile's identified
    model) or explicit `gains` (e.g. designed on a different profile).
    The run's noise stream is that of `ops.draw_noise` for ``seed``
    (generated inside the kernel on CUDA). Runs on CUDA unless
    ``device="cpu"``."""
    _reject(init=init, adaptive=adaptive, design=design, policy=policy,
            workload=workload, detector=detector, faults=faults,
            guard=guard, record_events=record_events)
    profile = _resolve(profile)
    if gains is None:
        if epsilon is None:
            raise ValueError("pass epsilon or gains")
        gains = PIGains.from_model(profile, epsilon, tau_obj)
    traces, f = _run_rows(
        profile_values(profile)[None], gains_values(gains)[None],
        torch.tensor([seed], dtype=torch.int64),
        total_work=total_work, max_time=max_time, dt=dt,
        summary_warmup=summary_warmup, collect_traces=collect_traces,
        device=device)
    f = {k: v[0] for k, v in f.items()}
    n = int(f["steps"])
    trimmed = {} if traces is None else {
        k: v[0, :n] for k, v in traces.items() if k != "valid"}
    return SimResult(traces=trimmed,
                     exec_time=float(f["t"]),
                     energy=float(f["energy"]),
                     work=float(f["work"]),
                     completed=bool(f["work"] >= total_work),
                     n_steps=n,
                     pi_state=PIState(prev_error=f["prev_error"],
                                      prev_pcap_l=f["prev_pcap_l"]),
                     plant_state=PlantState(progress_l=f["progress_l"],
                                            dropped=f["dropped"] > 0,
                                            energy=f["energy"],
                                            work=f["work"]),
                     pcap=float(f["pcap"]),
                     summary=_summary_dict(f, _hist_edges(profile)))


def grid_rows(profiles: Sequence[Union[str, PlantProfile]],
              epsilons: Sequence[float], seeds: Sequence[int],
              tau_obj: float = 10.0):
    """The profiles x epsilons x seeds grid as per-run rows in grid-nest
    order: (N, 14) profile rows, (N, 9) gain rows, (N,) int64 seeds."""
    profs = [_resolve(p) for p in profiles]
    eps = [float(e) for e in epsilons]
    seeds = [int(s) for s in seeds]
    if not (profs and eps and seeds):
        raise ValueError("sweep needs at least one profile, epsilon and "
                         "seed")
    pv = torch.stack([profile_values(p) for p in profs])          # (P, 14)
    gv = torch.stack([torch.stack([
        gains_values(PIGains.from_model(p, e, tau_obj)) for e in eps])
        for p in profs])                                          # (P, E, 9)
    ip, ie, is_ = (torch.from_numpy(i) for i in np.indices(
        (len(profs), len(eps), len(seeds))).reshape(3, -1))
    return pv[ip], gv[ip, ie], torch.tensor(seeds, dtype=torch.int64)[is_]


def sweep(profiles, epsilons, seeds, total_work, max_time=3600.0,
          dt=1.0, tau_obj=10.0, adaptive=None, policies=None,
          collect_traces=True, summary_warmup=0, workloads=None,
          detector=None, faults=None, guard=None, record_events=None, *,
          backend: str = "kernel", chunk_size: Optional[int] = None,
          devices=None, typed_pi: bool = False, consume=None,
          durable=None, campaign=None,
          device: Union[None, str, torch.device] = None
          ) -> SweepResult:
    """Closed-loop grid: profiles x epsilons x seeds, one batch of runs.

    Every (profile, epsilon, seed) cell is one run whose parameters and
    noise stream ride in its own row, so any sub-grid reproduces the
    same cells exactly. `collect_traces=False` switches to summary mode
    (no (.., T) traces; O(grid) memory). `summary_warmup` excludes each
    run's first steps (the descent transient) from the online summary
    reductions only. Runs on CUDA unless ``device="cpu"``.

    The reference's other axes and execution options (``adaptive``,
    ``policies``, ``workloads``, ``detector``, ``faults``, ``guard``,
    ``record_events``, ``chunk_size``, ``devices``, ``durable``, ...)
    and ``backend="scan"`` raise NotImplementedError naming the ROADMAP
    item that brings them."""
    _reject(adaptive=adaptive, policies=policies, workloads=workloads,
            detector=detector, faults=faults, guard=guard,
            record_events=record_events, chunk_size=chunk_size,
            devices=devices, typed_pi=typed_pi, consume=consume,
            durable=durable, campaign=campaign)
    _check_backend(backend)
    single = isinstance(profiles, (str, PlantProfile))
    profs = [_resolve(p) for p in ([profiles] if single else profiles)]
    prof, gains, seed_rows = grid_rows(profs, epsilons, seeds, tau_obj)
    traces, final = _run_rows(
        prof, gains, seed_rows, total_work=total_work, max_time=max_time,
        dt=dt, summary_warmup=summary_warmup,
        collect_traces=collect_traces, device=device)
    shape = (len(profs), len(epsilons), len(seeds))
    final = {k: v.reshape(shape + v.shape[1:]) for k, v in final.items()}
    if traces is not None:
        traces = {k: v.reshape(shape + v.shape[1:])
                  for k, v in traces.items()}
    edges = {k: np.stack([_hist_edges(p)[k] for p in profs])
             for k in ("progress_edges", "pcap_edges")}
    summary = _summary_dict(final, edges)
    if single:
        traces = (None if traces is None
                  else {k: v[0] for k, v in traces.items()})
        final = {k: v[0] for k, v in final.items()}
        summary = {k: v[0] for k, v in summary.items()}
    return SweepResult(traces=traces,
                       exec_time=final["t"],
                       energy=final["energy"],
                       work=final["work"],
                       completed=final["work"] >= total_work,
                       n_steps=final["steps"].astype(np.int32),
                       summary=summary)
