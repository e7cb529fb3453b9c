"""Closed-loop simulation front end (paper Figs. 5-7 at fleet scale);
port of the fixed-gain-PI path of `repro.core.sim`.

The paper's evaluation is thousands of closed-loop runs sweeping the
degradation grid eps across clusters and seeds. Two engines run them:

* ``backend="kernel"`` (the default): the fused closed-loop op
  (`repro_torch.kernels.closed_loop`): on CUDA the hand-written kernel,
  which generates each run's noise stream (`ops.draw_noise` of its seed)
  inside the kernel, so no noise tensor exists; on the CPU its plain
  PyTorch version on `draw_noise`. That op is the reference's
  ``backend="pallas"`` path: static plant, fixed-gain PI,
  rounded-Gaussian heartbeats, per-run noise streams.
* ``backend="scan"``: the reference's own engine (`engine_step`,
  `_scan_core`), a step loop of PyTorch ops over the batch of runs on the
  device: the Eq. 3 plant on `draw_noise`'s plant channels, exact
  Poisson heartbeat counts (`repro_torch.core.poisson`), the Eq. 1
  window median, the Eq. 4 PI, early exit and the online summaries. It
  is the engine of every paper figure in the reference, and the carrier
  later slices extend (policies, phased workloads, faults).

Entry points:

* `simulate_closed_loop(profile, ...)` — one run; trimmed numpy traces.
* `sweep(profiles, epsilons, seeds, ...)` — the profiles x epsilons x
  seeds grid as one batch of runs, in trace or summary mode.
* `engine_step(...)` — the scan engine's fused single-period step.
* `open_loop_runs(profile, steps, seeds)` — constant-cap open-loop runs
  batched over seeds (the full-power baseline of Fig. 7).
* `replay_model(profile, pcaps, dt)` — deterministic Eq. 3 replay (the
  Fig. 5 model-accuracy baseline).

Runs finish by early-exit-by-mask: once accumulated work reaches
`total_work` (or time reaches `max_time`) a run's state freezes; the
`valid` trace marks live steps. With ``collect_traces=False`` no
per-step output exists: the runs are reduced online (count,
progress/power moments, progress and cap histograms), which is what
makes 100k-run grids fit; `hist_quantile` turns the histograms into
median/p95-style statistics.

What the reference offers beyond these paths raises NotImplementedError
naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.controller import PIGains, PIState, pi_init, pi_step
from repro_torch.core.plane import gains_values, unpack_gains
from repro_torch.core.plant import (PROFILE_FIELDS, PROFILES, PlantProfile,
                                    PlantState, pcap_linearize, plant_init,
                                    plant_step, simulate)
from repro_torch.core.poisson import PoissonStream
from repro_torch.kernels.closed_loop import ops
from repro_torch.kernels.closed_loop import ref as R
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
    "init": "Queue 1 item 7 (execution and runtime: resume_init)",
    "cap_limit": "Queue 1 item 7 (execution and runtime: the fleet)",
    "schedule": "Queue 1 item 5 (phased workloads and detection)",
}


def _reject(**given) -> None:
    """Raise for the first argument outside the closed-loop kernel's
    capability (the reference's `pallas_ok` check)."""
    for name, value in given.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}= is not ported yet: ROADMAP {_TODO[name]}")


def _check_backend(backend: str) -> None:
    if backend not in ("kernel", "scan"):
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         "backend='kernel' (the fused closed-loop op) and "
                         "backend='scan' (the Poisson-heartbeat engine)")


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


# ---- the scan engine (the reference's backend="scan") -------------------

def _bucket_steps(n: int) -> int:
    """Round the scan length up to a power of two (min 256), as the
    reference does to share compiled engines across nearby horizons:
    frozen steps after completion are no-ops and `max_time` is enforced
    by the mask, so only the trace length depends on it."""
    b = 256
    while b < n:
        b *= 2
    return b


def _unpack_profile(vals: torch.Tensor) -> PlantProfile:
    """Packed (..., 14) profile rows -> a PlantProfile of (...) tensors."""
    return PlantProfile(name="_rows", **{
        f: vals[..., i] for i, f in enumerate(PROFILE_FIELDS)})


def _window_median(n, anchor_gap, has_anchor, dt):
    """Closed-form Eq. 1 median for n evenly spaced beats in one period
    (integer counts): the window's rate multiset is {rate_first} + (n-1)
    x {n/dt}, the first interval reaching back `anchor_gap` before the
    window; with no anchor (no beat has ever fired) (n-1) x {n/dt}."""
    return R.window_median(n.to(torch.float32), anchor_gap, has_anchor, dt)


class _Summary(NamedTuple):
    """Online per-run reductions carried through the step loop (the
    summary mode's entire output; also carried in trace mode so the two
    modes stay comparable). `count` is the number of accumulated steps —
    live steps past the summary warmup — and the normalizer for the
    moments. (B,) leaves and (B, BINS) histograms."""
    count: torch.Tensor
    progress_sum: torch.Tensor
    progress_sq_sum: torch.Tensor
    power_sum: torch.Tensor
    progress_hist: torch.Tensor
    pcap_hist: torch.Tensor


def _summary_init(like: torch.Tensor) -> _Summary:
    z = torch.zeros_like(like)
    B = like.shape[0]
    return _Summary(count=z, progress_sum=z, progress_sq_sum=z, power_sum=z,
                    progress_hist=like.new_zeros((B, PROG_BINS)),
                    pcap_hist=like.new_zeros((B, CAP_BINS)))


def _hist_add(hist, x, lo, hi, nbins, live):
    """``live`` added to each run's bin of ``x`` in [lo, hi) (nbins bins,
    truncated, then clipped)."""
    return R._hist_add(hist, R.hist_index(x, lo, hi, nbins), live)


class _Carry(NamedTuple):
    """The engine's per-run state, (B,) leaves: the fixed-gain PI path's
    (the typed `PIState`; the packed policy vector, the detector, fault,
    guard and recorder state come with later slices)."""
    plant: PlantState
    pol: PIState
    pcap: torch.Tensor        # command applied next period [W]
    anchor_gap: torch.Tensor  # time from last beat to window start [s]
    has_anchor: torch.Tensor  # bool: any beat ever fired
    t: torch.Tensor           # simulated time [s]
    steps: torch.Tensor       # int32 live (pre-completion) step count
    done: torch.Tensor        # bool: total_work or max_time reached
    summ: _Summary


def _default_init(profile: PlantProfile, gains: PIGains) -> _Carry:
    """Fresh carry for runs with (B,)-tensor profile and gain fields."""
    ps = plant_init(profile)
    z = torch.zeros_like(ps.progress_l)
    f = torch.zeros_like(ps.dropped)
    return _Carry(plant=ps,
                  pol=PIState(prev_error=z,
                              prev_pcap_l=pi_init(gains).prev_pcap_l),
                  pcap=profile.pcap_max.clone(),
                  anchor_gap=z, has_anchor=f, t=z,
                  steps=torch.zeros_like(z, dtype=torch.int32),
                  done=f, summ=_summary_init(z))


def _reject_engine(**given) -> None:
    """The engine arguments this path does not cover yet."""
    if given.pop("typed_pi") is not True:
        raise NotImplementedError(
            "engine_step runs the typed fixed-gain PI path only "
            "(typed_pi=True); the packed policy path is not ported yet: "
            f"ROADMAP {_TODO['policies']}")
    policy = given.pop("policy")
    if not isinstance(policy, (tuple, list)) or tuple(policy) != ("pi",):
        raise NotImplementedError(
            f"policy= is not ported yet: ROADMAP {_TODO['policy']}")
    _reject(**given)


def engine_step(profile: PlantProfile, gains: PIGains, c: _Carry,
                total_work, max_time, dt, noise: torch.Tensor,
                sampler: Callable[[torch.Tensor], torch.Tensor], *,
                policy=("pi",), policy_vals=None, cap_limit=None,
                summary_from=0.0, schedule=None, detector=None,
                typed_pi: bool = True, faults=None, guard=None):
    """One fused control period over a batch of runs: plant (Eq. 3) ->
    heartbeat median (Eq. 1) -> Eq. 4 PI command, with
    early-exit-by-mask freezing and online summary reduction.

    ``profile`` / ``gains`` hold (B,) tensor fields (`_unpack_profile`,
    `plane.unpack_gains`); the scalars are 0-dim float32 tensors. The
    reference's period key becomes two explicit inputs: ``noise``, the
    plant's (4, B) draws (`plant_step`), and ``sampler``, a callable from
    the (B,) heartbeat rates lam = max(progress, 0) * dt to (B,) integer
    counts (`PoissonStream`, or the reference's own draws in a parity
    test). `summary_from` excludes the first steps from the online
    summaries only.

    This is the reference's ``typed_pi`` single-branch fixed-gain PI
    path; ``policy``, ``policy_vals``, ``cap_limit``, ``schedule``,
    ``detector``, ``faults`` and ``guard`` raise NotImplementedError
    naming the ROADMAP item that brings them.

    Returns (new_carry, out) where out holds this period's trace row."""
    _reject_engine(typed_pi=typed_pi, policy=policy, policies=policy_vals,
                   cap_limit=cap_limit, schedule=schedule,
                   detector=detector, faults=faults, guard=guard)
    plant_s, meas = plant_step(profile, c.plant, c.pcap, dt, noise)
    t = c.t + dt
    # synthesize heartbeats at the measured rate (Eq. 1 input)
    n = sampler(torch.clamp(meas["progress"], min=0.0) * dt)
    progress = _window_median(n, c.anchor_gap, c.has_anchor, dt)
    anchor_gap = torch.where(
        n > 0, 0.5 * dt / torch.clamp(n.to(torch.float32), min=1.0),
        c.anchor_gap + dt)
    has_anchor = c.has_anchor | (n > 0)
    pol_s, pcap = pi_step(gains, c.pol, progress, dt)

    # early-exit-by-mask: freeze everything once done
    frz = lambda new, old: torch.where(c.done, old, new)
    plant_s = PlantState(*map(frz, plant_s, c.plant))
    pol_s = PIState(*map(frz, pol_s, c.pol))
    pcap = frz(pcap, c.pcap)
    anchor_gap = frz(anchor_gap, c.anchor_gap)
    has_anchor = frz(has_anchor, c.has_anchor)
    t = frz(t, c.t)
    zero = torch.zeros_like(progress)
    progress = torch.where(c.done, zero, progress)
    power = torch.where(c.done, zero, meas["power"])

    acc = ((~c.done) & (c.steps.to(torch.float32) >= summary_from)
           ).to(torch.float32)
    summ = _Summary(
        count=c.summ.count + acc,
        progress_sum=c.summ.progress_sum + acc * progress,
        progress_sq_sum=c.summ.progress_sq_sum
        + acc * progress * progress,
        power_sum=c.summ.power_sum + acc * power,
        progress_hist=_hist_add(c.summ.progress_hist, progress,
                                0.0, PROG_HIST_SPAN * profile.K_L,
                                PROG_BINS, acc),
        pcap_hist=_hist_add(c.summ.pcap_hist, pcap, profile.pcap_min,
                            profile.pcap_max, CAP_BINS, acc))

    done = (c.done | (plant_s.work >= total_work)
            | (t >= max_time - 1e-6))
    out = {"t": t, "progress": progress, "pcap": pcap,
           "power": power, "energy": plant_s.energy,
           "work": plant_s.work, "valid": ~c.done}
    return _Carry(plant_s, pol_s, pcap, anchor_gap, has_anchor, t,
                  c.steps + (~c.done).to(torch.int32), done, summ), out


def _scan_core(max_steps: int, collect: bool = True):
    """Closed-loop runs over a batch: (profile_vals (B, 14), gains_vals
    (B, 9), seeds (B,) int64, total_work, max_time, dt, summary_from) ->
    (traces (T, B) per key | None, final carry), all on the rows' device.

    Each run's plant noise is `ops.draw_noise` of its seed (channels 0-3,
    drawn `ops.CHUNK_T` steps at a time) and its heartbeat counts come
    from a `PoissonStream` of its seed, so a run depends only on its own
    row. The loop makes no host sync; after it, one check that every
    Poisson draw resolved."""

    def run(profile_vals, gains_vals, seeds, total_work, max_time, dt,
            summary_from):
        dev = profile_vals.device
        # filled on the device: a copy from the host would sync
        sc = lambda x: torch.full((), float(x), dtype=torch.float32,
                                  device=dev)
        tw, mt, dt, sf = (sc(total_work), sc(max_time), sc(dt),
                          sc(summary_from))
        profile = _unpack_profile(profile_vals.to(torch.float32))
        gains = unpack_gains(gains_vals.to(device=dev,
                                           dtype=torch.float32))
        seeds = seeds.to(device=dev, dtype=torch.int64)
        stream = PoissonStream(seeds)
        c = _default_init(profile, gains)
        traces = None
        if collect:
            B = seeds.shape[0]
            traces = {k: torch.empty((max_steps, B), device=dev,
                                     dtype=torch.bool if k == "valid"
                                     else torch.float32)
                      for k in R.TRACE_KEYS}
        for t0 in range(0, max_steps, ops.CHUNK_T):
            n_t = min(ops.CHUNK_T, max_steps - t0)
            noise = ops.draw_noise(seeds, n_t, t0=t0)
            for j in range(n_t):
                i = t0 + j
                c, out = engine_step(
                    profile, gains, c, tw, mt, dt, noise[j, :4],
                    lambda lam: stream(lam, i), summary_from=sf)
                if collect:
                    for k, v in out.items():
                        traces[k][i] = v
        stream.check()
        return traces, c

    return run


def _final_dict(c: _Carry) -> Dict[str, np.ndarray]:
    """An engine carry as the kernel route's final dict (`ref.init_state`
    keys; flags and step counts as float32), numpy, so both backends
    share one result assembly."""
    f = {"progress_l": c.plant.progress_l, "dropped": c.plant.dropped,
         "energy": c.plant.energy, "work": c.plant.work,
         "prev_error": c.pol.prev_error, "prev_pcap_l": c.pol.prev_pcap_l,
         "pcap": c.pcap, "anchor_gap": c.anchor_gap,
         "has_anchor": c.has_anchor, "t": c.t, "steps": c.steps,
         "done": c.done, **c.summ._asdict()}
    return {k: v.to(torch.float32).cpu().numpy() for k, v in f.items()}


def _scan_rows(prof, gains, seeds, *, total_work, max_time, dt,
               summary_warmup, collect_traces, device):
    """Flat batch of runs through the scan engine -> (traces (N, T) |
    None, final) as numpy, T = `_bucket_steps(ceil(max_time / dt))`."""
    dev = resolve_device(device)
    max_steps = _bucket_steps(int(np.ceil(max_time / dt)))
    traces, c = _scan_core(max_steps, collect_traces)(
        prof.to(dev), gains.to(dev), seeds.to(dev), total_work, max_time,
        dt, summary_warmup)
    if traces is not None:
        traces = {k: v.T.cpu().numpy() for k, v in traces.items()}
    return traces, _final_dict(c)


def open_loop_runs(profile: Union[str, PlantProfile], steps: int,
                   seeds: Sequence[int], pcap: Optional[float] = None,
                   dt: float = 1.0,
                   device: Union[None, str, torch.device] = None) -> dict:
    """Constant-cap open-loop runs batched over seeds (the uncontrolled
    full-power baseline of Fig. 7): `plant.simulate` on each seed's
    `ops.draw_noise` plant channels. Returns the traces as (S, steps)
    tensors and ``energy`` / ``work`` as (S,), on ``device`` (CUDA unless
    told otherwise)."""
    dev = resolve_device(device)
    profile = _resolve(profile)
    pcap = profile.pcap_max if pcap is None else pcap
    seeds = torch.tensor([int(s) for s in seeds], dtype=torch.int64,
                         device=dev)
    # the profile as float32 fields on the device, as the reference
    # unpacks its packed row
    prof = _unpack_profile(profile_values(profile).to(dev))
    pcaps = torch.full((int(steps),), float(pcap), dtype=torch.float32,
                       device=dev)
    noise = ops.draw_noise(seeds, int(steps))[:, :4]
    tr = simulate(prof, pcaps, torch.tensor(float(dt), device=dev), noise)
    # seed-independent traces (the cap, the clean progress) broadcast to
    # every run, as the reference's vmap over seeds returns them
    S = seeds.shape[0]
    return {k: (v.expand(S) if k in ("energy", "work")
                else v.reshape(v.shape[0], -1).expand(-1, S).T).contiguous()
            for k, v in tr.items()}


def replay_model(profile: Union[str, PlantProfile], pcaps, dt: float = 1.0,
                 device: Union[None, str, torch.device] = None
                 ) -> torch.Tensor:
    """Deterministic Eq. 3 replay of a pcap schedule (noise-free model
    prediction, the Fig. 5 accuracy baseline), float32 on ``device``
    (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    prof = _unpack_profile(profile_values(_resolve(profile)).to(dev))
    pcaps = (pcaps.to(device=dev, dtype=torch.float32)
             if isinstance(pcaps, torch.Tensor)
             else torch.as_tensor(np.asarray(pcaps, np.float32),
                                  device=dev))
    dt = torch.tensor(float(dt), dtype=torch.float32, device=dev)
    pl = pcap_linearize(prof, pcaps)
    w = dt / (dt + prof.tau)
    y = pl[0] * prof.K_L
    ys = torch.empty_like(pl)
    for i in range(pl.shape[0]):
        y = prof.K_L * w * pl[i] + (1.0 - w) * y
        ys[i] = y
    return ys + prof.K_L


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

    ``backend="kernel"`` (the default) runs the fused closed-loop op;
    ``backend="scan"`` the Poisson-heartbeat step loop (`_scan_core`),
    whose traces are `_bucket_steps(ceil(max_time / dt))` long, as the
    reference's scan engine makes them. ``typed_pi=`` is accepted as the
    reference accepts it: both engines run the typed fixed-gain PI path.
    The reference's other axes and execution options (``adaptive``,
    ``policies``, ``workloads``, ``detector``, ``faults``, ``guard``,
    ``record_events``, ``chunk_size``, ``devices``, ``durable``, ...)
    raise NotImplementedError naming the ROADMAP item that brings
    them."""
    _reject(adaptive=adaptive, policies=policies, workloads=workloads,
            detector=detector, faults=faults, guard=guard,
            record_events=record_events, chunk_size=chunk_size,
            devices=devices, consume=consume, durable=durable,
            campaign=campaign)
    _check_backend(backend)
    single = isinstance(profiles, (str, PlantProfile))
    profs = [_resolve(p) for p in ([profiles] if single else profiles)]
    prof, gains, seed_rows = grid_rows(profs, epsilons, seeds, tau_obj)
    traces, final = (_run_rows if backend == "kernel" else _scan_rows)(
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
