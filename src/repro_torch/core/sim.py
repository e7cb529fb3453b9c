"""Closed-loop simulation front end (paper Figs. 5-7 at fleet scale);
port of `repro.core.sim`: the fixed-gain PI path, the power policies
(`repro_torch.core.policies`: PI, RLS-adaptive PI, duty-cycle,
offline RL) and the scenario axes (phased workloads and change
detection, `repro_torch.core.workloads`; faults and the guard,
`repro_torch.core.faults`; the flight recorder,
`repro_torch.obs.events`).

The paper's evaluation is thousands of closed-loop runs sweeping the
degradation grid eps across clusters and seeds. Two engines run them:

* ``backend="kernel"``: the fused closed-loop op
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
  window median, the controller (the typed Eq. 4 PI, or any policy
  branch set through the packed policy state), early exit and the online
  summaries, and the scenario inputs: per-run phase schedules, the
  change-point detector, fault scripts, the guard and the event ring.
  It is the engine of every paper figure in the reference.

``backend="auto"`` (the default) is the reference's capability
dispatch, with the card in the TPU's place: a grid whose policies are
all fixed-gain PI (branch set ``("pi",)``) with no scenario axis runs
the kernel route, any other grid the scan engine.

Entry points:

* `simulate_closed_loop(profile, ...)` — one run; trimmed numpy traces.
  ``adaptive=RLSConfig(...)`` / ``policy=`` and the scenario arguments
  (``workload=``, ``detector=``, ``faults=``, ``guard=``,
  ``record_events=``) run it on the scan engine.
* `sweep(profiles, epsilons, seeds, ...)` — the profiles x epsilons
  [x policies] [x workloads] [x detectors] [x faults] x seeds grid as one
  batch of runs, in trace or summary mode.
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

Execution (`repro_torch.core.executor`): both engines are flat-grid
functions over per-run rows, and every grid runs through
`executor.run_grid`: one chunk by default, ``chunk_size=`` bounded
chunks, ``devices=`` shards, ``consume=`` a per-chunk callback,
`sweep_resumable` ``state=`` / ``stop_after=``, and ``durable=dir`` the
campaign supervisor (`repro_torch.core.supervisor`). Each run depends
only on its own row, so every layout equals one-shot bit for bit.
`resume_init` + ``simulate_closed_loop(init=)`` continue a run from
existing plant, controller and scenario state on the scan engine (the
NRM's delegation path, `repro_torch.core.nrm`).

`engine_step(cap_limit=)` clips each run's command to its own limit
(the fleet's per-node allocation, `repro_torch.core.hierarchy`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import executor
from repro_torch.core import faults as flt
from repro_torch.core import poisson
from repro_torch.core import policies as pol
from repro_torch.core import supervisor
from repro_torch.core.adaptive import (RLSConfig, RLSState, rls_init,
                                       rls_pack, rls_unpack)
from repro_torch.core.controller import PIGains, PIState, pi_init, pi_step
from repro_torch.core.plane import gains_values, plane_step, unpack_gains
from repro_torch.core.policies.pi import (PI_RLS_HI, PI_RLS_LO, PIPolicy,
                                         pi_pack)
from repro_torch.core.plant import (PROFILE_FIELDS, PROFILES, PlantProfile,
                                    PlantState, pcap_linearize, plant_init,
                                    plant_step, simulate)
from repro_torch.core.poisson import PoissonStream
from repro_torch.core.workloads.detect import (DET_N_DETECT, DetectorConfig,
                                               detect_init, detect_step,
                                               detector_values)
from repro_torch.core.workloads.schedule import (PhaseSchedule,
                                                 ScheduleValues,
                                                 active_profile, chain_rows)
from repro_torch.counter_rng import unit24
from repro_torch.kernels.closed_loop import ops
from repro_torch.kernels.closed_loop import ref as R
from repro_torch.kernels.closed_loop.ref import (CAP_BINS, PROG_BINS,
                                                 PROG_HIST_SPAN)
from repro_torch.obs import events as evt

def _check_backend(backend: str) -> None:
    if backend not in ("auto", "kernel", "scan"):
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         "backend='kernel' (the fused closed-loop op), "
                         "backend='scan' (the Poisson-heartbeat engine) "
                         "and backend='auto' (the kernel where it covers "
                         "the grid, else the scan engine)")


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
    pi_state: Optional[PIState]  # None for non-PI policies
    plant_state: PlantState
    pcap: float
    summary: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)
    # final estimator (adaptive runs), numpy fields
    rls_state: Optional[RLSState] = None
    # final packed (POLICY_STATE_DIM,) policy state
    policy_state: Optional[np.ndarray] = None
    # final packed detector state (detector= runs); its alarm count is
    # n_phase_changes
    detector_state: Optional[np.ndarray] = None
    # final packed fault state (faults= runs)
    fault_state: Optional[np.ndarray] = None
    # final packed guard state (guard= runs; faults.G_* slots carry the
    # watchdog counters)
    guard_state: Optional[np.ndarray] = None
    # flight-recorder timeline (record_events= runs): decoded records,
    # oldest surviving first (see repro_torch.obs.events)
    events: Optional[list] = None
    # the packed ring itself
    event_state: Optional[np.ndarray] = None

    @property
    def n_events_total(self) -> int:
        """Monotonic count of every event appended (evicted ones too)."""
        return (0 if self.event_state is None
                else evt.ring_total(self.event_state))

    @property
    def n_phase_changes(self) -> int:
        return (0 if self.detector_state is None
                else int(self.detector_state[DET_N_DETECT]))


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Batched runs over profiles x epsilons [x policies] [x workloads]
    [x detectors] [x faults] x seeds.

    Arrays have shape (P, E, S) — (P, E, A, S) for policy/adaptive grids,
    with a W, D or F axis before S for a list of workloads, detector
    configs or fault schedules; traces (..., T) — with the P (A, W) axes
    squeezed away when a single profile (single Policy/RLSConfig, single
    PhaseSchedule) was passed. Frozen (post-completion) steps carry
    `valid == False`. In summary mode (`collect_traces=False`) `traces` is
    None and only `summary` (plus the scalar reductions) is
    materialized."""
    traces: Optional[Dict[str, np.ndarray]]
    exec_time: np.ndarray
    energy: np.ndarray
    work: np.ndarray
    completed: np.ndarray
    n_steps: np.ndarray
    summary: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)
    # per-run change-point alarm counts (detector= sweeps), else None
    detections: Optional[np.ndarray] = None
    # per-run final guard state (..., GUARD_STATE_DIM) for guard= sweeps
    guard_state: Optional[np.ndarray] = None
    # per-run packed flight-recorder rings (..., ring_dim) for
    # record_events= sweeps; decode with repro_torch.obs.events.decode_grid
    events: Optional[np.ndarray] = None

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


def _kernel_core(collect: bool):
    """The fused closed-loop op as a flat-grid engine for the executor:
    (rows {"prof" (B, 14), "gains" (B, 9), "seeds" (B,)}, total_work,
    max_time, dt, summary_from) -> (traces (B, T) per key | None, the
    kernel's final dict), tensors on the rows' device. It is the
    reference's ``backend="pallas"`` arm: every run's noise is
    `ops.draw_noise` of its own seed, so any slice of a grid computes the
    one-shot rows."""

    def flat(b, total_work, max_time, dt, summary_from):
        traces, final = ops.closed_loop_sim(
            b["prof"], b["gains"], b["seeds"], total_work=float(total_work),
            max_time=float(max_time), dt=float(dt),
            summary_from=float(summary_from), collect=collect)
        if traces is not None:
            traces = {k: v.T for k, v in traces.items()}
            traces["valid"] = traces["valid"] > 0.5
        return traces, final

    return flat


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
    """The engine's per-run state, (B,) leaves. ``pol`` is the typed
    `PIState` (the fixed-gain PI fast path) or the packed (B,
    POLICY_STATE_DIM) policy state. The scenario fields are None when
    their axis is off, so a scenario-free carry keeps the structure (and
    the arithmetic) of the engine without them: ``det`` the detector state
    (B, DET_STATE_DIM), ``fstate`` the fault state (B, FAULT_STATE_DIM),
    ``guard`` the guard state (B, GUARD_STATE_DIM), ``events`` the
    flight-recorder rings (B, ring_dim)."""
    plant: PlantState
    pol: Union[PIState, torch.Tensor]
    pcap: torch.Tensor        # command applied next period [W]
    anchor_gap: torch.Tensor  # time from last beat to window start [s]
    has_anchor: torch.Tensor  # bool: any beat ever fired
    t: torch.Tensor           # simulated time [s]
    steps: torch.Tensor       # int32 live (pre-completion) step count
    done: torch.Tensor        # bool: total_work or max_time reached
    summ: _Summary
    det: Optional[torch.Tensor] = None
    fstate: Optional[torch.Tensor] = None
    guard: Optional[torch.Tensor] = None
    events: Optional[torch.Tensor] = None


def _default_init(profile: PlantProfile, gains: PIGains, policy=("pi",),
                  policy_vals=None, typed_pi: Optional[bool] = None,
                  schedule: Optional[ScheduleValues] = None,
                  det_vals=None, faults: Optional[flt.FaultValues] = None,
                  guard=None, n_events: int = 0) -> _Carry:
    """Fresh carry for runs with (B,)-tensor profile and gain fields: the
    typed `PIState` on the fast path, else ``policy``'s packed init from
    its (B, POLICY_PARAM_DIM) ``policy_vals`` rows (zeros when None).
    ``typed_pi=None`` picks the typed path for ``("pi",)`` without
    values (the port's engine entry points default to it).

    A scheduled run starts in its phase-0 plant (the base profile only
    gives the actuator and design context); ``det_vals`` (B,
    DET_PARAM_DIM) starts the detector, ``faults`` the fault state,
    ``guard`` (any guard vector) the guard state and ``n_events`` > 0 an
    empty ring of that many slots per run."""
    plant_prof = (profile if schedule is None else _unpack_profile(
        active_profile(schedule, torch.zeros_like(schedule.period))[0]))
    ps = plant_init(plant_prof)
    z = torch.zeros_like(ps.progress_l)
    f = torch.zeros_like(ps.dropped)
    if typed_pi is None:
        typed_pi = pol.as_branches(policy) == ("pi",) and policy_vals is None
    if typed_pi:
        pol_s = PIState(prev_error=z, prev_pcap_l=pi_init(gains).prev_pcap_l)
    else:
        if policy_vals is None:
            policy_vals = z.new_zeros(z.shape + (pol.POLICY_PARAM_DIM,))
        pol_s = pol.branch_init(policy)(policy_vals, gains)
    return _Carry(plant=ps, pol=pol_s,
                  pcap=profile.pcap_max.clone(),
                  anchor_gap=z, has_anchor=f, t=z,
                  steps=torch.zeros_like(z, dtype=torch.int32),
                  done=f, summ=_summary_init(z),
                  det=(None if det_vals is None
                       else detect_init(det_vals, gains)),
                  fstate=(None if faults is None
                          else flt.fault_state_init(profile)),
                  guard=(None if guard is None
                         else flt.guard_init(z.shape, z.device)),
                  events=(evt.ring_init(n_events, z.shape, z.device)
                          if n_events else None))


def _check_carry(c: _Carry, **axes) -> None:
    """Each scenario input given exactly when the carry holds its state."""
    for name, field in (("detector", "det"), ("faults", "fstate"),
                        ("guard", "guard")):
        if (axes[name] is None) != (getattr(c, field) is None):
            raise ValueError(
                f"{name}= and the carry's {field} state must come together; "
                "build the carry with _default_init(..., "
                f"{'det_vals' if name == 'detector' else name}=...)")


def engine_step(profile: PlantProfile, gains: PIGains, c: _Carry,
                total_work, max_time, dt, noise: torch.Tensor,
                sampler: Callable[[torch.Tensor], torch.Tensor], *,
                policy=("pi",), policy_vals=None, cap_limit=None,
                summary_from=0.0, schedule=None, detector=None,
                typed_pi: Optional[bool] = None, faults=None, guard=None,
                fault_u: Optional[torch.Tensor] = None):
    """One fused control period over a batch of runs: plant (Eq. 3) ->
    heartbeat median (Eq. 1) -> power-policy command, with
    early-exit-by-mask freezing and online summary reduction.

    ``profile`` / ``gains`` hold (B,) tensor fields (`_unpack_profile`,
    `plane.unpack_gains`); the scalars are 0-dim float32 tensors. The
    reference's period key becomes explicit inputs: ``noise``, the
    plant's (4, B) draws (`plant_step`), ``sampler``, a callable from the
    (B,) heartbeat rates lam = max(progress, 0) * dt to (B,) integer
    counts (`PoissonStream`, or the reference's own draws in a parity
    test), and with ``faults`` ``fault_u``, the (B,) uniforms in [0, 1)
    of the meter-spike draw. `summary_from` excludes the first steps
    from the online summaries only.

    The controller is the typed Eq. 4 PI when ``c.pol`` is a `PIState`
    (``typed_pi``, the reference's single-branch fast path), else the
    `repro_torch.core.policies` contract through `plane_step`: ``policy``
    is a branch-name tuple or a Policy (more than one name: each row runs
    the branch of its kind, ``policy_vals[:, 0]``) and ``policy_vals``
    the (B, POLICY_PARAM_DIM) packed hyperparameters; the branch set's
    trace extras join ``out``. Both paths make the same float ops in the
    same order for ("pi",), so their trajectories are equal bit for bit.
    ``typed_pi=None`` follows the carry.

    Scenario inputs, each None when off (and then no op of it runs):

    * ``schedule`` (per-run `ScheduleValues`): the plant's parameters are
      gathered from the active phase by sim time each period, while the
      gains and actuator context stay the base design's; ``phase`` trace.
    * ``detector`` ((B, DET_PARAM_DIM) `detector_values` rows): the
      Page-Hinkley detector on progress residuals; an alarm applies the
      policy's `on_change` hook and sets `PolicyObs.phase_change`;
      ``phase_change`` trace. On the typed path too (fixed-gain PI's
      on_change is the identity).
    * ``faults`` (per-run `FaultValues`): actuator faults before the
      plant step, crashes (no work, idle power, progress_l pinned to
      -K_L), heartbeat dropout (the floor of the kept fraction) and
      staleness, meter freeze, bias and spike. The controller sees the
      corrupted observations; the ``power`` trace holds the OBSERVED
      reading while the summary accumulates the TRUE one;
      ``fault_active`` trace.
    * ``guard`` (a `faults.guard_values` vector): the guarded-degradation
      layer in `plane_step`; ``guard_mode`` trace.
    * the recorder (``c.events`` not None): edge-triggered appends of
      phase flips, fault enter/exit, detector alarms, guard HOLD /
      FAILSAFE / recover and recovery resets, all gated on the live mask.

    Faults, guard and recorder need the packed path, as in the
    reference. ``cap_limit`` (a number or (B,) per run) clips the
    policy's command, ``min(pcap, cap_limit)``, on either path, before the
    early-exit freeze (`torch.minimum`, which keeps a NaN as
    ``jnp.minimum`` does): the fleet's per-node budget allocation.

    Returns (new_carry, out) where out holds this period's trace row."""
    branches = pol.as_branches(policy)
    typed = isinstance(c.pol, PIState)
    if (typed or typed_pi) and branches != ("pi",):
        raise ValueError("typed_pi is the single-branch ('pi',) fast "
                         f"path; got branches {branches}")
    if typed_pi is not None and bool(typed_pi) != typed:
        raise ValueError(
            f"typed_pi={typed_pi}, but the carry's policy state is "
            f"{'typed' if typed else 'packed'}; build the carry with "
            "_default_init(..., typed_pi=...)")
    if typed and (faults is not None or guard is not None):
        raise ValueError("typed_pi is the guard-free fixed-gain PI fast "
                         "path; faults=/guard= need the packed engine")
    if typed and c.events is not None:
        raise ValueError("typed_pi is the recorder-free fixed-gain PI "
                         "fast path; event recording needs the packed "
                         "engine")
    if faults is not None and fault_u is None:
        raise ValueError("faults= needs fault_u, the meter-spike uniforms")
    _check_carry(c, detector=detector, faults=faults, guard=guard)
    if not typed and policy_vals is None:
        policy_vals = c.pol.new_zeros(c.pol.shape[:-1]
                                      + (pol.POLICY_PARAM_DIM,))
    if schedule is None:
        plant_prof, phase_idx = profile, None
    else:
        vals, phase_idx = active_profile(schedule, c.t)
        plant_prof = _unpack_profile(vals)
    if faults is not None:
        af = flt.fault_channels(faults, c.t)
        applied = flt.apply_actuator(af, c.fstate, c.pcap,
                                     plant_prof.pcap_min)
    else:
        applied = c.pcap
    plant_s, meas = plant_step(plant_prof, c.plant, applied, dt, noise)
    t = c.t + dt
    if faults is not None:
        crash = af.crash > 0
        idle = plant_prof.power_of_pcap(plant_prof.pcap_min)
        # a crashed tenant does no work and burns idle power; progress_l
        # pins to -K_L (true progress 0) so the restart comes up cold
        plant_s = PlantState(
            progress_l=torch.where(crash, -plant_prof.K_L,
                                   plant_s.progress_l),
            dropped=plant_s.dropped,
            energy=torch.where(crash, c.plant.energy + idle * dt,
                               plant_s.energy),
            work=torch.where(crash, c.plant.work, plant_s.work))
        true_power = torch.where(crash, idle, meas["power"])
    # synthesize heartbeats at the measured rate (Eq. 1 input)
    n = sampler(torch.clamp(meas["progress"], min=0.0) * dt)
    if faults is not None:
        # dropout thins the window deterministically (floor of the kept
        # fraction); a crashed tenant emits no beats at all
        nf = torch.floor(n.to(torch.float32)
                         * (1.0 - torch.clamp(af.hb_drop, 0.0, 1.0)))
        n = torch.where(af.hb_drop > 0, nf.to(n.dtype), n)
        n = torch.where(crash, torch.zeros_like(n), n)
    progress = _window_median(n, c.anchor_gap, c.has_anchor, dt)
    anchor_gap = torch.where(
        n > 0, 0.5 * dt / torch.clamp(n.to(torch.float32), min=1.0),
        c.anchor_gap + dt)
    has_anchor = c.has_anchor | (n > 0)
    if faults is not None:
        # sensor-side corruption: what the CONTROLLER observes (the plant
        # integrals above stay truthful)
        last = lambda i: c.fstate[..., i]
        prog_obs = torch.where(af.hb_stale > 0, last(flt.F_LAST_PROGRESS),
                               progress)
        healthy = torch.where(af.meter_freeze > 0, last(flt.F_LAST_POWER),
                              true_power)
        pw = healthy + af.meter_bias
        spike = fault_u < af.meter_spike_p
        spike_v = torch.where(af.meter_spike_v != 0.0, af.meter_spike_v,
                              float("nan"))
        power_obs = torch.where(spike, spike_v, pw)
        fstate_n = torch.stack([prog_obs, healthy, c.pcap, applied,
                                af.crash, torch.zeros_like(af.crash)], -1)
        f_any = ((af.hb_drop > 0) | (af.hb_stale > 0)
                 | (af.meter_freeze > 0) | (af.meter_bias != 0)
                 | (af.meter_spike_p > 0) | (af.act_stuck_on > 0)
                 | (af.act_quant > 0) | (af.act_delay > 0)
                 | crash).to(torch.float32)
    else:
        prog_obs, power_obs = progress, meas["power"]
        fstate_n = c.fstate

    gmode = None
    guard_s = c.guard
    if typed:
        # single-branch PI fast path: the detector still runs (fixed-gain
        # PI's on_change is the identity, so no dispatch is needed)
        if detector is None:
            det_s, change = c.det, None
        else:
            det_s, detected = detect_step(detector, c.det, progress,
                                          gains.linearize(c.pcap), dt)
            change = detected.to(torch.float32)
        pol_s, pcap = pi_step(gains, c.pol, progress, dt)
    elif guard is None:
        # the control plane's single control-law code path; the
        # controller sees the OBSERVED telemetry
        pol_s, det_s, pcap, change = plane_step(
            gains, policy, policy_vals, c.pol, c.pcap, prog_obs, power_obs,
            dt, det_vals=detector, det_state=c.det)
    else:
        pol_s, det_s, pcap, change, guard_s, gmode = plane_step(
            gains, policy, policy_vals, c.pol, c.pcap, prog_obs, power_obs,
            dt, det_vals=detector, det_state=c.det, guard_vals=guard,
            guard_state=c.guard)
    if cap_limit is not None:
        pcap = torch.minimum(pcap, torch.as_tensor(
            cap_limit, dtype=pcap.dtype, device=pcap.device))

    # early-exit-by-mask: freeze everything once done
    frz = lambda new, old: torch.where(c.done, old, new)
    rows = lambda new, old: (None if new is None else
                             torch.where(c.done[..., None], old, new))
    plant_s = PlantState(*map(frz, plant_s, c.plant))
    pol_s = (PIState(*map(frz, pol_s, c.pol)) if typed
             else rows(pol_s, c.pol))
    det_s = rows(det_s, c.det)
    guard_s = rows(guard_s, c.guard)
    fstate_n = rows(fstate_n, c.fstate)
    pcap = frz(pcap, c.pcap)
    anchor_gap = frz(anchor_gap, c.anchor_gap)
    has_anchor = frz(has_anchor, c.has_anchor)
    t = frz(t, c.t)
    zero = torch.zeros_like(progress)
    progress = torch.where(c.done, zero, prog_obs)
    power = torch.where(c.done, zero,
                        meas["power"] if faults is None else true_power)
    if detector is not None:
        change = torch.where(c.done, zero, change)

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
    if faults is not None:
        # the trace keeps the OBSERVED reading (what the controller was
        # fed); the summary above accumulated the true one
        out["power"] = torch.where(c.done, zero, power_obs)
        out["fault_active"] = torch.where(c.done, zero, f_any)
    if guard is not None:
        out["guard_mode"] = torch.where(c.done, zero, gmode)
    if schedule is not None:
        out["phase"] = torch.where(c.done, -1, phase_idx)
    if detector is not None:
        out["phase_change"] = change
    if not typed:
        out.update(pol.branch_extras(policy)(pol_s))
    ev = None if c.events is None else _record(
        c, t, progress, pcap, phase_idx, change, gmode, guard_s,
        (af, f_any) if faults is not None else None)
    return _Carry(plant_s, pol_s, pcap, anchor_gap, has_anchor, t,
                  c.steps + (~c.done).to(torch.int32), done, summ,
                  det_s, fstate_n, guard_s, ev), out


def _record(c: _Carry, t, progress, pcap, phase_idx, change, gmode,
            guard_s, fault) -> torch.Tensor:
    """The flight recorder's edge-triggered appends for one period, into
    one copy of the carry's rings; every append is gated on the live
    mask, so a frozen run's ring stays untouched."""
    ev = c.events.clone()
    live = ~c.done
    if phase_idx is not None:
        prev_phase = ev[..., evt.H_PREV_PHASE].clone()
        phase_f = phase_idx.to(torch.float32)
        evt.ring_append_(ev, live & (prev_phase >= 0)
                         & (phase_f != prev_phase), c.t, evt.EV_PHASE_FLIP,
                         evt.SRC_SCHEDULE, prev_phase, phase_f)
        ev[..., evt.H_PREV_PHASE] = torch.where(live, phase_f, prev_phase)
    if fault is not None:
        af, f_any = fault
        prev_f = ev[..., evt.H_PREV_FAULT].clone()
        evt.ring_append_(ev, live & (f_any > 0) & (prev_f <= 0), t,
                         evt.EV_FAULT_ENTER, evt.SRC_FAULTS, af.crash,
                         af.hb_drop, af.meter_freeze)
        evt.ring_append_(ev, live & (f_any <= 0) & (prev_f > 0), t,
                         evt.EV_FAULT_EXIT, evt.SRC_FAULTS)
        ev[..., evt.H_PREV_FAULT] = torch.where(live, f_any, prev_f)
    if c.det is not None:
        evt.ring_append_(ev, live & (change > 0), t, evt.EV_DETECTOR_ALARM,
                         evt.SRC_DETECTOR, progress, pcap)
    if gmode is not None:
        prev_mode = c.guard[..., flt.G_MODE]
        stale = guard_s[..., flt.G_STALE]
        evt.ring_append_(ev, live & (gmode >= flt.GUARD_HOLD)
                         & (prev_mode < flt.GUARD_HOLD), t,
                         evt.EV_GUARD_HOLD, evt.SRC_GUARD, stale, pcap)
        evt.ring_append_(ev, live & (gmode >= flt.GUARD_FAILSAFE)
                         & (prev_mode < flt.GUARD_FAILSAFE), t,
                         evt.EV_GUARD_FAILSAFE, evt.SRC_GUARD, stale, pcap,
                         guard_s[..., flt.G_N_INVALID])
        evt.ring_append_(ev, live & (gmode < flt.GUARD_HOLD)
                         & (prev_mode >= flt.GUARD_HOLD), t,
                         evt.EV_GUARD_RECOVER, evt.SRC_GUARD, prev_mode,
                         pcap)
        evt.ring_append_(ev, live & (guard_s[..., flt.G_N_RESETS]
                                     > c.guard[..., flt.G_N_RESETS]), t,
                         evt.EV_RECOVERY_RESET, evt.SRC_GUARD,
                         guard_s[..., flt.G_N_RESETS], pcap)
    return ev


# The meter-spike draw's stream word: after `draw_noise`'s words 0-7 and
# the Poisson sampler's, so a faults=None run draws exactly what it drew
# before faults existed, and each run's word depends only on its seed.
FAULT_WORD = poisson.FIRST_WORD + poisson.N_WORDS


def _scan_core(max_steps: int, collect: bool = True, branches=("pi",),
               typed_pi: bool = True, n_events: int = 0):
    """Closed-loop runs over a batch: (profile_vals (B, 14), gains_vals
    (B, 9), seeds (B,) int64, total_work, max_time, dt, summary_from[,
    policy_vals (B, POLICY_PARAM_DIM)], *, sched, det_vals, fvals, gvals,
    init) -> (traces (T, B) per key | None, final carry), all on the rows'
    device. ``init`` (a (B,)-row `_Carry`, from `resume_init`) replaces
    the fresh carry; it must hold a packed policy state. ``typed_pi``
    runs the typed fixed-gain PI path; otherwise the packed policy state
    of the branch set ``branches``, each run's hyperparameters and kind
    in its ``policy_vals`` row (zeros when None), and the set's trace
    extras. The scenario inputs are per-run rows (`ScheduleValues` (B,
    rows, ...), detector values (B, DET_PARAM_DIM), `FaultValues` (B,
    MAX_FAULT_ROWS)) and the grid-wide guard vector, each None when off;
    ``n_events`` > 0 carries a ring of that many slots per run.

    Each run's plant noise is `ops.draw_noise` of its seed (channels 0-3,
    drawn `ops.CHUNK_T` steps at a time), its heartbeat counts come from
    a `PoissonStream` of its seed, and its meter-spike uniforms from the
    counter stream `FAULT_WORD` of its seed, so a run depends only on its
    own row. The loop makes no host sync; after it, one check that every
    Poisson draw resolved."""

    def run(profile_vals, gains_vals, seeds, total_work, max_time, dt,
            summary_from, policy_vals=None, *, sched=None, det_vals=None,
            fvals=None, gvals=None, init=None):
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
        if not typed_pi:
            policy_vals = (torch.zeros((seeds.shape[0],
                                        pol.POLICY_PARAM_DIM), device=dev)
                           if policy_vals is None else policy_vals.to(
                               device=dev, dtype=torch.float32))
        c = (_default_init(profile, gains, branches, policy_vals, typed_pi,
                           sched, det_vals, fvals, gvals, n_events)
             if init is None else init)
        fault_keys = (None if fvals is None
                      else ops.seed_keys(seeds, FAULT_WORD))
        traces = None
        for t0 in range(0, max_steps, ops.CHUNK_T):
            n_t = min(ops.CHUNK_T, max_steps - t0)
            noise = ops.draw_noise(seeds, n_t, t0=t0)
            for j in range(n_t):
                i = t0 + j
                fault_u = (None if fault_keys is None else unit24(
                    ops.stream_words(fault_keys, ops.step_hash(i)))[0])
                c, out = engine_step(
                    profile, gains, c, tw, mt, dt, noise[j, :4],
                    lambda lam: stream(lam, i), policy=branches,
                    policy_vals=policy_vals, typed_pi=typed_pi,
                    summary_from=sf, schedule=sched, detector=det_vals,
                    faults=fvals, guard=gvals, fault_u=fault_u)
                if collect:
                    if traces is None:  # the keys: the row's, extras too
                        traces = {k: torch.empty((max_steps,) + v.shape,
                                                 dtype=v.dtype, device=dev)
                                  for k, v in out.items()}
                    for k, v in out.items():
                        traces[k][i] = v
        stream.check()
        return traces, c

    return run


# the scenario fields of a final carry, by their result names
_SCENARIO_STATE = (("det", "detector_state"), ("fstate", "fault_state"),
                   ("guard", "guard_state"), ("events", "event_state"))


def _final_tensors(c: _Carry) -> Dict[str, torch.Tensor]:
    """An engine carry as the kernel route's final dict (`ref.init_state`
    keys; flags and step counts as float32), on the carry's device, so
    both backends share one result assembly; a packed policy state also
    comes back whole, as ``policy_state``, and each scenario state under
    its result name (``detector_state``, ``fault_state``,
    ``guard_state``, ``event_state``)."""
    packed = not isinstance(c.pol, PIState)
    pi = PIState(c.pol[..., 0], c.pol[..., 1]) if packed else c.pol
    f = {"progress_l": c.plant.progress_l, "dropped": c.plant.dropped,
         "energy": c.plant.energy, "work": c.plant.work,
         "prev_error": pi.prev_error, "prev_pcap_l": pi.prev_pcap_l,
         "pcap": c.pcap, "anchor_gap": c.anchor_gap,
         "has_anchor": c.has_anchor, "t": c.t, "steps": c.steps,
         "done": c.done, **c.summ._asdict()}
    if packed:
        f["policy_state"] = c.pol
    for field, name in _SCENARIO_STATE:
        if getattr(c, field) is not None:
            f[name] = getattr(c, field)
    return {k: v.to(torch.float32) for k, v in f.items()}


def _scan_flat(max_steps: int, collect: bool, branches=("pi",),
               typed_pi: bool = True, n_events: int = 0):
    """The scan engine as a flat-grid engine for the executor: (rows
    {"prof", "gains", "seeds"[, "pvals", "sched", "det", "faults",
    "init"]}, total_work, max_time, dt, summary_from[, guard vector]) ->
    (traces (B, T) per key | None, final dict), tensors on the rows'
    device. Each run depends only on its own row (`_scan_core`), so any
    slice of a grid computes the one-shot rows."""
    run = _scan_core(max_steps, collect, tuple(branches), typed_pi,
                     n_events)

    def flat(b, total_work, max_time, dt, summary_from, gvals=None):
        traces, c = run(b["prof"], b["gains"], b["seeds"], total_work,
                        max_time, dt, summary_from, b.get("pvals"),
                        sched=b.get("sched"), det_vals=b.get("det"),
                        fvals=b.get("faults"), gvals=gvals,
                        init=b.get("init"))
        if traces is not None:
            traces = {k: v.T for k, v in traces.items()}
        return traces, _final_tensors(c)

    return flat


def _execute(fn, batched, shared, n_runs: int, *, device, chunk_size=None,
             devices=None, consume=None, state=None, stop_after=None,
             durable=None, campaign=None):
    """A flat grid through `executor.run_grid`, or the campaign supervisor
    with ``durable=`` -> (merged (traces, final) numpy | None,
    ExecState)."""
    if durable is not None:
        merged, report = supervisor.run_durable(
            fn, batched, shared, n_runs, dir=durable,
            chunk_size=chunk_size, devices=devices, device=device,
            consume=consume, config=campaign)
        return merged, report.state
    return executor.run_grid(fn, batched, shared, n_runs,
                             chunk_size=chunk_size, devices=devices,
                             device=device, consume=consume, state=state,
                             stop_after=stop_after)


def _scan_batch(scen: "_Scenario", batched: dict) -> tuple:
    """Add a batch's per-run scenario rows to its executor rows; the
    shared tail: the grid-wide guard vector, when armed."""
    for name, v in (("sched", scen.sched), ("det", scen.det),
                    ("faults", scen.faults)):
        if v is not None:
            batched[name] = v
    return () if scen.guard is None else (scen.guard,)


class _Scenario(NamedTuple):
    """A batch's scenario inputs as per-run rows on the host (each None
    when off): schedules, detector values, fault rows, the guard vector
    and the ring size."""
    sched: Optional[ScheduleValues] = None
    det: Optional[torch.Tensor] = None
    faults: Optional[flt.FaultValues] = None
    guard: Optional[torch.Tensor] = None
    n_events: int = 0

    @property
    def on(self) -> bool:
        return (self.sched is not None or self.det is not None
                or self.faults is not None or self.guard is not None
                or self.n_events > 0)

    def inputs(self, device) -> Dict[str, object]:
        """The `_scan_core` run's scenario keywords, on ``device``."""
        to = lambda x: None if x is None else (
            type(x)(*(v.to(device) for v in x)) if isinstance(x, tuple)
            else x.to(device))
        return dict(sched=to(self.sched), det_vals=to(self.det),
                    fvals=to(self.faults), gvals=to(self.guard))


def _resolve_n_events(record_events: Union[None, bool, int]) -> int:
    """record_events= sugar -> the ring's slot count (0 = recorder off).
    True picks the default ring; an int sizes it explicitly."""
    if record_events is None or record_events is False:
        return 0
    if record_events is True:
        return evt.DEFAULT_MAX_EVENTS
    n = int(record_events)
    if n < 1:
        raise ValueError(f"record_events= wants True or a positive ring "
                         f"size, got {record_events!r}")
    return n


def _guard_vector(guard) -> Optional[torch.Tensor]:
    """guard= (None / False, True, or a GuardConfig) -> its vector."""
    if not guard:
        return None
    return flt.guard_values(None if guard is True else guard, device="cpu")


def _host_f32(x) -> torch.Tensor:
    """A state leaf (tensor on any device, numpy or float) as a float32
    CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def resume_init(plant: PlantState, pi: PIState, pcap,
                rls: Optional[RLSState] = None, policy_state=None,
                det_state=None, t0=0.0, fault_state=None, guard_state=None,
                event_state=None) -> _Carry:
    """Carry that resumes a run from existing plant / controller (and
    optionally RLS estimator) state: the NRM delegation path; the
    heartbeat window and the per-run summaries start fresh. Pass
    ``policy_state`` (a packed (POLICY_STATE_DIM,) vector from
    `SimResult.policy_state`) to resume a non-PI policy; otherwise the
    PI / RLS states are packed into the PI branch's layout, tagged.
    ``det_state``, ``fault_state``, ``guard_state`` and ``event_state``
    (the packed vectors of `SimResult`) resume the detector, the fault
    script's state, the guard and the flight recorder: the next segment
    keeps appending to the same ring, so its monotonic total spans the
    whole resumed run.

    ``t0`` sets the carried sim time the segment starts at. It defaults
    to 0 (each segment gets its own `max_time` budget: the NRM path),
    but a workload-scripted run gathers its active phase by this clock:
    pass the previous segment's `exec_time` so the schedule continues
    instead of restarting at phase 0 (`max_time` is then measured on the
    same absolute clock).

    Leaves of any device or numpy come back as CPU tensors of the
    engine's dtypes; ``simulate_closed_loop(init=)`` moves the carry to
    the device it runs on."""
    if policy_state is None:
        vec = pi_pack(PIState(_host_f32(pi.prev_error),
                              _host_f32(pi.prev_pcap_l)),
                      None if rls is None else rls_pack(
                          RLSState(*(_host_f32(x) for x in rls))))
        vec[pol.BRANCH_TAG_SLOT] = float(pol.branch_tag(
            "pi_rls" if rls is not None else "pi"))
    else:
        vec = _host_f32(policy_state).clone()
    z = torch.zeros((), dtype=torch.float32)
    f = torch.zeros((), dtype=torch.bool)
    opt = lambda x: None if x is None else _host_f32(x).clone()
    return _Carry(plant=PlantState(
                      progress_l=_host_f32(plant.progress_l),
                      dropped=_host_f32(plant.dropped) > 0.5,
                      energy=_host_f32(plant.energy),
                      work=_host_f32(plant.work)),
                  pol=vec, pcap=_host_f32(pcap), anchor_gap=z,
                  has_anchor=f, t=_host_f32(t0),
                  steps=torch.zeros((), dtype=torch.int32), done=f,
                  summ=_Summary(count=z, progress_sum=z, progress_sq_sum=z,
                                power_sum=z,
                                progress_hist=torch.zeros(PROG_BINS),
                                pcap_hist=torch.zeros(CAP_BINS)),
                  det=opt(det_state), fstate=opt(fault_state),
                  guard=opt(guard_state), events=opt(event_state))


def _resume_fixups(init: _Carry, branch: str, pvals: torch.Tensor,
                   gains: PIGains, profile: PlantProfile, dv, fv, gvl,
                   n_events: int) -> _Carry:
    """The reference's host-side checks of a resume carry against the run
    it starts: the policy branch must match (fixed-gain PI state upgrades
    to adaptive PI with a fresh estimator), and each scenario input must
    come with its state (a fresh one is made for an input the carry
    predates; a state without its input raises)."""
    src = pol.tag_branch(int(init.pol[pol.BRANCH_TAG_SLOT]))
    if src is not None and src != branch and not (
            src == "pi" and branch == "pi_rls"):
        # the one allowed upgrade is pi -> pi_rls (fresh estimator
        # below); anything else would silently misread the slots
        raise ValueError(
            f"init policy state was produced by branch '{src}' but this "
            f"run dispatches '{branch}'; resume with the same policy (pi "
            "state does upgrade to adaptive pi)")
    rls_block = init.pol[PI_RLS_LO:PI_RLS_HI]
    if branch == "pi_rls" and not bool(rls_block.any()):
        # resume carry predates the estimator: start a fresh one so
        # adaptive= is honoured rather than silently dropped
        vec = init.pol.clone()
        vec[PI_RLS_LO:PI_RLS_HI] = rls_pack(rls_init(pvals[1:7], gains.k_p,
                                                     gains.k_i))
        vec[pol.BRANCH_TAG_SLOT] = float(pol.branch_tag("pi_rls"))
        init = init._replace(pol=vec)
    elif branch == "pi" and bool(rls_block.any()):
        raise ValueError("init carries RLS state but adaptive=None; pass "
                         "the RLSConfig so the estimator's params are "
                         "given")
    for name, field, given, fresh in (
            ("detector", "det", dv,
             lambda: detect_init(dv[0], gains)),
            ("faults", "fstate", fv,
             lambda: flt.fault_state_init(profile, device="cpu")),
            ("guard", "guard", gvl,
             lambda: flt.guard_init((), device="cpu"))):
        if given is not None and getattr(init, field) is None:
            init = init._replace(**{field: fresh()})
        elif given is None and getattr(init, field) is not None:
            raise ValueError(f"init carries {name} state but {name}=None; "
                             f"pass the {name} so its params are given")
    if n_events and init.events is None:
        # resume carry predates the recorder: start an empty ring
        init = init._replace(events=evt.ring_init(n_events, (), "cpu"))
    elif not n_events and init.events is not None:
        raise ValueError("init carries a flight-recorder ring but "
                         "record_events=None; pass record_events so the "
                         "ring stays in the carry")
    elif (init.events is not None
          and evt.ring_capacity(init.events) != n_events):
        raise ValueError(
            f"init ring has {evt.ring_capacity(init.events)} slots but "
            f"record_events={n_events}; resume with the same ring size")
    return init


def _carry_rows(c):
    """An unbatched carry (tree of tensors) as a batch of one run."""
    if c is None:
        return None
    if isinstance(c, tuple):
        return type(c)(*(_carry_rows(x) for x in c))
    return c[None]


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
                         init=None, adaptive: Optional[RLSConfig] = None,
                         design: Optional[PlantProfile] = None,
                         policy: Optional[pol.Policy] = None,
                         workload: Optional[PhaseSchedule] = None,
                         detector: Optional[DetectorConfig] = None,
                         faults: Optional[flt.FaultSchedule] = None,
                         guard: Union[None, bool, flt.GuardConfig] = None,
                         record_events: Union[None, bool, int] = None
                         ) -> SimResult:
    """One closed-loop run.

    Pass either `epsilon` (gains placed from the profile's identified
    model) or explicit `gains` (e.g. designed on a different profile, as
    in the gain-shift experiments). With none of ``policy``,
    ``adaptive``, ``design`` and the scenario arguments the run goes
    through the fused closed-loop op (the kernel route; its noise stream
    that of `ops.draw_noise` for ``seed``, generated inside the kernel on
    CUDA). Otherwise it runs on the scan engine, as the reference always
    does: ``policy=`` any Policy, ``adaptive=RLSConfig(...)`` sugar for
    ``policy=PIPolicy(adaptive=...)`` (the RLS estimator re-places the PI
    gains online), ``design`` the model the initial gains were placed on
    (defaults to the plant profile; the estimator and the detector
    linearize against it).

    Scenarios (see `engine_step`): ``workload=PhaseSchedule(...)``
    scripts a time-varying plant (traces gain ``phase``);
    ``detector=DetectorConfig(...)`` runs the change-point detector
    (traces gain ``phase_change``; `SimResult.detector_state`);
    ``faults=FaultSchedule(...)`` scripts telemetry and actuator faults
    (traces gain ``fault_active``; ``power`` is the observed reading);
    ``guard=GuardConfig(...)`` (or True) arms the guard (traces gain
    ``guard_mode``; `SimResult.guard_state`); ``record_events=True`` (or
    a ring size) arms the flight recorder (`SimResult.events`, the
    decoded timeline, and `event_state`, the ring). Faults, guard and
    recorder run the packed ("pi",) engine when no policy is given.

    ``init`` (a carry from `resume_init`) continues a previous run from
    its plant, controller (estimator, policy) and scenario state, on the
    packed scan engine: the kernel starts every run from a fresh carry.
    The carry is checked against the run (`_resume_fixups`): the policy
    branch must match, and a scenario input the carry predates gets a
    fresh state. Runs on CUDA unless ``device="cpu"``."""
    if policy is not None and adaptive is not None:
        raise ValueError("pass policy= or adaptive=, not both "
                         "(adaptive= is sugar for PIPolicy(adaptive=...))")
    if policy is not None and design is not None:
        raise ValueError("design= only applies to the adaptive= sugar; "
                         "give the policy its design model directly "
                         "(PIPolicy(adaptive=..., design=...))")
    profile = _resolve(profile)
    if gains is None:
        if epsilon is None:
            raise ValueError("pass epsilon or gains")
        gains = PIGains.from_model(profile, epsilon, tau_obj)
    n_events = _resolve_n_events(record_events)
    det_design = _resolve(design) if design is not None else profile
    scen = _Scenario(
        sched=(None if workload is None else ScheduleValues(*(
            torch.as_tensor(np.asarray(x))[None]
            for x in workload.pack(profile)))),
        det=(None if detector is None else detector_values(
            detector, det_design, device="cpu")[None]),
        faults=(None if faults is None
                else flt.FaultValues(*(torch.as_tensor(np.asarray(x))[None]
                                       for x in faults.pack()))),
        guard=_guard_vector(guard), n_events=n_events)
    given = not (policy is None and adaptive is None and design is None)
    # a resumed run carries a packed policy state: the packed scan engine
    packed = given or init is not None or scen.faults is not None \
        or scen.guard is not None or n_events > 0
    if policy is None:
        policy = PIPolicy(adaptive=adaptive,
                          design=None if design is None
                          else _resolve(design))
    branch = policy.branch
    pvals = pol.policy_values(policy, profile, gains)
    batched = {"prof": profile_values(profile)[None],
               "gains": gains_values(gains)[None],
               "seeds": torch.tensor([seed], dtype=torch.int64)}
    shared = (total_work, max_time, dt, summary_warmup)
    if packed or scen.on:
        if init is not None:
            batched["init"] = _carry_rows(_resume_fixups(
                init, branch, pvals, gains, profile, scen.det,
                scen.faults, scen.guard, n_events))
        if packed:
            batched["pvals"] = pvals[None]
        shared += _scan_batch(scen, batched)
        fn = _scan_flat(_bucket_steps(int(np.ceil(max_time / dt))),
                        collect_traces, (branch,), not packed, n_events)
    else:
        fn = _kernel_core(collect_traces)
    (traces, f), _ = _execute(fn, batched, shared, 1, device=device)
    f = {k: v[0] for k, v in f.items()}
    n = int(f["steps"])
    trimmed = {} if traces is None else {
        k: v[0, :n] for k, v in traces.items() if k != "valid"}
    vec = f.get("policy_state")
    if vec is None:  # the kernel route or typed PI: the PI slots, tagged
        vec = np.zeros((pol.POLICY_STATE_DIM,), np.float32)
        vec[0], vec[1] = f["prev_error"], f["prev_pcap_l"]
        vec[pol.BRANCH_TAG_SLOT] = float(pol.branch_tag("pi"))
    rls_state = None
    if branch == "pi_rls":
        rls_state = RLSState(*(x.numpy() for x in rls_unpack(
            torch.from_numpy(vec[PI_RLS_LO:PI_RLS_HI]))))
    ring = f.get("event_state")
    return SimResult(traces=trimmed,
                     exec_time=float(f["t"]),
                     energy=float(f["energy"]),
                     work=float(f["work"]),
                     completed=bool(f["work"] >= total_work),
                     n_steps=n,
                     pi_state=(PIState(prev_error=f["prev_error"],
                                       prev_pcap_l=f["prev_pcap_l"])
                               if branch in ("pi", "pi_rls") else None),
                     plant_state=PlantState(progress_l=f["progress_l"],
                                            dropped=f["dropped"] > 0,
                                            energy=f["energy"],
                                            work=f["work"]),
                     pcap=float(f["pcap"]),
                     summary=_summary_dict(f, _hist_edges(profile)),
                     rls_state=rls_state, policy_state=vec,
                     detector_state=f.get("detector_state"),
                     fault_state=f.get("fault_state"),
                     guard_state=f.get("guard_state"),
                     events=None if ring is None else evt.decode_ring(ring),
                     event_state=ring)


def _policy_axis(adaptive, policies):
    """The grid's policies, whether the A axis is squeezed, and whether
    they were given at all (the reference's ValueErrors)."""
    if adaptive is not None and policies is not None:
        raise ValueError("pass policies= or adaptive=, not both "
                         "(adaptive= is sugar for PIPolicy(adaptive=...))")
    if policies is None:
        if adaptive is None:
            return [PIPolicy()], True, False
        single = isinstance(adaptive, RLSConfig)
        cfgs = [adaptive] if single else list(adaptive)
        if not cfgs:
            raise ValueError("adaptive= needs at least one RLSConfig")
        return [PIPolicy(adaptive=c) for c in cfgs], single, True
    single = isinstance(policies, pol.Policy)
    pls = [policies] if single else list(policies)
    if not pls:
        raise ValueError("policies= needs at least one Policy")
    return pls, single, True


def _grid(profs, epsilons, seeds, tau_obj, pls, kinds, extra=()):
    """The profiles x epsilons x policies [x extra axes] x seeds grid as
    per-run rows in grid-nest order: (N, 14) profile rows, (N, 9) gain
    rows, (N,) int64 seeds and (N, POLICY_PARAM_DIM) policy values, the
    latter built at the eps[0] design point per profile (as the reference
    does: RLS's kl_ref and tau_obj depend only on the profile), and each
    run's index on every axis, (P, E, A, *extra, S) in that order."""
    eps = [float(e) for e in epsilons]
    seeds = [int(s) for s in seeds]
    if not (profs and eps and seeds):
        raise ValueError("sweep needs at least one profile, epsilon and "
                         "seed")
    pv = torch.stack([profile_values(p) for p in profs])          # (P, 14)
    gv = torch.stack([torch.stack([
        gains_values(PIGains.from_model(p, e, tau_obj)) for e in eps])
        for p in profs])                                          # (P, E, 9)
    av = torch.stack([torch.stack([
        pol.policy_values(p_, p, PIGains.from_model(p, eps[0], tau_obj),
                          kind=k) for p_, k in zip(pls, kinds)])
        for p in profs])                                          # (P, A, 10)
    shape = (len(profs), len(eps), len(pls)) + tuple(extra) + (len(seeds),)
    idx = [torch.from_numpy(i) for i in
           np.indices(shape).reshape(len(shape), -1)]
    ip, ie, ia, is_ = idx[0], idx[1], idx[2], idx[-1]
    return (pv[ip], gv[ip, ie], torch.tensor(seeds, dtype=torch.int64)[is_],
            av[ip, ia], idx)


def grid_rows(profiles: Sequence[Union[str, PlantProfile]],
              epsilons: Sequence[float], seeds: Sequence[int],
              tau_obj: float = 10.0):
    """The profiles x epsilons x seeds grid as per-run rows in grid-nest
    order: (N, 14) profile rows, (N, 9) gain rows, (N,) int64 seeds."""
    return _grid([_resolve(p) for p in profiles], epsilons, seeds, tau_obj,
                 [PIPolicy()], (0,))[:3]


def _scenario_axes(profs, workloads, detector, faults):
    """The scenario grid axes in the reference's order, W, D, F: for each
    given as a list, its length and a function making each run's row from
    its (profile, axis) indices; a single PhaseSchedule / DetectorConfig /
    FaultSchedule rides every run with no axis (the W axis is then
    squeezed after the run)."""
    axes, build = [], {}
    squeeze_w = isinstance(workloads, PhaseSchedule)
    if workloads is not None:
        wls = [workloads] if squeeze_w else list(workloads)
        if not wls:
            raise ValueError("workloads= needs at least one PhaseSchedule")
        # each schedule resolves against every profile; all pack to the
        # grid's common row count. A (P, W, ...) table, gathered per run.
        rows = max(chain_rows(len(w.phases)) for w in wls)
        packs = [[w.pack(p, rows) for w in wls] for p in profs]
        table = [torch.from_numpy(np.stack([np.stack([pk[k] for pk in pw])
                                            for pw in packs]))
                 for k in range(3)]
        axes.append(len(wls))
        build["sched"] = (len(axes), lambda ip, iw: ScheduleValues(
            *(x[ip, iw] for x in table)))
    det_grid = detector is not None and not isinstance(detector,
                                                       DetectorConfig)
    if detector is not None:
        cfgs = list(detector) if det_grid else [detector]
        if not cfgs:
            raise ValueError("detector= needs at least one DetectorConfig")
        # design model = each profile: a (P, D, DET_PARAM_DIM) table
        dv = torch.stack([torch.stack([detector_values(d, p, device="cpu")
                                       for d in cfgs]) for p in profs])
        if det_grid:
            axes.append(len(cfgs))
        build["det"] = (len(axes) if det_grid else None,
                        lambda ip, idet: dv[ip, idet])
    fault_grid = faults is not None and not isinstance(faults,
                                                       flt.FaultSchedule)
    if faults is not None:
        scheds = list(faults) if fault_grid else [faults]
        if not scheds:
            raise ValueError("faults= needs at least one FaultSchedule")
        # plant-independent rows: an (F, MAX_FAULT_ROWS) table
        fv = [torch.from_numpy(np.stack([np.asarray(f.pack()[k])
                                         for f in scheds]))
              for k in range(6)]
        if fault_grid:
            axes.append(len(scheds))
        build["faults"] = (len(axes) if fault_grid else None,
                           lambda ip, ifl: flt.FaultValues(
                               *(x[ifl] for x in fv)))
    return tuple(axes), build, squeeze_w


def _scenario_rows(build, idx, guard, n_events) -> "_Scenario":
    """Per-run scenario rows of a grid from `_scenario_axes`' row makers and
    `_grid`'s per-axis indices (an axis-free input takes index 0)."""
    n = idx[0].shape[0]
    rows = {}
    for name, (axis, make) in build.items():
        sub = (idx[2 + axis] if axis is not None
               else torch.zeros(n, dtype=torch.int64))
        rows[name] = make(idx[0], sub)
    return _Scenario(guard=guard, n_events=n_events, **rows)


def _sweep_impl(profiles, epsilons, seeds, total_work, max_time, dt,
                tau_obj, adaptive, policies, collect_traces,
                summary_warmup, workloads, detector, faults, guard,
                record_events, *, backend, chunk_size, devices, typed_pi,
                consume, state=None, stop_after=None, durable=None,
                campaign=None, device=None):
    """Shared implementation behind `sweep` / `sweep_resumable`: builds
    the grid as per-run rows in grid-nest order and runs one flat engine
    over them through the executor (or the campaign supervisor). Returns
    (SweepResult | None, ExecState)."""
    _check_backend(backend)
    single = isinstance(profiles, (str, PlantProfile))
    profs = [_resolve(p) for p in ([profiles] if single else profiles)]
    pls, squeeze_pol, given = _policy_axis(adaptive, policies)
    branches, kinds = pol.resolve_kinds(pls)
    extra, build, squeeze_w = _scenario_axes(profs, workloads, detector,
                                             faults)
    gvl = _guard_vector(guard)
    n_events = _resolve_n_events(record_events)
    if typed_pi and branches != ("pi",):
        raise ValueError("typed_pi= is the single-branch fixed-gain PI "
                         f"fast path; this grid dispatches {branches}")
    if typed_pi and ("faults" in build or gvl is not None):
        raise ValueError("typed_pi= is the guard-free fixed-gain PI "
                         "fast path; faults=/guard= need the packed "
                         "engine")
    if typed_pi and n_events:
        raise ValueError("typed_pi= is the recorder-free fixed-gain PI "
                         "fast path; record_events= needs the packed "
                         "engine")
    scen_on = bool(build) or gvl is not None or n_events > 0
    kernel_ok = branches == ("pi",) and not scen_on
    if backend == "auto":
        backend = "kernel" if kernel_ok else "scan"
    elif backend == "kernel" and not kernel_ok:
        raise ValueError(
            "backend='kernel' covers the fixed-gain PI path only (static "
            "plant, no detector, no faults/guard, no flight recorder); "
            f"this grid needs branches={branches}, workloads="
            f"{'sched' in build}, detector={'det' in build}, faults="
            f"{'faults' in build}, guard={gvl is not None}, record_events="
            f"{n_events > 0} — use backend='scan'")
    prof, gains, seed_rows, pvals, idx = _grid(profs, epsilons, seeds,
                                               tau_obj, pls, kinds, extra)
    batched = {"prof": prof, "gains": gains, "seeds": seed_rows}
    shared = (total_work, max_time, dt, summary_warmup)
    if backend == "kernel":
        fn = _kernel_core(collect_traces)
    else:
        packed = (given and not typed_pi) or "faults" in build \
            or gvl is not None or n_events > 0
        if packed:
            batched["pvals"] = pvals
        shared += _scan_batch(_scenario_rows(build, idx, gvl, n_events),
                              batched)
        fn = _scan_flat(_bucket_steps(int(np.ceil(max_time / dt))),
                        collect_traces, branches, not packed, n_events)
    merged, exec_state = _execute(
        fn, batched, shared, int(seed_rows.shape[0]), device=device,
        chunk_size=chunk_size, devices=devices, consume=consume,
        state=state, stop_after=stop_after, durable=durable,
        campaign=campaign)
    if merged is None:  # a consume hook ran, or stop_after cut short
        return None, exec_state
    traces, final = merged
    shape = (len(profs), len(epsilons), len(pls)) + extra + (len(seeds),)
    final = {k: v.reshape(shape + v.shape[1:]) for k, v in final.items()}
    if traces is not None:
        traces = {k: v.reshape(shape + v.shape[1:])
                  for k, v in traces.items()}
    edges = {k: np.stack([_hist_edges(p)[k] for p in profs])
             for k in ("progress_edges", "pcap_edges")}
    squeeze = lambda d, axis: None if d is None else {
        k: v if k.endswith("_edges") else v[(slice(None),) * axis + (0,)]
        for k, v in d.items()}
    if squeeze_w:
        traces, final = squeeze(traces, 3), squeeze(final, 3)
    if squeeze_pol:
        traces, final = squeeze(traces, 2), squeeze(final, 2)
    summary = _summary_dict(final, edges)
    if single:
        traces, final = squeeze(traces, 0), squeeze(final, 0)
        summary = {k: v[0] for k, v in summary.items()}
    det = final.get("detector_state")
    return SweepResult(traces=traces,
                       exec_time=final["t"],
                       energy=final["energy"],
                       work=final["work"],
                       completed=final["work"] >= total_work,
                       n_steps=final["steps"].astype(np.int32),
                       summary=summary,
                       detections=None if det is None
                       else det[..., DET_N_DETECT],
                       guard_state=final.get("guard_state"),
                       events=final.get("event_state")), exec_state


def sweep(profiles, epsilons, seeds, total_work, max_time=3600.0,
          dt=1.0, tau_obj=10.0, adaptive=None, policies=None,
          collect_traces=True, summary_warmup=0, workloads=None,
          detector=None, faults=None, guard=None, record_events=None, *,
          backend: str = "auto", chunk_size: Optional[int] = None,
          devices=None, typed_pi: bool = False, consume=None,
          durable=None, campaign=None,
          device: Union[None, str, torch.device] = None
          ) -> Optional[SweepResult]:
    """Closed-loop grid: profiles x epsilons [x policies] [x workloads]
    [x detectors] [x faults] x seeds, one batch of runs.

    Every cell is one run whose parameters and random streams ride in its
    own row, so any sub-grid reproduces the same cells exactly.
    `collect_traces=False` switches to summary mode (no (.., T) traces;
    O(grid) memory). `summary_warmup` excludes each run's first steps
    (the descent transient) from the online summary reductions only.
    Runs on CUDA unless ``device="cpu"``.

    ``policies=`` takes a single Policy (axis squeezed) or a sequence
    (an A axis between epsilons and seeds; a heterogeneous list runs as
    one batch, each run on its own branch); ``adaptive=`` is sugar for
    ``policies=[PIPolicy(adaptive=cfg) for cfg in ...]``, a single
    RLSConfig squeezing the axis. Policy values are built at the eps[0]
    design point per profile.

    Scenario axes, in the reference's order after the policies:
    ``workloads=`` a single `PhaseSchedule` (W axis squeezed) or a list
    (a W axis), each schedule resolved against every profile;
    ``detector=`` a `DetectorConfig` (every run, design model = each
    profile; `SweepResult.detections` counts the alarms) or a list (a D
    axis); ``faults=`` a `FaultSchedule` (every run, no axis) or a list
    (an F axis); ``guard=`` a `GuardConfig` or True for every run
    (`SweepResult.guard_state`); ``record_events=`` True or a ring size
    (`SweepResult.events`, the packed rings).

    ``backend="auto"`` (the default) runs the kernel route when every
    policy is fixed-gain PI (branch set ``("pi",)``) and no scenario axis
    is given, the scan engine otherwise; ``backend="kernel"`` refuses
    other grids; ``backend="scan"`` runs the Poisson-heartbeat step loop
    (`_scan_core`), whose traces are `_bucket_steps(ceil(max_time /
    dt))` long, as the reference's scan engine makes them, and carry the
    branch set's extras (a single branch kind only). The scan engine runs
    the typed fixed-gain PI path without ``policies=`` / ``adaptive=``
    (or with ``typed_pi=True``) unless faults, a guard or the recorder
    are on, which need the packed policy state, as in the reference.

    Execution (`repro_torch.core.executor`): the grid is flattened to
    per-run rows in grid-nest order and one flat engine runs over them,
    one chunk by default. ``chunk_size=`` cuts it into bounded-memory
    chunks (the scan engine runs every step of every chunk, so its
    chunked wall is about the number of chunks times one chunk's);
    ``devices=`` (an int, ``"all"`` or a device sequence) splits each
    chunk's rows over devices; ``consume=`` streams each chunk's
    ``(traces, final)`` numpy results to ``consume(lo, hi, out)`` instead
    of keeping them, and `sweep` returns None. ``durable=dir`` runs the
    grid under the campaign supervisor (`repro_torch.core.supervisor`):
    every chunk is journaled and checkpointed into ``dir``, transient
    failures retry, and after a crash `supervisor.resume_campaign(dir)`
    returns the uninterrupted result; ``campaign=`` is its
    `supervisor.CampaignConfig`. The arguments are pickled into ``dir``
    as the campaign spec (devices as strings). Every layout equals the
    one-shot grid bit for bit."""
    if durable is not None and consume is None:
        # first writer wins: a resume re-entering through sweep() keeps
        # the original spec. consume= callbacks are not picklable;
        # callers owning one (harvest_dataset) save their own spec.
        supervisor.save_campaign_spec(durable, "sweep", dict(
            profiles=profiles, epsilons=list(epsilons),
            seeds=list(seeds), total_work=total_work, max_time=max_time,
            dt=dt, tau_obj=tau_obj, adaptive=adaptive, policies=policies,
            collect_traces=collect_traces, summary_warmup=summary_warmup,
            workloads=workloads, detector=detector, faults=faults,
            guard=guard, record_events=record_events, backend=backend,
            chunk_size=chunk_size, devices=devices, typed_pi=typed_pi,
            campaign=campaign, device=device))
    res, _ = _sweep_impl(profiles, epsilons, seeds, total_work, max_time,
                         dt, tau_obj, adaptive, policies, collect_traces,
                         summary_warmup, workloads, detector, faults, guard,
                         record_events, backend=backend,
                         chunk_size=chunk_size, devices=devices,
                         typed_pi=typed_pi, consume=consume,
                         durable=durable, campaign=campaign, device=device)
    return res


def sweep_resumable(profiles, epsilons, seeds, total_work,
                    max_time=3600.0, dt=1.0, tau_obj=10.0,
                    adaptive=None, policies=None, collect_traces=True,
                    summary_warmup=0, workloads=None, detector=None,
                    faults=None, guard=None, record_events=None, *,
                    backend: str = "auto", chunk_size: int,
                    devices=None, typed_pi: bool = False, state=None,
                    stop_after: Optional[int] = None,
                    device: Union[None, str, torch.device] = None):
    """Chunked sweep that can stop and resume across chunk boundaries:
    returns (SweepResult | None, `executor.ExecState`). ``stop_after=``
    processes at most that many chunks per call (the result is None until
    the grid completes); pass the returned state (plain numpy, it
    pickles) back via ``state=`` to continue where the previous call, or
    process, left off. Same grid semantics as `sweep`."""
    return _sweep_impl(profiles, epsilons, seeds, total_work, max_time,
                       dt, tau_obj, adaptive, policies, collect_traces,
                       summary_warmup, workloads, detector, faults, guard,
                       record_events, backend=backend,
                       chunk_size=chunk_size, devices=devices,
                       typed_pi=typed_pi, consume=None, state=state,
                       stop_after=stop_after, device=device)
