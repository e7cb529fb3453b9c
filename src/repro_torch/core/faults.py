"""Fault scripts as scan-engine inputs + the guarded-degradation layer;
port of `repro.core.faults`.

The paper evaluates the Eq. 4 PI loop under clean telemetry; a
production feedback loop on HPC nodes sees heartbeat loss, frozen RAPL
meters and stuck powercap actuators. This module scripts those failures
the way `repro_torch.core.workloads` scripts phases: as fixed-width
packed rows (`FaultSchedule` -> `FaultValues`) evaluated inside the
engine step, so `sweep(faults=[...])` runs whole fault scenarios as one
more grid axis, and `FaultyActuator` wraps a live actuator with the same
schedule.

Channels (`FaultWindow.kind`):

* ``hb_dropout``   — fraction p1 of this period's heartbeats are lost.
* ``hb_stale``     — the aggregator's output freezes at its last value.
* ``meter_freeze`` — the power meter repeats its last healthy reading.
* ``meter_bias``   — additive bias of p1 watts on the reading.
* ``meter_spike``  — with per-step probability p1 the reading is
  replaced by p2 (p2=0 means NaN — the poisoned register).
* ``act_stuck``    — the cap actuator ignores commands and holds p1
  watts (p1=0: holds whatever was last applied).
* ``act_quant``    — commands quantize to a p1-watt grid above pcap_min.
* ``act_delay``    — commands take effect one control period late.
* ``crash``        — tenant crash: no progress, no beats, idle power;
  the plant restarts cold when the window ends.

Sensor-side channels corrupt only what the CONTROLLER observes; the
plant's own work/energy integrals stay truthful.

The guard layer (`GuardConfig`, consumed by `repro_torch.core.plane.
plane_step`) is packed here too: a stale-signal watchdog (no fresh
progress within ``hold_k`` periods -> hold the applied cap, past
``failsafe_k`` -> fail safe to pcap_max), non-finite/outlier sentinels on
progress and power, and a policy-state divergence guard that routes
through the policy's `on_change` hook. Every trigger is a
`torch.where(trigger, ..., clean)`, so a run whose guard never triggers
is bit for bit the unguarded one.

Every tensor here is batched over leading run axes: `FaultValues` leaves
are (..., MAX_FAULT_ROWS) with a (...) period, channel activations and
per-run states (...) and (..., width).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.obs import metrics as obs_metrics

FAULT_KINDS = ("none", "hb_dropout", "hb_stale", "meter_freeze",
               "meter_bias", "meter_spike", "act_stuck", "act_quant",
               "act_delay", "crash")
(K_NONE, K_HB_DROPOUT, K_HB_STALE, K_METER_FREEZE, K_METER_BIAS,
 K_METER_SPIKE, K_ACT_STUCK, K_ACT_QUANT, K_ACT_DELAY,
 K_CRASH) = range(len(FAULT_KINDS))

#: fixed row count every resolved schedule packs to, so a list of
#: schedules stacks into one (F, MAX_FAULT_ROWS) grid axis
MAX_FAULT_ROWS = 8

# kinds whose primary parameter has a meaningful "unset" default
_DEFAULT_P1 = {"hb_dropout": 1.0, "meter_spike": 1.0}

Device = Union[None, str, torch.device]


class FaultValues(NamedTuple):
    """Packed fault rows (float32), for one run or a batch of runs."""
    start: torch.Tensor   # (..., R) window start [s]
    end: torch.Tensor     # (..., R) window end [s] (+inf on padding rows)
    kind: torch.Tensor    # (..., R) index into FAULT_KINDS (0 = none)
    p1: torch.Tensor      # (..., R) primary parameter (kind-specific)
    p2: torch.Tensor      # (..., R) secondary parameter (kind-specific)
    period: torch.Tensor  # (...); > 0 makes the script cyclic


@dataclasses.dataclass(frozen=True)
class FaultWindow:
    """One scripted failure window: `kind` active on [start, start+duration)."""
    kind: str
    start: float
    duration: float
    p1: float = 0.0
    p2: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS or self.kind == "none":
            raise ValueError(f"unknown fault kind {self.kind!r}; choose "
                             f"from {FAULT_KINDS[1:]}")
        if self.duration <= 0:
            raise ValueError("fault window duration must be positive")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A fault script: windows on the run clock (cyclic if period > 0).

    `resolve()` packs to fixed-width `FaultValues` rows as
    `PhaseSchedule.resolve` packs phases, so schedules ride the engine's
    inputs and stack into a `sweep(faults=[...])` axis.
    """
    windows: Tuple[FaultWindow, ...] = ()
    period: float = 0.0
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "windows", tuple(self.windows))
        if len(self.windows) > MAX_FAULT_ROWS:
            raise ValueError(f"{len(self.windows)} fault windows > "
                             f"MAX_FAULT_ROWS={MAX_FAULT_ROWS}")
        if self.period > 0:
            for w in self.windows:
                if w.start + w.duration > self.period:
                    raise ValueError("cyclic fault window overruns the "
                                     "period")

    def pack(self) -> Tuple[np.ndarray, ...]:
        """The packed rows as numpy float32: (start, end, kind, p1, p2)
        (MAX_FAULT_ROWS,) each and the period, a float32 scalar."""
        R = MAX_FAULT_ROWS
        start = np.full(R, np.inf, np.float32)
        end = np.full(R, np.inf, np.float32)
        kind = np.zeros(R, np.float32)
        p1 = np.zeros(R, np.float32)
        p2 = np.zeros(R, np.float32)
        for i, w in enumerate(self.windows):
            start[i] = w.start
            end[i] = w.start + w.duration
            kind[i] = FAULT_KINDS.index(w.kind)
            p1[i] = w.p1 if w.p1 else _DEFAULT_P1.get(w.kind, 0.0)
            p2[i] = w.p2
        return start, end, kind, p1, p2, np.float32(self.period)

    def resolve(self, device: Device = None) -> FaultValues:
        """The packed `FaultValues` on ``device`` (CUDA unless told
        otherwise)."""
        dev = resolve_device(device)
        return FaultValues(*(torch.from_numpy(np.asarray(a)).to(dev)
                             for a in self.pack()))

    # host-side view (FaultyActuator + tests)
    def active(self, t: float) -> Tuple[FaultWindow, ...]:
        t_eff = float(t) % self.period if self.period > 0 else float(t)
        return tuple(w for w in self.windows
                     if w.start <= t_eff < w.start + w.duration)


class ActiveFaults(NamedTuple):
    """Per-channel activation at one instant, (...) float32 per run."""
    hb_drop: torch.Tensor        # fraction of beats lost this period
    hb_stale: torch.Tensor       # 0/1: hold last observed progress
    meter_freeze: torch.Tensor   # 0/1: hold last healthy power reading
    meter_bias: torch.Tensor     # additive watts on the reading
    meter_spike_p: torch.Tensor  # per-step spike probability
    meter_spike_v: torch.Tensor  # spike value (0 -> NaN)
    act_stuck_on: torch.Tensor   # 0/1: actuator ignores commands
    act_stuck_val: torch.Tensor  # stuck value (0 -> hold last applied)
    act_quant: torch.Tensor      # command quantum in watts (0 = off)
    act_delay: torch.Tensor      # 0/1: one-period command delay
    crash: torch.Tensor          # 0/1: tenant down


def fault_channels(fv: FaultValues, t) -> ActiveFaults:
    """Reduce the packed rows to per-channel activations at time ``t``
    ((...) per run): the max over the rows of each kind's parameter where
    its window is on (the bias is a sum), the cyclic wrap a floored
    modulo. Every kind is reduced at once, over a (..., rows, kinds)
    mask, so the step pays a few launches for all eleven channels."""
    t = torch.as_tensor(t, dtype=torch.float32, device=fv.start.device)
    t_eff = torch.where(fv.period > 0,
                        torch.remainder(t, torch.clamp(fv.period,
                                                       min=1e-9)), t)
    tt = t_eff[..., None]
    on = (tt >= fv.start) & (tt < fv.end)
    kinds = torch.arange(len(FAULT_KINDS), device=fv.kind.device)
    onk = on[..., None] & (fv.kind[..., None] == kinds)   # (..., R, K)
    peak = lambda v: torch.where(onk, v[..., None], 0.0).amax(-2)
    p1, p2 = peak(fv.p1), peak(fv.p2)                     # (..., K)
    hit = onk.any(-2).to(torch.float32)
    return ActiveFaults(
        hb_drop=p1[..., K_HB_DROPOUT],
        hb_stale=hit[..., K_HB_STALE],
        meter_freeze=hit[..., K_METER_FREEZE],
        meter_bias=torch.where(onk[..., K_METER_BIAS], fv.p1,
                               0.0).sum(-1),
        meter_spike_p=p1[..., K_METER_SPIKE],
        meter_spike_v=p2[..., K_METER_SPIKE],
        act_stuck_on=hit[..., K_ACT_STUCK],
        act_stuck_val=p1[..., K_ACT_STUCK],
        act_quant=p1[..., K_ACT_QUANT],
        act_delay=hit[..., K_ACT_DELAY],
        crash=hit[..., K_CRASH],
    )


# ---- per-run fault state (rides the engine's carry) -----------------------

FAULT_STATE_DIM = 6
(F_LAST_PROGRESS,   # last delivered (non-stale) aggregated progress
 F_LAST_POWER,      # last healthy power reading (freeze anchor)
 F_PREV_CMD,        # previous period's cap command (act_delay)
 F_PREV_APPLIED,    # previous period's applied cap (act_stuck hold)
 F_CRASHED,         # 0/1: was down last period (restart edge)
 F_SPARE) = range(FAULT_STATE_DIM)


def fault_state_init(profile, device: Device = None) -> torch.Tensor:
    """Initial fault state (..., FAULT_STATE_DIM): runs start uncapped at
    full power. A profile with tensor fields gives a row per run on their
    device; one with float fields a single row on ``device`` (CUDA unless
    told otherwise)."""
    pmax = profile.pcap_max
    if not isinstance(pmax, torch.Tensor):
        pmax = torch.tensor(pmax, dtype=torch.float32,
                            device=resolve_device(device))
    pmax = pmax.to(torch.float32)
    power = torch.as_tensor(profile.power_of_pcap(profile.pcap_max),
                            dtype=torch.float32, device=pmax.device)
    z = torch.zeros_like(pmax)
    return torch.stack([z, power.expand_as(pmax), pmax, pmax, z, z], -1)


def apply_actuator(af: ActiveFaults, fstate: torch.Tensor, pcap_cmd,
                   pcap_min) -> torch.Tensor:
    """Distort the controller's cap command the way a sick actuator
    would; identity (bit for bit) when no actuator channel is active.
    Rounding is half to even, as the reference's."""
    cmd = torch.where(af.act_delay > 0, fstate[..., F_PREV_CMD], pcap_cmd)
    q = af.act_quant
    cmd = torch.where(
        q > 0,
        pcap_min + torch.round((cmd - pcap_min) / torch.clamp(q, min=1e-9))
        * q, cmd)
    stuck = torch.where(af.act_stuck_val > 0, af.act_stuck_val,
                        fstate[..., F_PREV_APPLIED])
    return torch.where(af.act_stuck_on > 0, stuck, cmd)


# ---- guarded degradation (consumed by repro_torch.core.plane.plane_step) --

GUARD_PARAM_DIM = 6


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Guarded-degradation knobs for `plane_step(guard_vals=...)`.

    hold_k / failsafe_k count consecutive control periods without a
    fresh, in-range progress signal: past hold_k the run HOLDS its
    applied cap, past failsafe_k it fails safe to pcap_max — the one cap
    that can never violate the paper's performance contract.
    outlier_mult bounds accepted signals (progress <= mult * setpoint,
    power <= mult * power(pcap_max)); anything outside counts as stale.
    recover_reset routes the first fresh signal after a fail-safe
    through the policy's `on_change` hook, so estimators re-converge
    from the reset covariance instead of the poisoned one.
    """
    hold_k: int = 3
    failsafe_k: int = 12
    outlier_mult: float = 8.0
    recover_reset: bool = True


def guard_values(cfg: Optional[GuardConfig] = None,
                 device: Device = None) -> torch.Tensor:
    """Pack a GuardConfig (defaults when None) -> (GUARD_PARAM_DIM,)
    float32 on ``device`` (CUDA unless told otherwise)."""
    cfg = cfg or GuardConfig()
    return torch.tensor([cfg.hold_k, cfg.failsafe_k, cfg.outlier_mult,
                         1.0 if cfg.recover_reset else 0.0, 0.0, 0.0],
                        dtype=torch.float32, device=resolve_device(device))


GUARD_STATE_DIM = 8
(G_STALE,          # consecutive periods without a valid progress signal
 G_MODE,           # 0 normal / 1 hold / 2 fail-safe
 G_LAST_PROGRESS,  # last accepted progress (substituted while stale)
 G_LAST_POWER,     # last accepted power reading
 G_N_INVALID,      # cumulative rejected-signal count (observability)
 G_N_FAILSAFE,     # cumulative periods spent in fail-safe
 G_N_RESETS,       # cumulative forced estimator resets
 G_SPARE) = range(GUARD_STATE_DIM)

GUARD_NORMAL, GUARD_HOLD, GUARD_FAILSAFE = 0.0, 1.0, 2.0


def guard_init(shape: Tuple[int, ...] = (), device: Device = None
               ) -> torch.Tensor:
    """Fresh guard state, ``shape + (GUARD_STATE_DIM,)`` zeros on
    ``device`` (CUDA unless told otherwise)."""
    return torch.zeros(tuple(shape) + (GUARD_STATE_DIM,),
                       dtype=torch.float32, device=resolve_device(device))


# ---- live-runtime fault injection ----------------------------------------

class FaultyActuator:
    """Wrap any power actuator (``set_pcap``, ``read_power``) with a
    `FaultSchedule` evaluated on the host clock: stuck/quantized/delayed
    caps on `set_pcap`, frozen/biased/spiked readings on `read_power`.
    Drive the clock with `tick(t)` each control period. Crash windows read
    as zero power and swallow commands. Duck-typed: everything else
    delegates to the wrapped actuator. Every perturbation actually
    applied increments the per-kind ``faults_injected_total`` counter in
    the process metrics registry."""

    def __init__(self, inner, schedule: FaultSchedule, seed: int = 0):
        self.inner = inner
        self.schedule = schedule
        self._t = 0.0
        self._rng = np.random.default_rng(seed)
        self._prev_cmd: Optional[float] = None
        self._last_applied: Optional[float] = None
        self._frozen: Optional[float] = None
        # per-kind injection counter, cached so the per-period hot path
        # is one dict op, not a registry lookup under the lock
        self._injected = obs_metrics.get_registry().counter(
            "faults_injected_total",
            "fault perturbations actually applied by FaultyActuator",
            labelnames=("kind",))

    def tick(self, t: float) -> None:
        self._t = float(t)

    def _chan(self, kind: str) -> Optional[FaultWindow]:
        for w in self.schedule.active(self._t):
            if w.kind == kind:
                return w
        return None

    def set_pcap(self, pcap: float) -> None:
        cmd = float(pcap)
        if self._chan("act_delay") is not None:
            cmd, self._prev_cmd = (
                self._prev_cmd if self._prev_cmd is not None else cmd,
                float(pcap))
            self._injected.inc(kind="act_delay")
        else:
            self._prev_cmd = float(pcap)
        w = self._chan("act_quant")
        if w is not None:
            lo = getattr(getattr(self.inner, "profile", None),
                         "pcap_min", 0.0)
            cmd = lo + round((cmd - lo) / max(w.p1, 1e-9)) * w.p1
            self._injected.inc(kind="act_quant")
        w = self._chan("act_stuck")
        if w is not None:
            cmd = (w.p1 if w.p1 else
                   self._last_applied if self._last_applied is not None
                   else cmd)
            self._injected.inc(kind="act_stuck")
        if self._chan("crash") is not None:
            self._injected.inc(kind="crash")
            return  # a crashed tenant's runtime takes no commands
        self._last_applied = cmd
        self.inner.set_pcap(cmd)

    def read_power(self) -> float:
        if self._chan("crash") is not None:
            return 0.0
        true = float(self.inner.read_power())
        w = self._chan("meter_freeze")
        if w is not None:
            self._injected.inc(kind="meter_freeze")
            return self._frozen if self._frozen is not None else true
        self._frozen = true
        v = true
        w = self._chan("meter_bias")
        if w is not None:
            v += w.p1
            self._injected.inc(kind="meter_bias")
        w = self._chan("meter_spike")
        if w is not None and self._rng.random() < (w.p1 or 1.0):
            v = w.p2 if w.p2 else float("nan")
            self._injected.inc(kind="meter_spike")
        return v

    def drop_heartbeat(self) -> bool:
        """Should the workload shim drop this heartbeat right now?"""
        if self._chan("crash") is not None:
            return True
        w = self._chan("hb_dropout")
        if w is not None and self._rng.random() < (w.p1 or 1.0):
            self._injected.inc(kind="hb_dropout")
            return True
        return False

    def __getattr__(self, name):
        return getattr(self.inner, name)
