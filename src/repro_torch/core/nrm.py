"""Node Resource Manager (Argo-NRM analogue, in-process); port of
`repro.core.nrm`: the paper's runtime, which "periodically monitors
application progress and chooses at runtime a suitable power cap".

The paper's NRM is a daemon mediating sensors (heartbeats, RAPL energy)
and actuators (RAPL powercap) over Unix sockets. Here the same roles are
played in-process, so the controller runs inside a training or serving
loop:

* sensors: a `HeartbeatAggregator` fed by the workload (a step callback
  or a simulated plant), plus a power sensor;
* actuators: the `PowerActuator` interface; `SimulatedPowerActuator`
  drives a `repro_torch.core.plant` plant;
* the loop: `NRM.control_step()` aggregates progress (Eq. 1), runs the
  configured power policy (Eq. 4 PI by default, RLS-adaptive PI with
  ``PowerControlConfig(adaptive=True)``, or any `repro_torch.core.policies`
  policy) through `repro_torch.core.plane.plane_step`, the control-law
  code path the scan engine runs, and actuates; ``detector=`` runs the
  change-point detector live and ``guard=`` the guarded-degradation
  layer;
* the paper's evaluation: `NRM.run_simulated` continues the run on the
  scan engine (`sim.resume_init` + ``sim.simulate_closed_loop(init=)``),
  threading controller, estimator, policy, detector, guard, recorder and
  plant state across calls.

Randomness. The reference's actuator splits a `jax.random` key every
period and folds a seed in for each `run_simulated` call; the port does
not re-implement `jax.random`. The actuator's noise is the counter
stream of `ops.draw_noise` keyed by (its seed, its period count), and
each `run_simulated` segment's engine seed is a hash of (the actuator's
seed, the call's seed, the periods run so far), so a resumed segment
with the same seed does not replay the previous segment's noise. Runs
therefore match the reference statistically; `control_step` on given
progress and power is the reference's arithmetic.

The NRM's state lives on one device (CUDA unless ``device="cpu"``), and
`state_dict` / `load_state_dict` hold JSON-able lists in the reference's
layout: a reference checkpoint loads as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import PowerControlConfig
from repro_torch.core import faults as flt
from repro_torch.core import plane
from repro_torch.core import policies as pol
from repro_torch.core import sim
from repro_torch.core.adaptive import (RLSAdapter, RLSConfig, RLSState,
                                       rls_init, rls_pack, rls_unpack,
                                       rls_values)
from repro_torch.core.controller import PIController, PIGains, PIState
from repro_torch.core.plant import (PROFILES, PlantProfile, PlantState,
                                    plant_init, plant_step)
from repro_torch.core.policies.pi import (PI_RLS_HI, PI_RLS_LO, PIPolicy,
                                          pi_pack, reexcite_cap)
from repro_torch.core.signals import HeartbeatAggregator
from repro_torch.core.workloads.detect import (DetectorConfig, detect_init,
                                               detector_values)
from repro_torch.kernels.closed_loop import ops
from repro_torch.obs import events as evt
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

Device = Union[None, str, torch.device]
_M64 = (1 << 64) - 1


def _segment_seed(*words: int) -> int:
    """A 63-bit engine seed from integer words (splitmix64's mixer
    folded over them)."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = ((h ^ (int(w) & _M64)) * 0xBF58476D1CE4E5B9) & _M64
        h = ((h ^ (h >> 31)) * 0x94D049BB133111EB) & _M64
        h ^= h >> 29
    return h >> 1


def _on(x, dev: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A state leaf (tensor, numpy, list or float) on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev, dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


class PowerActuator:
    """Actuator interface: set a power cap, read back measured power."""

    def set_pcap(self, pcap: float) -> None:
        raise NotImplementedError

    def read_power(self) -> float:
        raise NotImplementedError


class SimulatedPowerActuator(PowerActuator):
    """Drives a simulated plant on ``device`` (CUDA unless told
    otherwise); advances the plant state each control period. The
    period's noise is `ops.draw_noise` of ``seed`` at step ``periods``
    (the period count), so the stream depends only on the seed."""

    def __init__(self, profile: PlantProfile, seed: int = 0,
                 device: Device = None):
        self.profile = profile
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.periods = 0
        self.state = PlantState(*(_on(x, self.device, x.dtype)
                                  for x in plant_init(profile)))
        self._seeds = torch.tensor([self.seed], dtype=torch.int64,
                                   device=self.device)
        self._pcap = profile.pcap_max
        self._last_meas: Dict[str, float] = {}

    def set_pcap(self, pcap: float) -> None:
        self._pcap = float(np.clip(pcap, self.profile.pcap_min,
                                   self.profile.pcap_max))

    def advance(self, dt: float) -> Dict[str, float]:
        with obs_trace.span("nrm.advance"):
            noise = ops.draw_noise(self._seeds, 1,
                                   t0=self.periods)[0, :4, 0]
            self.periods += 1
            self.state, meas = plant_step(self.profile, self.state,
                                          self._pcap, dt, noise)
            keys = list(meas)
            vals = torch.stack([meas[k].to(self.device, torch.float32)
                                for k in keys]).tolist()  # one sync
            self._last_meas = dict(zip(keys, vals))
            return self._last_meas

    def read_power(self) -> float:
        return self._last_meas.get("power", float("nan"))


@dataclasses.dataclass
class ControlRecord:
    t: float
    progress: float
    pcap: float
    power: float
    setpoint: float
    phase_change: bool = False  # the live detector alarmed this period
    # guarded-degradation mode this period (faults.GUARD_NORMAL /
    # GUARD_HOLD / GUARD_FAILSAFE as int); 0 when no guard is armed
    guard_mode: int = 0


class NRM:
    """Sensor/actuator registry + synchronous control loop, its state on
    ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, pc_cfg: PowerControlConfig,
                 actuator: Optional[PowerActuator] = None,
                 profile: Optional[PlantProfile] = None,
                 policy: Optional[pol.Policy] = None,
                 detector: Optional[DetectorConfig] = None,
                 guard: Union[None, bool, flt.GuardConfig] = None,
                 reexcite: int = 0, reexcite_frac: float = 0.08,
                 device: Device = None):
        self.device = resolve_device(device)
        self.cfg = pc_cfg
        self.profile = profile or PROFILES[pc_cfg.plant_profile]
        self.actuator = actuator or SimulatedPowerActuator(
            self.profile, device=self.device)
        self.gains = PIGains.from_model(self.profile, pc_cfg.epsilon,
                                        pc_cfg.tau_obj, self.device)
        self._new_controller()
        self.hb = HeartbeatAggregator()
        self.records: List[ControlRecord] = []
        self._t = 0.0
        self._rls_cfg = None
        self._rls_state = None  # RLSState on the device (both paths)
        # non-PI power policy; its packed state is threaded across
        # run_simulated calls like the RLS estimator's
        self._policy = policy
        self._policy_state = None
        # online change-point detector: runs live in control_step AND
        # inside run_simulated's engine, its packed state threaded across
        self._detector = detector
        self._det_state = None
        # guarded degradation: the same watchdog plane_step runs in the
        # scan engine, armed live in control_step and in run_simulated
        self._guard = (None if not guard
                       else (flt.GuardConfig() if guard is True
                             else guard))
        self._guard_state = None
        self._guard_vals = None
        # host-side decision stream (SRC_NRM): live detector alarms and
        # guard-mode transitions seen by control_step; run_simulated's
        # timeline lives in the packed ring below instead
        self.events = evt.EventLog()
        # packed flight-recorder ring threaded across run_simulated
        # segments (None until a record_events= run)
        self._event_state = None
        # packed detector/policy parameter vectors are pure functions of
        # (config, profile, gains): cached here, rebuilt on calibrate()
        self._det_vals = None
        self._policy_vals = None
        # last cap COMMAND actually applied to the actuator (the
        # detector's model replays it through the design transform)
        self._pcap_applied = float(self.profile.pcap_max)
        # detector-triggered re-identification: reexcite= windows of
        # +/- dither after each alarm (policies.pi.reexcite_cap); 0 = off
        self._reexcite_k = int(reexcite)
        self._reexcite_frac = float(reexcite_frac)
        self._reexcite_left = 0
        self._reexcite_i = 0
        if policy is not None and pc_cfg.adaptive:
            raise ValueError("policy= replaces the PI controller; "
                             "adaptive RLS only schedules PI gains")
        if pc_cfg.adaptive:
            self._rls_cfg = RLSConfig()

    def _new_controller(self) -> None:
        # the gains carry the device: the PI state starts there
        self.controller = PIController(self.gains)

    # ---- workload-facing API ---------------------------------------------
    def heartbeat(self, work: float = 1.0,
                  t: Optional[float] = None) -> None:
        with obs_trace.span("nrm.heartbeat"):
            self.hb.beat(self._t if t is None else t, work)

    def calibrate(self, full_power_rate: float) -> None:
        """Rescale the plant's linear gain so progress_max matches the
        measured full-power heart rate of THIS workload (the paper does
        this implicitly by identifying each benchmark separately)."""
        frac_max = self.profile.progress_max / self.profile.K_L
        new_kl = full_power_rate / max(frac_max, 1e-9)
        self.profile = dataclasses.replace(self.profile, K_L=new_kl)
        if isinstance(self.actuator, SimulatedPowerActuator):
            # a fresh plant on the re-scaled profile
            self.actuator = SimulatedPowerActuator(self.profile,
                                                   device=self.device)
        self.gains = PIGains.from_model(self.profile, self.cfg.epsilon,
                                        self.cfg.tau_obj, self.device)
        self._new_controller()
        # the detector replays the (re-scaled) design model; stale state
        # (and cached parameter packs) would alarm on the calibration
        # jump itself
        self._det_state = None
        self._det_vals = None
        self._policy_vals = None

    # ---- control loop -----------------------------------------------------
    def _det_pack(self):
        """Lazy packed detector (vals, state); (None, None) without
        detector=. The model is anchored at the cap APPLIED when the
        detector first arms."""
        if self._detector is None:
            return None, None
        if self._det_vals is None:
            self._det_vals = detector_values(self._detector, self.profile,
                                             device=self.device)
        if self._det_state is None:
            self._det_state = detect_init(self._det_vals, self.gains,
                                          self._pcap_applied)
        return self._det_vals, self._det_state

    def _guard_pack(self):
        """Lazy packed guard (vals, state); (None, None) unguarded."""
        if self._guard is None:
            return None, None
        if self._guard_vals is None:
            self._guard_vals = flt.guard_values(self._guard,
                                                device=self.device)
        if self._guard_state is None:
            self._guard_state = flt.guard_init((), self.device)
        return self._guard_vals, self._guard_state

    def control_step(self, dt: Optional[float] = None,
                     now: Optional[float] = None) -> ControlRecord:
        """One control period: a 1-tenant wrapper over
        `repro_torch.core.plane.plane_step`, the control-law code path
        the scan engine runs. The PI / adaptive-PI / policy= state is
        packed into the plane's fixed-width vectors before the step and
        unpacked after. Pass ``now`` when an external clock (the serving
        loop's simulated time) drives the schedule; dt is then derived.
        With detector= the change-point detector runs first each period:
        an alarm resets the RLS estimator / fires the policy's
        `on_change` hook and is recorded on the ControlRecord. The
        period is the span ``nrm.control_step`` (`obs.trace`)."""
        with obs_trace.span("nrm.control_step"):
            return self._control_step(dt, now)

    def _control_step(self, dt: Optional[float],
                      now: Optional[float]) -> ControlRecord:
        if now is not None:
            if dt is None:
                dt = max(now - self._t, 1e-6)
            self._t = now
        else:
            dt = dt or self.cfg.sampling_period
            self._t += dt
        progress = self.hb.progress(self._t)
        det_vals, det_state = self._det_pack()
        gvals, gstate = self._guard_pack()
        prev_gmode = 0.0 if gstate is None else float(gstate[flt.G_MODE])
        gmode = 0.0
        f32 = lambda x: torch.tensor(x, dtype=torch.float32,
                                     device=self.device)
        if self._policy is not None:
            if self._policy_vals is None:
                self._policy_vals = pol.policy_values(
                    self._policy, self.profile, self.gains).to(self.device)
            vals = self._policy_vals
            if self._policy_state is None:
                self._policy_state = pol.policy_init(
                    self._policy, vals, self.gains).to(self.device)
            power = self.actuator.read_power()
            if not np.isfinite(power):
                # first period: no measurement yet; the policies that
                # read obs.power get the model's estimate instead
                power = float(self.profile.power_of_pcap(
                    self._pcap_applied))
            out = plane.plane_step(
                self.gains, self._policy, vals, self._policy_state,
                self._pcap_applied, f32(progress), f32(power), f32(dt),
                det_vals=det_vals, det_state=det_state,
                guard_vals=gvals, guard_state=gstate)
            if gvals is None:
                self._policy_state, det_s, pcap, change = out
            else:
                (self._policy_state, det_s, pcap, change,
                 self._guard_state, gmode) = out
            pcap = float(pcap)
        else:
            # PI / adaptive PI ride the SAME plane step, through the pi /
            # pi_rls branches the engine dispatches
            adaptive = self._rls_cfg is not None
            if self._policy_vals is None:
                self._policy_vals = pol.policy_values(
                    PIPolicy(adaptive=self._rls_cfg), self.profile,
                    self.gains).to(self.device)
            if adaptive and self._rls_state is None:
                self._rls_state = rls_init(
                    rls_values(self._rls_cfg, self.profile,
                               self.gains).to(self.device),
                    self.gains.k_p, self.gains.k_i)
            state = pi_pack(self.controller.state,
                            None if not adaptive
                            else rls_pack(self._rls_state))
            branch = "pi_rls" if adaptive else "pi"
            out = plane.plane_step(
                self.controller.gains, branch, self._policy_vals, state,
                self._pcap_applied, progress, None, dt,
                det_vals=det_vals, det_state=det_state,
                guard_vals=gvals, guard_state=gstate)
            if gvals is None:
                state, det_s, pcap, change = out
            else:
                (state, det_s, pcap, change,
                 self._guard_state, gmode) = out
            self.controller.state = PIState(prev_error=state[0],
                                            prev_pcap_l=state[1])
            if adaptive:
                self._rls_state = rls_unpack(state[PI_RLS_LO:PI_RLS_HI])
                # observability: the stateful controller's gains track
                # the scheduled placement
                self.controller.gains = dataclasses.replace(
                    self.controller.gains,
                    k_p=float(self._rls_state.k_p),
                    k_i=float(self._rls_state.k_i))
            pcap = float(pcap)
        if det_vals is not None:
            self._det_state = det_s
        detected = bool(float(change))
        reexcited = False
        if self._reexcite_k:
            if detected:
                # arm the probe: plane_step just routed branch_on_change
                # (covariance blow + forced re-placement); the next
                # healthy windows get informative caps, not steady state
                self._reexcite_left = self._reexcite_k
                self._reexcite_i = 0
            elif self._reexcite_left > 0:
                healthy = (np.isfinite(progress) and progress > 0.0
                           and float(gmode) == 0.0)
                if healthy:
                    pcap = reexcite_cap(pcap, self._reexcite_i,
                                        self._reexcite_frac,
                                        self.profile.pcap_min,
                                        self.profile.pcap_max)
                    self._reexcite_i += 1
                    self._reexcite_left -= 1
                    reexcited = True
        self.actuator.set_pcap(pcap)
        self._pcap_applied = float(np.clip(pcap, self.profile.pcap_min,
                                           self.profile.pcap_max))
        rec = ControlRecord(t=self._t, progress=progress, pcap=pcap,
                            power=self.actuator.read_power(),
                            setpoint=float(self.gains.setpoint),
                            phase_change=detected,
                            guard_mode=int(float(gmode)))
        self.records.append(rec)
        # observability: registry counters/gauges plus the host decision
        # stream, edge-triggered like the in-engine recorder
        reg = obs_metrics.get_registry()
        reg.counter("nrm_control_steps_total",
                    "live control periods executed").inc()
        reg.gauge("nrm_pcap_watts",
                  "cap applied by the last control period"
                  ).set(self._pcap_applied)
        reg.gauge("nrm_progress",
                  "heartbeat progress seen by the last control period"
                  ).set(float(progress))
        if detected:
            reg.counter("nrm_detector_alarms_total",
                        "live change-point detector alarms").inc()
            self.events.append(self._t, evt.EV_DETECTOR_ALARM, evt.SRC_NRM,
                               (float(progress), self._pcap_applied))
        if reexcited:
            reg.counter("nrm_reexcitations_total",
                        "post-alarm re-excitation dithers applied").inc()
            self.events.append(self._t, evt.EV_REEXCITE, evt.SRC_NRM,
                               (float(self._reexcite_i),
                                self._pcap_applied))
        if gvals is not None:
            gmode_f = float(gmode)
            if gmode_f >= flt.GUARD_HOLD > prev_gmode:
                self.events.append(self._t, evt.EV_GUARD_HOLD, evt.SRC_NRM,
                                   (prev_gmode, self._pcap_applied))
            if gmode_f >= flt.GUARD_FAILSAFE > prev_gmode:
                reg.counter("nrm_failsafe_entries_total",
                            "live guard failsafe entries").inc()
                self.events.append(self._t, evt.EV_GUARD_FAILSAFE,
                                   evt.SRC_NRM,
                                   (prev_gmode, self._pcap_applied))
            if prev_gmode >= flt.GUARD_HOLD > gmode_f:
                self.events.append(self._t, evt.EV_GUARD_RECOVER,
                                   evt.SRC_NRM,
                                   (prev_gmode, self._pcap_applied))
        return rec

    # ---- full simulated run (paper evaluation setup) -----------------------
    def run_simulated(self, total_work: float, max_time: float = 3600.0,
                      seed: int = 0,
                      faults: Optional[flt.FaultSchedule] = None,
                      record_events: Union[None, bool, int] = None
                      ) -> Dict[str, np.ndarray]:
        """Closed loop against the simulated plant until work completes.

        Continues the run on the scan engine (`sim.resume_init` +
        ``sim.simulate_closed_loop(init=)``; its step bucket is
        `sim._bucket_steps(ceil(max_time / sampling_period))`, whatever
        the work). NRM and actuator state (controller, estimator or
        policy, detector, guard, plant, last measurement, noise position)
        is threaded through, so repeated calls continue where the last
        run stopped. The per-step loop (`_run_simulated_python`) remains
        as the equivalence oracle.

        ``record_events=True`` (or a ring size) arms the flight recorder;
        the packed ring is threaded across calls, so a later segment keeps
        appending to the same timeline (once armed, later calls keep
        recording unless ``record_events=False``). Decode the timeline
        with `flight_events()`."""
        if not isinstance(self.actuator, SimulatedPowerActuator):
            raise TypeError("run_simulated drives a SimulatedPowerActuator; "
                            f"this NRM has {type(self.actuator).__name__}")
        kwargs = {}
        rls = None
        policy_state = None
        if self._policy is not None:
            kwargs = {"policy": self._policy}
            if (self._policy_state is None
                    and self._policy.branch not in ("pi", "pi_rls")):
                # first call, non-PI policy: fresh policy state. PI-branch
                # policies leave policy_state None so resume_init packs
                # the (possibly checkpoint-restored) controller.state
                self._policy_state = pol.policy_init(
                    self._policy,
                    pol.policy_values(self._policy, self.profile,
                                      self.gains),
                    self.gains).to(self.device)
            policy_state = self._policy_state
        elif self._rls_cfg is not None:
            kwargs = {"adaptive": self._rls_cfg, "design": self.profile}
            rls = self._rls_state
            if rls is None:  # fresh estimator around the design model
                rls = rls_init(rls_values(self._rls_cfg, self.profile,
                                          self.gains),
                               self.gains.k_p, self.gains.k_i)
        if self._detector is not None:
            kwargs["detector"] = self._detector
        if self._guard is not None:
            kwargs["guard"] = self._guard
        if faults is not None:
            kwargs["faults"] = faults
        ev_state = self._event_state
        if record_events is None and ev_state is not None:
            # a previous segment armed the recorder: keep recording at
            # the same ring size so the in-ring total stays monotonic
            record_events = evt.ring_capacity(np.asarray(ev_state))
        if record_events is None or record_events is False:
            ev_state = None
            self._event_state = None
        else:
            kwargs["record_events"] = record_events
        act = self.actuator
        init = sim.resume_init(act.state, self.controller.state, act._pcap,
                               rls=rls, policy_state=policy_state,
                               det_state=self._det_state,
                               guard_state=(self._guard_state
                                            if self._guard is not None
                                            else None),
                               event_state=ev_state)
        res = sim.simulate_closed_loop(
            act.profile, gains=self.gains, total_work=total_work,
            max_time=max_time, dt=self.cfg.sampling_period,
            seed=_segment_seed(act.seed, seed, act.periods), init=init,
            device=self.device, **kwargs)
        dev = self.device
        self._t = res.exec_time
        if res.pi_state is not None:
            self.controller.state = PIState(
                prev_error=_on(res.pi_state.prev_error, dev),
                prev_pcap_l=_on(res.pi_state.prev_pcap_l, dev))
        if self._policy is not None:
            # round-trip the packed policy state exactly like the RLS
            # estimator's: the next call resumes, not restarts
            self._policy_state = _on(res.policy_state, dev)
        if res.detector_state is not None:
            # the detector continues live (control_step) where the run
            # ended
            self._det_state = _on(res.detector_state, dev)
        if res.guard_state is not None:
            self._guard_state = _on(res.guard_state, dev)
        if res.event_state is not None:
            self._event_state = np.asarray(res.event_state)
        ps = res.plant_state
        act.state = PlantState(progress_l=_on(ps.progress_l, dev),
                               dropped=_on(ps.dropped, dev, torch.bool),
                               energy=_on(ps.energy, dev),
                               work=_on(ps.work, dev))
        act._pcap = res.pcap
        self._pcap_applied = float(res.pcap)
        if res.n_steps:
            act._last_meas = {
                "power": float(res.traces["power"][-1]),
                "progress": float(res.traces["progress"][-1]),
                "pcap": res.pcap,
            }
        if res.rls_state is not None and self._rls_cfg is not None:
            # pc_cfg.adaptive path only (an adaptive PIPolicy passed via
            # policy= threads its estimator inside _policy_state); the
            # same state feeds the next control_step's plane_step call
            self._rls_state = RLSState(*(
                _on(x, dev, torch.bool if x.dtype == bool else torch.float32)
                for x in res.rls_state))
            self.controller.gains = dataclasses.replace(
                self.controller.gains, k_p=float(res.rls_state.k_p),
                k_i=float(res.rls_state.k_i))
        # the actuator's stream moves past this run, so a later advance()
        # does not replay the engine's periods
        act.periods += res.n_steps
        return res.traces

    def flight_events(self) -> list:
        """Decoded flight-recorder timeline (the last N events across
        every recorded `run_simulated` segment); [] before the first
        record_events= run."""
        if self._event_state is None:
            return []
        return evt.decode_ring(self._event_state)

    def serve(self, port: int = 0, host: str = "127.0.0.1"):
        """Start a `repro_torch.obs.serve.ObsServer` (daemon thread)
        exposing this NRM mid-run: ``/events?log=nrm`` tails the host
        decision log, ``/events?log=flight`` the decoded in-scan flight
        recorder (refreshed per request), ``/metrics`` the process
        registry a `run_simulated` loop publishes into. Returns the
        running server (``.url``, ``.stop()``)."""
        from repro_torch.obs import serve as obs_serve
        return obs_serve.start_server(
            port=port, host=host,
            event_sources={"nrm": self.events, "flight": self.flight_events})

    def _run_simulated_python(self, total_work: float,
                              max_time: float = 3600.0,
                              seed: int = 0) -> Dict[str, np.ndarray]:
        """Reference per-step loop (adaptive path + equivalence tests).

        Deliberately does NOT go through plane_step: the numpy
        `RLSAdapter` here is the float64 oracle the packed estimator is
        tested against."""
        adapter = None
        if self._rls_cfg is not None:
            c = self._rls_cfg
            adapter = RLSAdapter(self.gains, self.profile, lam=c.lam,
                                 dwell=c.dwell, kl_clamp=c.kl_clamp,
                                 p_trace_max=c.p_trace_max)
        rng = np.random.default_rng(seed)
        dt = self.cfg.sampling_period
        traces = {"t": [], "progress": [], "pcap": [], "power": [],
                  "energy": [], "work": []}
        t = 0.0
        while t < max_time:
            meas = self.actuator.advance(dt)
            t += dt
            self._t = t
            # synthesize heartbeats for this period at the measured rate
            n = max(0, int(rng.poisson(max(meas["progress"], 0.0) * dt)))
            for i in range(n):
                self.hb.beat(t - dt + (i + 0.5) * dt / max(n, 1))
            progress = self.hb.progress(t)
            if adapter is not None:
                self.controller.gains = adapter.update(
                    self.controller.gains, progress,
                    float(self.controller.state.prev_pcap_l), dt)
            pcap = self.controller.step(progress, dt)
            self.actuator.set_pcap(pcap)
            energy, work = torch.stack([self.actuator.state.energy,
                                        self.actuator.state.work]).tolist()
            traces["t"].append(t)
            traces["progress"].append(progress)
            traces["pcap"].append(pcap)
            traces["power"].append(meas["power"])
            traces["energy"].append(energy)
            traces["work"].append(work)
            if work >= total_work:
                break
        return {k: np.asarray(v) for k, v in traces.items()}

    # ---- checkpointable state ----------------------------------------------
    def state_dict(self) -> dict:
        """JSON-able lists in the reference's layout (a reference
        checkpoint loads here as it is, and this one there)."""
        lst = lambda x: np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                                   else x, np.float32).tolist()
        d = {
            "prev_error": float(self.controller.state.prev_error),
            "prev_pcap_l": float(self.controller.state.prev_pcap_l),
            "t": self._t,
        }
        if self._policy_state is not None:
            d["policy_state"] = lst(self._policy_state)
        if self._rls_state is not None:
            d["rls_state"] = lst(rls_pack(self._rls_state))
        if self._det_state is not None:
            d["det_state"] = lst(self._det_state)
        if self._guard_state is not None:
            d["guard_state"] = lst(self._guard_state)
        if self._event_state is not None:
            d["event_state"] = lst(self._event_state)
        d["pcap_applied"] = self._pcap_applied
        # re-excitation probe position IS run state: losing it would
        # restart (or drop) the post-alarm dither across a kill/resume
        d["reexcite"] = [self._reexcite_left, self._reexcite_i]
        # the heartbeat ring buffer IS run state: without it, the first
        # post-restore control period sees zero progress and commands a
        # transient the pre-kill run never saw
        d["heartbeats"] = self.hb.state_dict()
        return d

    def load_state_dict(self, d: dict) -> None:
        dev = self.device
        self.controller.state = PIState(prev_error=_on(d["prev_error"], dev),
                                        prev_pcap_l=_on(d["prev_pcap_l"],
                                                        dev))
        self._t = float(d["t"])
        # restore OR reset: a checkpoint without policy/estimator state
        # (saved before any run) must not leave stale state behind
        ps = d.get("policy_state")
        if ps is not None and self._policy is None:
            raise ValueError("checkpoint carries policy state but this "
                             "NRM has no policy=; configure the same "
                             "policy before loading")
        self._policy_state = None if ps is None else _on(ps, dev)
        ds = d.get("det_state")
        if ds is not None and self._detector is None:
            raise ValueError("checkpoint carries change-point detector "
                             "state but this NRM has no detector=; "
                             "configure a DetectorConfig before loading")
        self._det_state = None if ds is None else _on(ds, dev)
        gs = d.get("guard_state")
        if gs is not None and self._guard is None:
            raise ValueError("checkpoint carries guard state but this "
                             "NRM has no guard=; configure the same "
                             "GuardConfig before loading")
        self._guard_state = None if gs is None else _on(gs, dev)
        es = d.get("event_state")
        # restore OR reset, like the rest: no config gate (recording is a
        # run_simulated argument, not a constructor choice)
        self._event_state = (None if es is None
                             else np.asarray(es, np.float32))
        self._pcap_applied = float(d.get("pcap_applied",
                                         self.profile.pcap_max))
        rx = d.get("reexcite", [0, 0])
        self._reexcite_left, self._reexcite_i = int(rx[0]), int(rx[1])
        hb = d.get("heartbeats")
        if hb is not None:
            self.hb.load_state_dict(hb)
        rs = d.get("rls_state")
        if rs is not None and self._rls_cfg is None:
            raise ValueError("checkpoint carries RLS estimator state but "
                             "this NRM is not adaptive; set "
                             "PowerControlConfig(adaptive=True) before "
                             "loading")
        if rs is None:
            self._rls_state = None
            if self._rls_cfg is not None:
                # pre-run checkpoint: back to the design-model placement
                self.controller.gains = self.gains
        else:
            self._rls_state = rls_unpack(_on(rs, dev))
            self.controller.gains = dataclasses.replace(
                self.controller.gains, k_p=float(self._rls_state.k_p),
                k_i=float(self._rls_state.k_i))
