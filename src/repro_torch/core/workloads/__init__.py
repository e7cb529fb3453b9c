"""Phased-workload subsystem: time-varying plants + phase-change
detection; port of `repro.core.workloads`.

* `schedule` — `PhaseSchedule`: a script of (duration, plant-delta)
  segments packed into fixed-width tensors that the scan engine
  (`repro_torch.core.sim`) gathers from by each run's sim-time, plus
  generators (STREAM<->DGEMM alternation, roofline-derived schedules,
  randomized Markov chains for property tests).
* `detect` — an online change-point detector (two-sided Page-Hinkley /
  CUSUM on progress-model residuals) carried in the engine's state,
  which on detection routes the policy state through the policy
  contract's `on_change` hook.
"""
from repro_torch.core.workloads.detect import (DET_PARAM_FIELDS,
                                               DET_STATE_DIM,
                                               DetectorConfig, detect_init,
                                               detect_step, detector_values)
from repro_torch.core.workloads.schedule import (MAX_PHASES, Phase,
                                                 PhaseSchedule,
                                                 ScheduleValues,
                                                 active_profile, chain_rows,
                                                 markov_schedule,
                                                 roofline_schedule,
                                                 stream_dgemm_schedule)

__all__ = [
    "MAX_PHASES", "Phase", "PhaseSchedule", "ScheduleValues",
    "active_profile", "chain_rows", "markov_schedule",
    "roofline_schedule", "stream_dgemm_schedule", "DET_PARAM_FIELDS",
    "DET_STATE_DIM", "DetectorConfig", "detect_init", "detect_step",
    "detector_values",
]
