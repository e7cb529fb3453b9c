"""Phase-scripted, time-varying plants (paper §2: workload phases); port
of `repro.core.workloads.schedule`.

A `PhaseSchedule` scripts the plant's identified parameters over the run:
each `Phase` holds a duration and what the plant looks like during it —
an absolute `PlantProfile`, field overrides (`delta`) and/or field
multipliers (`scale`) applied to the run's base profile. `resolve(base)`
packs the script into `ScheduleValues`: fixed-width float32 tensors
(`chain_rows` rows in `repro_torch.core.plant.PROFILE_FIELDS` order) that
the scan engine gathers from by each run's sim-time, so one step loop
serves every schedule and a grid of schedules is one more batch axis
(`sweep(workloads=[...])`).

Semantics: phase i is active for t in [ends[i-1], ends[i]) (half-open, a
boundary step belongs to the NEW phase). A non-cyclic schedule holds its
last phase forever once the scripted segments are exhausted; a `cyclic`
schedule wraps sim-time modulo its total duration (floored, as
`torch.remainder` computes it).

Generators:

* `stream_dgemm_schedule` — alternates a memory-bound (STREAM: sharp
  knee, large energy headroom) and a compute-bound (DGEMM: shallow knee,
  little headroom) variant of a base profile, via the same saturation ->
  knee mapping `repro_torch.core.phases` uses for roofline cells.
* `roofline_schedule` — phases taken from roofline terms through
  `phases.profile_for_cell` (data/compute movement between devices).
* `markov_schedule` — a randomized phase chain (exponential dwell times,
  uniform jumps) for property tests, drawn from numpy's generator so a
  seed gives the reference's schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.phases import knee_for_saturation, profile_for_cell
from repro_torch.core.plant import PROFILE_FIELDS, PROFILES, PlantProfile

# Piece size of the packed schedule tensors: schedules pack into a whole
# number of MAX_PHASES-row pieces (16 rows cover every paper scenario in
# one piece; longer scripts chain further pieces — `chain_rows`), so a
# grid of schedules shares one row count.
MAX_PHASES = 16

_N_FIELDS = len(PROFILE_FIELDS)


def chain_rows(n_phases: int) -> int:
    """Packed row count for an n-phase schedule: the smallest whole
    number of MAX_PHASES-row pieces that holds it."""
    return MAX_PHASES * max(1, -(-n_phases // MAX_PHASES))


class ScheduleValues(NamedTuple):
    """Packed form of a PhaseSchedule (the engine-facing contract), for
    one run or a batch of runs (leading axes ``...``).

    ``ends`` is the cumulative end time of each phase (+inf padding past
    the last scripted phase); ``profiles`` the per-phase plant rows in
    `PROFILE_FIELDS` order (padding repeats the last row); ``period`` the
    cycle length in seconds, 0 for non-cyclic schedules. Every schedule of
    one grid packs to a common row count (`PhaseSchedule.resolve(rows=)`).
    """
    ends: torch.Tensor      # (..., rows) float32
    profiles: torch.Tensor  # (..., rows, len(PROFILE_FIELDS)) float32
    period: torch.Tensor    # (...) float32; 0 = hold the last phase forever


def active_profile(sched: ScheduleValues, t):
    """(profile row, phase index) active at sim-time ``t`` ((...) float32,
    one time per run): rows (..., len(PROFILE_FIELDS)), int32 indices.

    Half-open segments: the search takes the right side, so a boundary
    time goes to the NEXT phase, matching the engine's half-open control
    windows; the wrap of a cyclic schedule is a floored modulo."""
    t = torch.as_tensor(t, dtype=torch.float32, device=sched.ends.device)
    t_eff = torch.where(sched.period > 0,
                        torch.remainder(t, torch.clamp(sched.period,
                                                       min=1e-9)), t)
    idx = torch.searchsorted(sched.ends, t_eff[..., None], right=True,
                             out_int32=True)[..., 0]
    idx = torch.clamp(idx, 0, sched.ends.shape[-1] - 1)
    row = torch.take_along_dim(sched.profiles,
                               idx.to(torch.int64)[..., None, None],
                               dim=-2)[..., 0, :]
    return row, idx


def _profile_row(p: PlantProfile) -> np.ndarray:
    return np.asarray([getattr(p, f) for f in PROFILE_FIELDS], np.float32)


def _as_items(m) -> Tuple[Tuple[str, float], ...]:
    items = tuple(m.items()) if isinstance(m, Mapping) else tuple(m)
    for f, _ in items:
        if f not in PROFILE_FIELDS:
            raise ValueError(f"unknown plant field {f!r}; choose from "
                             f"{PROFILE_FIELDS}")
    return items


@dataclasses.dataclass(frozen=True)
class Phase:
    """One schedule segment: how long, and what the plant looks like.

    ``profile`` (absolute) replaces the base for this phase; ``delta``
    overrides individual fields; ``scale`` multiplies them — applied in
    that order, so a phase can e.g. take the DGEMM profile and still
    scale its noise."""
    duration: float
    profile: Optional[PlantProfile] = None
    delta: Tuple[Tuple[str, float], ...] = ()
    scale: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.duration <= 0:
            raise ValueError("phase duration must be positive")
        object.__setattr__(self, "delta", _as_items(self.delta))
        object.__setattr__(self, "scale", _as_items(self.scale))

    def resolve(self, base: PlantProfile) -> PlantProfile:
        p = self.profile or base
        kw: Dict[str, float] = dict(self.delta)
        for f, s in self.scale:
            kw[f] = kw.get(f, getattr(p, f)) * s
        return dataclasses.replace(p, **kw) if kw else p


@dataclasses.dataclass(frozen=True)
class PhaseSchedule:
    """A time-ordered script of plant phases (host-side config)."""
    phases: Tuple[Phase, ...]
    cyclic: bool = False
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "phases", tuple(self.phases))
        if not self.phases:
            raise ValueError("a PhaseSchedule needs at least one phase")

    @property
    def duration(self) -> float:
        return float(sum(p.duration for p in self.phases))

    def boundaries(self) -> np.ndarray:
        """Scripted phase-change times within one cycle (test helper)."""
        return np.cumsum([p.duration for p in self.phases[:-1]])

    def pack(self, base: Union[str, PlantProfile],
             rows: Optional[int] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.float32]:
        """The packed (ends, profiles, period) as numpy float32: `resolve`
        without the tensors."""
        base = PROFILES[base] if isinstance(base, str) else base
        n = len(self.phases)
        n_rows = chain_rows(n) if rows is None else int(rows)
        if n_rows < n or n_rows % MAX_PHASES:
            raise ValueError(f"rows={n_rows} cannot hold {n} phases in "
                             f"whole {MAX_PHASES}-row pieces")
        ends = np.full((n_rows,), np.inf, np.float32)
        ends[:n] = np.cumsum([p.duration for p in self.phases])
        rows_ = np.zeros((n_rows, _N_FIELDS), np.float32)
        for i, ph in enumerate(self.phases):
            rows_[i] = _profile_row(ph.resolve(base))
        rows_[n:] = rows_[n - 1]
        if self.cyclic:
            period = float(ends[n - 1])
        else:
            period = 0.0
            ends[n - 1] = np.inf  # hold the last phase forever
        return ends, rows_, np.float32(period)

    def resolve(self, base: Union[str, PlantProfile],
                rows: Optional[int] = None,
                device: Union[None, str, torch.device] = None
                ) -> ScheduleValues:
        """Pack against a base profile -> `ScheduleValues` on ``device``
        (CUDA unless told otherwise).

        ``rows`` overrides the packed row count (a whole number of
        MAX_PHASES pieces >= the phase count): grids stacking short and
        long schedules pass the common `chain_rows` maximum so every
        schedule shares one shape. Scripts longer than one piece pack by
        chaining pieces; the engine's gather does not care how many."""
        ends, rows_, period = self.pack(base, rows)
        dev = resolve_device(device)
        return ScheduleValues(
            ends=torch.from_numpy(ends).to(dev),
            profiles=torch.from_numpy(rows_).to(dev),
            period=torch.from_numpy(np.asarray(period)).to(dev))


# ---- generators -----------------------------------------------------------

# Saturation ratios fed to the roofline knee mapping: STREAM is strongly
# memory-bound (early knee, deep energy headroom), DGEMM strongly
# compute-bound (near-linear power-to-progress).
STREAM_SAT = 3.0
DGEMM_SAT = 0.3


def stream_dgemm_schedule(base: Union[str, PlantProfile] = "gros",
                          dwell: float = 200.0, n_cycles: int = 1,
                          cyclic: bool = False,
                          dgemm_kl_scale: float = 1.0) -> PhaseSchedule:
    """STREAM <-> DGEMM alternation (paper §5.2's two regimes).

    Each cycle is one STREAM dwell followed by one DGEMM dwell; with
    ``cyclic=True`` two phases alternate forever. ``dgemm_kl_scale``
    optionally shifts the compute phase's absolute rate too."""
    base = PROFILES[base] if isinstance(base, str) else base
    stream = knee_for_saturation(base, STREAM_SAT)
    dgemm = knee_for_saturation(base, DGEMM_SAT)
    if dgemm_kl_scale != 1.0:
        dgemm = dataclasses.replace(dgemm, K_L=dgemm.K_L * dgemm_kl_scale)
    pair = [Phase(dwell, profile=stream), Phase(dwell, profile=dgemm)]
    phases = pair if cyclic else pair * n_cycles
    return PhaseSchedule(tuple(phases), cyclic=cyclic,
                         name=f"stream-dgemm-{base.name}")


def roofline_schedule(cells: Sequence[Dict[str, float]],
                      durations: Sequence[float],
                      base: str = "v5e-chip") -> PhaseSchedule:
    """Phases from roofline terms (`phases.roofline_terms` dicts): each
    cell's boundedness becomes that phase's plant knee."""
    if len(cells) != len(durations):
        raise ValueError("one duration per roofline cell")
    phases = tuple(Phase(d, profile=profile_for_cell(c, base))
                   for c, d in zip(cells, durations))
    return PhaseSchedule(phases, name=f"roofline-{base}")


def markov_schedule(seed: int, base: Union[str, PlantProfile] = "gros",
                    states: Optional[Sequence[PlantProfile]] = None,
                    mean_dwell: float = 100.0, n_phases: int = 6
                    ) -> PhaseSchedule:
    """Randomized phase chain for property tests: exponential dwell times
    (floored at one control period) and uniform jumps to a DIFFERENT
    state each boundary."""
    base = PROFILES[base] if isinstance(base, str) else base
    if states is None:
        states = [knee_for_saturation(base, s) for s in
                  (STREAM_SAT, 1.0, DGEMM_SAT)]
    rng = np.random.default_rng(seed)
    cur = int(rng.integers(len(states)))
    phases = []
    for _ in range(n_phases):
        dwell = max(1.0, float(rng.exponential(mean_dwell)))
        phases.append(Phase(dwell, profile=states[cur]))
        if len(states) > 1:
            cur = (cur + 1 + int(rng.integers(len(states) - 1))) \
                % len(states)
    return PhaseSchedule(tuple(phases), name=f"markov-{seed}")
