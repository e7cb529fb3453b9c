"""Flight recorder: a fixed-width event ring riding the scan engine's
carry; port of `repro.obs.events`.

The engine (`repro_torch.core.sim.engine_step`) runs a whole grid as one
step loop on the device, so it cannot report *when* things happened —
guard escalations, detector alarms, phase flips — without a record that
travels with each run. The recorder is a packed float32 row per run:

  ``[total, prev_phase, prev_fault, row0 .. row{N-1}]``

where each row is ``(sim_time, event_code, source_id, p0, p1, p2, p3)``.
``total`` counts every event ever appended (monotonic); rows are written
at ``total % capacity`` so overflow evicts oldest-first. The two
``prev_*`` header slots carry the last-seen phase index / fault-active
flag so edge-triggered events (phase flip, fault enter/exit) need no
wider carry.

Neutrality: the ring is an optional carry field that is ``None`` when
recording is off, so recorder-off runs compute exactly what the
recorder-free engine computes; a recorder-on run only observes.

Host side, ``decode_ring`` unpacks a ring into typed ``Event`` records
(oldest surviving first); ``EventLog`` is the eager host-path twin with
the same capacity/oldest-first semantics and a picklable ``state_dict``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device

# ---------------------------------------------------------------- layout
EVENT_WIDTH = 7        # (sim_time, event_code, source_id, payload[4])
HEADER = 3             # [0]=total appended, [1]=prev phase, [2]=prev fault
H_TOTAL, H_PREV_PHASE, H_PREV_FAULT = 0, 1, 2
DEFAULT_MAX_EVENTS = 64

EVENT_NAMES = (
    "none",
    "detector_alarm",    # change-point detector fired
    "guard_hold",        # guard mode crossed into HOLD
    "guard_failsafe",    # guard mode crossed into FAILSAFE
    "guard_recover",     # guard mode returned to NORMAL
    "recovery_reset",    # guard routed an on_change recovery reset
    "phase_flip",        # workload schedule switched phases
    "fault_enter",       # any scripted fault window became active
    "fault_exit",        # all scripted fault windows cleared
    "quarantine_enter",  # plane: tenant escalated to FAILSAFE
    "quarantine_exit",   # plane: tenant left FAILSAFE
    "tenant_added",      # plane: slot allocated
    "tenant_removed",    # plane: slot freed
    # appended codes stay append-only: decoded rings from older
    # checkpoints keep their numbering
    "chunk_retry",        # supervisor: chunk attempt failed, backing off
    "chunk_dead",         # supervisor: chunk dead-lettered
    "device_quarantine",  # supervisor: device marked suspect
    "device_reinstate",   # supervisor: quarantined device probed back
    "campaign_resume",    # supervisor: campaign reopened from journal
    "reexcite",           # nrm: post-alarm re-excitation dither applied
)
(EV_NONE, EV_DETECTOR_ALARM, EV_GUARD_HOLD, EV_GUARD_FAILSAFE,
 EV_GUARD_RECOVER, EV_RECOVERY_RESET, EV_PHASE_FLIP, EV_FAULT_ENTER,
 EV_FAULT_EXIT, EV_QUARANTINE_ENTER, EV_QUARANTINE_EXIT,
 EV_TENANT_ADDED, EV_TENANT_REMOVED, EV_CHUNK_RETRY, EV_CHUNK_DEAD,
 EV_DEVICE_QUARANTINE, EV_DEVICE_REINSTATE, EV_CAMPAIGN_RESUME,
 EV_REEXCITE) = range(len(EVENT_NAMES))

SOURCE_NAMES = ("sim", "guard", "detector", "schedule", "faults",
                "plane", "nrm", "supervisor")
(SRC_SIM, SRC_GUARD, SRC_DETECTOR, SRC_SCHEDULE, SRC_FAULTS,
 SRC_PLANE, SRC_NRM, SRC_SUPERVISOR) = range(len(SOURCE_NAMES))


def ring_dim(max_events: int) -> int:
    return HEADER + int(max_events) * EVENT_WIDTH


def ring_capacity(vec) -> int:
    """Slot count of a packed ring (from its last axis)."""
    return (int(vec.shape[-1]) - HEADER) // EVENT_WIDTH


def ring_init(max_events: int, shape: Tuple[int, ...] = (),
              device: Union[None, str, torch.device] = None
              ) -> torch.Tensor:
    """Fresh empty rings, ``shape + (ring_dim(max_events),)`` float32 on
    ``device`` (CUDA unless told otherwise). ``prev_phase`` starts at -1
    (unknown, so the first observed phase does not register as a
    flip)."""
    if max_events < 1:
        raise ValueError(f"max_events must be >= 1, got {max_events}")
    vec = torch.zeros(tuple(shape) + (ring_dim(max_events),),
                      dtype=torch.float32, device=resolve_device(device))
    vec[..., H_PREV_PHASE] = -1.0
    return vec


def _slot_index(vec: torch.Tensor) -> torch.Tensor:
    """(..., EVENT_WIDTH) int64 positions of each ring's next row."""
    slot = torch.remainder(vec[..., H_TOTAL].to(torch.int64),
                           ring_capacity(vec))
    offsets = torch.arange(HEADER, HEADER + EVENT_WIDTH, device=vec.device)
    return torch.add(offsets, slot[..., None], alpha=EVENT_WIDTH)


def _per_ring(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a tensor or a scalar) as one value per ring, shaped and
    typed like ``like``; a scalar is filled on the rings' device (a copy
    from the host would make the card wait)."""
    if isinstance(x, torch.Tensor):
        return x.to(like.dtype).expand_as(like)
    return torch.full_like(like, x)


def _event_row(vec, t, code, source, payload) -> torch.Tensor:
    """(..., EVENT_WIDTH) float32 rows for the rings ``vec``."""
    like = vec[..., H_TOTAL]
    return torch.stack([_per_ring(x, like) for x in
                        (t, float(code), float(source)) + tuple(payload)],
                       -1)


def ring_append(vec: torch.Tensor, fire, t, code: int, source: int,
                p0=0.0, p1=0.0, p2=0.0, p3=0.0) -> torch.Tensor:
    """Conditionally append one event to each ring of ``vec`` ((...,
    ring_dim)), where ``fire`` ((...) bool, or a bool) holds; ``t`` and
    the payload are (...) tensors or scalars. Returns new rings.

    Each ring's next slot (``total % capacity``) is gathered, replaced by
    the event where ``fire`` holds, and scattered back: a ring that does
    not fire gets its own bits written back, and only the 7 words of one
    slot per ring move. Oldest-first eviction falls out of writing at
    ``total % capacity``."""
    return ring_append_(vec.clone(), fire, t, code, source, p0, p1, p2, p3)


def ring_append_(vec: torch.Tensor, fire, t, code: int, source: int,
                 p0=0.0, p1=0.0, p2=0.0, p3=0.0) -> torch.Tensor:
    """`ring_append` in place: writes into ``vec`` and returns it (the
    scan engine appends up to nine events a step into one copy of its
    rings)."""
    if isinstance(fire, torch.Tensor):
        fire = fire.expand(vec.shape[:-1])
    else:
        fire = torch.full(vec.shape[:-1], bool(fire), device=vec.device)
    idx = _slot_index(vec)
    old = torch.gather(vec, -1, idx)
    row = _event_row(vec, t, code, source, (p0, p1, p2, p3))
    vec.scatter_(-1, idx, torch.where(fire[..., None], row, old))
    vec[..., H_TOTAL].add_(fire)
    return vec


def ring_total(vec) -> int:
    """Monotonic count of every event ever appended (survivors + evicted)."""
    v = vec.cpu().numpy() if isinstance(vec, torch.Tensor) else vec
    return int(round(float(np.asarray(v)[..., H_TOTAL])))


# ------------------------------------------------------------ host decode
@dataclasses.dataclass(frozen=True)
class Event:
    """One decoded recorder event (host-side, typed)."""
    t: float
    code: int
    name: str
    source: int
    source_name: str
    payload: Tuple[float, float, float, float]

    def as_dict(self) -> Dict[str, Any]:
        return {"t": self.t, "code": self.code, "name": self.name,
                "source": self.source, "source_name": self.source_name,
                "payload": list(self.payload)}


def _mk_event(row: np.ndarray) -> Event:
    code = int(row[1])
    src = int(row[2])
    name = EVENT_NAMES[code] if 0 <= code < len(EVENT_NAMES) else f"?{code}"
    sname = (SOURCE_NAMES[src] if 0 <= src < len(SOURCE_NAMES)
             else f"?{src}")
    return Event(t=float(row[0]), code=code, name=name, source=src,
                 source_name=sname, payload=tuple(float(x) for x in row[3:7]))


def _host(vec) -> np.ndarray:
    return (vec.detach().cpu().numpy() if isinstance(vec, torch.Tensor)
            else np.asarray(vec))


def decode_ring(vec) -> List[Event]:
    """Unpack one ring (a tensor or array) into Events, oldest surviving
    first."""
    v = np.asarray(_host(vec), dtype=np.float64)
    if v.ndim != 1:
        raise ValueError(f"decode_ring wants a 1-d ring, got shape {v.shape}"
                         " (use decode_grid for batched axes)")
    cap = ring_capacity(v)
    total = int(round(v[H_TOTAL]))
    rows = v[HEADER:].reshape(cap, EVENT_WIDTH)
    n = min(total, cap)
    start = total % cap if total > cap else 0
    return [_mk_event(rows[(start + i) % cap]) for i in range(n)]


def decode_grid(arr) -> np.ndarray:
    """Decode a grid of rings (any leading axes) -> object ndarray of
    ``List[Event]`` with the same leading shape."""
    a = _host(arr)
    lead = a.shape[:-1]
    out = np.empty(lead, dtype=object)
    for idx in np.ndindex(*lead) if lead else [()]:
        out[idx] = decode_ring(a[idx])
    return out if lead else out[()]


# ------------------------------------------------------- host event log
class EventLog:
    """Eager host-path twin of the in-scan ring: bounded, oldest-first
    eviction, monotonic total.

    ``capacity`` is the maxlen bound (mirroring the ring contract):
    appends beyond it evict oldest-first and increment ``dropped``. Attach
    a ``sink`` (anything with ``write(dict)`` or a plain callable) to
    stream EVERY appended event before eviction. Sink failures are
    counted (``sink_errors``), never raised: observability must not take
    down the control path."""

    def __init__(self, capacity: int = 256, sink: Optional[Any] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._rows: List[Event] = []
        self.total = 0
        self.dropped = 0
        self.sink_errors = 0
        self._sink = sink

    def set_sink(self, sink: Optional[Any]) -> None:
        self._sink = sink

    def append(self, t: float, code: int, source: int,
               payload: Sequence[float] = ()) -> Event:
        p = tuple(float(x) for x in payload)[:4]
        p = p + (0.0,) * (4 - len(p))
        ev = _mk_event(np.array([t, code, source, *p], dtype=np.float64))
        self._rows.append(ev)
        over = len(self._rows) - self.capacity
        if over > 0:
            del self._rows[:over]
            self.dropped += over
        self.total += 1
        if self._sink is not None:
            try:
                write = getattr(self._sink, "write", self._sink)
                write(ev.as_dict())
            except Exception:
                self.sink_errors += 1
        return ev

    def events(self) -> List[Event]:
        return list(self._rows)

    def __len__(self) -> int:
        return len(self._rows)

    def state_dict(self) -> Dict[str, Any]:
        return {"capacity": self.capacity, "total": self.total,
                "dropped": self.dropped,
                "rows": [[e.t, e.code, e.source, *e.payload]
                         for e in self._rows]}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.capacity = int(d["capacity"])
        self.total = int(d["total"])
        # pre-drop-counter snapshots: the evicted count is derivable
        self.dropped = int(d.get("dropped",
                                 max(0, int(d["total"]) - len(d["rows"]))))
        self._rows = [_mk_event(np.asarray(r, dtype=np.float64))
                      for r in d["rows"]]


def filter_events(events: Sequence[Event], *,
                  code: Optional[int] = None,
                  source: Optional[int] = None) -> List[Event]:
    return [e for e in events
            if (code is None or e.code == code)
            and (source is None or e.source == source)]
