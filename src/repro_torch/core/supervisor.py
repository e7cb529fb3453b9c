"""Durable campaign supervisor: crash-safe, self-healing sweeps; port of
`repro.core.supervisor`.

`repro_torch.core.executor.run_grid` makes huge grids bounded (chunking,
sharding, resumable `ExecState`); this layer makes them durable. A
week-long campaign must survive kill -9, out-of-memory errors,
preemption and lost devices. Four mechanisms, one loop:

* **Write-ahead chunk journal**: every planned / started / committed
  chunk is an append-only, fsync'd, CRC-guarded JSONL record in
  ``<dir>/journal.jsonl``, beside an atomically replaced `ExecState`
  checkpoint (``state.pkl``, tmp + ``os.replace``). `resume_campaign`
  reopens the directory after any crash and replays exactly the
  uncommitted chunks; because every run's parameters and random streams
  ride in its own row, the resumed result is bit for bit the
  uninterrupted one. A torn tail (partial last record) is dropped and its
  chunk replayed.
* **Retry / timeout / backoff ladder**: each chunk attempt runs under an
  optional wall-clock watchdog (`CampaignConfig.chunk_timeout_s`, a
  worker thread + ``join(timeout)``). A CUDA launch cannot be interrupted
  either, but a timed-out zombie is benign: it enqueues on the same
  stream as the retry, computes the same rows from the same seeds and
  writes the same bytes into the same buffer rows. Transient failures
  (``torch.OutOfMemoryError`` "CUDA out of memory", ``MemoryError``,
  injected test faults) retry with the shared
  `repro_torch.obs.retry.RetryPolicy` ladder; a chunk that exhausts its
  budget or fails permanently is dead-lettered and the campaign goes on.
* **Device quarantine**: a failure attributed to a device marks it
  suspect; the remaining chunks re-plan over the largest surviving subset
  that divides the planned chunk (the fingerprint pins ``n_runs x
  chunk``), down to one device. After `CampaignConfig.probe_after` clean
  commits the oldest quarantined device is probed back in.
* **Chaos harness**: `FlakyGridFn` scripts deterministic failures per
  chunk attempt, driving every rung of the ladder in tests.

Sticky CUDA errors. An illegal memory access, an unspecified launch
failure or a device-side assert poisons the CUDA context of the process:
every later launch on that device fails, so retrying in-process would
dead-letter every remaining chunk. `classify_failure` reads them (and
`DeviceLost`) as ``"device"``. When such a failure leaves no device to
fall back to (one device, or the last one active), the campaign stops:
the checkpoint is written, the journal gets a ``halt`` record, and
`CampaignHalted` is raised. The directory is intact, and
`resume_campaign(dir)` in a fresh process (a new CUDA context) finishes
it, bit for bit.

Durability semantics: in **buffer mode** the checkpoint is
authoritative: journal commits newer than the last checkpoint are
recomputed on resume (bit-identical, counted as
``supervisor_chunks_replayed_total``). In **consume mode** the journal is
authoritative: committed chunks were already delivered downstream and
are never re-delivered (at-least-once overall: a crash between delivery
and commit re-delivers that one chunk; the consume wrapper dedupes within
a process).

Entry points: `sim.sweep(..., durable=dir)`,
`policies.offline_rl.harvest_dataset(..., durable=dir)` and
`hierarchy.fleet_sweep(..., durable=dir)` save a pickled
campaign spec into the directory (devices as strings, never a
`torch.device` bound to a context); `resume_campaign(dir)` re-dispatches
it and returns the finished result. A child process that runs a
campaign on the card is started fresh (spawned or exec'd), never forked
from a process that has initialised CUDA.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import random
import signal
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import executor
from repro_torch.obs import events as evt
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.retry import RetryPolicy
from repro_torch.obs.sink import JsonlSink

JOURNAL_NAME = "journal.jsonl"
CHECKPOINT_NAME = "state.pkl"
SPEC_NAME = "campaign.pkl"
EVENTS_NAME = "events.jsonl"

_BACKOFF_BUCKETS = (0.01, 0.05, 0.25, 1.0, 5.0, 30.0)


# ------------------------------------------------------------- failures
class ChunkTimeout(RuntimeError):
    """A chunk attempt exceeded the watchdog's wall-clock deadline."""


class TransientFault(RuntimeError):
    """An injected (or classified) transient failure: always retried."""


class DeviceLost(RuntimeError):
    """A shard's device dropped out mid-chunk. ``device_id`` (the
    device's position in the campaign's device tuple) lets the
    supervisor quarantine the right device."""

    def __init__(self, device_id: Optional[int] = None,
                 msg: str = "device lost"):
        super().__init__(f"{msg} (device {device_id})")
        self.device_id = device_id


class CampaignHalted(RuntimeError):
    """A device failure left no device to run on (a sticky CUDA error
    poisons the process's context). Journal and checkpoint are intact:
    `resume_campaign` in a fresh process finishes the campaign."""


# substrings of exception text that mark a failure worth retrying (the
# runtime's allocation and availability errors, and the chaos harness's
# own marker), and those that mark a lost or poisoned device
_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "DEADLINE_EXCEEDED",
                      "UNAVAILABLE", "ABORTED", "out of memory",
                      "transient")
_DEVICE_MARKERS = ("device lost", "lost device", "device failure",
                   "illegal memory access", "unspecified launch failure",
                   "device-side assert", "misaligned address",
                   "illegal instruction")


def classify_failure(exc: BaseException) -> str:
    """Map one failed chunk attempt to a ladder rung: ``"device"``
    (quarantine + retry, or halt without a device to fall back to),
    ``"timeout"`` / ``"transient"`` (retry with backoff) or
    ``"permanent"`` (dead-letter)."""
    if isinstance(exc, DeviceLost):
        return "device"
    if isinstance(exc, ChunkTimeout):
        return "timeout"
    if isinstance(exc, (TransientFault, MemoryError,
                        torch.OutOfMemoryError)):
        return "transient"
    text = f"{type(exc).__name__}: {exc}"
    if any(m in text for m in _DEVICE_MARKERS):
        return "device"
    if any(m in text for m in _TRANSIENT_MARKERS):
        return "transient"
    return "permanent"


# -------------------------------------------------------------- journal
class Journal:
    """Append-only, fsync'd, CRC-guarded JSONL writer.

    Every record carries a ``crc`` of its canonical serialization;
    `read_journal` drops a torn tail (partial or garbled LAST line: the
    write a crash interrupted) and raises on corruption anywhere else.
    ``append`` returns only after the line is fsync'd: a record in the
    journal survives kill -9."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")

    def append(self, rec: Dict[str, Any]) -> None:
        body = json.dumps(rec, sort_keys=True, separators=(",", ":"))
        line = json.dumps({**rec, "crc": zlib.crc32(body.encode())},
                          sort_keys=True, separators=(",", ":"))
        self._fh.write(line + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        self._fh.close()


def read_journal(path) -> Tuple[List[Dict[str, Any]], int]:
    """Parse a journal -> (records, torn) where ``torn`` counts dropped
    partial tail records (0 or 1). A bad record that is NOT the tail is
    real corruption and raises."""
    with open(path, encoding="utf-8") as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.strip()]
    records: List[Dict[str, Any]] = []
    for i, ln in enumerate(lines):
        try:
            d = json.loads(ln)
            crc = d.pop("crc")
            body = json.dumps(d, sort_keys=True, separators=(",", ":"))
            if zlib.crc32(body.encode()) != crc:
                raise ValueError("crc mismatch")
        except (ValueError, KeyError, TypeError, AttributeError):
            if i == len(lines) - 1:
                return records, 1  # torn tail: drop, replay its chunk
            raise ValueError(f"corrupt campaign journal {path} at line "
                             f"{i + 1} (not the tail — refusing to "
                             "resume)")
        records.append(d)
    return records, 0


def _atomic_write(path: Path, data: bytes) -> None:
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


# ------------------------------------------------------------ config/report
@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    """Supervisor knobs. Picklable: rides the campaign spec, so a resume
    replays the same ladder.

    ``chunk_timeout_s`` arms the per-attempt watchdog (None = no
    deadline). ``checkpoint_every`` is the commit cadence of `ExecState`
    snapshots (buffer-mode checkpoints carry the merged buffers:
    O(n_runs) bytes each; consume-mode checkpoints are tiny).
    ``probe_after`` is the clean-commit count before a quarantined device
    is probed back in. ``kill_after_commits`` / ``kill_signal`` are the
    chaos harness's crash injector: the process signals ITSELF right
    after the Nth commit record is durable."""
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    chunk_timeout_s: Optional[float] = None
    checkpoint_every: int = 8
    probe_after: int = 4
    seed: int = 0
    kill_after_commits: Optional[int] = None
    kill_signal: int = int(getattr(signal, "SIGKILL", 9))


@dataclasses.dataclass
class CampaignReport:
    """What one `run_durable` call did (returned beside the merged result;
    ``state`` is the final `executor.ExecState`)."""
    dir: str
    n_chunks: int
    committed: int
    replayed: int
    retries: int
    dead: List[Tuple[int, str]]
    quarantined: List[int]
    reinstated: List[int]
    resumed: bool
    torn_records: int
    state: Any = None


# ------------------------------------------------------------- chaos fn
class FlakyGridFn:
    """Deterministic executor-layer fault injector, the sibling of
    `repro_torch.core.faults.FaultyActuator` one level down the stack.

    Wraps a per-chunk engine and scripts failures by CALL INDEX (the
    supervisor processes chunks in order and retries in place, so call
    order is the deterministic timeline): ``failures[i]`` raises that
    exception INSTEAD of computing call ``i``; ``delays[i]`` sleeps
    first (how tests trip the watchdog). Every injection increments the
    per-kind ``supervisor_faults_injected_total`` counter."""

    def __init__(self, fn: Callable,
                 failures: Optional[Mapping[int, BaseException]] = None,
                 delays: Optional[Mapping[int, float]] = None):
        self.fn = fn
        self.failures = dict(failures or {})
        self.delays = dict(delays or {})
        self.calls = 0
        self._injected = obs_metrics.get_registry().counter(
            "supervisor_faults_injected_total",
            "chunk faults injected by FlakyGridFn",
            labelnames=("kind",))

    def __call__(self, batched, *shared):
        i = self.calls
        self.calls += 1
        d = self.delays.get(i)
        if d:
            time.sleep(d)
        exc = self.failures.get(i)
        if exc is not None:
            self._injected.inc(kind=classify_failure(exc))
            raise exc
        return self.fn(batched, *shared)


# ------------------------------------------------------------ the loop
def run_durable(fn: Callable, batched: Any, shared: Tuple, n_runs: int,
                *, dir, chunk_size: Optional[int] = None,
                devices: executor.Devices = None, device=None,
                donate: bool = True, consume: Optional[Callable] = None,
                config: Optional[CampaignConfig] = None
                ) -> Tuple[Any, CampaignReport]:
    """Drive `executor.run_grid` one journaled chunk at a time.

    Same grid contract as `run_grid`; ``dir`` is the campaign directory
    (journal + checkpoint + event stream). Returns ``(merged | None,
    CampaignReport)``: ``merged`` is the bit-for-bit buffers of an
    uninterrupted ``run_grid`` call (None in consume mode). An existing
    journal in ``dir`` resumes: the fingerprint (``n_runs x chunk`` + the
    grid content digest) must match or the call is rejected, exactly like
    `ExecState` resumes. Raises `CampaignHalted` when a device failure
    leaves no device to run on (see the module docstring)."""
    cfg = config or CampaignConfig()
    d = Path(dir)
    d.mkdir(parents=True, exist_ok=True)
    devs = executor.resolve_devices(devices, device)
    chunk = int(chunk_size) if chunk_size else n_runs
    chunk = max(1, min(chunk, n_runs))
    if chunk % len(devs):
        chunk += len(devs) - chunk % len(devs)
    n_chunks = -(-n_runs // chunk)
    dg = executor.digest(batched, shared)
    fingerprint = f"{n_runs}x{chunk}:{dg}"

    reg = obs_metrics.get_registry()
    c_retries = reg.counter(
        "supervisor_retries_total",
        "chunk attempts retried by the campaign supervisor",
        labelnames=("reason",))
    c_dead = reg.counter("supervisor_dead_letter_total",
                         "chunks dead-lettered after exhausting retries")
    c_replayed = reg.counter(
        "supervisor_chunks_replayed_total",
        "journal-committed chunks recomputed on resume (buffer mode)")
    c_resumes = reg.counter("supervisor_campaign_resumes_total",
                            "campaigns reopened from a journal directory")
    c_torn = reg.counter("supervisor_torn_records_total",
                         "partial journal tail records dropped on resume")
    g_quar = reg.gauge("supervisor_quarantined_devices",
                       "devices currently quarantined by the supervisor")
    h_backoff = reg.histogram(
        "supervisor_backoff_seconds",
        "backoff sleeps between chunk retry attempts",
        buckets=_BACKOFF_BUCKETS)

    t0 = time.monotonic()
    _t = lambda: round(time.monotonic() - t0, 3)
    esink = JsonlSink(d / EVENTS_NAME)
    log = evt.EventLog(capacity=256, sink=esink)

    jpath = d / JOURNAL_NAME
    cpath = d / CHECKPOINT_NAME
    state = None
    resumed = False
    torn = 0
    replayed = 0
    dead: Dict[int, str] = {}
    committed_in_journal: set = set()
    if jpath.exists() and jpath.stat().st_size:
        records, torn = read_journal(jpath)
        plan = next((r for r in records if r.get("k") == "plan"), None)
        if plan is None:
            raise ValueError(f"campaign journal {jpath} has no plan "
                             "record")
        if plan["fp"] != fingerprint:
            raise ValueError(f"campaign dir {d} was planned for grid "
                             f"{plan['fp']}, this call is {fingerprint}")
        committed_in_journal = {int(r["ci"]) for r in records
                                if r.get("k") == "commit"}
        dead = {int(r["ci"]): str(r.get("err", "")) for r in records
                if r.get("k") == "dead"}
        if cpath.exists():
            # this program's own checkpoint, written by `_checkpoint`
            with open(cpath, "rb") as fh:
                state = pickle.load(fh)
            if state.fingerprint != fingerprint:
                raise ValueError(f"campaign checkpoint {cpath} was built "
                                 f"for grid {state.fingerprint}, this "
                                 f"call is {fingerprint}")
        resumed = True
    if state is None:
        state = executor.ExecState(n_runs=n_runs, chunk=chunk,
                                   done=np.zeros((n_chunks,), bool),
                                   fingerprint=fingerprint)
    if resumed:
        if consume is not None:
            # journal is authoritative: the consumer already received
            # every committed chunk — never re-deliver
            for ci in committed_in_journal:
                state.done[ci] = True
        else:
            # checkpoint is authoritative: commits newer than the
            # snapshot lost their buffer rows and are recomputed
            # (bit-identical by the one-row-per-run contract)
            replayed = sum(1 for ci in committed_in_journal
                           if not state.done[ci])
            if replayed:
                c_replayed.inc(replayed)
        for ci in dead:
            state.done[ci] = True
        c_resumes.inc()
        if torn:
            c_torn.inc(torn)
        log.append(_t(), evt.EV_CAMPAIGN_RESUME, evt.SRC_SUPERVISOR,
                   (float(state.done.sum()), float(n_chunks),
                    float(replayed), float(torn)))
    journal = Journal(jpath)
    if not resumed:
        journal.append({"k": "plan", "fp": fingerprint, "n_runs": n_runs,
                        "chunk": chunk, "n_chunks": n_chunks,
                        "devices": [str(dv) for dv in devs]})

    rng = random.Random(cfg.seed)
    active: List[int] = list(range(len(devs)))  # device positions
    quarantined: List[Tuple[int, int]] = []  # (device, commits at entry)
    reinstated: List[int] = []
    commits = 0        # commits by THIS process (chaos + probe cadence)
    since_ckpt = 0
    retries = 0
    g_quar.set(0)

    wrapped_consume = None
    if consume is not None:
        delivered = set(committed_in_journal)
        dlock = threading.Lock()

        def wrapped_consume(lo, hi, out):
            # dedupe by chunk: a timed-out zombie attempt and its retry
            # both compute identical rows; downstream must see one copy
            ci = lo // chunk
            with dlock:
                if ci in delivered:
                    return
                delivered.add(ci)
            consume(lo, hi, out)

    def _devices_arg():
        n = len(active)
        if n > 1 and chunk % n == 0:
            return tuple(devs[i] for i in active)
        for s in range(n - 1, 1, -1):
            # the fingerprint pins the chunk, so a surviving subset must
            # divide it; otherwise degrade to the single-device floor
            if chunk % s == 0:
                return tuple(devs[i] for i in active[:s])
        return (devs[active[0]],)

    def _one_chunk():
        return executor.run_grid(
            fn, batched, shared, n_runs, chunk_size=chunk,
            devices=_devices_arg(), donate=donate,
            consume=wrapped_consume, state=state, stop_after=1,
            grid_digest=dg)

    def _attempt():
        if cfg.chunk_timeout_s is None:
            return _one_chunk()
        box: Dict[str, Any] = {}

        def target():
            try:
                box["out"] = _one_chunk()
            except BaseException as e:  # noqa: BLE001 — reraised below
                box["exc"] = e

        th = threading.Thread(target=target, name="campaign-chunk",
                              daemon=True)
        th.start()
        th.join(cfg.chunk_timeout_s)
        if th.is_alive():
            # a launch cannot be interrupted; the zombie thread is left to
            # finish (or not): determinism makes any rows it still writes
            # identical to the retry's
            raise ChunkTimeout(f"chunk exceeded {cfg.chunk_timeout_s}s "
                               "wall-clock deadline")
        if "exc" in box:
            raise box["exc"]
        return box["out"]

    def _checkpoint():
        _atomic_write(cpath, pickle.dumps(state))

    def _quarantine(exc) -> bool:
        """Take the failing device out; False when none is left to run
        on (the campaign must halt)."""
        if len(active) <= 1:
            return False
        did = getattr(exc, "device_id", None)
        victim = did if did in active else active[-1]  # unattributed:
        active.remove(victim)                          # the last shard
        quarantined.append((victim, commits))
        g_quar.set(len(quarantined))
        journal.append({"k": "quarantine", "device": victim})
        log.append(_t(), evt.EV_DEVICE_QUARANTINE, evt.SRC_SUPERVISOR,
                   (float(victim), float(len(active))))
        return True

    while not state.complete:
        before = state.done.copy()
        ci = int(np.argmax(~state.done))
        attempt = 0
        while True:
            journal.append({"k": "start", "ci": ci, "attempt": attempt})
            try:
                _attempt()
                break
            except Exception as e:  # noqa: BLE001 — classified below
                reason = classify_failure(e)
                err = f"{type(e).__name__}: {e}"[:200]
                if reason == "device" and not _quarantine(e):
                    _checkpoint()
                    journal.append({"k": "halt", "ci": ci, "err": err})
                    journal.close()
                    esink.close()
                    raise CampaignHalted(
                        f"chunk {ci}: {err}; no device left to run on. "
                        f"Journal and checkpoint in {d} are intact: "
                        "resume_campaign in a fresh process finishes the "
                        "campaign") from e
                if (reason == "permanent"
                        or attempt >= cfg.retry.max_retries):
                    dead[ci] = err
                    state.done[ci] = True
                    journal.append({"k": "dead", "ci": ci, "err": err})
                    c_dead.inc()
                    log.append(_t(), evt.EV_CHUNK_DEAD,
                               evt.SRC_SUPERVISOR,
                               (float(ci), float(attempt)))
                    break
                delay = cfg.retry.backoff_s(attempt, rng)
                retries += 1
                c_retries.inc(reason=reason)
                h_backoff.observe(delay)
                journal.append({"k": "retry", "ci": ci,
                                "attempt": attempt, "reason": reason})
                log.append(_t(), evt.EV_CHUNK_RETRY, evt.SRC_SUPERVISOR,
                           (float(ci), float(attempt), delay))
                time.sleep(delay)
                attempt += 1
        # commit every newly done chunk (a zombie attempt may have
        # finished a different chunk than the one targeted)
        for done_ci in np.flatnonzero(state.done & ~before):
            if int(done_ci) in dead:
                continue
            journal.append({"k": "commit", "ci": int(done_ci)})
            commits += 1
            since_ckpt += 1
        if (cfg.kill_after_commits is not None
                and commits >= cfg.kill_after_commits):
            # chaos crash injector: the commits above are fsync'd, so the
            # journal the next process resumes from contains them
            os.kill(os.getpid(), cfg.kill_signal)
            time.sleep(30)  # SIGTERM delivery is asynchronous
            raise RuntimeError("chaos kill signal was not delivered")
        if since_ckpt >= cfg.checkpoint_every and not state.complete:
            _checkpoint()
            since_ckpt = 0
            journal.append({"k": "ckpt", "done": int(state.done.sum())})
        if quarantined and commits - quarantined[0][1] >= cfg.probe_after:
            dv, _ = quarantined.pop(0)
            active.append(dv)
            active.sort()
            g_quar.set(len(quarantined))
            reinstated.append(dv)
            journal.append({"k": "reinstate", "device": dv})
            log.append(_t(), evt.EV_DEVICE_REINSTATE, evt.SRC_SUPERVISOR,
                       (float(dv), float(len(active))))

    # final checkpoint + terminal record: a resume of a FINISHED campaign
    # returns the merged result straight from the snapshot
    _checkpoint()
    journal.append({"k": "done", "dead": sorted(dead)})
    journal.close()
    # events are observability, not the durable record (the journal is):
    # buffered writes only need to land on clean completion
    esink.close()
    # dead-lettered chunks leave their buffer rows unfilled; the report
    # names them so callers can mask or re-enqueue
    merged = (state.buffers if consume is None and state.complete
              else None)
    report = CampaignReport(
        dir=str(d), n_chunks=n_chunks, committed=commits,
        replayed=replayed, retries=retries,
        dead=sorted((ci, err) for ci, err in dead.items()),
        quarantined=[dv for dv, _ in quarantined],
        reinstated=reinstated, resumed=resumed, torn_records=torn,
        state=state)
    return merged, report


# --------------------------------------------------------- campaign spec
def _device_strings(v):
    """``device=`` / ``devices=`` values with every `torch.device` as its
    string: a pickled device must not bind the spec to a context."""
    if isinstance(v, torch.device):
        return str(v)
    if isinstance(v, (tuple, list)):
        return [_device_strings(x) for x in v]
    return v


def save_campaign_spec(dir, entry: str, kwargs: Dict[str, Any]) -> None:
    """Persist the campaign's entry point + arguments (pickle, atomic) so
    `resume_campaign` can re-dispatch it. First writer wins: a resume
    re-running the entry point keeps the original spec."""
    d = Path(dir)
    d.mkdir(parents=True, exist_ok=True)
    p = d / SPEC_NAME
    if p.exists():
        return
    kwargs = dict(kwargs)
    for k in ("device", "devices"):
        if k in kwargs:
            kwargs[k] = _device_strings(kwargs[k])
    camp = kwargs.get("campaign")
    if (camp is not None
            and getattr(camp, "kill_after_commits", None) is not None):
        # the chaos crash injector is per-process behavior, not a
        # campaign property: a resume must finish the campaign the crash
        # interrupted, not re-crash it
        kwargs["campaign"] = dataclasses.replace(camp,
                                                 kill_after_commits=None)
    _atomic_write(p, pickle.dumps({"entry": entry, "kwargs": kwargs}))


def resume_campaign(dir):
    """Reopen a campaign directory after a crash (or completion) and drive
    it to the finished result. Dispatches on the saved spec: ``sweep`` ->
    `SweepResult`, ``harvest_dataset`` -> transition arrays,
    ``fleet_sweep`` -> the fleet's traces dict. Uncommitted
    chunks are replayed; the result is bit for bit the uninterrupted
    run's."""
    p = Path(dir) / SPEC_NAME
    if not p.exists():
        raise FileNotFoundError(f"no campaign spec in {dir} — was this "
                                "directory created by a durable= call?")
    # the spec this program wrote with `save_campaign_spec`
    with open(p, "rb") as fh:
        spec = pickle.load(fh)
    entry, kwargs = spec["entry"], dict(spec["kwargs"])
    if entry == "sweep":
        from repro_torch.core import sim
        return sim.sweep(durable=dir, **kwargs)
    if entry == "harvest_dataset":
        from repro_torch.core.policies import offline_rl
        return offline_rl.harvest_dataset(durable=dir, **kwargs)
    if entry == "fleet_sweep":
        from repro_torch.core import hierarchy
        return hierarchy.fleet_sweep(durable=dir, **kwargs)
    raise ValueError(f"unknown campaign entry {entry!r}")
