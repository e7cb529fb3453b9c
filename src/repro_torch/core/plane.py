"""Batched multi-tenant control plane: one tick for thousands of
feedback loops, sharing a single code path with the NRM runtime and the
scan engine; port of `repro.core.plane`.

Layers (bottom to top):

* ``plane_step`` — the control period over a batch of tenants as a pure
  function: change-point detection on the applied cap's model replay,
  the policy's ``on_change`` reaction, then the policy step (with the
  guard around them when armed). The exact control section of
  `sim.engine_step` and of `NRM.control_step`.
* ``tick_fn(branches, guarded)`` — the service tick over (N,) tenant rows:
  gains unpacked per row, NaN power falling back to the model estimate,
  the per-tenant detector enable mask and the applied-cap clip. Plain
  `plane_step` over the rows (the reference vmaps one row; here every op
  is already batched).
* ``ControlPlane`` — the multi-tenant service: tenant add/remove with
  power-of-two capacity buckets, batched heartbeat ingestion through
  `signals.TenantHeartbeatStore`, the tick's rows copied to the device
  through `executor.run_grid` (``consume=`` streams per-chunk decisions),
  the decision stream (`obs.events.EventLog`), the registry metrics, and
  picklable `PlaneSnapshot` state fingerprinted like `executor.ExecState`.
  The tenant rows stay on the host, as the reference keeps them; each
  tick runs on ``device`` (CUDA unless ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import executor
from repro_torch.core import faults as flt
from repro_torch.core import policies as pol
from repro_torch.core.controller import PIGains
from repro_torch.core.plant import PROFILES, PlantProfile
from repro_torch.core.policies.pi import PIPolicy
from repro_torch.core.signals import TenantHeartbeatStore
from repro_torch.core.workloads.detect import (DET_PARAM_DIM, DET_STATE_DIM,
                                               DetectorConfig, detect_init,
                                               detect_step, detector_values)
from repro_torch.obs import events as evt
from repro_torch.obs import metrics as obs_metrics

# Canonical packing order for gain / actuator-context parameters (Eq. 2
# transform, actuator range, setpoint, PI gains).
GAIN_FIELDS = ("k_p", "k_i", "setpoint", "pcap_min", "pcap_max",
               "a", "b", "alpha", "beta")
GAIN_DIM = len(GAIN_FIELDS)


def gains_values(gains: PIGains) -> torch.Tensor:
    """Pack a PIGains into the canonical (GAIN_DIM,) float32 vector."""
    return torch.tensor([getattr(gains, f) for f in GAIN_FIELDS],
                        dtype=torch.float32)


def unpack_gains(vals) -> PIGains:
    """Inverse of `gains_values`: a (..., GAIN_DIM) vector or batch of
    rows -> a PIGains whose fields are (...) tensors (0-dim for one
    vector)."""
    return PIGains(**{f: vals[..., i] for i, f in enumerate(GAIN_FIELDS)})


def plane_step(gains: PIGains, policy, policy_vals, state, pcap_applied,
               progress, power, dt, *, det_vals=None, det_state=None,
               det_on=None, guard_vals=None, guard_state=None,
               guard_on=None):
    """One control period over a batch of tenants (runs) — the single
    control-law code path of the scan engine. Every per-run argument is
    batched over the same leading axes: ``state`` / ``policy_vals`` /
    ``det_*`` / ``guard_state`` rows (..., width), ``progress``,
    ``power``, ``pcap_applied``, ``det_on`` and ``guard_on`` (...).

    Detector first (when ``det_vals`` is not None): the residual is taken
    against the design model's replay of the cap APPLIED over the window
    just measured (``pcap_applied``), and an alarm routes the packed
    policy state through the branch's ``on_change`` hook before the step.
    Then the policy step proper, dispatched through the
    `repro_torch.core.policies` contract (``policy`` is a branch tuple or
    Policy; with more than one branch each row runs the branch of its
    kind, ``policy_vals[..., 0]``). ``det_on`` masks detection per row: a
    masked row's detector state is frozen and its alarm suppressed.
    ``det_vals=None`` runs no detector op at all.

    ``guard_vals`` (packed `repro_torch.core.faults.GuardConfig`, (6,) or
    per row) arms the guarded-degradation layer around the same core, in
    this order: non-finite/outlier sentinels on progress and power
    (rejected signals are replaced by the last accepted ones); the
    stale-signal watchdog (``hold_k`` consecutive invalid periods -> hold
    the applied cap, ``failsafe_k`` -> fail safe to pcap_max); the
    recovery reset (the first fresh signal after a fail-safe routes the
    state through ``on_change``); the divergence rollback (a non-finite
    post-step state rolls back through ``on_change`` and the cap fails
    safe); the freeze of policy and detector state while the watchdog is
    engaged; and the 8-slot guard state. ``guard_on`` masks the guard per
    row (masked rows compute exactly the unguarded arithmetic);
    ``guard_vals=None`` runs no guard op at all.

    Returns ``(new_state, new_det_state, pcap, change)`` with ``change``
    the 0/1 float32 alarm flag (0.0 without a detector) — plus
    ``(new_guard_state, guard_mode)`` when guarded. When no guard trigger
    fires, every guarded output is bit for bit the unguarded one: each
    trigger is a `torch.where` whose false branch is the clean value.
    """
    def core(state_in, progress_in, power_in):
        if det_vals is None:
            det_s, change = det_state, 0.0
            pol_prev = state_in
        else:
            det_s, detected = detect_step(det_vals, det_state, progress_in,
                                          gains.linearize(pcap_applied), dt)
            if det_on is not None:
                on = det_on > 0.5
                detected = detected & on
                det_s = torch.where(on[..., None], det_s, det_state)
            # alarm -> the policy's on_change reaction (RLS covariance
            # reset + immediate gain re-placement for adaptive PI;
            # identity for fixed-gain PI)
            pol_prev = torch.where(
                detected[..., None],
                pol.branch_on_change(policy)(policy_vals, state_in),
                state_in)
            change = detected.to(torch.float32)
        obs = pol.PolicyObs(progress=progress_in, power=power_in, dt=dt,
                            gains=gains, phase_change=change)
        new_state, pcap = pol.branch_step(policy)(policy_vals, pol_prev,
                                                  obs)
        return new_state, det_s, pcap, change

    if guard_vals is None:
        return core(state, progress, power)

    hold_k, failsafe_k, mult, recover = (guard_vals[..., i]
                                         for i in range(4))
    gs = guard_state
    g_s = lambda i: gs[..., i]
    # scalar readings (the NRM's) land on the gains' device
    pg = torch.as_tensor(progress, dtype=torch.float32, device=gains.device)
    g_on = (torch.ones_like(pg, dtype=torch.bool) if guard_on is None
            else guard_on > 0.5)
    # signal sentinels: non-finite, non-positive or wildly out-of-range
    # progress is NOT a measurement — it is a fault symptom
    p_ok = (torch.isfinite(pg) & (pg > 0.0)
            & (pg <= mult * torch.clamp(torch.as_tensor(gains.setpoint),
                                        min=1e-6)))
    p_ok_eff = p_ok | ~g_on  # masked rows treat every signal as valid
    last_pg = g_s(flt.G_LAST_PROGRESS)
    pg_eff = torch.where(p_ok_eff, pg, last_pg)
    if power is None:
        pw = pw_ok = pw_eff = None
    else:
        pw = torch.as_tensor(power, dtype=torch.float32,
                             device=gains.device)
        w_hi = mult * (gains.a * gains.pcap_max + gains.b)
        pw_ok = torch.isfinite(pw) & (pw >= 0.0) & (pw <= w_hi)
        last_pw = g_s(flt.G_LAST_POWER)
        pw_eff = torch.where(pw_ok | ~g_on, pw,
                             torch.where(last_pw > 0.0, last_pw,
                                         gains.a * pcap_applied + gains.b))
    # stale-signal watchdog: consecutive invalid progress periods
    stale = torch.where(p_ok_eff, 0.0, g_s(flt.G_STALE) + 1.0)
    mode = torch.where(stale > failsafe_k, flt.GUARD_FAILSAFE,
                       torch.where(stale > hold_k, flt.GUARD_HOLD,
                                   flt.GUARD_NORMAL))
    # recovery edge: the first fresh signal after a fail-safe routes the
    # state through on_change — estimators re-converge from a reset
    # covariance, not the one identified on garbage
    on_change = pol.branch_on_change(policy)
    recov = (g_on & (g_s(flt.G_MODE) >= flt.GUARD_FAILSAFE) & p_ok
             & (recover > 0.5))
    state_in = torch.where(recov[..., None],
                           on_change(policy_vals, state), state)
    ns, ds, pcap_cmd, change = core(state_in, pg_eff, pw_eff)
    # divergence guard: a non-finite post-step state rolls back to the
    # pre-step value via on_change and the cap fails safe this period
    diverged = g_on & ~torch.isfinite(ns).all(-1)
    ns = torch.where(diverged[..., None], on_change(policy_vals, state_in),
                     ns)
    pcap_cmd = torch.where(diverged, gains.pcap_max, pcap_cmd)
    # degradation ladder: hold the applied cap, then fail safe to
    # pcap_max; an engaged watchdog freezes policy + detector state
    engaged = mode >= flt.GUARD_HOLD
    pcap_out = torch.where(mode >= flt.GUARD_FAILSAFE, gains.pcap_max,
                           torch.where(engaged, pcap_applied, pcap_cmd))
    ns = torch.where(engaged[..., None], state, ns)
    if det_vals is not None:
        ds = torch.where(engaged[..., None], det_state, ds)
    change = torch.where(engaged, 0.0, change)
    inval = (~p_ok).to(torch.float32)
    if power is not None:
        inval = inval + (~pw_ok).to(torch.float32)
    new_gs = torch.stack([
        stale, mode,
        torch.where(p_ok, pg, last_pg),
        (g_s(flt.G_LAST_POWER) if power is None
         else torch.where(pw_ok, pw, g_s(flt.G_LAST_POWER))),
        g_s(flt.G_N_INVALID) + inval,
        g_s(flt.G_N_FAILSAFE) + (mode >= flt.GUARD_FAILSAFE).to(
            torch.float32),
        g_s(flt.G_N_RESETS) + (recov | diverged).to(torch.float32),
        g_s(flt.G_SPARE)], -1)
    new_gs = torch.where(g_on[..., None], new_gs, gs)
    return ns, ds, pcap_out, change, new_gs, mode


@functools.lru_cache(maxsize=None)
def tick_fn(branches: Tuple[str, ...], guarded: bool = False) -> Callable:
    """The batched service tick for one branch set: ``fn(rows, dt)`` runs
    `plane_step` over tenant rows (one function per (branch tuple,
    guarded), so adding tenants of an active policy kind reuses it).

    ``rows`` is a dict of row-major tensors on one device: ``gains`` (N,
    GAIN_DIM), ``pvals`` (N, POLICY_PARAM_DIM), ``pstate`` (N,
    POLICY_STATE_DIM), ``det_vals`` (N, DET_PARAM_DIM), ``det_state`` (N,
    DET_STATE_DIM), ``det_on`` / ``pcap`` / ``progress`` / ``power`` (N,);
    ``dt`` a 0-dim float32 tensor. NaN ``power`` falls back to the
    tenant's model estimate (a * pcap + b), as the NRM's first period
    does. Output rows: the advanced ``pstate`` / ``det_state`` plus
    ``pcap`` (raw command), ``applied`` (clipped to the tenant's actuator
    range) and ``phase_change``.

    With ``guarded=True`` the rows also carry ``guard_vals`` (N,
    GUARD_PARAM_DIM), ``guard_state`` (N, GUARD_STATE_DIM) and
    ``guard_on`` (N,), and the outputs gain ``guard_state`` /
    ``guard_mode``: per-tenant quarantine, a row whose watchdog trips is
    frozen at its held or fail-safe cap without touching the other rows'
    arithmetic (masked rows compute exactly the unguarded values)."""
    def fn(rows: Dict[str, torch.Tensor], dt):
        gains = unpack_gains(rows["gains"])
        pcap_applied = rows["pcap"]
        power = rows["power"]
        power = torch.where(torch.isfinite(power), power,
                            gains.a * pcap_applied + gains.b)
        extra = {}
        if guarded:
            extra = dict(guard_vals=rows["guard_vals"],
                         guard_state=rows["guard_state"],
                         guard_on=rows["guard_on"])
        res = plane_step(gains, branches, rows["pvals"], rows["pstate"],
                         pcap_applied, rows["progress"], power, dt,
                         det_vals=rows["det_vals"],
                         det_state=rows["det_state"],
                         det_on=rows["det_on"], **extra)
        ps2, ds2, pcap, change = res[:4]
        out = {"pstate": ps2, "det_state": ds2, "pcap": pcap,
               "applied": torch.clamp(pcap, gains.pcap_min,
                                      gains.pcap_max),
               "phase_change": change}
        if guarded:
            out["guard_state"], out["guard_mode"] = res[4], res[5]
        return out

    return fn


def _bucket(n: int, lo: int = 16) -> int:
    """Round a tenant count up to a power-of-two capacity bucket, so the
    chunked executor path is shared across nearby plane sizes instead of
    changing shape per add_tenant."""
    b = lo
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class PlaneSnapshot:
    """Picklable whole-plane state (`ExecState`-style): plain numpy arrays
    and host metadata only, so a plane kill/resumes across processes with
    no tenant's controller state lost. ``fingerprint`` (the executor's
    grid digest over the packed rows) guards against restoring a
    corrupted or hand-edited snapshot."""
    capacity: int
    n_tenants: int
    t: float
    dt: float
    branches: Tuple[str, ...]
    slots: Dict[Any, int]
    free: List[int]
    gains: np.ndarray
    pvals: np.ndarray
    pstate: np.ndarray
    det_vals: np.ndarray
    det_state: np.ndarray
    det_on: np.ndarray
    pcap: np.ndarray
    alive: np.ndarray
    store_state: dict
    max_beats: int
    guard_vals: Optional[np.ndarray] = None
    guard_state: Optional[np.ndarray] = None
    guard_on: Optional[np.ndarray] = None
    # decision-stream incident history (EventLog.state_dict): carried so a
    # kill/resume keeps the plane's quarantine/alarm timeline; NOT part of
    # the digest — observability metadata, not control state
    events: Optional[dict] = None
    fingerprint: str = ""

    def digest(self) -> str:
        d = {"gains": self.gains, "pvals": self.pvals,
             "pstate": self.pstate, "det_vals": self.det_vals,
             "det_state": self.det_state, "det_on": self.det_on,
             "pcap": self.pcap, "alive": self.alive}
        if self.guard_vals is not None:
            d.update(guard_vals=self.guard_vals,
                     guard_state=self.guard_state,
                     guard_on=self.guard_on)
        return executor.digest(d, (self.t, self.dt,
                                   ",".join(self.branches)))

    def validate_finite(self) -> None:
        """Reject NaN/inf-poisoned packed rows: the fingerprint only proves
        the snapshot was not modified AFTER it was taken — a plane that
        snapshotted already-diverged state hashes consistently, so restore
        re-checks the payload itself."""
        for name in ("gains", "pvals", "pstate", "det_vals",
                     "det_state", "pcap", "guard_vals", "guard_state"):
            arr = getattr(self, name)
            if arr is not None and not np.isfinite(arr).all():
                raise ValueError(
                    f"snapshot field {name!r} carries non-finite "
                    "values; refusing to restore a NaN-poisoned plane")


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if isinstance(
        x, torch.Tensor) else x, np.float32)


class ControlPlane:
    """Multi-tenant control plane: N feedback loops, one tick.

    Each tenant is one row of the packed host arrays (gains / actuator
    context, policy params + state, detector params + state, guard
    params + state, applied cap). ``tick()`` aggregates every tenant's
    Eq. 1 progress from the shared `TenantHeartbeatStore`, runs detection
    and policy for ALL tenants on ``device`` (one chunk, or chunked
    through `executor.run_grid`, streaming per-chunk decisions to a
    ``consume=`` hook), and records the applied caps for the next
    period's detector replay. Tenants may mix policy kinds."""

    def __init__(self, profile: Union[str, PlantProfile] = "gros",
                 epsilon: float = 0.1, dt: float = 1.0,
                 detector: Optional[DetectorConfig] = None,
                 guard: Optional[flt.GuardConfig] = None,
                 capacity: int = 16, max_beats: int = 64,
                 device: Union[None, str, torch.device] = None):
        self.device = resolve_device(device)
        self.profile = (PROFILES[profile] if isinstance(profile, str)
                        else profile)
        self.epsilon = float(epsilon)
        self.dt = float(dt)
        self.detector = detector          # default for new tenants
        self.guard = guard                # default guard for new tenants
        self._t = 0.0
        self._branches: Tuple[str, ...] = ("pi",)
        self._slots: Dict[Any, int] = {}
        self._free: List[int] = []
        cap = _bucket(capacity)
        self._alloc(cap)
        self.store = TenantHeartbeatStore(cap, max_beats=max_beats)
        self.last: Optional[Dict[str, np.ndarray]] = None
        # decision stream: tenant lifecycle + per-tenant guard/detector
        # incidents (quarantine entry/exit, alarms); a snapshot carries it
        self.events = evt.EventLog()
        self._drops_published = 0.0

    # ---- storage ----------------------------------------------------------
    def _alloc(self, cap: int) -> None:
        self._gains = np.zeros((cap, GAIN_DIM), np.float32)
        self._pvals = np.zeros((cap, pol.POLICY_PARAM_DIM), np.float32)
        self._pstate = np.zeros((cap, pol.POLICY_STATE_DIM), np.float32)
        self._dvals = np.zeros((cap, DET_PARAM_DIM), np.float32)
        self._dstate = np.zeros((cap, DET_STATE_DIM), np.float32)
        self._det_on = np.zeros(cap, np.float32)
        self._gvals = np.zeros((cap, flt.GUARD_PARAM_DIM), np.float32)
        self._gstate = np.zeros((cap, flt.GUARD_STATE_DIM), np.float32)
        self._guard_on = np.zeros(cap, np.float32)
        self._pcap = np.zeros(cap, np.float32)
        self._alive = np.zeros(cap, bool)
        # dead rows still flow through the tick: give them the default
        # profile's context so their (discarded) math stays finite
        self._gains[:] = _np(gains_values(
            PIGains.from_model(self.profile, self.epsilon)))
        self._dvals[:] = _np(detector_values(
            self.detector or DetectorConfig(), self.profile, device="cpu"))
        self._gvals[:] = _np(flt.guard_values(self.guard, device="cpu"))
        self._pcap[:] = self.profile.pcap_max
        self._free = [i for i in range(cap) if not self._alive[i]]

    @property
    def capacity(self) -> int:
        return self._gains.shape[0]

    @property
    def n_tenants(self) -> int:
        return int(self._alive.sum())

    def _grow(self, need: int) -> None:
        old_cap = self.capacity
        cap = _bucket(max(need, old_cap * 2))
        old = (self._gains, self._pvals, self._pstate, self._dvals,
               self._dstate, self._det_on, self._gvals, self._gstate,
               self._guard_on, self._pcap, self._alive)
        old_free = list(self._free)
        self._alloc(cap)
        for dst, src in zip((self._gains, self._pvals, self._pstate,
                             self._dvals, self._dstate, self._det_on,
                             self._gvals, self._gstate, self._guard_on,
                             self._pcap, self._alive), old):
            dst[:old_cap] = src
        self._free = old_free + list(range(old_cap, cap))
        new_store = TenantHeartbeatStore(cap,
                                         max_beats=self.store.max_beats)
        for f in ("_t", "_w", "_n", "_anchor", "_last_emit", "_drops"):
            getattr(new_store, f)[:old_cap] = getattr(self.store, f)
        self.store = new_store

    # ---- tenant lifecycle -------------------------------------------------
    def _kind(self, branch: str) -> int:
        if branch not in self._branches:
            # first tenant of a NEW policy kind: the branch tuple grows
            self._branches = self._branches + (branch,)
        return self._branches.index(branch)

    def add_tenant(self, tenant_id: Any = None, *, policy=None,
                   profile: Union[None, str, PlantProfile] = None,
                   epsilon: Optional[float] = None,
                   detector: Union[None, bool, DetectorConfig] = None,
                   guard: Union[None, bool, flt.GuardConfig] = None
                   ) -> Any:
        """Register one tenant; returns its id (the slot index when no
        ``tenant_id`` is given). ``policy=None`` runs the paper's Eq. 4
        PI; any `repro_torch.core.policies` Policy dispatches its branch.
        ``detector`` overrides the plane default: True / a DetectorConfig
        enables change-point detection for this tenant, False disables
        it. ``guard`` likewise arms (True / a `faults.GuardConfig`) or
        disarms (False) the guarded-degradation layer."""
        return self.add_tenants(1, ids=None if tenant_id is None
                                else [tenant_id], policy=policy,
                                profile=profile, epsilon=epsilon,
                                detector=detector, guard=guard)[0]

    def add_tenants(self, n: int, *, ids: Optional[List[Any]] = None,
                    policy=None,
                    profile: Union[None, str, PlantProfile] = None,
                    epsilon: Optional[float] = None,
                    detector: Union[None, bool, DetectorConfig] = None,
                    guard: Union[None, bool, flt.GuardConfig] = None
                    ) -> List[Any]:
        """Batch-register ``n`` homogeneous tenants in one row write (the
        100k-tenant path: one gains/init computation broadcast to all new
        rows)."""
        if ids is not None and len(ids) != n:
            raise ValueError("ids length must match n")
        prof = (self.profile if profile is None
                else PROFILES[profile] if isinstance(profile, str)
                else profile)
        eps = self.epsilon if epsilon is None else float(epsilon)
        gains = PIGains.from_model(prof, eps)
        p = policy if policy is not None else PIPolicy()
        kind = self._kind(p.branch)
        pv_t = pol.policy_values(p, prof, gains, kind=kind).to(
            torch.float32)
        pstate = _np(pol.branch_init(self._branches)(pv_t, gains))
        det_cfg = (self.detector if detector is None
                   else None if detector is False
                   else DetectorConfig() if detector is True
                   else detector)
        dv_t = detector_values(det_cfg or DetectorConfig(), prof,
                               device="cpu")
        dstate = _np(detect_init(dv_t, gains))
        guard_cfg = (self.guard if guard is None
                     else None if guard is False
                     else flt.GuardConfig() if guard is True
                     else guard)
        if len(self._free) < n:
            self._grow(self.capacity - len(self._free) + n)
        slots = np.asarray(self._free[:n])
        del self._free[:n]
        out_ids = list(ids) if ids is not None else [int(s) for s in slots]
        for tid, s in zip(out_ids, slots):
            if tid in self._slots:
                raise ValueError(f"tenant {tid!r} already registered")
            self._slots[tid] = int(s)
        self._gains[slots] = _np(gains_values(gains))
        self._pvals[slots] = _np(pv_t)
        self._pstate[slots] = pstate
        self._dvals[slots] = _np(dv_t)
        self._dstate[slots] = dstate
        self._det_on[slots] = 0.0 if det_cfg is None else 1.0
        self._gvals[slots] = _np(flt.guard_values(guard_cfg, device="cpu"))
        self._gstate[slots] = 0.0
        self._guard_on[slots] = 0.0 if guard_cfg is None else 1.0
        self._pcap[slots] = prof.pcap_max
        self._alive[slots] = True
        for s in slots:
            self.store.clear_row(int(s))
        # one stream record per ADD CALL (a 100k-row batch add is one
        # decision, not 100k), payload = (count, first slot)
        self.events.append(self._t, evt.EV_TENANT_ADDED, evt.SRC_PLANE,
                           (n, int(slots[0])))
        return out_ids

    def remove_tenant(self, tenant_id: Any) -> None:
        """Unregister a tenant; its row is cleared and recycled. Every
        OTHER tenant's controller/detector/window state is untouched."""
        s = self._slots.pop(tenant_id)
        self.events.append(self._t, evt.EV_TENANT_REMOVED, evt.SRC_PLANE,
                           (1, int(s)))
        self._alive[s] = False
        self._det_on[s] = 0.0
        self._guard_on[s] = 0.0
        self._gstate[s] = 0.0
        self.store.clear_row(s)
        # recycle-first: the freed row is the next one handed out
        self._free.insert(0, s)

    def slot(self, tenant_id: Any) -> int:
        return self._slots[tenant_id]

    # ---- ingestion --------------------------------------------------------
    def ingest(self, tenant_ids, times, works=None) -> None:
        """Batched heartbeat ingestion, any tenant mix (Eq. 1 input).
        ``tenant_ids`` are the ids returned by add_tenant(s); when they are
        the default slot ints the mapping is the identity and the whole
        batch is one vectorized store append."""
        ids = np.asarray(tenant_ids)
        if ids.dtype.kind not in "iu":
            ids = np.asarray([self._slots[t] for t in ids.tolist()])
        self.store.ingest(ids, times, works)

    # ---- the tick ---------------------------------------------------------
    def tick(self, dt: Optional[float] = None, now: Optional[float] = None,
             power=None, consume: Optional[Callable] = None,
             chunk_size: Optional[int] = None, devices=None
             ) -> Dict[str, np.ndarray]:
        """One control period for EVERY tenant.

        Advances the plane clock (``now=`` for an external clock, else
        ``dt``), aggregates each tenant's Eq. 1 progress from the
        heartbeat store on the host, and runs the tick on the plane's
        device. ``power`` optionally supplies per-slot measured power (NaN
        rows fall back to the model estimate). With ``chunk_size=`` the
        rows stream through `executor.run_grid` in chunks —
        ``consume(lo, hi, decisions)`` is called per chunk with that
        slice's decision rows while the plane's state rows update in
        place. Returns the full decision dict (slot-indexed numpy arrays:
        ``pcap``, ``applied``, ``phase_change``, ``progress``; and
        ``guard_mode`` when some tenant is guarded).

        Observability: per-tenant detector alarms and guard-mode crossings
        (hold, quarantine entry/exit) append to ``self.events``, and the
        tick publishes into the process metrics registry
        (``plane_ticks_total``, ``plane_tick_seconds``, tenant/quarantine
        gauges, ``plane_ingest_drops_total``)."""
        t_wall = time.perf_counter()
        if now is not None:
            dt = max(now - self._t, 1e-6) if dt is None else dt
            self._t = now
        else:
            dt = self.dt if dt is None else float(dt)
            self._t += dt
        cap = self.capacity
        progress = self.store.progress_all(self._t).astype(np.float32)
        progress = np.where(self._alive, progress, 0.0).astype(np.float32)
        if power is None:
            pw = np.full(cap, np.nan, np.float32)
        else:
            pw = np.asarray(power, np.float32).reshape(-1)
            if pw.shape != (cap,):
                full = np.full(cap, np.nan, np.float32)
                full[:len(pw)] = pw
                pw = full
        rows = {"gains": self._gains, "pvals": self._pvals,
                "pstate": self._pstate, "det_vals": self._dvals,
                "det_state": self._dstate, "det_on": self._det_on,
                "pcap": self._pcap, "progress": progress, "power": pw}
        # the guard rides the tick only when some live tenant armed it: a
        # guard-free plane keeps running the guard-free arithmetic
        guarded = bool(self._guard_on.any())
        if guarded:
            rows.update(guard_vals=self._gvals, guard_state=self._gstate,
                        guard_on=self._guard_on)
            prev_mode = self._gstate[:, flt.G_MODE].copy()
        fn = tick_fn(self._branches, guarded)
        decisions = {"pcap": np.empty(cap, np.float32),
                     "applied": np.empty(cap, np.float32),
                     "phase_change": np.empty(cap, np.float32)}
        if guarded:
            decisions["guard_mode"] = np.empty(cap, np.float32)

        def _merge(lo, hi, out):
            self._pstate[lo:hi] = out["pstate"]
            self._dstate[lo:hi] = out["det_state"]
            self._pcap[lo:hi] = out["applied"]
            if guarded:
                self._gstate[lo:hi] = out["guard_state"]
            for k in decisions:
                decisions[k][lo:hi] = out[k]
            if consume is not None:
                consume(lo, hi, {k: out[k] for k in decisions})

        executor.run_grid(fn, rows, (torch.tensor(dt, dtype=torch.float32),),
                          cap, chunk_size=chunk_size, devices=devices,
                          device=self.device, donate=False, consume=_merge)
        decisions["progress"] = progress
        self.last = decisions
        # decision stream: edge-triggered incidents only (the common
        # all-healthy tick appends nothing)
        alarms = (decisions["phase_change"] > 0) & (self._det_on > 0.5) \
            & self._alive
        for s in np.nonzero(alarms)[0]:
            self.events.append(self._t, evt.EV_DETECTOR_ALARM,
                               evt.SRC_PLANE, (1, int(s)))
        if guarded:
            mode = self._gstate[:, flt.G_MODE]
            armed = (self._guard_on > 0.5) & self._alive
            q_in = armed & (mode >= flt.GUARD_FAILSAFE) \
                & (prev_mode < flt.GUARD_FAILSAFE)
            q_out = armed & (mode < flt.GUARD_FAILSAFE) \
                & (prev_mode >= flt.GUARD_FAILSAFE)
            held = armed & (mode >= flt.GUARD_HOLD) \
                & (prev_mode < flt.GUARD_HOLD)
            for mask, code in ((held, evt.EV_GUARD_HOLD),
                               (q_in, evt.EV_QUARANTINE_ENTER),
                               (q_out, evt.EV_QUARANTINE_EXIT)):
                for s in np.nonzero(mask)[0]:
                    self.events.append(self._t, code, evt.SRC_PLANE,
                                       (1, int(s)))
        reg = obs_metrics.get_registry()
        reg.counter("plane_ticks_total",
                    "control-plane ticks executed").inc()
        reg.gauge("plane_tenants", "live tenant rows").set(
            float(self._alive.sum()))
        n_quar = (float(((self._gstate[:, flt.G_MODE] >= flt.GUARD_FAILSAFE)
                         & (self._guard_on > 0.5) & self._alive).sum())
                  if guarded else 0.0)
        reg.gauge("plane_quarantined",
                  "tenants held in guard fail-safe").set(n_quar)
        drops = float(self.store._drops.sum())
        if drops > self._drops_published:
            reg.counter("plane_ingest_drops_total",
                        "heartbeats rejected by ingest sanitization"
                        ).inc(drops - self._drops_published)
            self._drops_published = drops
        reg.histogram("plane_tick_seconds",
                      "wall-clock latency of one plane tick").observe(
            time.perf_counter() - t_wall)
        return decisions

    def quarantined(self) -> List[Any]:
        """Tenant ids currently held in fail-safe by their guard (the
        plane's quarantine list): their rows are frozen at pcap_max until
        fresh telemetry arrives, healthy tenants unaffected."""
        mask = (self._gstate[:, flt.G_MODE] >= flt.GUARD_FAILSAFE) \
            & (self._guard_on > 0.5) & self._alive
        return [tid for tid, s in self._slots.items() if mask[s]]

    def serve(self, port: int = 0, host: str = "127.0.0.1"):
        """Start a `repro_torch.obs.serve.ObsServer` (daemon thread) with
        this plane's decision stream attached: ``/metrics`` exposes the
        process registry the plane publishes into, ``/events?log=plane``
        tails its EventLog. Returns the running server (``.url``,
        ``.stop()``); serving never touches the tick path."""
        from repro_torch.obs import serve as obs_serve
        return obs_serve.start_server(
            port=port, host=host, event_sources={"plane": self.events})

    # ---- persistence ------------------------------------------------------
    def snapshot(self) -> PlaneSnapshot:
        """Picklable whole-plane state; `restore` round-trips it across
        processes with every tenant's controller state intact."""
        snap = PlaneSnapshot(
            capacity=self.capacity, n_tenants=self.n_tenants,
            t=self._t, dt=self.dt, branches=self._branches,
            slots=dict(self._slots), free=list(self._free),
            gains=self._gains.copy(), pvals=self._pvals.copy(),
            pstate=self._pstate.copy(), det_vals=self._dvals.copy(),
            det_state=self._dstate.copy(), det_on=self._det_on.copy(),
            pcap=self._pcap.copy(), alive=self._alive.copy(),
            store_state=self.store.state_dict(),
            max_beats=self.store.max_beats,
            guard_vals=self._gvals.copy(),
            guard_state=self._gstate.copy(),
            guard_on=self._guard_on.copy(),
            events=self.events.state_dict())
        snap.fingerprint = snap.digest()
        return snap

    @classmethod
    def restore(cls, snap: PlaneSnapshot, *,
                profile: Union[str, PlantProfile] = "gros",
                epsilon: float = 0.1,
                device: Union[None, str, torch.device] = None
                ) -> "ControlPlane":
        """Rebuild a plane from a snapshot (e.g. after a process kill), on
        ``device`` (CUDA unless ``device="cpu"``). The fingerprint is
        verified first: a snapshot whose packed rows do not hash to the
        recorded digest is rejected loudly, and so is one whose rows are
        not finite."""
        if snap.fingerprint and snap.digest() != snap.fingerprint:
            raise ValueError("snapshot fingerprint mismatch: the packed "
                             "state rows were modified or corrupted")
        # NaN-poisoning is orthogonal to tampering: a diverged plane
        # fingerprints consistently, so the payload is checked too
        snap.validate_finite()
        plane = cls(profile=profile, epsilon=epsilon, dt=snap.dt,
                    capacity=snap.capacity, max_beats=snap.max_beats,
                    device=device)
        plane._t = snap.t
        plane._branches = tuple(snap.branches)
        plane._slots = dict(snap.slots)
        plane._free = list(snap.free)
        plane._gains[:] = snap.gains
        plane._pvals[:] = snap.pvals
        plane._pstate[:] = snap.pstate
        plane._dvals[:] = snap.det_vals
        plane._dstate[:] = snap.det_state
        plane._det_on[:] = snap.det_on
        if snap.guard_vals is not None:
            plane._gvals[:] = snap.guard_vals
            plane._gstate[:] = snap.guard_state
            plane._guard_on[:] = snap.guard_on
        plane._pcap[:] = snap.pcap
        plane._alive[:] = snap.alive
        plane.store.load_state_dict(snap.store_state)
        if snap.events is not None:
            plane.events.load_state_dict(snap.events)
        return plane
