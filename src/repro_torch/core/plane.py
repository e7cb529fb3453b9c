"""The control plane's packing and its single control-law step (with the
change-point detector and the guard); the part of `repro.core.plane`
that the scan engine needs (the batched multi-tenant plane, `tick_fn`
and `ControlPlane`, is a later slice of the port)."""
from __future__ import annotations

import torch

from repro_torch.core import faults as flt
from repro_torch.core import policies as pol
from repro_torch.core.controller import PIGains
from repro_torch.core.workloads.detect import detect_step

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
