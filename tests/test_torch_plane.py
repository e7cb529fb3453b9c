"""The port's multi-tenant control plane (`repro_torch.core.plane`:
`tick_fn`, `ControlPlane`, `PlaneSnapshot`) against the reference's
`repro.core.plane`, on the CPU, and mirrors of the reference's plane
tests.

Tolerances, and why:

* the same tenants, the same ingested beats and the same power readings
  through both planes for 20 ticks: progress (host numpy in both) bit for
  bit, alarms and guard modes equal, commands within rtol 1e-6. The
  reference's tick is one jitted, vmapped graph, in which XLA contracts
  multiply-adds and fuses the Eq. 2 exp/log, so even its PI rows sit an
  ulp or two from op-by-op float32 (the port's arithmetic, and the
  reference's eager NRM, which the port matches bit for bit); RLS rows
  under guard resets restart from a fresh covariance on that ulp and are
  held to rtol 1e-4, as for `control_step`;
* a reference snapshot carried across by `convert` restores in the port
  and makes the reference's next decisions at the same bars;
* within the port (mirrors of `tests/test_plane.py` and the plane tests
  of `tests/test_obs.py`): the reference's own bars — bit for bit for
  chunking, snapshots, kill/resume and quarantine neutrality; rel 1e-3
  against the NRM; rtol 1e-6 / atol 1e-4 mixed plane against solo
  planes.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import faults as jflt  # noqa: E402
from repro.core import plane as jplane  # noqa: E402
from repro.core import policies as jpol  # noqa: E402
from repro.core.adaptive import RLSConfig as JRLS  # noqa: E402
from repro.core.workloads.detect import DetectorConfig as JDet  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import PowerControlConfig  # noqa: E402
from repro_torch.core import faults as flt  # noqa: E402
from repro_torch.core import policies as pol  # noqa: E402
from repro_torch.core.adaptive import RLSConfig  # noqa: E402
from repro_torch.core.controller import PIGains  # noqa: E402
from repro_torch.core.nrm import NRM  # noqa: E402
from repro_torch.core.plane import ControlPlane, _bucket, plane_step  # noqa: E402,E501
from repro_torch.core.plant import PROFILES  # noqa: E402
from repro_torch.core.policies import (DutyCyclePolicy,  # noqa: E402
                                       OfflineRLPolicy, PIPolicy)
from repro_torch.core.workloads.detect import (DetectorConfig,  # noqa: E402
                                               detect_init,
                                               detector_values)
from repro_torch.obs import events as evt  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402

CPU = dict(device="cpu")
GUARD = dict(hold_k=2, failsafe_k=5)


def _beats(rng, rate, t, dt):
    n = int(rng.poisson(rate * dt))
    return [t - dt + (j + 0.5) * dt / max(n, 1) for j in range(n)]


# ---- the port's plane against the reference's ---------------------------

# (ids, policy, detector, guard, blackout ticks) per tenant group
_MIX = [
    ([f"pi{i}" for i in range(5)], "pi", False, False, ()),
    (["rls0", "rls1"], "rls", False, False, ()),
    (["dc0", "dc1"], "dc", False, False, ()),
    (["det0", "det1"], "pi", True, False, ()),
    (["g0"], "pi", False, True, ()),
    (["g1"], "pi", False, True, range(5, 14)),
    (["grls"], "rls", False, True, range(4, 12)),
]


def _mixed_plane(ref: bool):
    if ref:
        mod, P, R, D, G = jplane, jpol, JRLS, JDet, jflt.GuardConfig
        p = mod.ControlPlane(profile="gros", dt=1.0)
    else:
        mod, P, R, D, G = None, pol, RLSConfig, DetectorConfig, \
            flt.GuardConfig
        p = ControlPlane(profile="gros", dt=1.0, **CPU)
    kinds = {"pi": lambda: None, "rls": lambda: P.PIPolicy(adaptive=R()),
             "dc": lambda: P.DutyCyclePolicy()}
    for ids, kind, det, guard, _ in _MIX:
        p.add_tenants(len(ids), ids=ids, policy=kinds[kind](),
                      detector=D(threshold=6.0, min_gap=5) if det
                      else None, guard=G(**GUARD) if guard else None)
    return p


def _drive_both(a, b, ticks, rng, k0=0):
    """Feed both planes the same beats (a rate drop at tick 10, the
    blackouts of `_MIX`) and power readings (every third slot NaN, the
    model-estimate fallback); yields each tick's two decision dicts."""
    out = []
    black = {t: set(bo) for ids, *_, bo in _MIX for t in ids}
    for k in range(k0, k0 + ticks):
        t = a._t + 1.0
        ids, times = [], []
        for i, tid in enumerate(a._slots):
            if k in black.get(tid, ()):
                continue
            bts = _beats(rng, (20.0 + 3.0 * i) if k < 10 else 6.0, t, 1.0)
            ids += [tid] * len(bts)
            times += bts
        a.ingest(ids, times)
        b.ingest(ids, times)
        pw = rng.uniform(60.0, 120.0, a.capacity).astype(np.float32)
        pw[::3] = np.nan
        out.append((a.tick(power=pw), b.tick(power=pw)))
    return out


def _rtol(tid):
    if tid == "grls":
        return 1e-4
    return 1e-6


def test_plane_tick_matches_reference():
    """Twenty ticks of a mixed plane (PI, RLS-PI, duty-cycle, detector and
    guarded rows, one guarded PI and one guarded RLS tenant blacked out
    and recovering) in both packages."""
    mine, ref = _mixed_plane(False), _mixed_plane(True)
    assert mine._slots == ref._slots and mine.capacity == ref.capacity
    np.testing.assert_array_equal(mine._gains, np.asarray(ref._gains))
    np.testing.assert_allclose(mine._pvals, np.asarray(ref._pvals),
                               rtol=1e-6)
    np.testing.assert_allclose(mine._pstate, np.asarray(ref._pstate),
                               rtol=1e-6)
    alarms = engaged = 0
    rng = np.random.default_rng(0)
    for k, (dm, dr) in enumerate(_drive_both(mine, ref, 20, rng)):
        assert set(dm) == set(dr)
        for key in ("progress", "phase_change", "guard_mode"):
            np.testing.assert_array_equal(dm[key], np.asarray(dr[key]),
                                          err_msg=f"tick {k} {key}")
        for tid, s in mine._slots.items():
            for key in ("pcap", "applied"):
                np.testing.assert_allclose(
                    dm[key][s], np.asarray(dr[key])[s], rtol=_rtol(tid),
                    err_msg=f"tick {k} {tid} {key}")
        alarms += int(dm["phase_change"].sum())
        engaged += int((dm["guard_mode"] >= flt.GUARD_FAILSAFE).sum())
    assert alarms > 0 and engaged > 0
    assert mine.quarantined() == ref.quarantined() == []
    assert [(e.code, e.payload) for e in mine.events.events()] == [
        (e.code, e.payload) for e in ref.events.events()]
    np.testing.assert_array_equal(mine._gstate[:, :2],
                                  np.asarray(ref._gstate)[:, :2])


def test_reference_snapshot_restores_and_ticks_equal():
    """A reference plane's snapshot after 6 ticks, carried across by
    `convert.plane_snapshot_from_reference`, restores in the port and
    makes the reference plane's next 8 decisions."""
    ref = _mixed_plane(True)
    twin = _mixed_plane(True)
    rng = np.random.default_rng(1)
    _drive_both(ref, twin, 6, rng)
    snap = convert.plane_snapshot_from_reference(
        pickle.loads(pickle.dumps(ref.snapshot())))
    mine = ControlPlane.restore(snap, **CPU)
    assert mine._slots == ref._slots and mine._t == ref._t
    np.testing.assert_array_equal(mine._pstate, np.asarray(ref._pstate))
    for k, (dm, dr) in enumerate(_drive_both(mine, ref, 8, rng, k0=6)):
        np.testing.assert_array_equal(dm["progress"],
                                      np.asarray(dr["progress"]))
        for tid, s in mine._slots.items():
            np.testing.assert_allclose(dm["applied"][s],
                                       np.asarray(dr["applied"])[s],
                                       rtol=_rtol(tid),
                                       err_msg=f"tick {k} {tid}")
    # a tampered carried snapshot is refused like a port one
    bad = convert.plane_snapshot_from_reference(ref.snapshot())
    bad.pstate[0, 0] += 1.0
    with pytest.raises(ValueError, match="fingerprint"):
        ControlPlane.restore(bad, **CPU)


# ---- mirrors of tests/test_plane.py (the ControlPlane tests) ------------

def test_plane_single_tenant_tracks_nrm():
    plane = ControlPlane(profile="gros", epsilon=0.1, dt=1.0, **CPU)
    plane.add_tenant("node0")
    nrm = NRM(PowerControlConfig(epsilon=0.1, plant_profile="gros"), **CPU)
    rng = np.random.default_rng(3)
    t = 0.0
    for k in range(50):
        t += 1.0
        bts = _beats(rng, 3.0 + (k % 5), t, 1.0)
        if bts:
            plane.ingest(["node0"] * len(bts), bts)
            for bt in bts:
                nrm.heartbeat(t=bt)
        dec = plane.tick()
        rec = nrm.control_step(dt=1.0)
        s = plane.slot("node0")
        assert dec["progress"][s] == pytest.approx(rec.progress, abs=1e-5)
        assert dec["applied"][s] == pytest.approx(
            float(np.clip(rec.pcap, nrm.profile.pcap_min,
                          nrm.profile.pcap_max)), rel=1e-3)


def test_plane_many_pi_tenants_track_independent_nrms():
    plane = ControlPlane(profile="gros", dt=1.0, **CPU)
    epss = [0.05, 0.1, 0.2]
    nrms = []
    for i, eps in enumerate(epss):
        plane.add_tenant(f"n{i}", epsilon=eps)
        nrms.append(NRM(PowerControlConfig(epsilon=eps,
                                           plant_profile="gros"), **CPU))
    rng = np.random.default_rng(4)
    t = 0.0
    for k in range(40):
        t += 1.0
        ids, times = [], []
        for i, nrm in enumerate(nrms):
            bts = _beats(rng, 10.0 + 5.0 * i, t, 1.0)
            ids += [f"n{i}"] * len(bts)
            times += bts
            for bt in bts:
                nrm.heartbeat(t=bt)
        if ids:
            plane.ingest(ids, times)
        dec = plane.tick()
        for i, nrm in enumerate(nrms):
            rec = nrm.control_step(dt=1.0)
            s = plane.slot(f"n{i}")
            assert dec["applied"][s] == pytest.approx(
                float(np.clip(rec.pcap, nrm.profile.pcap_min,
                              nrm.profile.pcap_max)), rel=1e-3), \
                f"tenant {i} period {k}"


def test_heterogeneous_plane_matches_single_branch_planes():
    mk = dict(profile="gros", dt=1.0, detector=DetectorConfig(), **CPU)
    mixed = ControlPlane(**mk)
    policies = {"a": None, "b": DutyCyclePolicy(),
                "c": PIPolicy(adaptive=RLSConfig()),
                "d": OfflineRLPolicy(weights=(0.2,) * pol.N_FEATURES)}
    solos = {}
    for tid, p in policies.items():
        mixed.add_tenant(tid, policy=p)
        solos[tid] = ControlPlane(**mk)
        solos[tid].add_tenant(tid, policy=p)
    rng = np.random.default_rng(5)
    t = 0.0
    for k in range(30):
        t += 1.0
        for i, tid in enumerate(policies):
            rate = 25.0 + 10.0 * i if k < 15 else 6.0
            bts = _beats(rng, rate, t, 1.0)
            if bts:
                mixed.ingest([tid] * len(bts), bts)
                solos[tid].ingest([tid] * len(bts), bts)
        dec = mixed.tick()
        for tid in policies:
            solo = solos[tid].tick()
            np.testing.assert_allclose(
                dec["applied"][mixed.slot(tid)],
                solo["applied"][solos[tid].slot(tid)],
                rtol=1e-6, atol=1e-4, err_msg=f"{tid} period {k}")


def test_add_remove_leaves_survivor_state_untouched():
    plane = ControlPlane(profile="gros", dt=1.0, **CPU)
    for i in range(3):
        plane.add_tenant(f"n{i}")
    rng = np.random.default_rng(6)
    t = 0.0
    for k in range(5):
        t += 1.0
        for i in range(3):
            bts = _beats(rng, 20.0, t, 1.0)
            plane.ingest([f"n{i}"] * len(bts), bts)
        plane.tick()
    s0, s2 = plane.slot("n0"), plane.slot("n2")
    keep = (plane._pstate[[s0, s2]].copy(), plane._pcap[[s0, s2]].copy(),
            plane.store.counts()[[s0, s2]].copy())
    victim = plane.slot("n1")
    plane.remove_tenant("n1")
    new_id = plane.add_tenant("n3", policy=DutyCyclePolicy())
    assert plane.slot("n3") == victim
    np.testing.assert_array_equal(plane._pstate[[s0, s2]], keep[0])
    np.testing.assert_array_equal(plane._pcap[[s0, s2]], keep[1])
    np.testing.assert_array_equal(plane.store.counts()[[s0, s2]], keep[2])
    assert plane.n_tenants == 3 and new_id == "n3"
    with pytest.raises(KeyError):
        plane.slot("n1")
    with pytest.raises(ValueError, match="already registered"):
        plane.add_tenant("n0")


def test_capacity_grows_in_buckets_preserving_state():
    assert _bucket(1) == 16 and _bucket(17) == 32 and _bucket(100) == 128
    plane = ControlPlane(profile="gros", dt=1.0, capacity=16, **CPU)
    plane.add_tenant("n0")
    plane.ingest(["n0"] * 3, [0.2, 0.5, 0.8])
    plane.tick()
    row = plane._pstate[plane.slot("n0")].copy()
    plane.add_tenants(40)
    assert plane.capacity == 64 and plane.n_tenants == 41
    np.testing.assert_array_equal(plane._pstate[plane.slot("n0")], row)
    plane.tick()


def test_chunked_tick_streams_and_matches_unchunked():
    a = ControlPlane(profile="gros", dt=1.0, **CPU)
    b = ControlPlane(profile="gros", dt=1.0, **CPU)
    ids = [f"n{i}" for i in range(20)]
    for p in (a, b):
        for tid in ids:
            p.add_tenant(tid)
    rng = np.random.default_rng(7)
    t, seen = 0.0, []
    for k in range(3):
        t += 1.0
        batch_ids, times = [], []
        for i, tid in enumerate(ids):
            bts = _beats(rng, 5.0 + i, t, 1.0)
            batch_ids += [tid] * len(bts)
            times += bts
        a.ingest(batch_ids, times)
        b.ingest(batch_ids, times)
        seen.clear()
        da = a.tick(chunk_size=8,
                    consume=lambda lo, hi, out: seen.append((lo, hi)))
        db = b.tick()
        assert seen[0][0] == 0 and seen[-1][1] == a.capacity
        for k_ in ("pcap", "applied", "phase_change", "progress"):
            np.testing.assert_array_equal(da[k_], db[k_], err_msg=k_)


def _demo_plane():
    plane = ControlPlane(profile="gros", dt=1.0,
                         detector=DetectorConfig(threshold=8.0), **CPU)
    plane.add_tenant("pi0")
    plane.add_tenant("dc0", policy=DutyCyclePolicy())
    plane.add_tenant("rls0", policy=PIPolicy(adaptive=RLSConfig()))
    return plane


_DRIVE = """
def _drive(plane, n_ticks, k0):
    out = []
    for k in range(k0, k0 + n_ticks):
        t = plane._t + 1.0
        ids, times = [], []
        for tid in ("pi0", "dc0", "rls0"):
            nb = 2 + (plane.slot(tid) + k) % 3
            ids += [tid] * nb
            times += [t - 1.0 + (j + 0.5) / nb for j in range(nb)]
        plane.ingest(ids, times)
        dec = plane.tick()
        out.append([dec["applied"][plane.slot(tid)]
                    for tid in ("pi0", "dc0", "rls0")])
    return np.asarray(out)
"""
exec(_DRIVE)  # deterministic beats, shared with the child process below


def test_snapshot_roundtrip_and_tamper_rejection():
    plane = _demo_plane()
    _drive(plane, 4, 0)  # noqa: F821
    twin = ControlPlane.restore(pickle.loads(pickle.dumps(plane.snapshot())),
                                **CPU)
    np.testing.assert_array_equal(_drive(plane, 4, 4),  # noqa: F821
                                  _drive(twin, 4, 4))  # noqa: F821
    bad = pickle.loads(pickle.dumps(plane.snapshot()))
    bad.pstate[0, 0] += 1.0
    with pytest.raises(ValueError, match="fingerprint"):
        ControlPlane.restore(bad, **CPU)


def test_snapshot_kill_resume_across_processes(tmp_path):
    plane = _demo_plane()
    _drive(plane, 4, 0)  # noqa: F821
    snap_path = tmp_path / "plane.pkl"
    with open(snap_path, "wb") as f:
        pickle.dump(plane.snapshot(), f)
    expect = _drive(plane, 4, 4)  # noqa: F821
    script = textwrap.dedent("""
        import pickle, sys
        import numpy as np
        from repro_torch.core.plane import ControlPlane
    """) + _DRIVE + textwrap.dedent("""
        with open(sys.argv[1], "rb") as f:
            plane = ControlPlane.restore(pickle.load(f), device="cpu")
        np.save(sys.argv[2], _drive(plane, 4, 4))
    """)
    out_path = tmp_path / "resumed.npy"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src")
    subprocess.run([sys.executable, "-c", script, str(snap_path),
                    str(out_path)], check=True, env=env, timeout=240)
    np.testing.assert_array_equal(np.load(out_path), expect)


def test_plane_step_detector_mask_freezes_state():
    prof = PROFILES["gros"]
    gains = PIGains.from_model(prof, 0.1)
    dv = detector_values(DetectorConfig(threshold=0.5, min_gap=0,
                                        drift=0.0), prof, **CPU)
    ds0 = detect_init(dv, gains)
    vals = pol.policy_values(PIPolicy(), prof, gains)
    st = pol.policy_init(PIPolicy(), vals, gains)
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    args = (gains, "pi", vals, st, f(prof.pcap_max), f(0.0), f(100.0),
            f(1.0))
    _, ds_on, _, _ = plane_step(*args, det_vals=dv, det_state=ds0,
                                det_on=f(1.0))
    _, ds_off, _, ch_off = plane_step(*args, det_vals=dv, det_state=ds0,
                                      det_on=f(0.0))
    assert float(ch_off) == 0.0
    np.testing.assert_array_equal(ds_off.numpy(), ds0.numpy())
    assert not np.array_equal(ds_on.numpy(), ds0.numpy())


def test_snapshot_nan_poisoned_state_rejected_despite_valid_hash():
    plane = _demo_plane()
    _drive(plane, 3, 0)  # noqa: F821
    snap = pickle.loads(pickle.dumps(plane.snapshot()))
    snap.pstate[0, 0] = np.nan
    snap.fingerprint = snap.digest()
    with pytest.raises(ValueError, match="non-finite"):
        ControlPlane.restore(snap, **CPU)
    snap2 = pickle.loads(pickle.dumps(plane.snapshot()))
    snap2.guard_state[1, 0] = np.inf
    snap2.fingerprint = snap2.digest()
    with pytest.raises(ValueError, match="non-finite"):
        ControlPlane.restore(snap2, **CPU)


def test_guard_quarantine_leaves_other_tenants_bit_identical():
    mk = dict(profile="gros", dt=1.0, guard=flt.GuardConfig(**GUARD), **CPU)
    healthy = ControlPlane(**mk)
    chaos = ControlPlane(**mk)
    ids = ["n0", "sick", "n2"]
    for p in (healthy, chaos):
        for tid in ids:
            p.add_tenant(tid)
    t = 0.0
    engaged = False
    for k in range(14):
        t += 1.0
        for p in (healthy, chaos):
            for tid in ids:
                if p is chaos and tid == "sick" and k >= 3:
                    continue
                nb = 4 + (k + len(tid)) % 3
                p.ingest([tid] * nb,
                         [t - 1.0 + (j + 0.5) / nb for j in range(nb)])
        dh = healthy.tick()
        dc = chaos.tick()
        for tid in ("n0", "n2"):
            sh, sc = healthy.slot(tid), chaos.slot(tid)
            for key in ("pcap", "applied", "progress"):
                np.testing.assert_array_equal(
                    dh[key][sh], dc[key][sc],
                    err_msg=f"{tid}/{key} tick {k}")
        engaged = engaged or float(dc["guard_mode"][chaos.slot("sick")]) > 0
    assert engaged
    assert chaos.quarantined() == ["sick"] and healthy.quarantined() == []
    t += 1.0
    for tid in ids:
        chaos.ingest([tid] * 4, [t - 1.0 + (j + 0.5) / 4 for j in range(4)])
    chaos.tick()
    assert chaos.quarantined() == []


# ---- mirrors of the plane tests of tests/test_obs.py ---------------------

def test_plane_quarantine_events_and_snapshot_carry():
    plane = ControlPlane(profile="gros", dt=1.0,
                         guard=flt.GuardConfig(**GUARD), **CPU)
    plane.add_tenants(2, ids=["ok", "sick"])
    added = evt.filter_events(plane.events.events(),
                              code=evt.EV_TENANT_ADDED)
    assert len(added) == 1 and added[0].payload[0] == 2
    t = 0.0
    for k in range(10):
        t += 1.0
        for tid in (["ok"] if k >= 2 else ["ok", "sick"]):
            plane.ingest([tid] * 4,
                         [t - 1.0 + (j + 0.5) / 4 for j in range(4)])
        plane.tick()
    assert plane.quarantined() == ["sick"]
    q_in = evt.filter_events(plane.events.events(),
                             code=evt.EV_QUARANTINE_ENTER)
    assert len(q_in) == 1 and q_in[0].source == evt.SRC_PLANE
    assert int(q_in[0].payload[1]) == plane.slot("sick")
    for k in range(3):
        t += 1.0
        for tid in ("ok", "sick"):
            plane.ingest([tid] * 4,
                         [t - 1.0 + (j + 0.5) / 4 for j in range(4)])
        plane.tick()
    assert plane.quarantined() == []
    assert evt.filter_events(plane.events.events(),
                             code=evt.EV_QUARANTINE_EXIT)
    resumed = ControlPlane.restore(plane.snapshot(), **CPU)
    assert [e.as_dict() for e in resumed.events.events()] == \
        [e.as_dict() for e in plane.events.events()]
    plane.remove_tenant("sick")
    assert evt.filter_events(plane.events.events(),
                             code=evt.EV_TENANT_REMOVED)
    reg = obs_metrics.get_registry()
    assert reg.gauge("plane_tenants", "live tenant rows").value() >= 1
    assert reg.counter("plane_ticks_total", "").value() >= 13
    assert reg.histogram("plane_tick_seconds", "").value()["count"] >= 13


def test_plane_old_snapshots_without_events_still_restore():
    import dataclasses as dc
    plane = ControlPlane(profile="gros", dt=1.0, **CPU)
    plane.add_tenants(1, ids=["a"])
    resumed = ControlPlane.restore(dc.replace(plane.snapshot(),
                                              events=None), **CPU)
    assert resumed.slot("a") == plane.slot("a")
