"""The port's flight recorder (`repro_torch.obs.events`: the ring, its
decoders and `EventLog`) and the scan engine's recorder, against the
reference's `repro.obs.events` / `repro.core.sim`.

Tiers:

* function level, bit for bit: the layout constants and names,
  `ring_init`, `ring_append` batched over rings (a per-ring slot
  ``total % capacity``; rings that do not fire keep their bits),
  `decode_ring` / `decode_grid` and `EventLog` round trips;
* engine level: the recorder with every event source (schedule,
  detector, faults, guard) on the reference's own draws, the decoded
  timelines equal event for event (`tests/_torch_scenarios.py`; times
  and payloads at rtol 1e-5, codes and sources exactly);
* mirrors of the ring cases of `tests/test_obs.py` on the port's own
  streams: recorder-on is bitwise neutral in trace and summary mode and
  on a sweep axis, the recorder is excluded from the fast paths, and the
  chaos timeline agrees with the guard's counters and the schedule's
  windows; the chunked half of the sweep case bit-equal to one-shot (the
  NRM resume case is in `tests/test_torch_nrm.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _hypothesis import given, settings, st  # noqa: E402

from repro.obs import events as JE  # noqa: E402

from repro_torch.core import faults as flt  # noqa: E402
from repro_torch.core import sim  # noqa: E402
from repro_torch.core.policies import PIPolicy  # noqa: E402
from repro_torch.obs import events as evt  # noqa: E402

import _torch_scenarios as SC  # noqa: E402

CPU = dict(device="cpu")


def test_layout_and_names_equal_reference():
    for n in ("EVENT_WIDTH", "HEADER", "H_TOTAL", "H_PREV_PHASE",
              "H_PREV_FAULT", "DEFAULT_MAX_EVENTS", "EVENT_NAMES",
              "SOURCE_NAMES"):
        assert getattr(evt, n) == getattr(JE, n), n
    codes = [n for n in vars(JE) if n.startswith(("EV_", "SRC_"))]
    assert codes and all(getattr(evt, n) == getattr(JE, n) for n in codes)
    for cap in (1, 7, 64):
        assert evt.ring_dim(cap) == JE.ring_dim(cap)
        ring = evt.ring_init(cap, **CPU)
        np.testing.assert_array_equal(ring.numpy(),
                                      np.asarray(JE.ring_init(cap)))
        assert evt.ring_capacity(ring) == cap
    assert evt.ring_init(5, (2, 3), **CPU).shape == (2, 3, evt.ring_dim(5))
    with pytest.raises(ValueError, match="max_events"):
        evt.ring_init(0, **CPU)


def test_ring_append_batched_equals_reference():
    """48 appends into 16 rings of 5 slots (overflow, eviction), each ring
    firing on its own pattern with its own times and payloads; the port
    appends to all rings at once, the reference ring by ring."""
    rng = np.random.default_rng(1)
    B, cap = 16, 5
    mine = evt.ring_init(cap, (B,), **CPU)
    ref = jnp.stack([JE.ring_init(cap)] * B)
    app = jax.jit(jax.vmap(JE.ring_append, in_axes=(0, 0, 0, None, None,
                                                     0, 0, 0, 0)),
                  static_argnums=(3, 4))
    for i in range(48):
        fire = rng.uniform(size=B) < 0.6
        t = rng.uniform(0, 100, B).astype(np.float32)
        p = rng.normal(size=(4, B)).astype(np.float32)
        code, src = int(rng.integers(1, 19)), int(rng.integers(0, 8))
        before = mine.clone()
        mine = evt.ring_append(mine, torch.from_numpy(fire),
                               torch.from_numpy(t), code, src,
                               *(torch.from_numpy(x) for x in p))
        ref = app(ref, jnp.asarray(fire), jnp.asarray(t), code, src,
                  *(jnp.asarray(x) for x in p))
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
        assert torch.equal(mine[~torch.from_numpy(fire)],
                           before[~torch.from_numpy(fire)])
    assert (mine[:, evt.H_TOTAL] > cap).all()
    a, b = evt.decode_grid(mine), JE.decode_grid(np.asarray(ref))
    for i in range(B):
        assert [e.as_dict() for e in a[i]] == [e.as_dict() for e in b[i]]
        assert evt.ring_total(mine[i]) == JE.ring_total(np.asarray(ref)[i])


def test_event_log_round_trips_equal_reference():
    mine, ref = evt.EventLog(capacity=4), JE.EventLog(capacity=4)
    sink_m, sink_r = [], []
    mine.set_sink(sink_m.append)
    ref.set_sink(sink_r.append)
    for i in range(9):
        for log in (mine, ref):
            log.append(float(i) * 1.5, (i % 18) + 1, i % 8, (i, -i, 0.25))
    assert mine.state_dict() == ref.state_dict()
    assert sink_m == sink_r and len(sink_m) == 9
    assert (mine.total, mine.dropped, len(mine)) == (ref.total, ref.dropped,
                                                     len(ref))
    clone = evt.EventLog()
    clone.load_state_dict(ref.state_dict())
    assert [e.as_dict() for e in clone.events()] == \
        [e.as_dict() for e in ref.events()]
    legacy = {k: v for k, v in ref.state_dict().items() if k != "dropped"}
    clone.load_state_dict(legacy)
    assert clone.dropped == ref.dropped
    got = evt.filter_events(mine.events(), code=3)
    assert [e.as_dict() for e in got] == [e.as_dict() for e in
                                          JE.filter_events(ref.events(),
                                                           code=3)]

    def boom(_):
        raise OSError("disk full")

    mine.set_sink(boom)
    mine.append(1.0, evt.EV_GUARD_HOLD, evt.SRC_GUARD)
    assert mine.sink_errors == 1


def test_engine_recorder_timelines_match_reference():
    """Every source at once (phase flips, fault enter/exit, detector
    alarms, guard HOLD / FAILSAFE / recover, recovery resets) into
    16-slot rings: the decoded timelines equal the reference's."""
    c, _ = SC.engine_case(SC.AXES, False, ("pi", "pi_rls"))
    mine = evt.decode_grid(c.events)
    names = set()
    for i, tl in enumerate(mine):
        names |= {e.name for e in tl}
    assert {"phase_flip", "fault_enter", "fault_exit", "detector_alarm",
            "guard_hold", "guard_failsafe", "guard_recover",
            "recovery_reset"} <= names


# ---- mirrors of the ring cases of tests/test_obs.py ------------------------

def test_ring_append_decode_roundtrip():
    vec = evt.ring_init(4, **CPU)
    vec = evt.ring_append(vec, True, 1.5, evt.EV_GUARD_HOLD, evt.SRC_GUARD,
                          3.0, 40.0)
    vec = evt.ring_append(vec, True, 2.5, evt.EV_FAULT_ENTER,
                          evt.SRC_FAULTS, 0.0, 1.0, 0.0)
    out = evt.decode_ring(vec)
    assert [e.name for e in out] == ["guard_hold", "fault_enter"]
    assert out[0].t == 1.5 and out[0].source_name == "guard"
    assert out[0].payload == (3.0, 40.0, 0.0, 0.0)
    assert out[1].code == evt.EV_FAULT_ENTER
    assert evt.ring_total(vec) == 2
    d = out[0].as_dict()
    assert d["name"] == "guard_hold" and d["payload"][0] == 3.0


def test_ring_append_fire_false_is_bit_noop():
    vec = evt.ring_init(2, **CPU)
    vec = evt.ring_append(vec, True, 1.0, evt.EV_DETECTOR_ALARM,
                          evt.SRC_DETECTOR)
    after = evt.ring_append(vec, False, 9.0, evt.EV_GUARD_FAILSAFE,
                            evt.SRC_GUARD, 7.0)
    assert torch.equal(after, vec)


@settings(max_examples=25, deadline=None)
@given(cap=st.integers(min_value=1, max_value=7),
       n=st.integers(min_value=0, max_value=40))
def test_ring_overflow_evicts_oldest_total_monotonic(cap, n):
    """After n appends into a cap-slot ring, `total` == n exactly and the
    decoded survivors are the LAST min(n, cap) events, oldest first."""
    vec = evt.ring_init(cap, **CPU)
    for i in range(n):
        vec = evt.ring_append(vec, True, float(i), evt.EV_DETECTOR_ALARM,
                              evt.SRC_DETECTOR, float(i))
    assert evt.ring_total(vec) == n
    out = evt.decode_ring(vec)
    assert len(out) == min(n, cap)
    want = list(range(n))[-min(n, cap):]
    assert [int(e.payload[0]) for e in out] == want
    assert [e.t for e in out] == [float(w) for w in want]


def test_decode_ring_rejects_grids_decode_grid_accepts_them():
    grid = evt.ring_init(3, (2,), **CPU)
    with pytest.raises(ValueError, match="decode_grid"):
        evt.decode_ring(grid)
    decoded = evt.decode_grid(grid.reshape(2, 1, -1))
    assert decoded.shape == (2, 1)
    assert decoded[0, 0] == []


def test_event_log_eviction_and_state_roundtrip():
    log = evt.EventLog(capacity=3)
    for i in range(5):
        log.append(float(i), evt.EV_TENANT_ADDED, evt.SRC_PLANE, (i,))
    assert log.total == 5 and len(log) == 3
    assert [e.t for e in log.events()] == [2.0, 3.0, 4.0]
    clone = evt.EventLog()
    clone.load_state_dict(log.state_dict())
    assert clone.total == 5 and clone.capacity == 3
    assert [e.as_dict() for e in clone.events()] == \
        [e.as_dict() for e in log.events()]
    got = evt.filter_events(log.events(), code=evt.EV_TENANT_ADDED,
                            source=evt.SRC_PLANE)
    assert len(got) == 3


_CHAOS = dict(
    total_work=1e9, max_time=150.0,
    faults=flt.FaultSchedule(
        (flt.FaultWindow("hb_dropout", 30.0, 40.0, p1=1.0),),
        period=150.0, name="dropout"),
    guard=flt.GuardConfig(hold_k=3, failsafe_k=12), **CPU)


def test_recorder_on_is_bitwise_neutral_trace_mode():
    off = sim.simulate_closed_loop("gros", 0.1, **_CHAOS)
    on = sim.simulate_closed_loop("gros", 0.1, record_events=True, **_CHAOS)
    for k in off.traces:
        np.testing.assert_array_equal(off.traces[k], on.traces[k],
                                      err_msg=k)
    np.testing.assert_array_equal(off.guard_state, on.guard_state)
    assert off.events is None and off.event_state is None
    assert on.events and on.n_events_total > 0


def test_recorder_on_is_bitwise_neutral_summary_and_empty_ring():
    """A clean run with no event source: the ring stays empty and the
    summaries match the recorder-off run on the same engine exactly."""
    kw = dict(total_work=3000.0, max_time=400.0, collect_traces=False,
              **CPU)
    off = sim.simulate_closed_loop("gros", 0.1, policy=PIPolicy(), **kw)
    on = sim.simulate_closed_loop("gros", 0.1, record_events=8, **kw)
    assert on.events == [] and on.n_events_total == 0
    for k in off.summary:
        np.testing.assert_array_equal(off.summary[k], on.summary[k],
                                      err_msg=k)


def test_recorder_neutral_on_sweep_axis():
    kw = dict(total_work=2000.0, max_time=300.0, collect_traces=False,
              faults=_CHAOS["faults"], guard=_CHAOS["guard"], **CPU)
    eps = (0.05, 0.1)
    off = sim.sweep("gros", eps, range(3), **kw)
    on = sim.sweep("gros", eps, range(3), record_events=16, **kw)
    for k in off.summary:
        np.testing.assert_array_equal(off.summary[k], on.summary[k],
                                      err_msg=k)
    assert off.events is None
    assert on.events.shape == (2, 3, evt.ring_dim(16))
    decoded = evt.decode_grid(on.events)
    assert decoded.shape == (2, 3)
    for idx in np.ndindex(*decoded.shape):
        assert evt.filter_events(decoded[idx], code=evt.EV_FAULT_ENTER)


def test_recorder_excluded_from_fast_paths():
    kw = dict(total_work=500.0, max_time=100.0, collect_traces=False,
              record_events=True, **CPU)
    with pytest.raises(ValueError, match="typed_pi"):
        sim.sweep("gros", (0.1,), range(2), typed_pi=True, **kw)
    with pytest.raises(ValueError, match="record_events"):
        sim.sweep("gros", (0.1,), range(2), backend="kernel", **kw)
    with pytest.raises(ValueError, match="record_events"):
        sim.simulate_closed_loop("gros", 0.1, total_work=500.0,
                                 max_time=100.0, record_events=-3, **CPU)


def test_chaos_timeline_agrees_with_guard_counters_and_schedule():
    """A scripted dropout storm: the decoded HOLD / FAILSAFE / recovery
    timeline is ordered per fault cycle, agrees with the guard's own
    G_N_RESETS counter, and each enter/exit lands inside/outside the
    host-view `FaultSchedule.active(t)` windows."""
    sched = flt.FaultSchedule(
        (flt.FaultWindow("hb_dropout", 30.0, 40.0, p1=1.0),),
        period=150.0, name="storm")
    res = sim.simulate_closed_loop(
        "gros", 0.1, total_work=1e9, max_time=400.0, faults=sched,
        guard=flt.GuardConfig(hold_k=3, failsafe_k=12), record_events=256,
        **CPU)
    ev = res.events
    assert ev == sorted(ev, key=lambda e: e.t)
    enters = evt.filter_events(ev, code=evt.EV_FAULT_ENTER)
    exits = evt.filter_events(ev, code=evt.EV_FAULT_EXIT)
    holds = evt.filter_events(ev, code=evt.EV_GUARD_HOLD)
    fsafes = evt.filter_events(ev, code=evt.EV_GUARD_FAILSAFE)
    recovers = evt.filter_events(ev, code=evt.EV_GUARD_RECOVER)
    resets = evt.filter_events(ev, code=evt.EV_RECOVERY_RESET)
    assert len(enters) == len(exits) == 3
    assert len(holds) == len(fsafes) == len(recovers) == 3
    assert len(resets) == int(res.guard_state[flt.G_N_RESETS])
    for en, ho, fs, ex, rc in zip(enters, holds, fsafes, exits, recovers):
        assert en.t < ho.t < fs.t < ex.t <= rc.t
        assert sched.active(en.t), f"no active window at enter t={en.t}"
        assert not sched.active(ex.t), f"window still active at {ex.t}"
    assert all(h.payload[0] >= 3 for h in holds)
    assert all(f.payload[0] >= 12 for f in fsafes)
    assert all(e.source == evt.SRC_GUARD
               for e in holds + fsafes + recovers + resets)
    assert all(e.source == evt.SRC_FAULTS for e in enters + exits)


def test_recorder_neutral_on_sweep_axis_and_chunked():
    """The chunked half of the reference's test: rings and summaries of
    a chunked recorded sweep equal the one-shot ones bit for bit."""
    kw = dict(total_work=2000.0, max_time=300.0, collect_traces=False,
              faults=_CHAOS["faults"], guard=_CHAOS["guard"], **CPU)
    eps = (0.05, 0.1)
    off = sim.sweep("gros", eps, range(3), **kw)
    on = sim.sweep("gros", eps, range(3), record_events=16, **kw)
    chunked = sim.sweep("gros", eps, range(3), record_events=16,
                        chunk_size=2, **kw)
    for k in off.summary:
        np.testing.assert_array_equal(off.summary[k], chunked.summary[k],
                                      err_msg=k)
    np.testing.assert_array_equal(on.events, chunked.events)
    np.testing.assert_array_equal(on.guard_state, chunked.guard_state)
