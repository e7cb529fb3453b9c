"""The port's runtime (`repro_torch.core.nrm`: `NRM`,
`SimulatedPowerActuator`) and the resume path under it (`sim.resume_init`
+ ``sim.simulate_closed_loop(init=)``) on the CPU, against the
reference's `repro.core.nrm`, and twins of the reference's NRM tests
(`tests/test_sim.py`, `test_system.py`, `test_policies.py`,
`test_obs.py`).

Tolerances, and why:

* `control_step` on the same injected beats and a fixed power reading:
  bit-equal pcaps for PI, the detector, the guard and a policy=; the RLS
  paths within rtol 1e-6. The reference's NRM calls `plane_step`
  eagerly, op by op, so its covariance update rounds each product and
  sum apart, while the port follows the reference's fused (jitted)
  arithmetic, one rounding per multiply-add (`core/fma.py`); the update
  cancels ~99.6 of ~100, so the last bit of P moves. Under the guard's
  resets the estimator restarts from a fresh covariance and that ulp
  grows, so RLS under the guard is held to its guard decisions (equal)
  and rtol 1e-4.
* `run_simulated`: the port's runs use its own counter streams, the
  reference's `jax.random` (not re-implemented), so energy and time are
  compared over seeds within 5 combined standard errors of the two
  means.
* Resume and checkpoints: bit for bit within the port; a reference
  checkpoint loads into the port as it is.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs.base import PowerControlConfig as JCfg  # noqa: E402
from repro.core import faults as jflt  # noqa: E402
from repro.core import nrm as jnrm  # noqa: E402
from repro.core.adaptive import RLSConfig as JRLS  # noqa: E402
from repro.core.policies import DutyCyclePolicy as JDuty  # noqa: E402
from repro.core.policies import PIPolicy as JPI  # noqa: E402
from repro.core.workloads import DetectorConfig as JDet  # noqa: E402

from repro_torch.configs.base import PowerControlConfig  # noqa: E402
from repro_torch.core import faults as flt  # noqa: E402
from repro_torch.core import sim  # noqa: E402
from repro_torch.core.adaptive import RLSConfig  # noqa: E402
from repro_torch.core.controller import PIGains, pi_init  # noqa: E402
from repro_torch.core.energy import summarize_run, tradeoff_table  # noqa: E402
from repro_torch.core.nrm import NRM, SimulatedPowerActuator  # noqa: E402
from repro_torch.core.plant import (PROFILES, pcap_linearize,  # noqa: E402
                                    plant_init)
from repro_torch.core.plane import gains_values, unpack_gains  # noqa: E402
from repro_torch.core.policies import DutyCyclePolicy, PIPolicy  # noqa: E402
from repro_torch.core.workloads import DetectorConfig  # noqa: E402
from repro_torch.obs import events as evt  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402

CPU = dict(device="cpu")
# every run_simulated here: a 256-step engine bucket (the reference's
# default max_time of 3600 s is a 4,096-step bucket)
MT = 256.0


def _nrm(eps=0.1, profile="gros", adaptive=False, **kw):
    return NRM(PowerControlConfig(epsilon=eps, plant_profile=profile,
                                  adaptive=adaptive), **kw, **CPU)


class FixedPower:
    """An actuator that reads back one fixed power and records caps."""

    def __init__(self, power):
        self.power, self.caps = power, []

    def set_pcap(self, pcap):
        self.caps.append(pcap)

    def read_power(self):
        return self.power


GUARD = dict(hold_k=2, failsafe_k=4)


@pytest.mark.parametrize("case,rtol", [
    ("pi", 0.0), ("detector", 0.0), ("guard", 0.0), ("dutycycle", 0.0),
    ("detector_guard", 0.0), ("pi_rls", 1e-6), ("pi_rls_policy", 1e-6),
    ("pi_rls_guard", 1e-4)])
def test_control_step_equals_reference_on_injected_beats(case, rtol):
    """Both NRMs get the same heartbeats (bursts of 10-30 per period and
    5-period blackouts) and an actuator reading a fixed 80 W; every
    period's cap, alarm and guard mode, and the decision streams, are
    compared (tolerances in the module docstring)."""
    adaptive = case in ("pi_rls", "pi_rls_guard")
    mine_kw, ref_kw = {}, {}
    if "detector" in case:
        mine_kw["detector"], ref_kw["detector"] = (DetectorConfig(),
                                                   JDet())
    if "guard" in case:
        mine_kw["guard"] = flt.GuardConfig(**GUARD)
        ref_kw["guard"] = jflt.GuardConfig(**GUARD)
    if case == "dutycycle":
        mine_kw["policy"], ref_kw["policy"] = DutyCyclePolicy(), JDuty()
    if case == "pi_rls_policy":
        mine_kw["policy"] = PIPolicy(adaptive=RLSConfig())
        ref_kw["policy"] = JPI(adaptive=JRLS())
    mine = NRM(PowerControlConfig(epsilon=0.1, adaptive=adaptive),
               actuator=FixedPower(80.0), **mine_kw, **CPU)
    ref = jnrm.NRM(JCfg(epsilon=0.1, adaptive=adaptive),
                   actuator=FixedPower(80.0), **ref_kw)
    rng = np.random.default_rng(0)
    t, recs = 0.0, []
    for k in range(60):
        n = 0 if k % 17 in (5, 6, 7, 8, 9) else int(rng.integers(10, 30))
        for i in range(n):
            mine.heartbeat(t=t + (i + 0.5) / n)
            ref.heartbeat(t=t + (i + 0.5) / n)
        t += 1.0
        recs.append((mine.control_step(), ref.control_step()))
    pa = np.array([a.pcap for a, _ in recs])
    pb = np.array([b.pcap for _, b in recs])
    if rtol == 0.0:
        np.testing.assert_array_equal(pa, pb)
    else:
        np.testing.assert_allclose(pa, pb, rtol=rtol)
    for a, b in recs:
        assert (a.progress, a.phase_change, a.guard_mode) == (
            b.progress, b.phase_change, b.guard_mode)
    assert [(e.code, e.source) for e in mine.events.events()] == [
        (e.code, e.source) for e in ref.events.events()]
    assert mine.actuator.caps == pytest.approx(ref.actuator.caps,
                                               rel=rtol, abs=0.0)


def test_reexcitation_probe_equals_reference():
    """The post-alarm dither (reexcite=) on adaptive PI: the same alarms,
    the same dithered periods and caps within the RLS bar."""
    mine = NRM(PowerControlConfig(epsilon=0.1, adaptive=True),
               actuator=FixedPower(80.0), detector=DetectorConfig(
                   threshold=3.0), reexcite=4, **CPU)
    ref = jnrm.NRM(JCfg(epsilon=0.1, adaptive=True),
                   actuator=FixedPower(80.0),
                   detector=JDet(threshold=3.0), reexcite=4)
    t = 0.0
    for k in range(30):
        n = 10 if k < 12 else 30  # the rate triples: an alarm
        for i in range(n):
            mine.heartbeat(t=t + (i + 0.5) / n)
            ref.heartbeat(t=t + (i + 0.5) / n)
        t += 1.0
        a, b = mine.control_step(), ref.control_step()
        assert a.phase_change == b.phase_change
        assert a.pcap == pytest.approx(b.pcap, rel=1e-6)
    codes = [e.code for e in mine.events.events()]
    assert codes == [e.code for e in ref.events.events()]
    assert evt.EV_REEXCITE in codes and evt.EV_DETECTOR_ALARM in codes


def _headline(make, seeds):
    """Per-seed (energy, time) at eps 0.0 and 0.1, and the trade-off
    table, the reference tests' way."""
    out, runs = {}, []
    for eps in (0.0, 0.1):
        e, t = [], []
        for seed in seeds:
            tr = make(eps).run_simulated(total_work=1500.0, max_time=MT,
                                         seed=seed)
            e.append(float(tr["energy"][-1]))
            t.append(float(tr["t"][-1]))
            runs.append(summarize_run(eps, 1.0, tr["progress"],
                                      tr["power"]))
        out[eps] = (np.array(e), np.array(t))
    return out, tradeoff_table(runs)


def test_run_simulated_statistics_match_reference():
    """The paper's headline through `run_simulated` on both packages (8
    seeds each, gros, eps 0.0 and 0.1): mean energy and time within 5
    combined standard errors, and the reference test's bars on the
    port (eps=0.1: 5-45% energy saved for under 30% more time)."""
    seeds = range(8)
    mine, table = _headline(lambda e: _nrm(e), seeds)
    ref, _ = _headline(lambda e: jnrm.NRM(JCfg(epsilon=e,
                                               plant_profile="gros")),
                       seeds)
    for eps in (0.0, 0.1):
        for i in (0, 1):
            a, b = mine[eps][i], ref[eps][i]
            se = np.hypot(a.std(ddof=1) / np.sqrt(len(a)),
                          b.std(ddof=1) / np.sqrt(len(b)))
            assert abs(a.mean() - b.mean()) <= 5 * max(se, 1e-6), (eps, i)
    assert 0.05 < table[0.1]["energy_saving"] < 0.45
    assert table[0.1]["time_increase"] < 0.30


def test_closed_loop_reaches_setpoint_band():
    nrm = _nrm(0.15)
    tr = nrm.run_simulated(total_work=2000.0, max_time=MT, seed=1)
    sp = float(nrm.gains.setpoint)
    tail = tr["progress"][len(tr["progress"]) // 2:]
    assert abs(tail.mean() - sp) < 0.12 * sp


def test_energy_time_tradeoff_direction():
    t0 = _nrm(0.0).run_simulated(total_work=1500.0, max_time=MT, seed=0)
    t3 = _nrm(0.3).run_simulated(total_work=1500.0, max_time=MT, seed=0)
    assert t3["energy"][-1] < t0["energy"][-1]
    assert t3["t"][-1] >= t0["t"][-1]


@pytest.mark.parametrize("name", ["gros", "dahu"])
def test_engine_matches_stateful_nrm_loop(name):
    """The engine and the per-step loop (`_run_simulated_python`) are the
    same model up to the random streams: run-level statistics agree
    within the plant's noise envelope."""
    eps, work = 0.15, 2000.0
    nrm = _nrm(eps, name)
    ref = nrm._run_simulated_python(total_work=work, max_time=MT, seed=3)
    res = sim.simulate_closed_loop(name, eps, total_work=work, max_time=MT,
                                   seed=3, **CPU)
    assert res.completed
    assert res.exec_time == pytest.approx(float(ref["t"][-1]), rel=0.12)
    assert res.energy == pytest.approx(float(ref["energy"][-1]), rel=0.12)
    sp = float(nrm.gains.setpoint)
    for tr in (ref, res.traces):
        tail = tr["progress"][len(tr["progress"]) // 2:]
        assert abs(tail.mean() - sp) < 0.12 * sp
    assert set(res.traces) == set(ref)


def test_nrm_delegation_threads_state():
    nrm = _nrm()
    tr = nrm.run_simulated(total_work=300.0, max_time=MT, seed=2)
    assert float(tr["work"][-1]) >= 300.0
    assert nrm._t == pytest.approx(float(tr["t"][-1]))
    assert float(nrm.actuator.state.work) == pytest.approx(
        float(tr["work"][-1]))
    assert float(nrm.controller.state.prev_pcap_l) == pytest.approx(
        float(pcap_linearize(PROFILES["gros"], tr["pcap"][-1])), rel=1e-4)
    tr2 = nrm.run_simulated(total_work=600.0, max_time=MT, seed=5)
    assert float(tr2["work"][0]) > 300.0


def test_resumed_segments_keep_working_and_draw_fresh_noise():
    """Three segments at the same call seed: work keeps rising, the
    actuator's period count advances by each segment's steps, and no
    segment replays another's noise."""
    nrm = _nrm()
    works, powers = [], []
    for _ in range(3):
        before = nrm.actuator.periods
        tr = nrm.run_simulated(total_work=1e9, max_time=60.0, seed=0)
        assert nrm.actuator.periods == before + len(tr["t"]) == before + 60
        works.append(tr["work"])
        powers.append(tr["power"])
    assert works[0][-1] < works[1][0] < works[1][-1] < works[2][0]
    assert not np.array_equal(powers[1] - powers[1].mean(),
                              powers[2] - powers[2].mean())


def test_actuator_noise_is_its_seed_counter_stream():
    """The actuator's period noise is `draw_noise` of its seed at its
    period count: two actuators on one seed agree, another seed does
    not."""
    p = PROFILES["gros"]
    a, b, c = (SimulatedPowerActuator(p, seed=s, **CPU) for s in (3, 3, 4))
    ma = [a.advance(1.0) for _ in range(5)]
    assert ma == [b.advance(1.0) for _ in range(5)]
    assert ma != [c.advance(1.0) for _ in range(5)]
    assert a.periods == 5


def test_nrm_adaptive_runs_on_engine_and_threads_rls_state():
    nrm = _nrm(adaptive=True)
    tr = nrm.run_simulated(total_work=400.0, max_time=MT, seed=2)
    assert {"kl_hat", "tau_hat", "k_p", "k_i"} <= set(tr)
    assert nrm._rls_state is not None
    assert nrm.controller.gains.k_p == pytest.approx(
        float(nrm._rls_state.k_p))
    tr2 = nrm.run_simulated(total_work=800.0, max_time=MT, seed=3)
    assert float(tr2["work"][0]) > 400.0
    assert bool(nrm._rls_state.has_prev)
    rec = nrm.control_step()  # the live loop continues the estimator
    assert np.isfinite(rec.pcap)


def test_adaptive_resume_without_rls_state_starts_estimator():
    p = PROFILES["gros"]
    g = PIGains.from_model(p, 0.1)
    init = sim.resume_init(plant_init(p), pi_init(g), p.pcap_max)
    res = sim.simulate_closed_loop(p, gains=g, total_work=300.0,
                                   max_time=MT, seed=1, init=init,
                                   adaptive=RLSConfig(), **CPU)
    assert res.rls_state is not None
    assert "kl_hat" in res.traces


def test_resume_init_fresh_state_equals_default_run():
    """Resuming from freshly initialized plant and controller state is
    bit for bit the same run as starting from scratch on the packed
    engine."""
    p = PROFILES["gros"]
    g = PIGains.from_model(p, 0.1)
    p32 = sim._unpack_profile(sim.profile_values(p))
    g32 = unpack_gains(gains_values(g))
    init = sim.resume_init(plant_init(p32), pi_init(g32), p.pcap_max)
    a = sim.simulate_closed_loop(p, gains=g, total_work=400.0, max_time=MT,
                                 seed=4, init=init, **CPU)
    b = sim.simulate_closed_loop(p, gains=g, total_work=400.0, max_time=MT,
                                 seed=4, policy=PIPolicy(), **CPU)
    assert a.n_steps == b.n_steps
    for k in ("progress", "pcap", "energy"):
        np.testing.assert_array_equal(a.traces[k], b.traces[k])


def test_resume_init_policy_state_continues_non_pi_policy():
    p = PROFILES["gros"]
    g = PIGains.from_model(p, 0.1)
    dc = DutyCyclePolicy()
    kw = dict(gains=g, max_time=MT, **CPU)
    r1 = sim.simulate_closed_loop(p, total_work=300.0, seed=1, policy=dc,
                                  **kw)
    init = sim.resume_init(r1.plant_state, None, r1.pcap,
                           policy_state=r1.policy_state)
    r2 = sim.simulate_closed_loop(p, total_work=600.0, seed=2, policy=dc,
                                  init=init, **kw)
    assert float(r2.traces["work"][0]) > 300.0
    assert abs(float(r2.traces["dc_level"][0])
               - float(r1.policy_state[0])) <= dc.up_step
    rls = sim.simulate_closed_loop(p, total_work=300.0, seed=1,
                                   adaptive=RLSConfig(), **kw)
    bad = sim.resume_init(rls.plant_state, rls.pi_state, rls.pcap,
                          rls=rls.rls_state)
    with pytest.raises(ValueError):
        sim.simulate_closed_loop(p, total_work=100.0, init=bad, **kw)
    with pytest.raises(ValueError, match="branch"):
        sim.simulate_closed_loop(p, total_work=100.0, init=init, **kw)


def test_controller_state_checkpoint_roundtrip_across_packages():
    """A port checkpoint restores the port; the reference's
    `NRM.state_dict()` loads into the port as it is (JSON-able lists),
    and the port's into the reference."""
    nrm = _nrm()
    nrm.run_simulated(total_work=200.0, max_time=MT, seed=2)
    for _ in range(3):
        nrm.heartbeat(t=nrm._t + 0.25)
        nrm.control_step()
    state = nrm.state_dict()
    other = _nrm()
    other.load_state_dict(state)
    assert float(other.controller.state.prev_pcap_l) == float(
        nrm.controller.state.prev_pcap_l)
    assert other._t == nrm._t and other.state_dict() == state
    ref = jnrm.NRM(JCfg(epsilon=0.1), guard=True,
                   detector=JDet())
    ref.run_simulated(total_work=200.0, max_time=MT, seed=2,
                      record_events=8)
    ref.heartbeat(t=ref._t + 0.5)
    rsd = ref.state_dict()
    mine = _nrm(guard=True, detector=DetectorConfig())
    mine.load_state_dict(rsd)
    got = mine.state_dict()
    assert set(got) == set(rsd)
    for k in rsd:
        if k != "heartbeats":
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(rsd[k]), err_msg=k)
    assert got["heartbeats"] == rsd["heartbeats"]
    back = jnrm.NRM(JCfg(epsilon=0.1), guard=True, detector=JDet())
    back.load_state_dict(got)
    assert back._t == ref._t
    # both continue from the same checkpoint to the same next cap
    assert mine.control_step().pcap == back.control_step().pcap


def test_adaptive_improves_completion_under_gain_shift():
    results = {}
    for adaptive in (False, True):
        nrm = _nrm(adaptive=adaptive)
        shifted = sim.dataclasses.replace(PROFILES["gros"],
                                          K_L=PROFILES["gros"].K_L * 2)
        nrm.actuator = SimulatedPowerActuator(shifted, seed=5, **CPU)
        tr = nrm.run_simulated(total_work=1500.0, max_time=MT, seed=6)
        results[adaptive] = tr["t"][-1]
    assert results[True] <= results[False] * 1.05


# ---- twins of tests/test_policies.py's NRM tests --------------------------

def test_nrm_resume_round_trips_non_pi_policy_state():
    nrm = _nrm(policy=DutyCyclePolicy())
    tr = nrm.run_simulated(total_work=300.0, max_time=MT, seed=2)
    assert "dc_level" in tr and float(tr["work"][-1]) >= 300.0
    level1 = float(nrm._policy_state[0])
    assert level1 == float(tr["dc_level"][-1])
    tr2 = nrm.run_simulated(total_work=600.0, max_time=MT, seed=3)
    assert float(tr2["work"][0]) > 300.0
    dc = DutyCyclePolicy()
    assert abs(float(tr2["dc_level"][0]) - level1) <= max(dc.up_step,
                                                          dc.down_step)
    trf = _nrm(policy=DutyCyclePolicy()).run_simulated(
        total_work=300.0, max_time=MT, seed=3)
    assert float(trf["dc_level"][0]) >= dc.n_levels - dc.down_step
    d = nrm.state_dict()
    assert "policy_state" in d
    nrm2 = _nrm(policy=DutyCyclePolicy())
    nrm2.load_state_dict(d)
    np.testing.assert_array_equal(nrm2._policy_state.numpy(),
                                  nrm._policy_state.numpy())
    pre_run = _nrm(policy=DutyCyclePolicy()).state_dict()
    assert "policy_state" not in pre_run
    nrm2.load_state_dict(pre_run)
    assert nrm2._policy_state is None
    with pytest.raises(ValueError, match="policy"):
        _nrm().load_state_dict(d)
    level_before = float(nrm._policy_state[0])
    rec = nrm.control_step()
    assert abs(float(nrm._policy_state[0]) - level_before) <= max(
        dc.up_step, dc.down_step)
    assert nrm.actuator._pcap == pytest.approx(
        np.clip(rec.pcap, nrm.profile.pcap_min, nrm.profile.pcap_max))


def test_nrm_adaptive_checkpoint_round_trips_estimator_state():
    nrm = _nrm(adaptive=True)
    nrm.run_simulated(total_work=400.0, max_time=MT, seed=2)
    d = nrm.state_dict()
    assert "rls_state" in d
    other = _nrm(adaptive=True)
    other.load_state_dict(d)
    np.testing.assert_array_equal(other._rls_state.theta.numpy(),
                                  nrm._rls_state.theta.numpy())
    assert float(other._rls_state.kl_hat) == float(nrm._rls_state.kl_hat)
    assert other.controller.gains.k_p == pytest.approx(
        float(nrm._rls_state.k_p))
    fresh_ckpt = _nrm(adaptive=True).state_dict()
    assert "rls_state" not in fresh_ckpt
    other.load_state_dict(fresh_ckpt)
    assert other._rls_state is None
    assert other.controller.gains.k_p == pytest.approx(other.gains.k_p)
    with pytest.raises(ValueError, match="adaptive"):
        _nrm().load_state_dict(d)


def test_nrm_explicit_pi_policy_matches_default_path():
    a, b = _nrm(), _nrm(policy=PIPolicy())
    d = {"prev_error": -2.0, "prev_pcap_l": -0.2, "t": 0.0}
    a.load_state_dict(d)
    b.load_state_dict(d)
    ta = a.run_simulated(total_work=300.0, max_time=MT, seed=4)
    tb = b.run_simulated(total_work=300.0, max_time=MT, seed=4)
    for k in ("progress", "pcap", "energy"):
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def test_nrm_accepts_adaptive_pi_policy():
    nrm = _nrm(policy=PIPolicy(adaptive=RLSConfig()))
    tr = nrm.run_simulated(total_work=300.0, max_time=MT, seed=2)
    assert {"kl_hat", "tau_hat"} <= set(tr)
    assert nrm._policy_state is not None and nrm._rls_cfg is None
    tr2 = nrm.run_simulated(total_work=600.0, max_time=MT, seed=3)
    assert float(tr2["work"][0]) > 300.0
    theta1_init = 0.5 * PROFILES["gros"].K_L
    assert float(tr["theta1"][0]) == pytest.approx(theta1_init)
    assert float(tr2["theta1"][0]) != pytest.approx(theta1_init)


# ---- twins of tests/test_obs.py's NRM tests --------------------------------

_CHAOS = flt.FaultSchedule((
    flt.FaultWindow("hb_dropout", 20.0, 60.0, p1=1.0),
    flt.FaultWindow("meter_freeze", 80.0, 100.0)), name="chaos")


def test_recorder_resume_keeps_total_monotonic():
    g = flt.GuardConfig(hold_k=3, failsafe_k=12)
    nrm = _nrm(guard=g)
    nrm.run_simulated(1e9, max_time=150.0, faults=_CHAOS, record_events=32)
    t1 = evt.ring_total(nrm._event_state)
    assert t1 > 0
    nrm.run_simulated(1e9, max_time=150.0, faults=_CHAOS)
    t2 = evt.ring_total(nrm._event_state)
    assert t2 > t1 and evt.ring_capacity(nrm._event_state) == 32
    assert len(nrm.flight_events()) == min(t2, 32)
    clone = _nrm(guard=g)
    clone.load_state_dict(nrm.state_dict())
    assert evt.ring_total(clone._event_state) == t2
    nrm.run_simulated(1e9, max_time=50.0, record_events=False)
    assert nrm._event_state is None and nrm.flight_events() == []


def test_nrm_control_step_publishes_metrics():
    reg = obs_metrics.get_registry()
    c = reg.counter("nrm_control_steps_total",
                    "live control periods executed")
    before = c.value()
    nrm = _nrm()
    for _ in range(3):
        nrm.actuator.advance(nrm.cfg.sampling_period)
        nrm.heartbeat(t=nrm._t + 0.5)
        nrm.control_step()
    assert c.value() - before == 3
    assert reg.gauge("nrm_pcap_watts",
                     "cap applied by the last control period").value() > 0


def test_faulty_actuator_counts_injections():
    reg = obs_metrics.get_registry()
    c = reg.counter("faults_injected_total",
                    "fault perturbations actually applied by FaultyActuator",
                    labelnames=("kind",))
    before = c.value(kind="act_stuck")
    inner = SimulatedPowerActuator(_nrm().profile, **CPU)
    sched = flt.FaultSchedule(
        (flt.FaultWindow("act_stuck", 0.0, 10.0, p1=55.0),),
        period=100.0, name="stuck")
    fa = flt.FaultyActuator(inner, sched)
    fa.tick(1.0)
    fa.set_pcap(90.0)
    assert c.value(kind="act_stuck") - before == 1
    assert inner._pcap == 55.0


def test_nrm_serve_attaches_its_event_streams():
    """`NRM.serve` exposes the NRM's decision log (``/events?log=nrm``)
    and its flight recorder (``log=flight``, empty before a
    record_events= run) beside ``/healthz``."""
    import json
    import urllib.request
    get = lambda u: urllib.request.urlopen(u, timeout=10).read().decode()
    nrm = _nrm()
    nrm.events.append(1.0, evt.EV_DETECTOR_ALARM, evt.SRC_NRM, (1.0, 2.0))
    srv = nrm.serve()
    try:
        assert json.loads(get(srv.url + "/healthz"))["status"] == "ok"
        rows = [json.loads(ln) for ln in
                get(srv.url + "/events?log=nrm").splitlines()]
        assert [r["log"] for r in rows] == ["nrm"]
        assert rows[0]["name"] == "detector_alarm"
        assert get(srv.url + "/events?log=flight") == ""
    finally:
        srv.stop()


def test_policy_with_adaptive_config_is_rejected():
    with pytest.raises(ValueError, match="policy= replaces"):
        _nrm(adaptive=True, policy=DutyCyclePolicy())
    with pytest.raises(TypeError, match="SimulatedPowerActuator"):
        _nrm(actuator=FixedPower(80.0)).run_simulated(100.0, max_time=MT)
