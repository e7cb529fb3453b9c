"""The port's fault injection and guarded degradation
(`repro_torch.core.faults`, the guard of `plane_step`, the scan engine's
fault and guard axes) against the reference's `repro.core.faults` /
`repro.core.plane` / `repro.core.sim`.

Tiers:

* function level, bit for bit: the constants, `FaultSchedule.resolve`,
  `fault_channels` batched over runs on a time grid (window edges, the
  cyclic wrap, overlapping windows), `apply_actuator` (half-quantum
  commands: both round half to even), `guard_values`; `fault_state_init`
  bit for bit but for the power at pcap_max (rtol 1e-6: XLA contracts
  a * pcap + b into an FMA); `FaultyActuator` against the reference's on
  the same stub actuator and script;
* `plane_step` guarded, and guarded with the detector, for each branch
  set of the policy slice, on readings that trip every sentinel and the
  watchdog ladder, and the engine with faults, with the guard, and with
  every scenario axis at once on the reference's own draws
  (`tests/_torch_scenarios.py`): the scan engine's bar (rtol 1e-5, atol
  1e-5; flags and counts exactly);
* mirrors of `tests/test_faults.py` on the port's own streams at the
  reference's bars, but `test_chunked_faulted_guarded_sweep_equals_one_shot`
  (chunked sweeps are ROADMAP Queue 1 item 7, and the reference fails
  it). The clean arm of each neutrality test runs on the scan engine, as
  every reference run does (a plain PI run without scenarios takes the
  port's kernel route).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import faults as JF  # noqa: E402
from repro.core import sim as jsim  # noqa: E402

from repro_torch.core import faults as flt  # noqa: E402
from repro_torch.core import policies as pol  # noqa: E402
from repro_torch.core import plane, sim  # noqa: E402
from repro_torch.core.adaptive import (RLSAdapter, RLSConfig,  # noqa: E402
                                       rls_init, rls_step, rls_values)
from repro_torch.core.controller import PIGains  # noqa: E402
from repro_torch.core.plane import plane_step  # noqa: E402
from repro_torch.core.plant import PROFILES  # noqa: E402
from repro_torch.core.policies import PIPolicy  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402

import _torch_scenarios as SC  # noqa: E402

CPU = dict(device="cpu")
ALL4 = ("pi", "pi_rls", "dutycycle", "offline_rl")
KW = dict(total_work=400.0, max_time=300.0, **CPU)


# ---- function level --------------------------------------------------------

def test_constants_equal_reference():
    assert flt.FAULT_KINDS == JF.FAULT_KINDS
    assert (flt.MAX_FAULT_ROWS, flt.FAULT_STATE_DIM, flt.GUARD_PARAM_DIM,
            flt.GUARD_STATE_DIM) == (JF.MAX_FAULT_ROWS, JF.FAULT_STATE_DIM,
                                     JF.GUARD_PARAM_DIM, JF.GUARD_STATE_DIM)
    names = [n for n in vars(JF) if n[:2] in ("K_", "F_", "G_")
             or n.startswith("GUARD_")]
    assert names and all(getattr(flt, n) == getattr(JF, n) for n in names)
    assert flt.ActiveFaults._fields == JF.ActiveFaults._fields
    assert flt.FaultValues._fields == JF.FaultValues._fields


def _pair_scripts():
    """The scripts of the engine tests and a few more, in both packages."""
    def both(windows, period=0.0):
        return (flt.FaultSchedule(tuple(flt.FaultWindow(*w) for w in
                                        windows), period),
                JF.FaultSchedule(tuple(JF.FaultWindow(*w) for w in windows),
                                 period))
    out = [both([])]
    for s in SC.ref_fault_schedules():
        out.append(both([(w.kind, w.start, w.duration, w.p1, w.p2)
                         for w in s.windows], s.period))
    out.append(both([("hb_dropout", 10.0, 5.0, 0.5, 0.0),
                     ("meter_bias", 12.0, 8.0, 3.0, 0.0),
                     ("meter_bias", 14.0, 2.0, 4.0, 0.0),
                     ("act_quant", 30.0, 10.0, 2.0, 0.0),
                     ("crash", 45.0, 5.0, 0.0, 0.0)], 60.0))
    return out


def test_fault_schedule_resolve_equals_reference():
    for mine, ref in _pair_scripts():
        fv, jv = mine.resolve(**CPU), ref.resolve()
        for f in flt.FaultValues._fields:
            a, b = getattr(fv, f).numpy(), np.asarray(getattr(jv, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        for t in (0.0, 3.0, 13.5, 47.9, 59.99, 61.0, 1e4):
            assert mine.active(t) == tuple(
                flt.FaultWindow(w.kind, w.start, w.duration, w.p1, w.p2)
                for w in ref.active(t))


def test_fault_channels_batched_equals_reference_on_a_time_grid():
    """Every run of the batch reads its own script at its own time: the
    window edges and one ulp either side, the cyclic wrap, far past."""
    scripts = _pair_scripts()
    t = np.concatenate([np.arange(0.0, 130.0, 0.5), [1e4, 47.999, 48.0]])
    t = np.concatenate([t, np.nextafter(t, np.float32(-1)),
                        np.nextafter(t, np.float32(1e9))]).astype(np.float32)
    t = t[(t == 0) | (np.abs(t) >= np.finfo(np.float32).tiny)]
    n = len(t)
    which = np.arange(n) % len(scripts)
    ref = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[scripts[k][1].resolve() for k in which])
    jaf = jax.jit(jax.vmap(JF.fault_channels))(ref, jnp.asarray(t))
    mine = flt.FaultValues(*(torch.from_numpy(np.array(np.asarray(x)))
                             for x in ref))
    af = flt.fault_channels(mine, torch.from_numpy(t))
    for f in flt.ActiveFaults._fields:
        np.testing.assert_array_equal(getattr(af, f).numpy(),
                                      np.asarray(getattr(jaf, f)),
                                      err_msg=f)
    assert float(af.crash.sum()) > 0 and float(af.act_quant.max()) > 0


def test_apply_actuator_equals_reference_with_half_quanta():
    """Commands exactly half a quantum above a grid point round to even,
    in both; every channel combination on random states."""
    rng = np.random.default_rng(3)
    n = 4096
    z = lambda: np.zeros(n, np.float32)
    chans = {f: z() for f in flt.ActiveFaults._fields}
    chans["act_delay"] = (rng.uniform(size=n) < 0.3).astype(np.float32)
    chans["act_quant"] = np.where(rng.uniform(size=n) < 0.5, rng.choice(
        [2.0, 5.0, 7.0, 0.5], n), 0.0).astype(np.float32)
    chans["act_stuck_on"] = (rng.uniform(size=n) < 0.2).astype(np.float32)
    chans["act_stuck_val"] = np.where(rng.uniform(size=n) < 0.5,
                                      rng.uniform(40, 120, n), 0.0
                                      ).astype(np.float32)
    pmin = np.float32(40.0)
    cmd = rng.uniform(40, 120, n).astype(np.float32)
    half = chans["act_quant"] > 0
    k = rng.integers(0, 8, n)
    cmd[half & (k < 4)] = (pmin + (k + 0.5) * chans["act_quant"])[
        half & (k < 4)]
    fstate = rng.uniform(40, 120, (n, flt.FAULT_STATE_DIM)).astype(
        np.float32)
    jaf = JF.ActiveFaults(**{f: jnp.asarray(v) for f, v in chans.items()})
    ref = jax.jit(jax.vmap(JF.apply_actuator, in_axes=(0, 0, 0, None)))(
        jaf, jnp.asarray(fstate), jnp.asarray(cmd), pmin)
    af = flt.ActiveFaults(**{f: torch.from_numpy(v)
                             for f, v in chans.items()})
    mine = flt.apply_actuator(af, torch.from_numpy(fstate),
                              torch.from_numpy(cmd), torch.tensor(pmin))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    # no actuator channel: the command itself, bit for bit
    none = flt.ActiveFaults(**{f: torch.zeros(n) for f in chans})
    assert torch.equal(flt.apply_actuator(none, torch.from_numpy(fstate),
                                          torch.from_numpy(cmd), 40.0),
                       torch.from_numpy(cmd))


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_fault_state_init_and_guard_values_equal_reference(name):
    prof = sim._unpack_profile(sim.profile_values(PROFILES[name])[None])
    mine = flt.fault_state_init(prof).numpy()[0]
    ref = np.asarray(jax.jit(lambda v: JF.fault_state_init(
        jsim._unpack_profile(v)))(jnp.asarray(
            sim.profile_values(PROFILES[name]).numpy())))
    np.testing.assert_allclose(mine[flt.F_LAST_POWER],
                               ref[flt.F_LAST_POWER], rtol=1e-6)
    mine[flt.F_LAST_POWER] = ref[flt.F_LAST_POWER]
    np.testing.assert_array_equal(mine, ref)
    host = flt.fault_state_init(PROFILES[name], **CPU).numpy()
    assert host.shape == (flt.FAULT_STATE_DIM,)
    for cfg in (None, flt.GuardConfig(), flt.GuardConfig(
            hold_k=2, failsafe_k=60, outlier_mult=3.5, recover_reset=False)):
        jcfg = None if cfg is None else JF.GuardConfig(
            **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        np.testing.assert_array_equal(flt.guard_values(cfg, **CPU).numpy(),
                                      np.asarray(JF.guard_values(jcfg)))
    assert torch.equal(flt.guard_init((3,), **CPU),
                       torch.zeros(3, flt.GUARD_STATE_DIM))


class _StubActuator:
    """A power actuator: applied caps in a list, power a fixed function of
    the last cap."""

    class profile:  # noqa: N801 — the attribute FaultyActuator reads
        pcap_min = 40.0

    def __init__(self):
        self.caps = []

    def set_pcap(self, pcap):
        self.caps.append(pcap)

    def read_power(self):
        return 0.9 * (self.caps[-1] if self.caps else 120.0) + 3.0

    def spare(self):
        return "delegated"


def test_faulty_actuator_equals_reference_on_a_stub():
    """The port's FaultyActuator and the reference's, each around its own
    stub, on the same script, seed and commands: the same caps applied,
    readings, dropped heartbeats, and per-kind injection counts in each
    package's registry."""
    windows = [("act_delay", 2.0, 3.0), ("act_quant", 6.0, 4.0, 7.0),
               ("act_stuck", 11.0, 3.0), ("meter_freeze", 15.0, 2.0),
               ("meter_bias", 18.0, 3.0, 4.5),
               ("meter_spike", 26.0, 4.0, 0.5, 0.0),
               ("hb_dropout", 30.0, 5.0, 0.6), ("crash", 36.0, 3.0)]
    mine = flt.FaultyActuator(_StubActuator(), flt.FaultSchedule(
        tuple(flt.FaultWindow(*w) for w in windows), period=40.0), seed=4)
    ref = JF.FaultyActuator(_StubActuator(), JF.FaultSchedule(
        tuple(JF.FaultWindow(*w) for w in windows), period=40.0), seed=4)
    from repro.obs import metrics as jmetrics
    c_mine = obs_metrics.get_registry().counter(
        "faults_injected_total", labelnames=("kind",))
    c_ref = jmetrics.get_registry().counter(
        "faults_injected_total", labelnames=("kind",))
    kinds = sorted({w[0] for w in windows})
    before = [(c_mine.value(kind=k), c_ref.value(kind=k)) for k in kinds]
    rng = np.random.default_rng(0)
    for t in np.arange(0.0, 80.0, 0.5):
        cmd = float(rng.uniform(40, 120))
        out = []
        for act in (mine, ref):
            act.tick(t)
            act.set_pcap(cmd)
            out.append((act.read_power(), act.drop_heartbeat(),
                        tuple(act.inner.caps)))
        np.testing.assert_equal(out[0], out[1])
    for k, (m0, r0) in zip(kinds, before):
        assert c_mine.value(kind=k) - m0 == c_ref.value(kind=k) - r0 > 0, k
    assert mine.spare() == "delegated"


@pytest.mark.parametrize("branches", [("pi",), ("pi_rls",), ALL4],
                         ids=lambda b: "+".join(b))
@pytest.mark.parametrize("detector", [False, True], ids=["guard",
                                                         "guard+detector"])
def test_plane_step_guarded_matches_reference(branches, detector):
    """Blackouts, NaN and far-out progress, NaN and out-of-range power on
    some rows; masked rows (``guard_on`` 0) run the unguarded arithmetic.
    The ladder reaches HOLD and FAILSAFE."""
    modes, _ = SC.plane_case(branches, detector=detector, guard=True)
    assert set(np.unique(modes.numpy())) == {0.0, 1.0, 2.0}


@pytest.mark.parametrize("axes", [("faults",), ("guard",),
                                  ("faults", "guard"), SC.AXES],
                         ids=lambda a: "+".join(a))
def test_engine_step_with_faults_and_guard_matches_reference(axes):
    """Every fault kind (`_torch_scenarios.ref_fault_schedules`), the guard
    ladder, and every scenario axis at once on all four branches; the
    meter-spike uniform is the reference's own fold_in(key, 7) draw."""
    branches = ALL4 if axes == SC.AXES else ("pi",)
    c, tr = SC.engine_case(axes, False, branches)
    if "faults" in axes:
        assert tr["fault_active"].sum() > 0
        assert torch.isnan(tr["power"]).any()          # the NaN spike
    if "faults" in axes and "guard" in axes:
        assert set(np.unique(tr["guard_mode"].numpy())) == {0.0, 1.0, 2.0}
        assert (c.guard[:, flt.G_N_RESETS] > 0).any()
    if axes == SC.AXES:
        assert (c.events[:, 0] > 16).any()             # a ring overflowed


def test_typed_path_refuses_faults_guard_and_recorder():
    prof = sim._unpack_profile(sim.profile_values(PROFILES["gros"])[None])
    gains = plane.unpack_gains(sim.gains_values(
        PIGains.from_model(PROFILES["gros"], 0.1))[None])
    fv = flt.FaultSchedule().resolve(**CPU)
    fv = flt.FaultValues(*(x[None] for x in fv))
    for kw, init in ((dict(faults=fv, fault_u=torch.zeros(1)),
                      dict(faults=fv)),
                     (dict(guard=flt.guard_values(**CPU)),
                      dict(guard=True)),
                     (dict(), dict(n_events=4))):
        c = sim._default_init(prof, gains, typed_pi=True, **init)
        with pytest.raises(ValueError, match="typed_pi"):
            sim.engine_step(prof, gains, c, 1e9, 64.0, 1.0,
                            torch.zeros(4, 1),
                            lambda lam: lam.to(torch.int32), **kw)


# ---- mirrors of tests/test_faults.py --------------------------------------

def _noop_schedule():
    return flt.FaultSchedule(name="noop")


def test_fault_channels_matches_host_schedule():
    sched = flt.FaultSchedule((
        flt.FaultWindow("hb_dropout", 10.0, 5.0, p1=0.5),
        flt.FaultWindow("meter_bias", 12.0, 8.0, p1=3.0),
        flt.FaultWindow("meter_bias", 14.0, 2.0, p1=4.0),
        flt.FaultWindow("act_quant", 30.0, 10.0, p1=2.0),
        flt.FaultWindow("crash", 45.0, 5.0),
    ), period=60.0)
    fv = sched.resolve(**CPU)
    for t in (0.0, 10.0, 13.0, 14.5, 20.5, 31.0, 47.0, 61.0, 73.0, 105.0):
        af = flt.fault_channels(fv, torch.tensor(t))
        kinds = [w.kind for w in sched.active(t)]
        assert float(af.hb_drop) == (0.5 if "hb_dropout" in kinds
                                     else 0.0), t
        bias = sum(w.p1 for w in sched.active(t) if w.kind == "meter_bias")
        assert float(af.meter_bias) == pytest.approx(bias), t
        assert float(af.act_quant) == (2.0 if "act_quant" in kinds
                                       else 0.0), t
        assert float(af.crash) == (1.0 if "crash" in kinds else 0.0), t


def test_fault_schedule_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        flt.FaultWindow("gremlins", 0.0, 1.0)
    with pytest.raises(ValueError, match="duration"):
        flt.FaultWindow("crash", 0.0, 0.0)
    with pytest.raises(ValueError, match="overruns the period"):
        flt.FaultSchedule((flt.FaultWindow("crash", 50.0, 20.0),),
                          period=60.0)
    with pytest.raises(ValueError, match="MAX_FAULT_ROWS"):
        flt.FaultSchedule(tuple(flt.FaultWindow("crash", i * 10.0, 1.0)
                                for i in range(flt.MAX_FAULT_ROWS + 1)))


def test_noop_schedule_bit_identical_trace_mode():
    clean = sim.simulate_closed_loop("gros", 0.1, policy=PIPolicy(), **KW)
    noop = sim.simulate_closed_loop("gros", 0.1, faults=_noop_schedule(),
                                    **KW)
    for k in clean.traces:
        np.testing.assert_array_equal(clean.traces[k], noop.traces[k],
                                      err_msg=k)
    assert clean.exec_time == noop.exec_time
    assert clean.energy == noop.energy and clean.work == noop.work
    assert float(np.abs(noop.traces["fault_active"]).max()) == 0.0


def test_noop_schedule_bit_identical_summary_mode():
    kw = dict(KW, collect_traces=False)
    clean = sim.simulate_closed_loop("gros", 0.1, policy=PIPolicy(), **kw)
    noop = sim.simulate_closed_loop("gros", 0.1, faults=_noop_schedule(),
                                    **kw)
    assert not clean.traces and not noop.traces
    for k in clean.summary:
        np.testing.assert_array_equal(clean.summary[k], noop.summary[k],
                                      err_msg=k)
    assert clean.energy == noop.energy and clean.work == noop.work


def test_untriggered_guard_bit_identical_full_run():
    clean = sim.simulate_closed_loop("gros", 0.1, policy=PIPolicy(), **KW)
    guarded = sim.simulate_closed_loop("gros", 0.1, guard=True, **KW)
    for k in clean.traces:
        np.testing.assert_array_equal(clean.traces[k], guarded.traces[k],
                                      err_msg=k)
    assert guarded.guard_state is not None
    assert float(np.abs(guarded.traces["guard_mode"]).max()) == 0.0
    assert float(guarded.guard_state[flt.G_MODE]) == flt.GUARD_NORMAL
    assert clean.guard_state is None


def test_sweep_noop_fault_axis_bit_identical_to_clean():
    kw = dict(KW, collect_traces=False)
    clean = sim.sweep("gros", [0.1, 0.2], range(2), backend="scan", **kw)
    scheds = [_noop_schedule(),
              flt.FaultSchedule((flt.FaultWindow("crash", 5.0, 10.0),))]
    faulted = sim.sweep("gros", [0.1, 0.2], range(2), faults=scheds, **kw)
    assert faulted.energy.shape == (2, 2, 2)  # (E, F, S)
    np.testing.assert_array_equal(clean.energy, faulted.energy[:, 0])
    np.testing.assert_array_equal(clean.summary["progress_hist"],
                                  faulted.summary["progress_hist"][:, 0])
    assert (faulted.exec_time[:, 1] > faulted.exec_time[:, 0]).all()
    single = sim.sweep("gros", [0.1, 0.2], range(2), faults=scheds[1], **kw)
    assert single.energy.shape == (2, 2)
    np.testing.assert_array_equal(single.energy, faulted.energy[:, 1])


def _pi_args(prof, gains, progress, pcap_applied):
    vals = pol.policy_values(PIPolicy(), prof, gains)
    st = pol.policy_init(PIPolicy(), vals, gains)
    return (gains, "pi", vals, st, pcap_applied, torch.tensor(progress),
            torch.tensor(80.0), torch.tensor(1.0))


def test_guarded_plane_step_untriggered_is_unguarded_bitwise():
    prof = PROFILES["gros"]
    gains = PIGains.from_model(prof, 0.1)
    args = _pi_args(prof, gains, 0.8 * prof.progress_max,
                    float(prof.pcap_max))
    plain = plane_step(*args)
    out = plane_step(*args, guard_vals=flt.guard_values(**CPU),
                     guard_state=flt.guard_init(**CPU))
    assert float(out[5]) == flt.GUARD_NORMAL
    for a, b in zip(plain, out[:4]):
        if a is None:
            assert b is None
        else:
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_guard_watchdog_hold_then_failsafe_then_recovery():
    prof = PROFILES["gros"]
    gains = PIGains.from_model(prof, 0.1)
    gv = flt.guard_values(flt.GuardConfig(hold_k=2, failsafe_k=4), **CPU)
    vals = pol.policy_values(PIPolicy(), prof, gains)
    state = pol.policy_init(PIPolicy(), vals, gains)
    gs = flt.guard_init(**CPU)
    applied = float(prof.pcap_max) - 10.0
    good = torch.tensor(0.8 * prof.progress_max)

    def step(progress, state, gs):
        return plane_step(gains, "pi", vals, state, applied, progress,
                          torch.tensor(80.0), torch.tensor(1.0),
                          guard_vals=gv, guard_state=gs)

    state, _, _, _, gs, mode = step(good, state, gs)
    assert float(mode) == flt.GUARD_NORMAL
    modes, caps, states = [], [], []
    for _ in range(6):
        state, _, cap, _, gs, mode = step(torch.tensor(0.0), state, gs)
        modes.append(float(mode))
        caps.append(float(cap))
        states.append(state.numpy().copy())
    assert modes == [flt.GUARD_NORMAL] * 2 + [flt.GUARD_HOLD] * 2 \
        + [flt.GUARD_FAILSAFE] * 2
    assert caps[2] == pytest.approx(applied) and \
        caps[3] == pytest.approx(applied)
    assert caps[4] == float(prof.pcap_max)
    np.testing.assert_array_equal(states[3], states[2])
    assert float(gs[flt.G_STALE]) == 6.0
    assert float(gs[flt.G_N_FAILSAFE]) == 2.0
    assert float(gs[flt.G_N_INVALID]) == 6.0
    state, _, cap, _, gs, mode = step(good, state, gs)
    assert float(mode) == flt.GUARD_NORMAL
    assert float(gs[flt.G_STALE]) == 0.0
    assert float(gs[flt.G_N_RESETS]) == 1.0


def test_guard_rejects_nonfinite_and_outlier_signals():
    prof = PROFILES["gros"]
    gains = PIGains.from_model(prof, 0.1)
    gv = flt.guard_values(flt.GuardConfig(outlier_mult=4.0), **CPU)
    vals = pol.policy_values(PIPolicy(), prof, gains)
    state = pol.policy_init(PIPolicy(), vals, gains)
    gs = flt.guard_init(**CPU)
    for bad in (float("nan"), float("inf"), 100.0 * prof.progress_max):
        _, _, _, _, gs2, _ = plane_step(
            gains, "pi", vals, state, float(prof.pcap_max),
            torch.tensor(bad), torch.tensor(80.0), torch.tensor(1.0),
            guard_vals=gv, guard_state=gs)
        assert float(gs2[flt.G_N_INVALID]) == 1.0
        assert float(gs2[flt.G_STALE]) == 1.0


def test_guard_contains_adaptive_degradation_under_blackouts():
    """10% duty heartbeat blackout + frozen meter: the unguarded RLS
    identifies the zero-progress garbage and its tracking error blows up;
    the guard's HOLD plateau keeps the estimator clean."""
    period, start = 400.0, 80.0
    blackout = flt.FaultSchedule((
        flt.FaultWindow("hb_dropout", start, 40.0, p1=1.0),
        flt.FaultWindow("meter_freeze", start, 40.0)), period=period)
    prof = PROFILES["gros"]
    setpoint = 0.9 * prof.progress_max
    kw = dict(total_work=1e12, max_time=2000.0,
              policies=[PIPolicy(adaptive=RLSConfig())],
              faults=[_noop_schedule(), blackout], collect_traces=False,
              summary_warmup=60, **CPU)
    errs = {}
    for arm, g in (("unguarded", None),
                   ("guarded", flt.GuardConfig(hold_k=3, failsafe_k=60))):
        res = sim.sweep("gros", [0.1], range(3), guard=g, **kw)
        w = res.work.reshape(2, 3)        # (F, S)
        t = res.exec_time.reshape(2, 3)
        err = np.abs(w / np.maximum(t, 1e-9) - setpoint) / setpoint
        errs[arm] = err.mean(-1)
        if arm == "guarded":
            gs = res.guard_state.reshape(2, 3, flt.GUARD_STATE_DIM)
            assert float(gs[..., flt.G_N_FAILSAFE].max()) == 0.0
            assert float(gs[1, :, flt.G_N_INVALID].min()) > 0.0
    clean_u, fault_u = errs["unguarded"]
    clean_g, fault_g = errs["guarded"]
    assert fault_u > 5.0 * clean_u, (clean_u, fault_u)
    assert fault_g < 2.5 * max(clean_g, 1e-4), (clean_g, fault_g)
    assert fault_u > 3.0 * fault_g


def test_rls_trace_clamp_bounds_unexcited_covariance_growth():
    """lam < 1 with a silent regressor inflates P geometrically; the trace
    clamp bounds it while the numpy oracle stays in lockstep."""
    prof = PROFILES["gros"]
    gains = PIGains.from_model(prof, 0.1)
    cfg = RLSConfig(lam=0.9, p_trace_max=5e3)
    rv = rls_values(cfg, prof, gains)
    s = rls_init(rv, gains.k_p, gains.k_i)
    adapter = RLSAdapter(gains, prof, lam=cfg.lam, dwell=cfg.dwell,
                         kl_clamp=cfg.kl_clamp, p_trace_max=cfg.p_trace_max)
    g = gains
    for _ in range(200):
        s = rls_step(rv, s, torch.tensor(prof.K_L), torch.tensor(0.0),
                     torch.tensor(1.0))
        g = adapter.update(g, float(prof.K_L), 0.0, 1.0)
    tr = float(s.P[0, 0] + s.P[1, 1])
    assert torch.isfinite(s.P).all()
    assert tr <= cfg.p_trace_max * 1.001
    np.testing.assert_allclose(s.P.numpy().astype(np.float64), adapter.P,
                               rtol=1e-4)
    assert (200.0 / cfg.lam ** 200) > 1e6 * cfg.p_trace_max


def test_rls_spike_corrupted_stream_keeps_gains_bounded():
    prof = PROFILES["gros"]
    gains = PIGains.from_model(prof, 0.1)
    cfg = RLSConfig(lam=0.97, p_trace_max=1e5)
    rv = rls_values(cfg, prof, gains)
    s = rls_init(rv, gains.k_p, gains.k_i)
    rng = np.random.default_rng(0)
    for i in range(300):
        progress = 0.8 * prof.progress_max + rng.normal(0.0, 0.5)
        if i % 17 == 5:
            progress = 1e6  # telemetry spike
        s = rls_step(rv, s, torch.tensor(progress, dtype=torch.float32),
                     torch.tensor(rng.uniform(-5.0, 5.0),
                                  dtype=torch.float32), torch.tensor(1.0))
        assert torch.isfinite(s.P).all(), i
        assert float(s.P[0, 0] + s.P[1, 1]) <= cfg.p_trace_max * 1.001
    assert np.isfinite(float(s.k_p)) and np.isfinite(float(s.k_i))
    tau_obj = 1.0 / (prof.K_L * gains.k_i)
    k_i_min = 1.0 / (prof.K_L * cfg.kl_clamp * tau_obj)
    k_i_max = cfg.kl_clamp / (prof.K_L * tau_obj)
    assert k_i_min * 0.99 <= float(s.k_i) <= k_i_max * 1.01
