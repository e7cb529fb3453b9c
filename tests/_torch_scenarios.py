"""Shared inputs of the scenario tests (`tests/test_torch_workloads.py`,
`test_torch_detect.py`, `test_torch_faults.py`, `test_torch_events.py`):
the port's `engine_step` with its scenario inputs (schedule, detector,
faults, guard, flight recorder) against the reference's, fed the
reference's own draws, step by step.

The reference's period key becomes the port's explicit inputs: the
plant noise and Poisson counts rebuilt from its split keys (as
`test_torch_scan_engine.py` does), and the meter-spike uniform drawn from
``jax.random.fold_in(key, 7)``, as the reference's engine draws it.
"""
import dataclasses

import numpy as np
import torch
import jax
import jax.numpy as jnp

from repro.core import faults as jflt
from repro.core import policies as jpol
from repro.core import sim as jsim
from repro.core import plane as jplane
from repro.core.plant import PROFILES as JPROFILES
from repro.core.workloads import detect as jdetect
from repro.core.workloads import (DetectorConfig as JDetectorConfig,
                                  Phase as JPhase,
                                  PhaseSchedule as JPhaseSchedule,
                                  detector_values as jdetector_values)

from repro_torch import convert
from repro_torch.core import plane, sim

from test_torch_policies import _both
from test_torch_scan_engine import _assert_carry_close, _key_noise

CPU = dict(device="cpu")
NAMES = ["gros", "dahu", "yeti", "gros", "dahu", "yeti"]
EPS = [0.1, 0.2, 0.1, 0.0, 0.3, 0.15]
STREAM = {"alpha": 3.0, "beta": 0.6}
DGEMM = {"alpha": 0.3, "beta": 1.14, "K_L": 2.0}
AXES = ("schedule", "detector", "faults", "guard", "events")


def ref_schedules():
    """Two reference schedules: a cyclic 3-phase one with short dwells
    (several flips and wraps in 64 periods) and a non-cyclic one whose
    boundaries fall on whole periods."""
    cyc = JPhaseSchedule((JPhase(7.0, scale=STREAM),
                          JPhase(5.0, scale=DGEMM), JPhase(9.0)),
                         cyclic=True)
    once = JPhaseSchedule((JPhase(20.0), JPhase(30.0, scale=DGEMM),
                           JPhase(10.0, scale={"K_L": 0.5})))
    return [cyc, once]


def ref_fault_schedules():
    """Two reference fault scripts covering every kind within 64
    periods: sensor faults and a crash on one, actuator faults and a
    blackout long enough to fail safe (under `GUARD`) on the other."""
    W = jflt.FaultWindow
    a = jflt.FaultSchedule((
        W("hb_dropout", 3.0, 5.0, p1=0.5), W("hb_stale", 9.0, 3.0),
        W("meter_freeze", 13.0, 4.0), W("meter_bias", 15.0, 6.0, p1=3.0),
        W("meter_spike", 22.0, 6.0, p1=0.5), W("act_quant", 29.0, 6.0,
                                               p1=7.0),
        W("act_stuck", 36.0, 4.0), W("crash", 41.0, 5.0)), period=48.0)
    b = jflt.FaultSchedule((
        W("act_delay", 2.0, 5.0), W("act_stuck", 8.0, 4.0, p1=60.0),
        W("meter_spike", 13.0, 3.0, p1=1.0, p2=900.0),
        W("hb_dropout", 18.0, 12.0, p1=1.0),
        W("meter_bias", 33.0, 8.0, p1=-2.5)))
    return [a, b]


GUARD = jflt.GuardConfig(hold_k=2, failsafe_k=4)
DET = JDetectorConfig(threshold=4.0, min_gap=3)


def rows(branches=("pi",), axes=()):
    """Six runs over gros / dahu / yeti (one yeti with frequent drops),
    kinds cycling over ``branches``, and the reference's scenario inputs
    for ``axes``: per-run stacked schedules, detector rows and fault rows,
    the guard vector and a 16-slot ring size. Numpy / reference values."""
    profs = [JPROFILES[n] for n in NAMES]
    profs[5] = dataclasses.replace(profs[5], drop_prob=0.3)
    gl = [jsim.PIGains.from_model(p, e) for p, e in zip(profs, EPS)]
    kinds = [i % len(branches) for i in range(len(NAMES))]
    pv = np.stack([np.asarray(jsim.profile_values(p)) for p in profs])
    gv = np.stack([np.asarray(jsim.gains_values(g)) for g in gl])
    av = np.stack([np.asarray(jpol.policy_values(_both(branches[k])[1], p,
                                                 g, kind=k))
                   for p, g, k in zip(profs, gl, kinds)])
    stack = lambda xs: jax.tree_util.tree_map(lambda *a: jnp.stack(a), *xs)
    scen = {}
    if "schedule" in axes:
        sch = ref_schedules()
        scen["schedule"] = stack([sch[i % 2].resolve(p, 16)
                                  for i, p in enumerate(profs)])
    if "detector" in axes:
        scen["detector"] = jnp.stack([jdetector_values(DET, p)
                                      for p in profs])
    if "faults" in axes:
        fs = ref_fault_schedules()
        scen["faults"] = stack([fs[i % 2].resolve()
                                for i in range(len(profs))])
    if "guard" in axes:
        scen["guard"] = jflt.guard_values(GUARD)
    n_events = 16 if "events" in axes else 0
    return pv, gv, av, scen, n_events


def port_scenario(scen):
    """The reference's scenario inputs as the port's tensors (CPU)."""
    out = {}
    if "schedule" in scen:
        out["schedule"] = convert.schedule_from_reference(scen["schedule"],
                                                          **CPU)
    if "detector" in scen:
        out["detector"] = convert.rows_from_reference(scen["detector"],
                                                      **CPU)
    if "faults" in scen:
        out["faults"] = convert.faults_from_reference(scen["faults"], **CPU)
    if "guard" in scen:
        out["guard"] = convert.rows_from_reference(scen["guard"], **CPU)
    return out


def engine_case(axes, typed, branches=("pi",), steps=64, seed=5, dt=1.0,
                total_work=1e9):
    """Both engines for ``steps`` periods with the scenario ``axes`` on
    the typed (``typed``) or the packed path of ``branches``; carries and
    trace rows compared every step at the scan engine's bar (rtol 1e-5,
    atol 1e-5; flags, counts and histograms exactly). Returns the port's
    final carry and its trace rows stacked over steps."""
    pv, gv, av, scen, n_events = rows(branches, axes)
    f32 = jnp.float32
    tw, mt, dtj, sf = f32(total_work), f32(1e4), f32(dt), f32(3.0)
    sched, det = scen.get("schedule"), scen.get("detector")
    fv, gvl = scen.get("faults"), scen.get("guard")
    ax = lambda x: None if x is None else 0

    def jinit(p, g, a, s, d, f):
        return jsim._default_init(
            jsim._unpack_profile(p), jsim._unpack_gains(g), policy=branches,
            policy_vals=None if typed else a, schedule=s, det_vals=d,
            typed_pi=typed, faults=f, guard=gvl, n_events=n_events)

    def jstep(p, g, a, s, d, f, c, k):
        return jsim.engine_step(
            jsim._unpack_profile(p), jsim._unpack_gains(g), c, tw, mt, dtj,
            k, policy=branches, policy_vals=None if typed else a,
            summary_from=sf, schedule=s, detector=d, typed_pi=typed,
            faults=f, guard=gvl)

    in_ax = (0, 0, 0, ax(sched), ax(det), ax(fv))
    jstep = jax.jit(jax.vmap(jstep, in_axes=in_ax + (0, 0)))
    jc = jax.jit(jax.vmap(jinit, in_axes=in_ax))(pv, gv, av, sched, det, fv)
    prof = sim._unpack_profile(torch.from_numpy(pv))
    gains = plane.unpack_gains(torch.from_numpy(gv))
    vals = None if typed else convert.policy_values_from_reference(av, **CPU)
    ps = port_scenario(scen)
    c = sim._default_init(prof, gains, branches, vals, typed,
                          ps.get("schedule"), ps.get("detector"),
                          ps.get("faults"), ps.get("guard"), n_events)
    _assert_carry_close(c, convert.carry_from_reference(jc, **CPU), "init")
    sc = lambda x: torch.tensor(x, dtype=torch.float32)
    B = pv.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(seed), steps * B)
    keys = keys.reshape(steps, B, -1)
    outs = []
    for i in range(steps):
        split = jax.vmap(jax.random.split)(keys[i])
        kplant, khb = split[:, 0], split[:, 1]
        noise = torch.from_numpy(np.asarray(jax.vmap(_key_noise)(kplant)).T
                                 .copy())
        fault_u = torch.from_numpy(np.asarray(jax.vmap(
            lambda k: jax.random.uniform(jax.random.fold_in(k, 7)))(
                keys[i])).copy())

        def sampler(lam):
            n = np.asarray(jax.vmap(jax.random.poisson)(
                khb, jnp.asarray(lam.numpy())))
            return torch.from_numpy(n.astype(np.int32))

        c, out = sim.engine_step(
            prof, gains, c, sc(total_work), sc(1e4), sc(dt), noise, sampler,
            policy=branches, policy_vals=vals, summary_from=sc(3.0),
            typed_pi=typed, schedule=ps.get("schedule"),
            detector=ps.get("detector"), faults=ps.get("faults"),
            guard=ps.get("guard"),
            fault_u=fault_u if "faults" in ps else None)
        jc, jout = jstep(pv, gv, av, sched, det, fv, jc, keys[i])
        _assert_carry_close(c, convert.carry_from_reference(jc, **CPU),
                            f"step {i}")
        assert set(out) == set(jout), (i, set(out) ^ set(jout))
        for k, v in out.items():
            want = np.asarray(jout[k])
            assert v.numpy().dtype == want.dtype, (k, v.dtype, want.dtype)
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-5,
                                       atol=1e-5,
                                       err_msg=f"step {i} out {k}")
        outs.append(out)
    return c, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def plane_case(branches, detector, guard, steps=24, seed=0):
    """`plane_step` in both packages over ``steps`` periods, each period
    from the states the reference reached, on the same inputs: progress around the
    setpoint with NaN, zero and far-out readings on some rows and periods
    (the guard's triggers), power with NaN and out-of-range readings, the
    applied cap anywhere in the actuator range, and per-row ``det_on`` /
    ``guard_on`` masks. Outputs compared every period at rtol 1e-5, atol
    1e-5 (NaN where the reference has NaN). Returns the port's guard modes
    and alarm flags over the periods."""
    pv, gv, av, scen, _ = rows(branches, (("detector",) if detector else ())
                               + (("guard",) if guard else ()))
    B = pv.shape[0]
    rng = np.random.default_rng(seed)
    det_on = (rng.uniform(size=B) > 0.25).astype(np.float32)
    guard_on = (rng.uniform(size=B) > 0.25).astype(np.float32)
    jg = jax.vmap(jplane.unpack_gains)(jnp.asarray(gv))
    setpoint = np.asarray(jg.setpoint)
    jvals = jnp.asarray(av)
    jstate = jax.vmap(lambda v, g: jpol.branch_init(branches)(
        v, jplane.unpack_gains(g)))(jvals, jnp.asarray(gv))
    jdet = (None if not detector else jax.vmap(
        lambda v, g: jdetect.detect_init(v, jplane.unpack_gains(g)))(
            scen["detector"], jnp.asarray(gv)))
    jgs = None if not guard else jnp.zeros((B, jflt.GUARD_STATE_DIM))

    def jfun(g, v, s, pa, pr, pw, dv, ds, don, gs, gon):
        return jplane.plane_step(
            jplane.unpack_gains(g), branches, v, s, pa, pr, pw,
            jnp.float32(1.0), det_vals=dv, det_state=ds,
            det_on=don if detector else None,
            guard_vals=scen.get("guard"), guard_state=gs,
            guard_on=gon if guard else None)

    d_ax = 0 if detector else None
    g_ax = 0 if guard else None
    jstep = jax.jit(jax.vmap(jfun, in_axes=(0, 0, 0, 0, 0, 0, d_ax, d_ax,
                                            0, g_ax, 0)))
    gains = plane.unpack_gains(torch.from_numpy(gv))
    vals = torch.from_numpy(av)
    state = torch.from_numpy(np.asarray(jstate).copy())
    ps = port_scenario(scen)
    dstate = None if jdet is None else torch.from_numpy(
        np.asarray(jdet).copy())
    gstate = None if jgs is None else torch.zeros(B, jflt.GUARD_STATE_DIM)
    T = lambda a: torch.from_numpy(np.asarray(a).copy())
    modes, alarms = [], []
    for i in range(steps):
        prog = (setpoint * rng.uniform(0.5, 1.3, B)).astype(np.float32)
        if 4 <= i < 12:
            prog[::2] = 0.0                      # a blackout on half the rows
        if i in (14, 15):
            prog[1] = np.nan
            prog[3] = 50.0 * setpoint[3]
        if i >= 16:
            prog = prog * 1.8                    # a level shift (alarms)
        pw = rng.uniform(30, 140, B).astype(np.float32)
        if i % 5 == 0:
            pw[2] = np.nan
            pw[4] = 1e5
        pa = rng.uniform(40, 120, B).astype(np.float32)
        out_j = jstep(jnp.asarray(gv), jvals, jstate, pa, prog, pw,
                      scen.get("detector"), jdet, det_on, jgs, guard_on)
        out = plane.plane_step(
            gains, branches, vals, state, T(pa), T(prog), T(pw),
            torch.tensor(1.0), det_vals=ps.get("detector"),
            det_state=dstate, det_on=T(det_on) if detector else None,
            guard_vals=ps.get("guard"), guard_state=gstate,
            guard_on=T(guard_on) if guard else None)
        assert len(out) == len(out_j) == (6 if guard else 4)
        for k, (a, b) in enumerate(zip(out, out_j)):
            if a is None or b is None:
                assert a is None and b is None
                continue
            a = a if isinstance(a, torch.Tensor) else torch.tensor(a)
            np.testing.assert_allclose(
                np.broadcast_to(a.numpy(), np.shape(b)), np.asarray(b),
                rtol=1e-5, atol=1e-5, err_msg=f"step {i} output {k}")
        # both go on from the reference's states: each period is one
        # step of the function from a state the reference reached
        jstate, jdet = out_j[0], out_j[1]
        state, dstate = T(jstate), None if jdet is None else T(jdet)
        if guard:
            jgs = out_j[4]
            gstate = T(jgs)
            modes.append(out[5])
        alarms.append(torch.as_tensor(out[3]))
    return (torch.stack(modes) if modes else None), torch.stack(
        [torch.broadcast_to(a, (B,)) for a in alarms])
