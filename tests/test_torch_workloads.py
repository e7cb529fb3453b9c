"""The port's phased workloads (`repro_torch.core.workloads.schedule`,
`repro_torch.core.phases`) and the scan engine's schedule axis, against
the reference's `repro.core.workloads` / `repro.core.phases` /
`repro.core.sim`.

Tiers:

* function level, bit for bit: `phases.*` (the port's H100 data-sheet
  constants swapped for the reference's TPU ones with monkeypatch, so
  the arithmetic is compared and no TPU rate sits in the port),
  `Phase.resolve`, `PhaseSchedule.resolve` (row counts, chained pieces,
  the ``rows=`` override), `active_profile` batched over runs on
  boundaries and cyclic wraps on both sides, `chain_rows`, and the three
  generators;
* engine level: `engine_step` with a per-run schedule on the typed and
  the packed path, fed the reference's own draws for 64 periods
  (`tests/_torch_scenarios.py`; rtol 1e-5, atol 1e-5, flags and counts
  exactly);
* mirrors of `tests/test_workloads.py` and `tests/test_phases.py` on the
  port's own streams, at the reference's bars. Not mirrored:
  `test_static_path_bit_for_bit_vs_prephases_engine` (the reference
  fails it), the two fleet tests (mirrored in
  `tests/test_torch_hierarchy.py`) and the one-compile half of the sweep
  axis test, a JAX cache property with no PyTorch counterpart. The resume tests (`resume_init(t0=,
  det_state=)`) run at the end of this file.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _hypothesis import given, settings, st  # noqa: E402

from repro.core import phases as jphases  # noqa: E402
from repro.core.plant import PROFILES as JPROFILES  # noqa: E402
from repro.core.workloads import schedule as JS  # noqa: E402

from repro_torch.core import phases, sim  # noqa: E402
from repro_torch.core import policies as pol  # noqa: E402
from repro_torch.core.controller import PIGains  # noqa: E402
from repro_torch.core.plant import PROFILE_FIELDS, PROFILES  # noqa: E402
from repro_torch.core.policies import PIPolicy  # noqa: E402
from repro_torch.core.workloads import (MAX_PHASES, Phase,  # noqa: E402
                                        PhaseSchedule, ScheduleValues,
                                        active_profile, chain_rows,
                                        markov_schedule, roofline_schedule,
                                        stream_dgemm_schedule)
from repro_torch.core.workloads import schedule as S  # noqa: E402

import _torch_scenarios as SC  # noqa: E402

CPU = dict(device="cpu")
STREAM, DGEMM = SC.STREAM, SC.DGEMM


# ---- phases: the roofline coupling ---------------------------------------

CELLS = [(197e12 * 256, 819e9 * 256, 50e9 * 256, 256),
         (1e15, 2e13, 1e11, 16), (3e17, 1e12, 5e13, 512), (1.0, 0.0, 0.0, 1)]


@pytest.fixture
def reference_rates(monkeypatch):
    """The port's chip-rate constants replaced by the reference's, so the
    two packages' arithmetic can be compared on the same rates."""
    monkeypatch.setattr(phases, "H100_PEAK_FLOPS", jphases.V5E_PEAK_FLOPS)
    monkeypatch.setattr(phases, "H100_HBM_BW", jphases.V5E_HBM_BW)
    monkeypatch.setattr(phases, "H100_NVLINK_BW", jphases.V5E_ICI_BW)


@pytest.mark.parametrize("cell", CELLS)
def test_phases_arithmetic_equals_reference(reference_rates, cell):
    mine, ref = phases.roofline_terms(*cell), jphases.roofline_terms(*cell)
    assert mine == ref
    assert phases.bottleneck(mine) == jphases.bottleneck(ref)
    assert phases.saturation_ratio(mine) == jphases.saturation_ratio(ref)
    for base in ("v5e-chip", "gros"):
        assert dataclasses.asdict(phases.profile_for_cell(mine, base)) == \
            dataclasses.asdict(jphases.profile_for_cell(ref, base))
    for sat in (0.1, 0.3, 1.0, 2.2, 3.0, 9.0):
        assert dataclasses.asdict(phases.knee_for_saturation(
            PROFILES["dahu"], sat)) == dataclasses.asdict(
                jphases.knee_for_saturation(JPROFILES["dahu"], sat))


def test_phases_rates_are_the_h100_data_sheet():
    assert (phases.H100_PEAK_FLOPS, phases.H100_HBM_BW,
            phases.H100_NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert not [n for n in vars(phases) if n.startswith("V5E")]


# mirrors of tests/test_phases.py, on the port's own rates

def test_roofline_terms_units():
    terms = phases.roofline_terms(flops=989e12 * 256,
                                  bytes_hbm=3.35e12 * 256,
                                  bytes_ici=450e9 * 256, chips=256)
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["memory_s"] == pytest.approx(1.0)
    assert terms["collective_s"] == pytest.approx(1.0)


def test_bottleneck_selection():
    assert phases.bottleneck({"compute_s": 3.0, "memory_s": 1.0,
                              "collective_s": 0.1}) == "compute_s"
    assert phases.bottleneck({"compute_s": 0.1, "memory_s": 1.0,
                              "collective_s": 0.5}) == "memory_s"


def test_memory_bound_cell_gets_saturating_plant():
    mem_bound = {"compute_s": 0.1, "memory_s": 1.0, "collective_s": 0.2}
    comp_bound = {"compute_s": 1.0, "memory_s": 0.2, "collective_s": 0.1}
    p_mem = phases.profile_for_cell(mem_bound)
    p_comp = phases.profile_for_cell(comp_bound)
    assert p_mem.alpha > p_comp.alpha
    assert p_mem.beta < p_comp.beta
    assert phases.saturation_ratio(mem_bound) > \
        phases.saturation_ratio(comp_bound)


# ---- schedules: packing and the gather ----------------------------------

def _pair(sched_fn):
    """The same schedule built in both packages."""
    return sched_fn(S, PROFILES), sched_fn(JS, JPROFILES)


SCHEDULES = {
    "stream-dgemm": lambda m, P: m.stream_dgemm_schedule("gros", dwell=50.0,
                                                         n_cycles=2),
    "stream-dgemm-cyclic": lambda m, P: m.stream_dgemm_schedule(
        "dahu", dwell=35.5, cyclic=True, dgemm_kl_scale=1.7),
    "scaled": lambda m, P: m.PhaseSchedule(
        (m.Phase(10.0, profile=P["dahu"], delta={"K_L": 50.0},
                 scale={"K_L": 2.0, "alpha": 0.5}),
         m.Phase(5.0), m.Phase(7.25, scale=STREAM)), cyclic=True),
    "markov-20": lambda m, P: m.markov_schedule(7, "yeti", n_phases=20,
                                                mean_dwell=9.0),
    "markov-40-cyclic": lambda m, P: m.PhaseSchedule(
        m.markov_schedule(3, "gros", n_phases=40).phases, cyclic=True),
    "roofline": lambda m, P: m.roofline_schedule(
        [{"compute_s": 0.1, "memory_s": 1.0, "collective_s": 0.2},
         {"compute_s": 1.0, "memory_s": 0.2, "collective_s": 0.1}],
        [30.0, 40.0]),
}


def _pack_equal(mine: ScheduleValues, ref):
    for f in ScheduleValues._fields:
        a, b = getattr(mine, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_resolve_and_generators_equal_reference(name):
    mine, ref = _pair(SCHEDULES[name])
    assert mine.cyclic == ref.cyclic and mine.name == ref.name
    assert mine.duration == ref.duration
    np.testing.assert_array_equal(mine.boundaries(), ref.boundaries())
    for base in ("gros", "yeti"):
        _pack_equal(mine.resolve(base, **CPU), ref.resolve(base))
        rows = chain_rows(len(mine.phases)) + MAX_PHASES
        _pack_equal(mine.resolve(PROFILES[base], rows, **CPU),
                    ref.resolve(JPROFILES[base], rows))


def test_chain_rows_equal_reference():
    for n in range(0, 70):
        assert chain_rows(n) == JS.chain_rows(n)
    assert MAX_PHASES == JS.MAX_PHASES
    assert (S.STREAM_SAT, S.DGEMM_SAT) == (JS.STREAM_SAT, JS.DGEMM_SAT)


def test_active_profile_batched_equals_reference_on_boundaries_and_wraps():
    """Every run of a batch gathers by its own time: times exactly on
    each boundary, one ulp either side, on the cyclic wrap, negative
    times and far past the script, for a cyclic and a held schedule, and
    a chained (32-row) one."""
    names = ("scaled", "stream-dgemm", "markov-20", "markov-40-cyclic")
    for name in names:
        mine, ref = _pair(SCHEDULES[name])
        sv_ref = ref.resolve("gros", 32 if name != "markov-40-cyclic"
                             else 48)
        period = float(sv_ref.period)
        edges = np.concatenate([[0.0], np.cumsum(
            [p.duration for p in ref.phases])]).astype(np.float32)
        t = [edges, np.nextafter(edges, np.float32(-np.inf)),
             np.nextafter(edges, np.float32(np.inf)), edges + period,
             edges - period, edges + 7 * period,
             np.float32([-1e-3, 1e6, 3.3e4, period * 2.5])]
        t = np.concatenate(t).astype(np.float32)
        # XLA on the CPU flushes subnormal floats to zero, PyTorch does
        # not: one ulp below t = 0 is no sim time, and is left out
        t = t[(t == 0) | (np.abs(t) >= np.finfo(np.float32).tiny)]
        jrow, jidx = jax.jit(jax.vmap(JS.active_profile,
                                      in_axes=(None, 0)))(sv_ref,
                                                          jnp.asarray(t))
        batch = ScheduleValues(*(torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(np.asarray(x), (len(t),) + np.shape(x))))
            for x in sv_ref))
        row, idx = active_profile(batch, torch.from_numpy(t))
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx),
                                      err_msg=name)
        np.testing.assert_array_equal(row.numpy(), np.asarray(jrow),
                                      err_msg=name)


# ---- engine level ----------------------------------------------------------

@pytest.mark.parametrize("typed", [True, False], ids=["typed", "packed"])
def test_engine_step_with_schedule_matches_reference(typed):
    """Each run gathers its own phase (a cyclic schedule on half the runs,
    a held one on the others); the phase trace flips and wraps."""
    c, tr = SC.engine_case(("schedule",), typed)
    phase = tr["phase"].numpy()
    assert set(np.unique(phase[:, 0])) == {0, 1, 2}
    assert set(np.unique(phase[:, 1])) == {0, 1, 2}
    assert (np.diff(phase[:, 0]) < 0).any()   # the cyclic wrap


# ---- mirrors of tests/test_workloads.py ------------------------------------

def test_phase_resolution_order_and_packing():
    base = PROFILES["gros"]
    ph = Phase(10.0, profile=PROFILES["dahu"], delta={"K_L": 50.0},
               scale={"K_L": 2.0, "alpha": 0.5})
    p = ph.resolve(base)
    assert p.K_L == pytest.approx(100.0)          # delta then scale
    assert p.alpha == pytest.approx(PROFILES["dahu"].alpha * 0.5)
    assert p.beta == PROFILES["dahu"].beta        # absolute profile wins
    sv = PhaseSchedule((ph, Phase(5.0))).resolve(base, **CPU)
    assert sv.ends.shape == (MAX_PHASES,)
    assert sv.profiles.shape == (MAX_PHASES, len(PROFILE_FIELDS))
    np.testing.assert_allclose(sv.ends[:1].numpy(), [10.0])
    assert torch.isinf(sv.ends[1:]).all()
    kl_col = PROFILE_FIELDS.index("K_L")
    assert float(sv.profiles[1, kl_col]) == pytest.approx(base.K_L)
    assert float(sv.profiles[-1, kl_col]) == pytest.approx(base.K_L)


def test_active_profile_half_open_and_cyclic():
    base = PROFILES["gros"]
    sched = PhaseSchedule((Phase(10.0, scale={"K_L": 2.0}), Phase(10.0)),
                          cyclic=True)
    sv = sched.resolve(base, **CPU)
    kl_col = PROFILE_FIELDS.index("K_L")
    for t, want_phase, want_kl in ((0.0, 0, 2 * base.K_L),
                                   (9.99, 0, 2 * base.K_L),
                                   (10.0, 1, base.K_L),   # boundary -> next
                                   (19.99, 1, base.K_L),
                                   (20.0, 0, 2 * base.K_L),  # cycle wrap
                                   (35.0, 1, base.K_L)):
        row, idx = active_profile(sv, torch.tensor(t))
        assert int(idx) == want_phase, t
        assert float(row[kl_col]) == pytest.approx(want_kl)
    sv2 = PhaseSchedule((Phase(10.0, scale={"K_L": 2.0}),
                         Phase(10.0))).resolve(base, **CPU)
    row, idx = active_profile(sv2, torch.tensor(1e6))
    assert int(idx) == 1 and float(row[kl_col]) == pytest.approx(base.K_L)


def test_schedule_validation():
    with pytest.raises(ValueError, match="at least one phase"):
        PhaseSchedule(())
    long = PhaseSchedule(tuple(Phase(1.0) for _ in range(MAX_PHASES + 1)))
    sv = long.resolve(PROFILES["gros"], **CPU)
    assert sv.ends.shape == (2 * MAX_PHASES,)
    assert sv.profiles.shape == (2 * MAX_PHASES, len(PROFILE_FIELDS))
    with pytest.raises(ValueError, match="pieces"):
        long.resolve(PROFILES["gros"], rows=MAX_PHASES, **CPU)
    with pytest.raises(ValueError, match="positive"):
        Phase(0.0)
    with pytest.raises(ValueError, match="unknown plant field"):
        Phase(1.0, delta={"nope": 1.0})


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 999), n_phases=st.integers(17, 26))
def test_long_cyclic_schedule_matches_unrolled_reference(seed, n_phases):
    """Chained cyclic schedules (> MAX_PHASES phases) run exactly like the
    same script unrolled flat across the horizon: same plant trajectory,
    the phase index wrapping modulo the cycle. Both lanes of one sweep
    (the W axis), so each run's seed and streams are the same."""
    base = PROFILES["gros"]
    chain = markov_schedule(seed, base, n_phases=n_phases, mean_dwell=12.0)
    assert len(chain.phases) > MAX_PHASES
    cyc = PhaseSchedule(chain.phases, cyclic=True)
    horizon = float(min(1.6 * cyc.duration, 900.0))
    flat, t = [], 0.0
    while t < horizon:
        ph = chain.phases[len(flat) % n_phases]
        flat.append(ph)
        t += ph.duration
    unrolled = PhaseSchedule(tuple(flat))
    r = sim.sweep(base, [0.1], [seed], total_work=1e9, max_time=horizon,
                  workloads=[cyc, unrolled], **CPU)
    a = {k: v[0, 0, 0] for k, v in r.traces.items()}
    b = {k: v[0, 1, 0] for k, v in r.traces.items()}
    assert r.n_steps[0, 0, 0] == r.n_steps[0, 1, 0]
    for k in ("progress", "pcap", "energy", "work"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    live = a["valid"]
    np.testing.assert_array_equal(a["phase"][live],
                                  b["phase"][live] % n_phases)


def test_generators():
    sd = stream_dgemm_schedule("gros", dwell=50.0, n_cycles=2)
    assert len(sd.phases) == 4 and sd.duration == pytest.approx(200.0)
    a0 = sd.phases[0].resolve(PROFILES["gros"])
    a1 = sd.phases[1].resolve(PROFILES["gros"])
    assert a0.alpha > a1.alpha  # STREAM knee sharper than DGEMM
    cyc = stream_dgemm_schedule("gros", dwell=50.0, cyclic=True)
    assert len(cyc.phases) == 2 and cyc.cyclic
    mk = markov_schedule(0, "gros", mean_dwell=30.0, n_phases=5)
    assert len(mk.phases) == 5
    rows = [p.resolve(PROFILES["gros"]) for p in mk.phases]
    for x, y in zip(rows, rows[1:]):
        assert (x.alpha, x.beta) != (y.alpha, y.beta)
    assert markov_schedule(3, "gros").phases != \
        markov_schedule(4, "gros").phases


def test_one_phase_base_schedule_equals_static_run():
    """A schedule that scripts 'the base profile forever' is bit for bit
    the static run on the same engine (the scan engine: a plain PI run
    without a schedule takes the kernel route): the gather changes the
    graph, not the numbers."""
    hold = PhaseSchedule((Phase(50.0),))
    kw = dict(total_work=500.0, max_time=600.0, seed=7, **CPU)
    a = sim.simulate_closed_loop("gros", 0.1, workload=hold, **kw)
    b = sim.simulate_closed_loop("gros", 0.1, policy=PIPolicy(), **kw)
    assert a.n_steps == b.n_steps
    for k in ("progress", "pcap", "energy", "work"):
        np.testing.assert_array_equal(a.traces[k], b.traces[k])
    assert (a.traces["phase"] == 0).all()


def test_phased_run_switches_dynamics_mid_run():
    """The scripted K_L doubling changes the closed loop mid-run: the
    faster plant lets the controller shed power."""
    sched = PhaseSchedule((Phase(100.0), Phase(100.0, scale={"K_L": 2.0})))
    res = sim.simulate_closed_loop("gros", 0.1, total_work=1e9,
                                   max_time=200.0, seed=0, workload=sched,
                                   **CPU)
    phase = res.traces["phase"]
    assert set(np.unique(phase)) == {0, 1}
    pcap = res.traces["pcap"]
    cap0 = pcap[(phase == 0)][30:].mean()
    cap1 = pcap[(phase == 1)][30:].mean()
    assert cap1 < cap0 - 5.0, (cap0, cap1)
    prog = res.traces["progress"]
    assert prog[(phase == 1)].mean() > 0.8 * prog[(phase == 0)].mean()


def test_sweep_workload_axis_shapes_summary():
    """A 3-phase STREAM<->DGEMM sweep in summary mode; a single schedule
    squeezes the W axis."""
    s3 = PhaseSchedule((Phase(80.0, scale=STREAM), Phase(80.0, scale=DGEMM),
                        Phase(80.0, scale=STREAM)))
    kw = dict(total_work=1e9, max_time=240.0, collect_traces=False, **CPU)
    res = sim.sweep(("gros", "dahu"), [0.1, 0.2], range(2),
                    workloads=[s3, markov_schedule(1, "gros")], **kw)
    assert res.traces is None
    assert res.exec_time.shape == (2, 2, 2, 2)  # (P, E, W, S)
    assert np.isfinite(res.summary["progress_mean"]).all()
    res1 = sim.sweep("gros", [0.1], range(2), workloads=s3, **kw)
    assert res1.exec_time.shape == (1, 2)
    np.testing.assert_array_equal(res1.energy, res.energy[0, :1, 0])


def test_sweep_matches_single_run_with_workload():
    s = stream_dgemm_schedule("gros", dwell=60.0, n_cycles=1)
    res = sim.sweep("gros", [0.1], [5], total_work=1e9, max_time=120.0,
                    workloads=s, **CPU)
    one = sim.simulate_closed_loop("gros", 0.1, total_work=1e9,
                                   max_time=120.0, seed=5, workload=s,
                                   **CPU)
    assert float(res.exec_time[0, 0]) == pytest.approx(one.exec_time)
    assert float(res.energy[0, 0]) == pytest.approx(one.energy, rel=1e-5)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_markov_phased_runs_stay_finite(seed):
    """Random Markov phase chains never break the engine: traces stay
    finite, caps inside the actuator range."""
    from repro_torch.core.workloads import DetectorConfig
    mk = markov_schedule(seed, "dahu", mean_dwell=40.0, n_phases=4)
    res = sim.simulate_closed_loop("dahu", 0.15, total_work=1e9,
                                   max_time=160.0, seed=seed % 7,
                                   workload=mk, detector=DetectorConfig(),
                                   **CPU)
    prog, pcap = res.traces["progress"], res.traces["pcap"]
    assert np.isfinite(prog).all() and np.isfinite(pcap).all()
    p = PROFILES["dahu"]
    assert (pcap >= p.pcap_min - 1e-3).all()
    assert (pcap <= p.pcap_max + 1e-3).all()


def test_pi_rls_on_change_hook_resets_covariance():
    """The pi_rls branch's on_change blows P back to fresh-init and forces
    the next step's gain re-placement."""
    from repro_torch.core.adaptive import RLSConfig, rls_unpack
    from repro_torch.core.policies.pi import PI_RLS_HI, PI_RLS_LO
    p = PROFILES["gros"]
    g = PIGains.from_model(p, 0.1)
    policy = PIPolicy(adaptive=RLSConfig(dwell=7))
    vals = pol.policy_values(policy, p, g)
    state = pol.policy_init(policy, vals, g)
    obs = pol.PolicyObs(progress=torch.tensor(20.0),
                        power=torch.tensor(80.0), dt=torch.tensor(1.0),
                        gains=g)
    for _ in range(20):
        state, _ = pol.policy_step(policy, vals, state, obs)
    before = rls_unpack(state[PI_RLS_LO:PI_RLS_HI])
    assert not np.allclose(before.P.numpy(), np.eye(2) * 1e2)
    after = rls_unpack(pol.branch_on_change(policy)(vals, state)
                       [PI_RLS_LO:PI_RLS_HI])
    np.testing.assert_allclose(after.P.numpy(), np.eye(2) * 1e2)
    assert float(after.since_update) == pytest.approx(7.0)
    assert not bool(after.has_prev)
    np.testing.assert_allclose(after.theta.numpy(), before.theta.numpy())


# ---- resuming a scheduled run (twins of the reference's resume tests) ----

def test_resume_t0_continues_the_schedule_clock():
    """`resume_init(t0=)` carries the sim time the schedule gathers by, so
    a split scheduled run continues mid-script; the default t0=0
    restarts it (the NRM's per-segment semantics)."""
    p = PROFILES["gros"]
    g = PIGains.from_model(p, 0.1)
    sched = PhaseSchedule((Phase(100.0), Phase(100.0, scale={"K_L": 2.0})))
    kw = dict(gains=g, total_work=1e9, workload=sched, device="cpu")
    r1 = sim.simulate_closed_loop(p, max_time=150.0, seed=3, **kw)
    assert int(r1.traces["phase"][-1]) == 1
    init = sim.resume_init(r1.plant_state, r1.pi_state, r1.pcap,
                           t0=r1.exec_time)
    r2 = sim.simulate_closed_loop(p, max_time=200.0, seed=4, init=init,
                                  **kw)
    assert int(r2.traces["phase"][0]) == 1
    assert float(r2.traces["t"][0]) == pytest.approx(151.0)
    init0 = sim.resume_init(r1.plant_state, r1.pi_state, r1.pcap)
    r3 = sim.simulate_closed_loop(p, max_time=50.0, seed=4, init=init0,
                                  **kw)
    assert int(r3.traces["phase"][0]) == 0


def test_detector_state_resumes_and_counts():
    from repro_torch.core.workloads import DetectorConfig
    p = PROFILES["gros"]
    g = PIGains.from_model(p, 0.1)
    kw = dict(gains=g, max_time=256.0, device="cpu")
    r1 = sim.simulate_closed_loop(p, total_work=300.0, seed=1,
                                  detector=DetectorConfig(), **kw)
    assert r1.detector_state is not None
    init = sim.resume_init(r1.plant_state, r1.pi_state, r1.pcap,
                           det_state=r1.detector_state)
    r2 = sim.simulate_closed_loop(p, total_work=600.0, seed=2, init=init,
                                  detector=DetectorConfig(), **kw)
    assert r2.detector_state is not None
    assert r2.n_phase_changes >= r1.n_phase_changes
    assert r2.detector_state[6] > 0  # DET_SINCE kept counting
    with pytest.raises(ValueError, match="detector"):
        sim.simulate_closed_loop(p, total_work=100.0, init=init, **kw)
