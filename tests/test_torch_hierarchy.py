"""The port's fleet (`repro_torch.core.hierarchy`) and the engine's cap
limit (`sim.engine_step(cap_limit=)`) against the reference's
`repro.core.hierarchy` and `repro.core.sim`, on the CPU.

Tolerances, and why:

* `_water_fill_bounds` on random feasible and infeasible budgets: rtol
  1e-6 (the port sums the node axis by pairwise halving, XLA in its own
  order; the carried allocation absorbs the difference each round);
* `engine_step(cap_limit=)` and the fleet step by step, both fed the
  reference's own draws (plant noise and Poisson counts rebuilt from its
  period keys with `test_torch_scan_engine._key_noise`): rtol 1e-5, atol
  1e-5, the bar of `tests/test_torch_scan_engine.py` (XLA contracts
  multiply-adds inside its fused step; flags and counts exactly);
* whole runs on the port's own streams against the reference's
  `simulate_fleet`: steady-state means at rel 0.08, the bar the reference
  holds between its own two fleet engines;
* within the port: every execution layout (chunks, durable campaigns,
  resume after kill -9) gives the same rows bit for bit, and a fleet of
  every test has an even node count, so the medians take the midpoint
  rule of ``jnp.median``.

Then mirrors of `tests/test_hierarchy.py`, the two fleet tests of
`tests/test_system.py`, the fleet tests of `tests/test_executor.py`,
`tests/test_supervisor.py` and `tests/test_workloads.py`, at their bars.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import hierarchy as jh  # noqa: E402
from repro.core import policies as jpol  # noqa: E402
from repro.core import sim as jsim  # noqa: E402
from repro.core.adaptive import RLSConfig as JRLS  # noqa: E402
from repro.core.plant import PROFILES as JPROFILES  # noqa: E402
from repro.core.workloads.schedule import Phase as JPhase  # noqa: E402
from repro.core.workloads.schedule import (  # noqa: E402
    PhaseSchedule as JPhaseSchedule)

from repro_torch import convert  # noqa: E402
from repro_torch.core import hierarchy as H  # noqa: E402
from repro_torch.core import plane, sim, supervisor  # noqa: E402
from repro_torch.core.adaptive import RLSConfig  # noqa: E402
from repro_torch.core.hierarchy import (FleetConfig,  # noqa: E402
                                        _simulate_fleet_reference,
                                        _water_fill, _water_fill_bounds,
                                        fleet_sweep, simulate_fleet)
from repro_torch.core.plant import PROFILES  # noqa: E402
from repro_torch.core.policies import DutyCyclePolicy, PIPolicy  # noqa: E402
from repro_torch.core.workloads import Phase, PhaseSchedule  # noqa: E402

from test_torch_scan_engine import _assert_carry_close, _key_noise  # noqa: E402,E501

CPU = dict(device="cpu")
STREAM = {"alpha": 3.0, "beta": 0.6}
DGEMM = {"alpha": 0.3, "beta": 1.14, "K_L": 2.0}


def _peak(prof, n):
    return float(prof.power_of_pcap(prof.pcap_max)) * n


# ---- water-filling against the reference -------------------------------

@pytest.mark.parametrize("frac", [0.3, 0.55, 0.8, 0.97, 1.4])
def test_water_fill_bounds_matches_reference(frac):
    """Random per-node bounds and weights; budgets below sum(lo) (frac
    0.3), feasible, and above sum(hi) (1.4)."""
    rng = np.random.default_rng(int(frac * 100))
    n = 48
    lo = rng.uniform(30.0, 90.0, n).astype(np.float32)
    hi = (lo + rng.uniform(20.0, 160.0, n)).astype(np.float32)
    w = (1.0 + rng.uniform(0.0, 3.0, n)).astype(np.float32)
    budget = float(frac * hi.sum()) if frac != 0.3 else 0.9 * float(
        lo.sum())
    ref = np.asarray(jh._water_fill_bounds(jnp.asarray(lo), jnp.asarray(hi),
                                           budget, jnp.asarray(w)))
    mine = _water_fill_bounds(torch.from_numpy(lo), torch.from_numpy(hi),
                              budget, torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(mine, ref, rtol=1e-6)
    # a batch of fleets (leading axis) gives each fleet's own answer
    both = _water_fill_bounds(torch.from_numpy(lo), torch.from_numpy(hi),
                              budget, torch.from_numpy(np.stack([w, w])))
    np.testing.assert_array_equal(both[0].numpy(), mine)


# ---- engine_step(cap_limit=) on the reference's own draws ---------------

@pytest.mark.parametrize("branches", [("pi",), ("pi", "pi_rls",
                                                "dutycycle")],
                         ids=["typed", "packed"])
def test_engine_step_cap_limit_matches_reference(branches):
    """Six runs for 40 periods under a per-run limit that moves every
    period (half of it below the policy's command): the command is
    min(policy, limit) before the early-exit freeze, as the reference's
    `engine_step` applies it."""
    typed = branches == ("pi",)
    names = ["gros", "dahu", "yeti", "gros", "dahu", "yeti"]
    profs = [JPROFILES[n] for n in names]
    pv = np.stack([np.asarray(jsim.profile_values(p)) for p in profs])
    gains = [jsim.PIGains.from_model(p, 0.1) for p in profs]
    gv = np.stack([np.asarray(jsim.gains_values(g)) for g in gains])
    jpols = [jpol.PIPolicy(), jpol.PIPolicy(adaptive=JRLS()),
             jpol.DutyCyclePolicy()]
    if typed:
        av = np.zeros((6, jpol.POLICY_PARAM_DIM), np.float32)
    else:
        av = np.stack([np.asarray(jpol.policy_values(
            jpols[i % 3], profs[i], gains[i], kind=i % 3))
            for i in range(6)])
    f32 = jnp.float32
    tw, mt, dtj = f32(1e9), f32(1e4), f32(1.0)

    def jinit(p, g, a):
        return jsim._default_init(jsim._unpack_profile(p),
                                  jsim._unpack_gains(g), branches, a,
                                  typed_pi=typed)

    def jstep(p, g, a, c, k, lim):
        return jsim.engine_step(jsim._unpack_profile(p),
                                jsim._unpack_gains(g), c, tw, mt, dtj, k,
                                policy=branches, policy_vals=a,
                                typed_pi=typed, cap_limit=lim)

    jstep = jax.jit(jax.vmap(jstep))
    jc = jax.jit(jax.vmap(jinit))(pv, gv, av)
    prof = sim._unpack_profile(torch.from_numpy(pv))
    g = plane.unpack_gains(torch.from_numpy(gv))
    avt = None if typed else convert.rows_from_reference(av, **CPU)
    c = sim._default_init(prof, g, branches, avt, typed_pi=typed)
    sc = lambda x: torch.tensor(x, dtype=torch.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 40 * 6).reshape(40, 6,
                                                                     -1)
    rng = np.random.default_rng(1)
    lo, hi = pv[:, 6], pv[:, 7]
    clipped = 0
    for i in range(40):
        lim = (lo + rng.uniform(0.2, 1.0, 6) * (hi - lo)).astype(
            np.float32)
        split = jax.vmap(jax.random.split)(keys[i])
        noise = torch.from_numpy(np.asarray(jax.vmap(_key_noise)(
            split[:, 0])).T.copy())
        khb = split[:, 1]
        sampler = lambda lam: torch.from_numpy(np.asarray(jax.vmap(
            jax.random.poisson)(khb, jnp.asarray(lam.numpy()))).astype(
                np.int32))
        c, out = sim.engine_step(prof, g, c, sc(1e9), sc(1e4), sc(1.0),
                                 noise, sampler, policy=branches,
                                 policy_vals=avt, typed_pi=typed,
                                 cap_limit=torch.from_numpy(lim))
        jc, jout = jstep(pv, gv, av, jc, keys[i], lim)
        _assert_carry_close(c, convert.carry_from_reference(jc, **CPU),
                            f"step {i}")
        for k, v in out.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jout[k]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i} out {k}")
        assert (out["pcap"].numpy() <= lim).all()
        clipped += int((out["pcap"].numpy() == lim).sum())
    assert clipped > 20  # the limit really bound


# ---- the fleet step by step on the reference's own draws ----------------

def _ref_draws(seed, n, scan_len):
    """The reference fleet's draws: node i's period key at step t is
    split(split(PRNGKey(seed), scan_len)[t], n)[i], split again into the
    plant's and the heartbeats' keys (`engine_step`)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), scan_len)
    node = jax.vmap(lambda k: jax.random.split(k, n))(keys)
    sp = jax.vmap(jax.vmap(jax.random.split))(node)
    noise = np.asarray(jax.vmap(jax.vmap(_key_noise))(sp[:, :, 0]))
    khb = sp[:, :, 1]

    def draws(t):
        def sampler(lam):
            return torch.from_numpy(np.asarray(jax.vmap(jax.random.poisson)(
                khb[t], jnp.asarray(lam.numpy()))).astype(np.int32))
        return torch.from_numpy(noise[t].T.copy()), sampler

    return draws


def _fleet_case(kind):
    n, steps = 12, 40
    if kind == "hetero":
        names = ("gros", "dahu", "yeti")
        mine = dict(policies=[PIPolicy(), PIPolicy(adaptive=RLSConfig()),
                              DutyCyclePolicy()],
                    schedules=[PhaseSchedule((Phase(15.0, scale=STREAM),
                                              Phase(60.0, scale=DGEMM))),
                               None,
                               PhaseSchedule((Phase(25.0, scale=DGEMM),
                                              Phase(60.0, scale=STREAM)))])
        ref = dict(policies=[jpol.PIPolicy(),
                             jpol.PIPolicy(adaptive=JRLS()),
                             jpol.DutyCyclePolicy()],
                   schedules=[JPhaseSchedule((JPhase(15.0, scale=STREAM),
                                              JPhase(60.0, scale=DGEMM))),
                              None,
                              JPhaseSchedule((JPhase(25.0, scale=DGEMM),
                                              JPhase(60.0,
                                                     scale=STREAM)))])
        budget = 0.55
    else:
        names, mine, ref = ("dahu",), {}, {}
        budget = 0.6 if kind == "budgeted" else 0.0
    peak = sum(_peak(PROFILES[p], n / len(names)) for p in names)
    fc = FleetConfig(n_nodes=n, epsilon=0.1, power_budget=budget * peak,
                     reallocate_every=5)
    jfc = jh.FleetConfig(n_nodes=n, epsilon=0.1,
                         power_budget=budget * peak, reallocate_every=5)
    return ([PROFILES[p] for p in names], fc, mine,
            [JPROFILES[p] for p in names], jfc, ref, steps)


@pytest.mark.parametrize("kind", ["unbudgeted", "budgeted", "hetero"])
def test_fleet_step_by_step_on_reference_draws(kind):
    """The port's fleet core on the reference's draws, every per-step
    row and the per-run reductions against the reference's fleet scan:
    homogeneous dahu with and without a budget, and gros / dahu / yeti
    with PI / RLS-PI / duty-cycle and phase-staggered schedules under a
    budget, reallocating every 5 periods."""
    profs, fc, mine_kw, jprofs, jfc, ref_kw, steps = _fleet_case(kind)
    jprofs_, jcls, jbr, jargs = jh._fleet_args(
        jprofs if len(jprofs) > 1 else jprofs[0], jfc, None,
        ref_kw.get("policies"), ref_kw.get("schedules"))
    profs_, cls, br, args = H._fleet_args(
        profs if len(profs) > 1 else profs[0], fc, None,
        mine_kw.get("policies"), mine_kw.get("schedules"))
    assert br == tuple(jbr)
    theirs = convert.fleet_args_from_reference(jargs, **CPU)
    for a, b in zip(args[:4], theirs[:4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    if args[4] is not None:
        for a, b in zip(args[4], theirs[4]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    scan_len = jsim._bucket_steps(steps)
    ref = jh._jit_fleet(fc.n_nodes, scan_len, fc.power_budget > 0,
                        tuple(jbr), len(jprofs))(
        *jargs, jnp.float32(jfc.power_budget),
        jnp.int32(jfc.reallocate_every), jnp.float32(jfc.straggler_boost),
        jnp.float32(steps), jnp.float32(jfc.dt), jax.random.PRNGKey(5))
    got = H._fleet_core(*args, torch.tensor([5]), branches=br,
                        n_classes=len(profs), budget=fc.power_budget,
                        reallocate_every=fc.reallocate_every,
                        boost=fc.straggler_boost, steps=steps, dt=fc.dt,
                        draws=_ref_draws(5, fc.n_nodes, scan_len))
    assert set(got) == set(ref)
    for k, v in got.items():
        r = np.asarray(ref[k])
        if r.ndim and r.shape[0] == scan_len:
            r = r[:steps]
        np.testing.assert_allclose(v[0].numpy(), r, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    if kind == "hetero":
        assert np.asarray(ref["phase_class"])[:steps].max() > 0


# ---- whole runs against the reference's simulate_fleet -----------------

@pytest.mark.parametrize("budgeted", [False, True])
@pytest.mark.parametrize("classes", [("dahu",), ("gros", "dahu")])
def test_fleet_matches_reference_statistics(classes, budgeted):
    """The port's fleet on its own streams against the reference's
    `simulate_fleet` on `jax.random`: steady-state fleet power, median
    progress and mean cap, per-class power and the run's energy within
    rel 0.08."""
    n = 64
    peak = sum(_peak(PROFILES[c], n / len(classes)) for c in classes)
    b = 0.6 * peak if budgeted else 0.0
    mine = simulate_fleet([PROFILES[c] for c in classes],
                          FleetConfig(n_nodes=n, power_budget=b), steps=80,
                          seed=1, **CPU)
    ref = jh.simulate_fleet([JPROFILES[c] for c in classes],
                            jh.FleetConfig(n_nodes=n, power_budget=b),
                            steps=80, seed=1)
    for k in ("power", "progress_med", "pcap_mean"):
        assert mine[k][30:].mean() == pytest.approx(
            np.asarray(ref[k])[30:].mean(), rel=0.08), k
    for c in range(len(classes)):
        assert mine["power_class"][30:, c].mean() == pytest.approx(
            np.asarray(ref["power_class"])[30:, c].mean(), rel=0.08)
    assert float(mine["energy_total"]) == pytest.approx(
        float(ref["energy_total"]), rel=0.08)
    np.testing.assert_array_equal(mine["class_counts"],
                                  ref["class_counts"])


def test_fleet_median_is_the_midpoint_rule():
    """Even node counts: the fleet median averages the two middle
    values, as ``jnp.median`` does (`torch.median` takes the lower)."""
    from repro_torch.core.signals import median
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0], [5.0, 5.0, 7.0, 9.0]])
    np.testing.assert_array_equal(median(x).numpy(), [2.5, 6.0])
    tr = simulate_fleet(PROFILES["gros"], FleetConfig(n_nodes=8), steps=6,
                        seed=0, **CPU)
    assert tr["progress_med"].shape == (6,)


# ---- mirrors of tests/test_hierarchy.py ---------------------------------

def test_water_fill_converges_to_feasible_budget():
    prof = PROFILES["dahu"]
    n = 64
    for frac in (0.45, 0.6, 0.8, 0.95):
        budget = frac * _peak(prof, n)
        for weights in (torch.ones(n), torch.linspace(1.0, 3.0, n)):
            alloc = _water_fill(prof, budget, n, weights)
            assert float(alloc.sum()) == pytest.approx(budget, rel=1e-4)
            assert float(alloc.min()) >= prof.pcap_min - 1e-4
            assert float(alloc.max()) <= prof.pcap_max + 1e-4


def test_water_fill_saturates_infeasible_budget():
    prof = PROFILES["dahu"]
    n = 8
    alloc = _water_fill(prof, 2.0 * _peak(prof, n), n, torch.ones(n))
    np.testing.assert_allclose(alloc.numpy(), prof.pcap_max, rtol=1e-5)
    alloc = _water_fill(prof, 0.5 * n * prof.pcap_min, n, torch.ones(n))
    np.testing.assert_allclose(alloc.numpy(), prof.pcap_min, rtol=1e-5)


def test_water_fill_favours_heavier_weights():
    prof = PROFILES["dahu"]
    n = 16
    w = torch.cat([torch.ones(n // 2), 2.0 * torch.ones(n // 2)])
    alloc = _water_fill(prof, 0.6 * _peak(prof, n), n, w).numpy()
    assert alloc[n // 2:].mean() > alloc[: n // 2].mean()


@pytest.mark.parametrize("budgeted", [False, True])
def test_fleet_engine_matches_reference_statistics(budgeted):
    """The engine-backed fleet and the hand-rolled step are the same
    two-level controller up to RNG stream and the heartbeat median
    filter; steady-state fleet statistics agree within rel 0.08."""
    prof = PROFILES["dahu"]
    n = 64
    budget = 0.6 * _peak(prof, n) if budgeted else 0.0
    fc = FleetConfig(n_nodes=n, epsilon=0.1, power_budget=budget)
    new = simulate_fleet(prof, fc, steps=80, seed=1, **CPU)
    ref = _simulate_fleet_reference(prof, fc, steps=80, seed=1, **CPU)
    for k in ("power", "progress_med", "pcap_mean"):
        assert new[k][30:].mean() == pytest.approx(ref[k][30:].mean(),
                                                   rel=0.08), k
    assert float(new["energy_total"]) == pytest.approx(
        float(ref["energy_total"]), rel=0.08)


def test_fleet_budget_adherence():
    prof = PROFILES["dahu"]
    n = 64
    budget = 0.6 * _peak(prof, n)
    fc = FleetConfig(n_nodes=n, epsilon=0.1, power_budget=budget)
    tr = simulate_fleet(prof, fc, steps=80, seed=1, **CPU)
    steady = tr["power"][30:].mean()
    assert steady < 1.05 * budget
    assert steady > 0.5 * budget


def test_water_fill_bounds_respects_per_node_ranges():
    n = 16
    lo = torch.cat([torch.full((n // 2,), 40.0), torch.full((n // 2,),
                                                             90.0)])
    hi = torch.cat([torch.full((n // 2,), 120.0),
                    torch.full((n // 2,), 250.0)])
    budget = 0.7 * float(hi.sum())
    alloc = _water_fill_bounds(lo, hi, budget, torch.ones(n)).numpy()
    assert alloc.sum() == pytest.approx(budget, rel=1e-4)
    assert (alloc >= lo.numpy() - 1e-4).all()
    assert (alloc <= hi.numpy() + 1e-4).all()
    assert alloc[n // 2:].mean() > alloc[: n // 2].mean()
    alloc = _water_fill_bounds(lo, hi, 0.5 * float(lo.sum()),
                               torch.ones(n)).numpy()
    np.testing.assert_allclose(alloc, lo.numpy(), rtol=1e-5)


@pytest.mark.parametrize("budgeted", [False, True])
def test_heterogeneous_fleet_matches_reference_statistics(budgeted):
    profs = [PROFILES["gros"], PROFILES["dahu"]]
    n = 64
    peak = sum(_peak(p, 1) for p in profs) * n / 2
    fc = FleetConfig(n_nodes=n, epsilon=0.1,
                     power_budget=0.6 * peak if budgeted else 0.0)
    new = simulate_fleet(profs, fc, steps=80, seed=1, **CPU)
    ref = _simulate_fleet_reference(profs, fc, steps=80, seed=1, **CPU)
    for k in ("power", "progress_med", "pcap_mean"):
        assert new[k][30:].mean() == pytest.approx(ref[k][30:].mean(),
                                                   rel=0.08), k
    for c in range(2):
        assert new["power_class"][30:, c].mean() == pytest.approx(
            ref["power_class"][30:, c].mean(), rel=0.08), f"class {c}"
    assert float(new["energy_total"]) == pytest.approx(
        float(ref["energy_total"]), rel=0.08)


def test_heterogeneous_fleet_budget_adherence_and_shifting():
    profs = [PROFILES["gros"], PROFILES["dahu"]]
    n = 64
    peak = sum(_peak(p, 1) for p in profs) * n / 2
    budget = 0.55 * peak
    fc = FleetConfig(n_nodes=n, epsilon=0.05, power_budget=budget,
                     straggler_boost=2.0)
    tr = simulate_fleet(profs, fc, steps=120, seed=2, **CPU)
    steady = tr["power"][40:].mean()
    assert steady < 1.05 * budget
    assert steady > 0.5 * budget
    alloc = tr["alloc_class"][40:].mean(0)
    assert alloc[1] > alloc[0] + 1.0
    assert tr["progress_class"][40:].mean(0).shape == (2,)
    assert (tr["class_counts"] == 32).all()


def test_heterogeneous_fleet_per_class_policies_run_and_adhere():
    profs = [PROFILES["gros"], PROFILES["dahu"]]
    n = 32
    peak = sum(_peak(p, 1) for p in profs) * n / 2
    fc = FleetConfig(n_nodes=n, epsilon=0.1, power_budget=0.7 * peak)
    tr = simulate_fleet(profs, fc, steps=80, seed=3,
                        policies=[PIPolicy(), DutyCyclePolicy()], **CPU)
    assert tr["power"][30:].mean() < 1.05 * (0.7 * peak)
    assert tr["power_class"].shape == (80, 2)
    node_pols = [PIPolicy() if i % 2 == 0 else DutyCyclePolicy()
                 for i in range(n)]
    tr2 = simulate_fleet(profs, fc, steps=80, seed=3, policies=node_pols,
                         **CPU)
    np.testing.assert_allclose(tr["power"], tr2["power"], rtol=1e-6)
    with pytest.raises(ValueError):
        simulate_fleet(profs, fc, steps=10, policies=[PIPolicy()] * 3,
                       **CPU)
    with pytest.raises(ValueError):
        simulate_fleet(profs, fc, steps=10,
                       node_class=[0] * (n - 1) + [5], **CPU)


def test_fleet_policies_per_node_wins_when_ambiguous():
    a, b = PIPolicy(), DutyCyclePolicy()
    assert H._fleet_policies([a, b], n_profiles=2, n=2,
                             cls=np.array([1, 0])) == [a, b]
    assert H._fleet_policies([a, b], n_profiles=2, n=4,
                             cls=np.array([1, 0, 1, 0])) == [b, a, b, a]


def test_fleet_per_class_vectors_survive_short_horizons():
    profs = [PROFILES["gros"], PROFILES["dahu"], PROFILES["yeti"]]
    fc = FleetConfig(n_nodes=6, epsilon=0.1)
    tr = simulate_fleet(profs, fc, steps=2, seed=0,
                        node_class=[0, 1, 2, 0, 1, 2], **CPU)
    assert tr["energy_class"].shape == (3,)
    assert tr["power_class"].shape == (2, 3)
    assert (tr["energy_class"] > 0).all()


def test_fleet_trace_length_and_horizon_freeze():
    prof = PROFILES["gros"]
    fc = FleetConfig(n_nodes=8, epsilon=0.1)
    tr = simulate_fleet(prof, fc, steps=50, seed=0, **CPU)
    assert len(tr["power"]) == 50
    e50 = float(tr["energy_total"])
    tr2 = simulate_fleet(prof, fc, steps=100, seed=0, **CPU)
    assert float(tr2["energy_total"]) == pytest.approx(2.0 * e50, rel=0.1)


# ---- mirrors of the fleet tests of test_system / test_workloads ---------

def test_fleet_respects_power_budget():
    prof = PROFILES["dahu"]
    peak = _peak(prof, 64)
    fc = FleetConfig(n_nodes=64, epsilon=0.1, power_budget=0.6 * peak)
    tr = simulate_fleet(prof, fc, steps=80, seed=1, **CPU)
    assert tr["power"][30:].mean() < 0.7 * peak


def test_fleet_scales_to_1024_nodes():
    tr = simulate_fleet(PROFILES["gros"], FleetConfig(n_nodes=1024,
                                                      epsilon=0.1),
                        steps=30, seed=2, **CPU)
    assert np.isfinite(tr["progress_med"]).all()
    assert float(tr["energy_total"]) > 0


def test_fleet_per_node_schedules_shift_budget():
    profs = [PROFILES["gros"], PROFILES["dahu"]]
    peak = sum(_peak(p, 1) for p in profs) * 6
    fc = FleetConfig(n_nodes=12, epsilon=0.05, power_budget=0.55 * peak,
                     reallocate_every=5)
    flip = PhaseSchedule((Phase(60.0, scale=STREAM),
                          Phase(200.0, scale=DGEMM)))
    hold = PhaseSchedule((Phase(60.0, scale=STREAM),))
    tr = simulate_fleet(profs, fc, steps=160, node_class=[0, 1] * 6,
                        schedules=[flip, hold], **CPU)
    assert tr["phase_class"].shape == (160, 2)
    assert tr["phase_class"][30].tolist() == [0.0, 0.0]
    assert tr["phase_class"][100].tolist() == [1.0, 0.0]
    alloc = tr["alloc_class"]
    share0_before = alloc[30, 0] / alloc[30].sum()
    share0_after = alloc[140:, 0].mean() / alloc[140:].mean(0).sum()
    assert share0_after > share0_before + 0.02, (share0_before,
                                                 share0_after)
    tr2 = simulate_fleet(profs, fc, steps=40, node_class=[0, 1] * 6, **CPU)
    assert "phase_class" not in tr2


def test_fleet_schedule_normalization_errors():
    fc = FleetConfig(n_nodes=4, epsilon=0.1)
    with pytest.raises(ValueError, match="schedules"):
        simulate_fleet(PROFILES["gros"], fc, steps=8,
                       schedules=[PhaseSchedule((Phase(1.0),))] * 3,
                       **CPU)


# ---- execution layouts: executor, supervisor, resume --------------------

def _small():
    prof = PROFILES["dahu"]
    return prof, FleetConfig(n_nodes=8, epsilon=0.1,
                             power_budget=0.7 * _peak(prof, 8))


def test_fleet_sweep_rides_executor_and_matches_single_runs():
    prof, fc = _small()
    fs = fleet_sweep(prof, fc, steps=25, seeds=[0, 1, 2], chunk_size=2,
                     **CPU)
    assert fs["power"].shape == (3, 25)
    for s in (0, 2):
        one = simulate_fleet(prof, fc, steps=25, seed=s, **CPU)
        np.testing.assert_allclose(fs["power"][s], one["power"], rtol=1e-6)
        np.testing.assert_allclose(fs["energy_total"][s],
                                   float(one["energy_total"]), rtol=1e-6)
        # the node streams depend only on (seed, node): bit for bit here
        for k in one:
            if k != "class_counts":
                np.testing.assert_array_equal(fs[k][s], one[k], err_msg=k)


def test_fleet_sweep_durable_matches_plain(tmp_path):
    prof, fc = _small()
    fs = fleet_sweep(prof, fc, steps=25, seeds=[0, 1, 2], chunk_size=2,
                     **CPU)
    fd = fleet_sweep(prof, fc, steps=25, seeds=[0, 1, 2], chunk_size=2,
                     durable=tmp_path, **CPU)
    np.testing.assert_array_equal(fs["power"], fd["power"])
    np.testing.assert_array_equal(fs["energy_total"], fd["energy_total"])
    assert (Path(tmp_path) / supervisor.SPEC_NAME).exists()
    again = supervisor.resume_campaign(tmp_path)
    for k in fs:
        np.testing.assert_array_equal(fs[k], again[k], err_msg=k)


def test_fleet_sweep_kill9_then_resume_campaign(tmp_path):
    """A durable fleet campaign killed -9 after two commits, reopened by
    `resume_campaign(dir)` alone: the uninterrupted traces, bit for
    bit."""
    code = f"""
from repro_torch.core.hierarchy import FleetConfig, fleet_sweep
from repro_torch.core.plant import PROFILES
from repro_torch.core.supervisor import CampaignConfig
p = PROFILES["dahu"]
fc = FleetConfig(n_nodes=8, epsilon=0.1,
                 power_budget=0.7 * 8 * float(p.power_of_pcap(p.pcap_max)))
fleet_sweep(p, fc, steps=25, seeds=range(5), chunk_size=1,
            durable={str(tmp_path)!r}, device="cpu",
            campaign=CampaignConfig(checkpoint_every=1,
                                    kill_after_commits=2))
print("SURVIVED_KILL")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == -int(signal.SIGKILL), out.stdout + out.stderr
    res = supervisor.resume_campaign(tmp_path)
    prof, fc = _small()
    one = fleet_sweep(prof, fc, steps=25, seeds=range(5), **CPU)
    for k in one:
        np.testing.assert_array_equal(one[k], res[k], err_msg=k)
