"""The port's closed-loop front end (`repro_torch.core.sim`) on the CPU:
statistically against the reference's scan engine, and as twins of the
reference's end-to-end system tests.

The port's runs use its own noise streams and rounded-Gaussian
heartbeats, the reference's scan engine Poisson heartbeats from
`jax.random`: the same model, different random numbers. So the
comparison is statistical, rtol 0.05 on seed-averaged statistics, as the
reference compares its own kernel backend with its scan engine.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import sim as jsim  # noqa: E402

from repro_torch.core import sim  # noqa: E402
from repro_torch.core.energy import (pareto_front, summarize_run,  # noqa: E402
                                     tradeoff_table)
from repro_torch.core.adaptive import RLSConfig, RLSState  # noqa: E402
from repro_torch.core.controller import PIState  # noqa: E402
from repro_torch.core.plant import PlantState  # noqa: E402
from repro_torch.core.policies import base as pol_base  # noqa: E402
from repro_torch.core.plant import PROFILES  # noqa: E402
from repro_torch.core.policies import DutyCyclePolicy, PIPolicy  # noqa: E402
from repro_torch.core.faults import FaultSchedule  # noqa: E402
from repro_torch.core.workloads import (DetectorConfig, Phase,  # noqa: E402
                                        PhaseSchedule)

CPU = dict(device="cpu")


def test_sweep_matches_reference_scan_statistically():
    kw = dict(total_work=1e9, max_time=192.0, collect_traces=False,
              summary_warmup=30)
    seeds = range(8)
    mine = sim.sweep("gros", [0.1, 0.3], seeds, **kw, **CPU)
    ref = jsim.sweep("gros", [0.1, 0.3], seeds, backend="scan", **kw)
    for k in ("progress_mean", "power_mean"):
        np.testing.assert_allclose(mine.summary[k].mean(-1),
                                   np.asarray(ref.summary[k]).mean(-1),
                                   rtol=0.05, err_msg=k)
    np.testing.assert_allclose(mine.energy.mean(-1),
                               np.asarray(ref.energy).mean(-1), rtol=0.05)


def test_sweep_shapes_squeeze_and_tradeoff_direction():
    eps = [0.0, 0.1, 0.3]
    res = sim.sweep(["gros", "dahu"], eps, range(2), total_work=800.0,
                    max_time=300.0, **CPU)
    assert res.exec_time.shape == (2, 3, 2)
    # the horizon is rounded up to the kernel's 64-step chunk
    assert res.traces["progress"].shape == (2, 3, 2, 320)
    assert res.traces["valid"].dtype == bool
    assert res.summary["progress_edges"].shape == (2, 65)
    assert res.n_steps.dtype == np.int32
    assert bool(res.completed.all())
    t, e = res.exec_time.mean(-1), res.energy.mean(-1)
    for p in range(2):
        assert e[p, 2] < e[p, 0]     # more degradation -> less energy
        assert t[p, 2] > t[p, 0]     # ... and more time
    one = sim.sweep("gros", eps, range(2), total_work=800.0, max_time=300.0,
                    collect_traces=False, **CPU)
    assert one.exec_time.shape == (3, 2) and one.traces is None
    assert one.summary["progress_hist"].shape == (3, 2, 64)
    assert one.summary["pcap_edges"].shape == (33,)
    np.testing.assert_array_equal(one.energy, res.energy[0])


def test_sweep_cell_equals_single_run_and_sub_grid():
    """Each run's noise rides with its seed: a sweep cell is exactly
    simulate_closed_loop at the same (eps, seed), and a sub-grid
    reproduces the one-shot rows."""
    res = sim.sweep("gros", [0.1], [3, 7, 9], total_work=1000.0,
                    max_time=200.0, **CPU)
    one = sim.simulate_closed_loop("gros", 0.1, total_work=1000.0,
                                   max_time=200.0, seed=7, **CPU)
    assert float(res.exec_time[0, 1]) == one.exec_time
    assert float(res.energy[0, 1]) == one.energy
    assert int(res.n_steps[0, 1]) == one.n_steps
    n = one.n_steps
    np.testing.assert_array_equal(res.traces["progress"][0, 1, :n],
                                  one.traces["progress"])
    sub = sim.sweep("gros", [0.1], [9], total_work=1000.0, max_time=200.0,
                    **CPU)
    np.testing.assert_array_equal(sub.summary["progress_hist"][0, 0],
                                  res.summary["progress_hist"][0, 2])


def test_early_exit_mask_freezes_state():
    res = sim.sweep("gros", [0.1], [0], total_work=200.0, max_time=128.0,
                    **CPU)
    valid = res.traces["valid"][0, 0]
    n = int(res.n_steps[0, 0])
    assert 0 < n < 128
    assert valid[:n].all() and not valid[n:].any()
    energy = res.traces["energy"][0, 0]
    assert (energy[n:] == energy[n - 1]).all()  # frozen after completion
    assert float(res.exec_time[0, 0]) == pytest.approx(float(n))
    assert (res.traces["progress"][0, 0, n:] == 0).all()


def test_summary_mode_matches_trace_reductions():
    kw = dict(total_work=900.0, max_time=128.0, **CPU)
    full = sim.sweep("gros", [0.1, 0.3], range(3), **kw)
    lean = sim.sweep("gros", [0.1, 0.3], range(3), collect_traces=False,
                     **kw)
    assert lean.traces is None and full.traces is not None
    for k in ("exec_time", "energy", "n_steps"):
        np.testing.assert_array_equal(getattr(full, k), getattr(lean, k))
    for k in ("progress_mean", "power_mean", "progress_hist", "pcap_hist"):
        np.testing.assert_array_equal(full.summary[k], lean.summary[k])
    np.testing.assert_allclose(full.summary["progress_mean"],
                               full.masked_mean("progress"), rtol=1e-4)
    np.testing.assert_allclose(full.summary["power_mean"],
                               full.masked_mean("power"), rtol=1e-4)
    np.testing.assert_allclose(full.summary["progress_hist"].sum(-1),
                               full.n_steps, rtol=1e-6)
    with pytest.raises(ValueError, match="summary mode"):
        lean.masked_mean("progress")


def test_single_live_step_summary():
    res = sim.simulate_closed_loop("gros", 0.1, total_work=1e-6,
                                   max_time=64.0, **CPU)
    assert res.n_steps == 1 and res.completed
    assert res.summary["progress_hist"].sum() == pytest.approx(1.0)
    assert res.summary["power_mean"] == pytest.approx(
        float(res.traces["power"][0]), rel=1e-5)
    med = sim.hist_quantile(res.summary["progress_hist"],
                            res.summary["progress_edges"], 0.5)
    lo = sim.hist_quantile(res.summary["progress_hist"],
                           res.summary["progress_edges"], 0.0)
    assert med == pytest.approx(lo)


def test_hist_quantile_equals_reference():
    rng = np.random.default_rng(3)
    hist = rng.integers(0, 5, (2, 3, 4, 64)).astype(np.float32)
    hist[0, 1, 2] = 0.0  # an empty histogram -> NaN in both
    edges = np.stack([sim._hist_edges(PROFILES[n])["progress_edges"]
                      for n in ("gros", "yeti")])
    for q in (0.0, 0.1, 0.5, 0.95, 1.0):
        np.testing.assert_array_equal(
            sim.hist_quantile(hist, edges, q),
            jsim.hist_quantile(hist, edges, q))
        np.testing.assert_array_equal(
            sim.hist_quantile(hist[0], edges[0], q),
            jsim.hist_quantile(hist[0], edges[0], q))
    for n in PROFILES:
        for k, v in sim._hist_edges(PROFILES[n]).items():
            np.testing.assert_array_equal(v, jsim._hist_edges(
                jsim.PROFILES[n])[k])


# ---- twins of tests/test_system.py, through the port's entry points ----

def test_closed_loop_reaches_setpoint_band():
    res = sim.simulate_closed_loop("gros", 0.15, total_work=2000.0, seed=1,
                                   max_time=256.0, **CPU)
    sp = 0.85 * PROFILES["gros"].progress_max
    prog = res.traces["progress"]
    assert res.completed
    assert abs(prog[len(prog) // 2:].mean() - sp) < 0.12 * sp


def test_energy_time_tradeoff_direction():
    kw = dict(total_work=1500.0, max_time=256.0, **CPU)
    r0 = sim.simulate_closed_loop("gros", 0.0, **kw)
    r3 = sim.simulate_closed_loop("gros", 0.3, **kw)
    assert r3.energy < r0.energy
    assert r3.exec_time >= r0.exec_time


def test_epsilon01_saves_energy_with_small_slowdown():
    """The paper's headline: eps=0.1 on gros ~22% energy for ~7% time."""
    res = sim.sweep("gros", [0.0, 0.1], range(4), total_work=1500.0,
                    max_time=256.0, **CPU)
    runs = []
    for e, eps in enumerate((0.0, 0.1)):
        for s in range(4):
            live = res.traces["valid"][e, s]
            runs.append(summarize_run(eps, 1.0,
                                      res.traces["progress"][e, s][live],
                                      res.traces["power"][e, s][live]))
    table = tradeoff_table(runs)
    assert 0.05 < table[0.1]["energy_saving"] < 0.45
    assert table[0.1]["time_increase"] < 0.30


def test_pareto_front_extraction():
    pts = [(10.0, 5.0), (12.0, 3.0), (11.0, 6.0), (15.0, 2.0), (9.0, 9.0)]
    labels = sorted(pts[i] for i in pareto_front(pts))
    assert labels == [(9.0, 9.0), (10.0, 5.0), (12.0, 3.0), (15.0, 2.0)]


KERNEL_ONLY = (ValueError, "fixed-gain PI path only")
TYPED_ONLY = (ValueError, "typed_pi")
HOLD = PhaseSchedule((Phase(50.0),))


@pytest.mark.parametrize("kwargs,error", [
    (dict(backend="kernel", policies=[DutyCyclePolicy()]),
     (ValueError, "fixed-gain PI path only")),
    (dict(adaptive=RLSConfig(), policies=PIPolicy()),
     (ValueError, "not both")),
    (dict(policies=[]), (ValueError, "at least one Policy")),
    (dict(backend="kernel", workloads=HOLD), KERNEL_ONLY),
    (dict(backend="kernel", detector=DetectorConfig()), KERNEL_ONLY),
    (dict(typed_pi=True, faults=FaultSchedule()), TYPED_ONLY),
    (dict(typed_pi=True, guard=True), TYPED_ONLY),
    (dict(record_events=-3), (ValueError, "record_events")),
    (dict(chunk_size=4, devices=2), (ValueError, "asked for 2 devices")),
    (dict(devices=()), (ValueError, "names no device")),
    (dict(devices=0), (ValueError, "asked for 0 devices")),
    (dict(backend="scan", adaptive=RLSConfig(), workloads=HOLD,
          consume=print, devices=3), (ValueError, "asked for 3 devices"))])
def test_sweep_rejects_what_the_kernel_cannot_run(kwargs, error):
    """The policy axis's misuses and the scenario axes on the paths that
    cannot carry them (the kernel route, the typed PI path) raise the
    reference's ValueErrors; so do more CUDA devices than exist (none
    here), as the reference's `resolve_devices` does, and a device list
    that names none."""
    with pytest.raises(error[0], match=error[1]):
        sim.sweep("gros", [0.1], [0], total_work=100.0, max_time=64.0,
                  **kwargs, **CPU)


def _carry(**kw):
    """A resume carry of a run at full power, with the given extras."""
    plant = PlantState(progress_l=-1.0, dropped=False, energy=0.0,
                       work=0.0)
    return sim.resume_init(plant, PIState(0.0, -0.05), 120.0, **kw)


_DUTY = np.zeros(17, np.float32)
_DUTY[16] = pol_base.branch_tag(DutyCyclePolicy().branch)
_RLS = RLSState(theta=[12.0, 0.5], P=[[1e2, 0.0], [0.0, 1e2]],
                prev_phi=[0.0, 0.0], has_prev=0.0, since_update=0.0,
                k_p=0.01, k_i=0.04, tau_hat=0.3, kl_hat=25.6)


@pytest.mark.parametrize("kwargs,error", [
    (dict(init=_carry(rls=_RLS)), (ValueError, "branch 'pi_rls'")),
    (dict(policy=PIPolicy(), adaptive=RLSConfig()),
     (ValueError, "not both")),
    (dict(policy=DutyCyclePolicy(), design=PROFILES["dahu"]),
     (ValueError, "design= only applies")),
    (dict(workload=HOLD, init=_carry(policy_state=_DUTY)),
     (ValueError, "branch 'dutycycle'")),
    (dict(init=_carry(det_state=np.zeros(8))),
     (ValueError, "detector state")),
    (dict(init=_carry(fault_state=np.zeros(6))),
     (ValueError, "faults state")),
    (dict(init=_carry(guard_state=np.zeros(8))),
     (ValueError, "guard state")),
    (dict(record_events=0), (ValueError, "record_events"))])
def test_simulate_rejects_what_the_kernel_cannot_run(kwargs, error):
    """A resume carry that does not fit the run raises the reference's
    ValueErrors: adaptive-PI state without ``adaptive=``, another
    policy's state,
    a scenario state without its input; a ring needs a positive
    size."""
    with pytest.raises(error[0], match=error[1]):
        sim.simulate_closed_loop("gros", 0.1, total_work=100.0,
                                 max_time=64.0, **kwargs, **CPU)


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="backend"):
        sim.sweep("gros", [0.1], [0], total_work=1.0, backend="pallas",
                  **CPU)
    with pytest.raises(ValueError, match="at least one"):
        sim.sweep("gros", [], [0], total_work=1.0, **CPU)
    with pytest.raises(ValueError, match="epsilon or gains"):
        sim.simulate_closed_loop("gros", total_work=1.0, **CPU)
