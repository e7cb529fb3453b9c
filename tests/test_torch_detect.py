"""The port's change-point detector (`repro_torch.core.workloads.detect`)
and its place in `plane_step` and the scan engine, against the
reference's `repro.core.workloads.detect` / `repro.core.plane` /
`repro.core.sim`.

Bars, and why:

* `detector_values` bit for bit; `detect_init` too, but for the model
  replay's anchor (rtol 2e-6: it goes through Eq. 2's exp, which XLA and
  PyTorch round a few ulps apart).
* `detect_step` over 64 periods against the jitted reference: the model
  replay, the level, the countdown, the counters and every alarm bit for
  bit; the two Page-Hinkley sums at rtol 1e-6, atol 1e-6. XLA on the CPU
  contracts the multiply-adds of the replay, the level EWMA and sigma's
  last square into FMAs (the port follows with `core/fma.py`), but how it
  contracts sigma's first square changes with the fusion it lands in, so
  sigma can sit an ulp off, and the sums carry that ulp.
* `plane_step` with the detector (and per-row ``det_on`` masks) for each
  branch set of the policy slice, and the scan engine's detector on the
  typed and the packed path, on the reference's own draws: the scan
  engine's bar (rtol 1e-5, atol 1e-5; flags and counts exactly).
* Mirrors of the reference's detector tests (`tests/test_workloads.py`)
  on the port's own streams at the reference's bars.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import plane as jplane  # noqa: E402
from repro.core.plant import PROFILES as JPROFILES  # noqa: E402
from repro.core.workloads import detect as JD  # noqa: E402

from repro_torch.core import plane, sim  # noqa: E402
from repro_torch.core.adaptive import RLSConfig  # noqa: E402
from repro_torch.core.controller import PIGains  # noqa: E402
from repro_torch.core.plant import PROFILES  # noqa: E402
from repro_torch.core.workloads import (DetectorConfig, Phase,  # noqa: E402
                                        PhaseSchedule)
from repro_torch.core.workloads import detect as D  # noqa: E402

import _torch_scenarios as SC  # noqa: E402

CPU = dict(device="cpu")
ALL4 = ("pi", "pi_rls", "dutycycle", "offline_rl")
CONFIGS = [dict(), dict(threshold=4.0, min_gap=0), dict(drift=0.1,
                                                        level_eta=0.2,
                                                        level_slack=1.5),
           dict(threshold=30.0, min_gap=25)]


def test_constants_equal_reference():
    assert D.DET_PARAM_FIELDS == JD.DET_PARAM_FIELDS
    assert (D.DET_PARAM_DIM, D.DET_STATE_DIM) == (JD.DET_PARAM_DIM,
                                                  JD.DET_STATE_DIM)
    assert (D.DET_PRED_L, D.DET_LEVEL, D.DET_M_POS, D.DET_M_NEG,
            D.DET_COOLDOWN, D.DET_N_DETECT, D.DET_SINCE) == \
        (JD.DET_PRED_L, JD.DET_LEVEL, JD.DET_M_POS, JD.DET_M_NEG,
         JD.DET_COOLDOWN, JD.DET_N_DETECT, JD.DET_SINCE)
    assert DetectorConfig() == DetectorConfig(**{
        f: getattr(JD.DetectorConfig(), f) for f in
        DetectorConfig.__dataclass_fields__})


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_detector_values_and_init_equal_reference(name):
    for cfg in CONFIGS:
        mine = D.detector_values(DetectorConfig(**cfg), PROFILES[name],
                                 **CPU)
        ref = JD.detector_values(JD.DetectorConfig(**cfg), JPROFILES[name])
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    g = PIGains.from_model(PROFILES[name], 0.15)
    jg = jplane.unpack_gains(jplane.gains_values(
        jplane.PIGains.from_model(JPROFILES[name], 0.15)))
    for pcap0 in (None, 77.0):
        a = D.detect_init(mine, plane.unpack_gains(plane.gains_values(g)),
                          pcap0).numpy()
        b = np.asarray(jax.jit(JD.detect_init, static_argnums=2)(
            jnp.asarray(np.asarray(ref)), jg, pcap0))
        # the replay's anchor goes through the Eq. 2 exp, which XLA and
        # PyTorch round a few ulps apart
        np.testing.assert_allclose(a[0], b[0], rtol=2e-6)
        np.testing.assert_array_equal(a[1:], b[1:])


def _step_rows(B=64, seed=0):
    """Detector rows over gros / dahu / yeti and four configs, and their
    gains, as numpy."""
    names = ["gros", "dahu", "yeti"]
    vals = np.stack([np.asarray(JD.detector_values(
        JD.DetectorConfig(**CONFIGS[i % 4]), JPROFILES[names[i % 3]]))
        for i in range(B)])
    gv = np.stack([np.asarray(jplane.gains_values(jplane.PIGains.from_model(
        JPROFILES[names[i % 3]], 0.1))) for i in range(B)])
    return vals, gv


@pytest.mark.parametrize("dt", [1.0, 0.5])
def test_detect_step_matches_reference_over_64_steps(dt):
    """Each package runs its own state for 64 periods on the same inputs:
    residuals around the design model, a level shift at period 30 (alarms
    on most rows), different configs and profiles per row."""
    vals, gv = _step_rows()
    B = vals.shape[0]
    jstep = jax.jit(jax.vmap(JD.detect_step, in_axes=(0, 0, 0, 0, None)))
    js = jax.vmap(lambda v, g: JD.detect_init(
        v, jplane.unpack_gains(g)))(vals, gv)
    ts = D.detect_init(torch.from_numpy(vals),
                       plane.unpack_gains(torch.from_numpy(gv)))
    rng = np.random.default_rng(5)
    n_alarm = 0
    for i in range(64):
        prog = (vals[:, 0] * rng.uniform(0.3, 1.3, B)).astype(np.float32)
        if i > 30:
            prog = prog * 1.5
        pl = -np.exp(-rng.uniform(0.5, 3, B)).astype(np.float32)
        js, jd = jstep(jnp.asarray(vals), js, jnp.asarray(prog),
                       jnp.asarray(pl), jnp.float32(dt))
        ts, td = D.detect_step(torch.from_numpy(vals), ts,
                               torch.from_numpy(prog), torch.from_numpy(pl),
                               torch.tensor(dt))
        a, b = np.asarray(js), ts.numpy()
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        for k in (D.DET_PRED_L, D.DET_LEVEL, D.DET_COOLDOWN, D.DET_N_DETECT,
                  D.DET_SINCE, 7):
            np.testing.assert_array_equal(b[:, k], a[:, k], err_msg=f"{i} {k}")
        for k in (D.DET_M_POS, D.DET_M_NEG):
            np.testing.assert_allclose(b[:, k], a[:, k], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{i} {k}")
        n_alarm += int(td.sum())
    assert n_alarm > B // 2


@pytest.mark.parametrize("branches", [("pi",), ("pi_rls",), ALL4],
                         ids=lambda b: "+".join(b))
def test_plane_step_with_detector_matches_reference(branches):
    """The alarm routes each row through its branch's on_change before the
    step; masked rows (``det_on`` 0) keep their detector state."""
    _, alarms = SC.plane_case(branches, detector=True, guard=False)
    assert alarms.sum() > 0


@pytest.mark.parametrize("typed", [True, False], ids=["typed", "packed"])
def test_engine_step_with_detector_matches_reference(typed):
    branches = ("pi",) if typed else ALL4
    c, tr = SC.engine_case(("detector",), typed, branches)
    assert tr["phase_change"].sum() > 0
    assert torch.equal(c.det[:, D.DET_N_DETECT],
                       tr["phase_change"].sum(0))


def test_engine_step_with_schedule_and_detector_matches_reference():
    c, tr = SC.engine_case(("schedule", "detector"), False, ALL4)
    assert tr["phase_change"].sum() > 0


# ---- mirrors of the detector tests of tests/test_workloads.py -------------

def test_detector_recovers_injected_boundary_within_5_periods():
    """An injected phase boundary at paper-scale noise is recovered within
    5 control periods, across seeds; a static plant never alarms."""
    sched = PhaseSchedule((Phase(200.0), Phase(400.0, scale={"K_L": 2.0})))
    kw = dict(total_work=1e9, max_time=400.0, detector=DetectorConfig(),
              **CPU)
    res = sim.sweep("gros", [0.1], range(4), workloads=sched, **kw)
    static = sim.sweep("gros", [0.1], range(4), collect_traces=False, **kw)
    for seed in range(4):
        alarms = np.nonzero(res.traces["phase_change"][0, seed])[0]
        assert len(alarms) >= 1
        assert 200 <= alarms[0] <= 205, alarms
    assert (static.detections == 0).all()


def _settle_periods(kl, a: int) -> int:
    """Periods after alarm `a` until kl_hat stays inside 20% of its own
    jump toward the run's final estimate."""
    final = kl[-20:].mean()
    band = 0.2 * abs(kl[a - 2] - final)
    for t in range(a, len(kl)):
        if (abs(kl[t] - final) <= band
                and abs(kl[min(t + 5, len(kl) - 1)] - final) <= 2 * band):
            return t - a
    return len(kl) - a


def test_detection_resets_rls_and_reconverges_gains_vs_baseline():
    """The alarm resets the RLS covariance and forces an immediate gain
    re-placement, so the detector arm's K_L estimate settles faster than
    the slow-forgetting no-detector baseline (same seeds, same plant)."""
    sched = PhaseSchedule((Phase(150.0), Phase(250.0, scale={"K_L": 1.5})))
    kw = dict(total_work=1e9, max_time=400.0, workloads=sched,
              adaptive=RLSConfig(), **CPU)
    base = sim.sweep("gros", [0.1], range(3), **kw)
    det = sim.sweep("gros", [0.1], range(3), detector=DetectorConfig(), **kw)
    faster = 0
    for seed in range(3):
        n = int(det.n_steps[0, seed])
        kl_d = det.traces["kl_hat"][0, seed, :n]
        kl_b = base.traces["kl_hat"][0, seed, :n]
        alarms = np.nonzero(det.traces["phase_change"][0, seed])[0]
        assert len(alarms) >= 1
        a = int(alarms[0])
        assert 150 <= a <= 162, alarms
        jump_det = abs(float(kl_d[a + 5]) - float(kl_d[a - 2]))
        jump_base = abs(float(kl_b[a + 5]) - float(kl_b[a - 2]))
        assert jump_det > jump_base, (jump_det, jump_base)
        if _settle_periods(kl_d, a) < _settle_periods(kl_b, a):
            faster += 1
    assert faster >= 2
