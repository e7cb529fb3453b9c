"""The port's plant, PI controller and packing (`repro_torch.core`)
against the JAX reference, fed identical inputs, plus twins of the
reference's own plant and controller tests that need no engine.

Function-level parity is fp32 at rtol 1e-6: the same ops in the same
order, with at most an ulp of difference in exp/log between frameworks.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import controller as jctl  # noqa: E402
from repro.core import plane as jplane  # noqa: E402
from repro.core import plant as jplant  # noqa: E402
from repro.core import sim as jsim  # noqa: E402

from repro_torch.core import plane  # noqa: E402
from repro_torch.core import sim  # noqa: E402
from repro_torch.core.controller import (PIController, PIGains,  # noqa: E402
                                         PIState, pi_init, pi_step)
from repro_torch.core.plant import (PROFILE_FIELDS, PROFILES,  # noqa: E402
                                    PlantState, pcap_linearize, plant_init,
                                    plant_step, simulate)

NAMES = sorted(PROFILES)


def _key_noise(key):
    """The four draws the reference's plant_step makes from ``key``:
    normal(kn), normal(kp), bernoulli(kd) == uniform(kd) < p,
    bernoulli(ke) == uniform(ke) < p."""
    kn, kp, kd, ke = jax.random.split(key, 4)
    return torch.tensor([float(jax.random.normal(kn)),
                         float(jax.random.normal(kp)),
                         float(jax.random.uniform(kd)),
                         float(jax.random.uniform(ke))])


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-6,
                               atol=1e-6)


def test_profiles_are_the_reference_table():
    assert PROFILE_FIELDS == jplant.PROFILE_FIELDS
    assert set(PROFILES) == set(jplant.PROFILES)
    for n in NAMES:
        assert dataclasses.asdict(PROFILES[n]) == dataclasses.asdict(
            jplant.PROFILES[n])


@pytest.mark.parametrize("name", NAMES)
def test_profile_values_equal_reference(name):
    np.testing.assert_array_equal(
        sim.profile_values(PROFILES[name]).numpy(),
        np.asarray(jsim.profile_values(jplant.PROFILES[name])))


@pytest.mark.parametrize("eps", [0.0, 0.1, 0.3])
@pytest.mark.parametrize("name", NAMES)
def test_gains_values_equal_reference(name, eps):
    assert plane.GAIN_FIELDS == jplane.GAIN_FIELDS
    mine = plane.gains_values(PIGains.from_model(PROFILES[name], eps))
    ref = jplane.gains_values(jctl.PIGains.from_model(jplant.PROFILES[name],
                                                      eps))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    back = plane.unpack_gains(mine)
    np.testing.assert_array_equal(plane.gains_values(back).numpy(),
                                  mine.numpy())


@pytest.mark.parametrize("name,pcap,dropped", [
    ("gros", 60.0, False), ("dahu", 120.0, False), ("yeti", 85.0, False),
    ("yeti", 85.0, True), ("v5e-host", 500.0, True),
    ("gros", 30.0, False)])  # below pcap_min: clipped
def test_plant_step_matches_reference(name, pcap, dropped):
    p, jp = PROFILES[name], jplant.PROFILES[name]
    js = jplant.plant_init(jp, pcap0=100.0 if name != "v5e-host" else 700.0)
    js = js._replace(dropped=jnp.array(dropped))
    ts = PlantState(progress_l=torch.tensor(float(js.progress_l)),
                    dropped=torch.tensor(dropped),
                    energy=torch.tensor(3.0), work=torch.tensor(5.0))
    js = js._replace(energy=jnp.float32(3.0), work=jnp.float32(5.0))
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        js2, jm = jplant.plant_step(jp, js, pcap, 1.0, key)
        ts2, tm = plant_step(p, ts, pcap, 1.0, _key_noise(key))
        for f in ("progress_l", "energy", "work"):
            _close(getattr(ts2, f), getattr(js2, f))
        assert bool(ts2.dropped) == bool(js2.dropped)
        for k in jm:
            _close(tm[k], jm[k])


def test_plant_init_and_linearize_match_reference():
    for n in NAMES:
        p, jp = PROFILES[n], jplant.PROFILES[n]
        for pcap0 in (None, 0.5 * (p.pcap_min + p.pcap_max)):
            a, b = plant_init(p, pcap0), jplant.plant_init(jp, pcap0)
            _close(a.progress_l, b.progress_l)
            assert float(a.energy) == 0.0 and not bool(a.dropped)
        caps = np.linspace(p.pcap_min, p.pcap_max, 17, dtype=np.float32)
        _close(pcap_linearize(p, torch.from_numpy(caps)),
               jplant.pcap_linearize(jp, jnp.asarray(caps)))
        assert p.progress_max == jp.progress_max


@pytest.mark.parametrize("name", ["gros", "yeti"])
def test_simulate_matches_reference(name):
    p, jp = PROFILES[name], jplant.PROFILES[name]
    caps = np.linspace(110.0, 50.0, 40, dtype=np.float32)
    key = jax.random.PRNGKey(4)
    ref = jplant.simulate(jp, jnp.asarray(caps), 1.0, key)
    noise = torch.stack([_key_noise(k)
                         for k in jax.random.split(key, len(caps))])
    mine = simulate(p, torch.from_numpy(caps), 1.0, noise)
    for k in ref:
        _close(mine[k], ref[k])


@pytest.mark.parametrize("name,eps", [("gros", 0.1), ("dahu", 0.3),
                                      ("v5e-chip", 0.0)])
def test_pi_step_and_transforms_match_reference(name, eps):
    g = PIGains.from_model(PROFILES[name], eps)
    jg = jctl.PIGains.from_model(jplant.PROFILES[name], eps)
    assert dataclasses.asdict(g) == pytest.approx(dataclasses.asdict(jg),
                                                  rel=1e-12)
    caps = np.linspace(g.pcap_min, g.pcap_max, 9, dtype=np.float32)
    lin = g.linearize(torch.from_numpy(caps))
    _close(lin, jg.linearize(jnp.asarray(caps)))
    _close(g.delinearize(lin), jg.delinearize(jnp.asarray(lin.numpy())))
    s, js = pi_init(g), jctl.pi_init(jg)
    _close(s.prev_pcap_l, js.prev_pcap_l)
    rng = np.random.default_rng(1)
    for prog in rng.uniform(0.0, 1.3 * g.setpoint, 12).astype(np.float32):
        s, cap = pi_step(g, s, torch.tensor(prog), 1.0)
        js, jcap = jctl.pi_step(jg, js, jnp.float32(prog), 1.0)
        _close(cap, jcap)
        _close(s.prev_error, js.prev_error)
        _close(s.prev_pcap_l, js.prev_pcap_l)


# ---- twins of tests/test_plant.py ----------------------------------------

def _noise(rng, T):
    return torch.from_numpy(np.stack([
        rng.standard_normal(T), rng.standard_normal(T), rng.uniform(size=T),
        rng.uniform(size=T)], axis=1).astype(np.float32))


@pytest.mark.parametrize("name", ["gros", "dahu", "yeti", "v5e-chip"])
def test_static_monotone_saturating(name):
    p = PROFILES[name]
    caps = torch.linspace(p.pcap_min, p.pcap_max, 30)
    prog = p.static_progress(caps)
    diffs = torch.diff(prog)
    assert bool((diffs > 0).all())
    assert float(diffs[-1]) < float(diffs[0])
    assert float(prog[-1]) <= p.K_L


def test_eq3_dynamics_match_closed_form():
    p = dataclasses.replace(PROFILES["gros"], noise_scale=0.0,
                            power_noise=0.0, drop_prob=0.0)
    state = plant_init(p, pcap0=120.0)
    pl = pcap_linearize(p, 60.0)
    w = 1.0 / (1.0 + p.tau)
    expect = p.K_L * w * pl + (1 - w) * state.progress_l
    new_state, _ = plant_step(p, state, 60.0, 1.0, torch.zeros(4))
    assert float(new_state.progress_l) == pytest.approx(float(expect),
                                                        rel=1e-5)


def test_energy_is_power_times_time():
    p = dataclasses.replace(PROFILES["gros"], noise_scale=0.0,
                            power_noise=0.0)
    tr = simulate(p, torch.full((50,), 100.0), 2.0,
                  _noise(np.random.default_rng(1), 50))
    expected = float(p.power_of_pcap(100.0)) * 50 * 2.0
    assert float(tr["energy"]) == pytest.approx(expected, rel=1e-5)


def test_yeti_drops_occur():
    tr = simulate(PROFILES["yeti"], torch.full((400,), 110.0), 1.0,
                  _noise(np.random.default_rng(2), 400))
    assert float(tr["progress"].min()) < 25.0
    assert float(tr["progress"].max()) > 50.0


@pytest.mark.parametrize("pcap", [40.0, 57.3, 80.0, 101.9, 120.0])
def test_linearization_roundtrip(pcap):
    g = PIGains.from_model(PROFILES["dahu"], 0.1)
    back = g.delinearize(g.linearize(pcap))
    assert float(back) == pytest.approx(pcap, rel=1e-4)


# ---- twins of tests/test_controller.py -----------------------------------

def _closed_loop(profile, epsilon, steps=120, seed=0, noise=True):
    p = profile if noise else dataclasses.replace(
        profile, noise_scale=0.0, power_noise=0.0, drop_prob=0.0)
    gains = PIGains.from_model(p, epsilon)
    ps, cs = plant_init(p), pi_init(gains)
    nz = _noise(np.random.default_rng(seed), steps)
    pcap = p.pcap_max
    prog, caps = [], []
    for i in range(steps):
        ps, meas = plant_step(p, ps, pcap, 1.0, nz[i])
        cs, pcap = pi_step(gains, cs, meas["progress"], 1.0)
        prog.append(float(meas["progress"]))
        caps.append(float(pcap))
    return np.asarray(prog), np.asarray(caps), gains


def test_gains_pole_placement_formulas():
    p = PROFILES["gros"]
    g = PIGains.from_model(p, epsilon=0.1, tau_obj=10.0)
    assert g.k_p == pytest.approx(p.tau / (p.K_L * 10.0))
    assert g.k_i == pytest.approx(1.0 / (p.K_L * 10.0))
    assert g.setpoint == pytest.approx(0.9 * p.progress_max)
    assert g.with_gains(1.0, 2.0).setpoint == g.setpoint


@pytest.mark.parametrize("name,eps", [("gros", 0.15), ("dahu", 0.10)])
def test_tracking_converges(name, eps):
    prog, caps, gains = _closed_loop(PROFILES[name], eps, steps=150)
    assert abs(prog[80:].mean() - gains.setpoint) < 0.1 * gains.setpoint
    assert caps[-1] < PROFILES[name].pcap_max * 0.95


def test_no_oscillation_noise_free():
    prog, caps, gains = _closed_loop(PROFILES["gros"], 0.15, noise=False)
    assert np.var(prog[100:]) < np.var(prog[10:40]) * 0.5 + 1e-9
    assert prog[100:].min() > gains.setpoint * 0.93


def test_anti_windup_unreachable_setpoint():
    p = dataclasses.replace(PROFILES["gros"], noise_scale=0.0,
                            power_noise=0.0)
    gains = PIGains.from_model(p, epsilon=-0.5)  # 150% of max: impossible
    ps, cs = plant_init(p), pi_init(gains)
    nz = _noise(np.random.default_rng(0), 110)
    pcap = p.pcap_max
    for i in range(50):
        ps, meas = plant_step(p, ps, pcap, 1.0, nz[i])
        cs, pcap = pi_step(gains, cs, meas["progress"], 1.0)
    assert float(pcap) == pytest.approx(p.pcap_max, rel=1e-3)
    gains2 = PIGains.from_model(p, epsilon=0.2)
    for i in range(50, 110):
        ps, meas = plant_step(p, ps, pcap, 1.0, nz[i])
        cs, pcap = pi_step(gains2, cs, meas["progress"], 1.0)
    assert abs(float(meas["progress"]) - gains2.setpoint) \
        < 0.05 * gains2.setpoint


def test_pi_controller_wrapper_matches_functional_steps():
    g = PIGains.from_model(PROFILES["dahu"], 0.1)
    ctl = PIController(g)
    s = pi_init(g)
    for prog in (30.0, 33.5, 35.0, 36.1):
        cap = ctl.step(prog, 1.0)
        s, want = pi_step(g, s, prog, 1.0)
        assert cap == float(want)
    assert isinstance(ctl.state, PIState)
    ctl.reset()
    assert float(ctl.state.prev_error) == 0.0
