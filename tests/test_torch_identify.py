"""The port's identification (`repro_torch.core.identify`) against the
reference's `repro.core.identify` on the same campaign, and twins of the
reference's own identification tests (`tests/test_identify.py`) on the
port alone.

The campaigns are the port's: `identify.static_campaign` runs
`sim.open_loop_runs` on `draw_noise` seeds (the reference's campaign
draws from `jax.random`, so its numbers differ). Both fits see the same
numbers. Tolerances: the least-squares fits are the same float64 numpy
code, so equal; the Gauss-Newton fit runs the same float32 iteration
with another autodiff and LU solve, rtol 1e-4 on the fitted parameters
(they agree to ~4e-6) and 1e-6 on R^2; Pearson's r rtol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import identify as jidentify  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import sim  # noqa: E402
from repro_torch.core.identify import (StaticFit, fit_dynamics,  # noqa: E402
                                       fit_rapl, fit_static, pearson,
                                       static_campaign)
from repro_torch.core.plant import (PROFILES, pcap_linearize,  # noqa: E402
                                    simulate)
from repro_torch.kernels.closed_loop import ops  # noqa: E402

CPU = dict(device="cpu")
PARAM_RTOL = 1e-4
R2_RTOL = 1e-6


def _fig5_schedule():
    """120 caps from default_rng(0), each held 4 s (the reference test's
    schedule)."""
    rng = np.random.default_rng(0)
    return np.repeat(rng.uniform(40, 120, 120), 4).astype(np.float32)


@pytest.mark.parametrize("name,reps", [("gros", 3), ("dahu", 3),
                                       ("yeti", 4)])
def test_fit_static_equals_reference_on_one_campaign(name, reps):
    caps, powers, progs = static_campaign(PROFILES[name], reps=reps, **CPU)
    assert caps.shape == powers.shape == progs.shape == (9 * reps,)
    mine = fit_static(caps, powers, progs, **CPU)
    ref = convert.static_fit_from_reference(
        jidentify.fit_static(caps, powers, progs))
    assert isinstance(mine, StaticFit)
    assert (mine.a, mine.b) == (ref.a, ref.b)
    for f in ("K_L", "alpha", "beta"):
        assert getattr(mine, f) == pytest.approx(getattr(ref, f),
                                                 rel=PARAM_RTOL), f
    assert mine.r2 == pytest.approx(ref.r2, rel=R2_RTOL)


def test_pearson_and_least_squares_equal_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=57).astype(np.float32)
    y = (0.3 * x + rng.normal(size=57)).astype(np.float32)
    assert pearson(x, y, **CPU) == pytest.approx(jidentify.pearson(x, y),
                                                 rel=1e-5)
    assert pearson(x, -x, **CPU) == pytest.approx(-1.0, abs=1e-6)
    caps = rng.uniform(40, 120, 20)
    power = 0.9 * caps + 3.0 + rng.normal(size=20)
    assert fit_rapl(caps, power) == jidentify.fit_rapl(caps, power)
    assert fit_rapl(torch.from_numpy(caps),
                    torch.from_numpy(power)) == fit_rapl(caps, power)
    for name in ("gros", "yeti"):
        p = PROFILES[name]
        pcaps = _fig5_schedule()
        pl = pcap_linearize(p, torch.from_numpy(pcaps)).numpy()
        yl = sim.replay_model(p, pcaps, **CPU).numpy() - p.K_L
        yl = yl + rng.normal(scale=0.05, size=yl.shape).astype(np.float32)
        assert fit_dynamics(pl, yl, 1.0) == jidentify.fit_dynamics(pl, yl,
                                                                   1.0)


# ---- twins of tests/test_identify.py on the port alone ----------------

@pytest.mark.parametrize("name,tol", [("gros", 0.05), ("dahu", 0.08)])
def test_static_fit_recovers_table2(name, tol):
    p = PROFILES[name]
    caps, powers, progs = static_campaign(p, **CPU)
    fit = fit_static(caps, powers, progs, **CPU)
    assert fit.a == pytest.approx(p.a, rel=tol)
    assert fit.b == pytest.approx(p.b, abs=2.0)
    assert fit.K_L == pytest.approx(p.K_L, rel=tol)
    assert fit.alpha == pytest.approx(p.alpha, rel=0.25)
    assert fit.beta == pytest.approx(p.beta, abs=3.0)
    assert fit.r2 > 0.95


def test_noisy_multisocket_fit_degrades_gracefully():
    """yeti: fit still works but R2 drops (paper §5: noisier with sockets)."""
    p = PROFILES["yeti"]
    caps, powers, progs = static_campaign(p, reps=4, **CPU)
    fit = fit_static(caps, powers, progs, **CPU)
    assert fit.K_L == pytest.approx(p.K_L, rel=0.25)
    assert 0.7 < fit.r2 <= 1.0


def test_rapl_line_fit():
    a, b = fit_rapl([40, 80, 120], [0.83 * 40 + 7, 0.83 * 80 + 7,
                                    0.83 * 120 + 7])
    assert a == pytest.approx(0.83, rel=1e-6)
    assert b == pytest.approx(7.0, rel=1e-6)


def test_dynamics_fit_recovers_tau():
    p = PROFILES["gros"]
    sched = _fig5_schedule()
    noise = ops.draw_noise([2], len(sched), **CPU)[:, :4, 0]
    tr = simulate(p, torch.from_numpy(sched), 1.0, noise)
    pl = pcap_linearize(p, torch.from_numpy(sched)).numpy()
    yl = tr["progress_clean"].numpy() - p.K_L
    tau, kl = fit_dynamics(pl, yl, 1.0)
    assert tau == pytest.approx(p.tau, rel=0.05)
    assert kl == pytest.approx(p.K_L, rel=0.05)


def test_pearson_progress_exec_time():
    """Progress correlates with completion rate (paper: 0.97 on gros)."""
    p = PROFILES["gros"]
    rates, times = [], []
    for i, pcap in enumerate(np.linspace(40, 120, 9)):
        tr = sim.open_loop_runs(p, 60, [3 + i], pcap=float(pcap), **CPU)
        mean_prog = float(tr["progress"].mean())
        rates.append(mean_prog)
        times.append(1000.0 / max(mean_prog, 1e-6))  # time for fixed work
    r = pearson(rates, [-t for t in times], **CPU)
    assert r > 0.9
