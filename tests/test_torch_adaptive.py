"""The port's RLS estimator (`repro_torch.core.adaptive`) and adaptive PI
(`sweep(adaptive=...)`, `simulate_closed_loop(adaptive=..., design=...)`)
against the reference's `repro.core.adaptive` and `repro.core.sim`.

Inputs come from a seed through numpy into both packages. Tiers:

* function level: `rls_init`, `rls_step` (a driven 200-step sequence,
  one configuration of which trips the covariance trace clamp),
  `rls_pack` / `rls_unpack` against the reference's jitted functions at
  rtol 1e-5, atol 1e-5, has_prev exactly. The port writes each 2-term
  dot as the fused multiply-add chain XLA evaluates, so on the CPU the
  two agree bit for bit in practice; the bar is the engine's;
* the numpy oracle `RLSAdapter` against the in-engine estimator, at the
  reference test's own bars;
* whole runs: the adaptive grid's seed means within rtol 0.05 of the
  reference's scan sweep (other random streams: the statistical bar the
  port's engines are held to), the grid's axis and squeeze rules, and
  the gain-shift scenario of the reference's system test.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import adaptive as JA  # noqa: E402
from repro.core import sim as jsim  # noqa: E402
from repro.core.plant import PROFILES as JPROFILES  # noqa: E402

from repro_torch.core import adaptive as A  # noqa: E402
from repro_torch.core import sim  # noqa: E402
from repro_torch.core.controller import PIGains  # noqa: E402
from repro_torch.core.plant import PROFILES, pcap_linearize  # noqa: E402
from repro_torch.core.policies import PIPolicy  # noqa: E402

CPU = dict(device="cpu")
RTOL = ATOL = 1e-5

# (config, design profile, eps) per row; the last row's p_trace_max sits
# below the covariance's growth under a constant regressor at lam 0.9
ROWS = [(A.RLSConfig(), "gros", 0.1),
        (A.RLSConfig(lam=0.97, dwell=3), "dahu", 0.2),
        (A.RLSConfig(lam=0.999, dwell=1, kl_clamp=2.0), "yeti", 0.05),
        (A.RLSConfig(lam=0.9, dwell=7), "gros", 0.3),
        (A.RLSConfig(lam=0.9, dwell=2, p_trace_max=150.0), "dahu", 0.1)]


def _rows():
    """(B, 6) rls values, (B,) design k_p / k_i, (B,) design K_L."""
    vals, kp, ki, kl = [], [], [], []
    for cfg, name, eps in ROWS:
        g = PIGains.from_model(PROFILES[name], eps)
        vals.append(A.rls_values(cfg, PROFILES[name], g).numpy())
        kp.append(g.k_p)
        ki.append(g.k_i)
        kl.append(PROFILES[name].K_L)
    f = lambda x: np.asarray(x, np.float32)
    return np.stack(vals), f(kp), f(ki), f(kl)


def _jcfg(cfg):
    return JA.RLSConfig(**dataclasses.asdict(cfg))


def test_rls_values_equal_reference():
    for cfg, name, eps in ROWS:
        g = PIGains.from_model(PROFILES[name], eps)
        jg = jsim.PIGains.from_model(JPROFILES[name], eps)
        for design in ("gros", name):
            mine = A.rls_values(cfg, PROFILES[design], g)
            assert mine.dtype == torch.float32 and mine.shape == (6,)
            np.testing.assert_array_equal(mine.numpy(), np.asarray(
                JA.rls_values(_jcfg(cfg), JPROFILES[design], jg)))


def _assert_state_close(mine: A.RLSState, ref, tag):
    for f in A.RLSState._fields:
        a, b = getattr(mine, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, (tag, f, a.shape, b.shape)
        if f == "has_prev":
            np.testing.assert_array_equal(a, b, err_msg=f"{tag} {f}")
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{tag} {f}")


def test_rls_step_driven_sequence_matches_reference():
    """200 steps of the estimator on the same (progress, pcap_L) inputs:
    excitation for 60 steps, then a constant regressor for 80 (the
    covariance grows by 1/lam a step in the unexcited direction, and the
    lam-0.9 row with p_trace_max 150 clamps), then excitation again."""
    vals, kp, ki, kl = _rows()
    B, T = vals.shape[0], 200
    rng = np.random.default_rng(7)
    prog = (kl * (0.7 + 0.1 * rng.standard_normal((T, B)))).astype(
        np.float32)
    pl = rng.uniform(-0.6, -0.02, (T, B)).astype(np.float32)
    prog[60:140] = prog[59]
    pl[60:140] = pl[59]
    jinit = jax.jit(jax.vmap(JA.rls_init))
    jstep = jax.jit(jax.vmap(JA.rls_step, in_axes=(0, 0, 0, 0, None)))
    js = jinit(vals, kp, ki)
    s = A.rls_init(torch.from_numpy(vals), torch.from_numpy(kp),
                   torch.from_numpy(ki))
    _assert_state_close(s, js, "init")
    clamped = np.zeros(B, bool)
    for i in range(T):
        js = jstep(vals, js, prog[i], pl[i], jnp.float32(1.0))
        s = A.rls_step(torch.from_numpy(vals), s, torch.from_numpy(prog[i]),
                       torch.from_numpy(pl[i]), torch.tensor(1.0))
        _assert_state_close(s, js, f"step {i}")
        tr = np.trace(np.asarray(js.P), axis1=1, axis2=2)
        clamped |= np.isclose(tr, vals[:, 5], rtol=1e-6)
    assert clamped.tolist() == [False] * (B - 1) + [True]
    # the estimator moved off its initial guess
    assert np.all(np.abs(s.theta[:, 0].numpy() - 0.5 * kl) > 1e-3)


def test_rls_untriggered_clamp_returns_p_itself():
    """Below p_trace_max the clamp's where returns P itself: the same
    step with no cap at all gives the same bits."""
    vals, kp, ki, kl = _rows()
    uncapped = vals.copy()
    uncapped[:, 5] = np.inf
    rng = np.random.default_rng(3)
    a = A.rls_init(torch.from_numpy(vals), torch.from_numpy(kp),
                   torch.from_numpy(ki))
    b = a
    for i in range(30):
        p = torch.from_numpy((kl * rng.uniform(0.5, 1.0, kl.shape)).astype(
            np.float32))
        u = torch.from_numpy(rng.uniform(-0.5, -0.05, kl.shape).astype(
            np.float32))
        a = A.rls_step(torch.from_numpy(vals[:4]), A.RLSState(
            *(x[:4] for x in a)), p[:4], u[:4], 1.0)
        b = A.rls_step(torch.from_numpy(uncapped[:4]), A.RLSState(
            *(x[:4] for x in b)), p[:4], u[:4], 1.0)
        assert float((a.P[:, 0, 0] + a.P[:, 1, 1]).max()) < 1e6
        assert torch.equal(a.P, b.P) and torch.equal(a.theta, b.theta)


def test_rls_pack_unpack_match_reference_and_round_trip():
    vals, kp, ki, kl = _rows()
    rng = np.random.default_rng(5)
    js = jax.vmap(JA.rls_init)(vals, kp, ki)
    s = A.rls_init(torch.from_numpy(vals), torch.from_numpy(kp),
                   torch.from_numpy(ki))
    jstep = jax.vmap(JA.rls_step, in_axes=(0, 0, 0, 0, None))
    for i in range(3):
        prog = (kl * rng.uniform(0.5, 1.0, kl.shape)).astype(np.float32)
        pl = rng.uniform(-0.5, -0.05, kl.shape).astype(np.float32)
        packed = A.rls_pack(s)
        assert packed.shape == (len(ROWS), A.RLS_STATE_SIZE)
        assert packed.dtype == torch.float32
        np.testing.assert_allclose(packed.numpy(),
                                   np.asarray(jax.vmap(JA.rls_pack)(js)),
                                   rtol=RTOL, atol=ATOL)
        back = A.rls_unpack(packed)
        for f in A.RLSState._fields:
            assert torch.equal(getattr(back, f), getattr(s, f)), (i, f)
        _assert_state_close(back, jax.vmap(JA.rls_unpack)(
            jax.vmap(JA.rls_pack)(js)), f"unpack {i}")
        js = jstep(vals, js, prog, pl, jnp.float32(1.0))
        s = A.rls_step(torch.from_numpy(vals), s, torch.from_numpy(prog),
                       torch.from_numpy(pl), 1.0)
    assert A.RLS_STATE_SIZE == JA.RLS_STATE_SIZE == 14
    assert A.RLS_FIELDS == JA.RLS_FIELDS


# ---- twins of the reference's adaptive tests ---------------------------

def test_scan_rls_matches_numpy_adapter():
    """The in-engine estimator and the numpy RLSAdapter are the same
    algorithm: driven with identical (progress, prev pcap_L) sequences —
    taken from an adaptive gain-shift run — their theta / tau_hat /
    K_L_hat trajectories agree (f32 vs f64 accumulation only; the
    reference test's bars)."""
    design = PROFILES["gros"]
    shifted = dataclasses.replace(design, K_L=design.K_L * 2)
    gains = PIGains.from_model(design, 0.1)
    res = sim.simulate_closed_loop(shifted, gains=gains, total_work=3000.0,
                                   max_time=256.0, seed=6,
                                   adaptive=A.RLSConfig(), design=design,
                                   **CPU)
    assert res.completed and res.rls_state is not None
    tr, n = res.traces, res.n_steps
    prev_pl = np.concatenate(
        [[float(pcap_linearize(design, design.pcap_max))],
         pcap_linearize(design, torch.from_numpy(tr["pcap"][:-1])).numpy()])
    oracle = A.RLSAdapter(gains, design)
    g = gains
    th = np.zeros((n, 2))
    tau = np.zeros(n)
    kl = np.zeros(n)
    for i in range(n):
        g = oracle.update(g, float(tr["progress"][i]), float(prev_pl[i]),
                          1.0)
        th[i] = oracle.theta
        tau[i], kl[i] = oracle.tau_hat, oracle.kl_hat
    np.testing.assert_allclose(tr["theta1"], th[:, 0], rtol=0.02,
                               atol=1e-3)
    np.testing.assert_allclose(tr["theta2"], th[:, 1], atol=5e-3)
    np.testing.assert_allclose(tr["tau_hat"], tau, rtol=0.05, atol=0.02)
    np.testing.assert_allclose(tr["kl_hat"], kl, rtol=0.01)
    assert float(res.rls_state.kl_hat) == pytest.approx(
        float(tr["kl_hat"][-1]))
    assert res.pi_state is not None and res.policy_state.shape == (17,)


def test_adaptive_sweep_grid_axis_and_squeeze():
    cfgs = [A.RLSConfig(lam=0.99), A.RLSConfig(lam=0.995),
            A.RLSConfig(lam=0.999)]
    res = sim.sweep("gros", [0.1, 0.2], range(2), total_work=500.0,
                    max_time=600.0, adaptive=cfgs, collect_traces=False,
                    **CPU)
    assert res.exec_time.shape == (2, 3, 2)  # (E, A, S), profile squeezed
    assert bool(np.asarray(res.completed).all())
    assert res.traces is None
    res1 = sim.sweep("gros", [0.1, 0.2], range(2), total_work=500.0,
                     max_time=600.0, adaptive=A.RLSConfig(),
                     collect_traces=False, **CPU)
    assert res1.exec_time.shape == (2, 2)
    # the A slice of the grid is that config alone
    np.testing.assert_array_equal(res1.exec_time, res.exec_time[:, 1])
    np.testing.assert_array_equal(res1.summary["progress_hist"],
                                  res.summary["progress_hist"][:, 1])
    with pytest.raises(ValueError, match="at least one RLSConfig"):
        sim.sweep("gros", [0.1], [0], total_work=1.0, adaptive=[], **CPU)


def test_adaptive_improves_completion_under_gain_shift():
    """Beyond the paper: RLS gain scheduling against fixed gains when the
    true plant gain doubles, both on the scan engine (the reference's
    system test drives the same scenario through its NRM runtime)."""
    design = PROFILES["gros"]
    shifted = dataclasses.replace(design, K_L=design.K_L * 2)
    kw = dict(gains=PIGains.from_model(design, 0.1), total_work=1500.0,
              max_time=256.0, seed=6, **CPU)
    fixed = sim.simulate_closed_loop(shifted, policy=PIPolicy(), **kw)
    adapt = sim.simulate_closed_loop(shifted, adaptive=A.RLSConfig(),
                                     design=design, **kw)
    assert fixed.completed and adapt.completed
    assert fixed.rls_state is None and "kl_hat" not in fixed.traces
    assert {"k_p", "k_i", "tau_hat", "kl_hat", "theta1",
            "theta2"} <= set(adapt.traces)
    assert adapt.exec_time <= fixed.exec_time * 1.05


def test_adaptive_sweep_matches_reference_scan_statistically():
    kw = dict(total_work=1e9, max_time=192.0, collect_traces=False,
              summary_warmup=30)
    cfgs = [A.RLSConfig(lam=0.97), A.RLSConfig(lam=0.999, dwell=2)]
    mine = sim.sweep(["gros", "dahu"], [0.1, 0.3], range(16),
                     adaptive=cfgs, **kw, **CPU)
    ref = jsim.sweep(["gros", "dahu"], [0.1, 0.3], range(16),
                     adaptive=[_jcfg(c) for c in cfgs], backend="scan",
                     **kw)
    assert mine.energy.shape == np.asarray(ref.energy).shape == (2, 2, 2,
                                                                 16)
    for k in ("progress_mean", "power_mean"):
        np.testing.assert_allclose(mine.summary[k].mean(-1),
                                   np.asarray(ref.summary[k]).mean(-1),
                                   rtol=0.05, err_msg=k)
    np.testing.assert_allclose(mine.energy.mean(-1),
                               np.asarray(ref.energy).mean(-1), rtol=0.05)
