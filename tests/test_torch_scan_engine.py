"""The port's scan engine (`repro_torch.core.sim`: `engine_step`,
`_scan_core`, `sweep(backend="scan")`, `open_loop_runs`, `replay_model`)
and its Poisson heartbeat sampler (`repro_torch.core.poisson`) against
the reference's `repro.core.sim` and `jax.random.poisson`.

Three tiers, as the port is checked everywhere:

* function level: `engine_step` fed the reference's own plant noise and
  Poisson counts (rebuilt from the reference's period keys) follows
  `repro.core.sim.engine_step(typed_pi=True)` step by step at fp32
  tolerance (rtol 1e-5, atol 1e-5; flags, counts and histograms
  exactly); `replay_model` at rtol 1e-5 with atol 1e-5 * K_L (XLA's jit
  and its own eager mode differ by an ulp in exp, and the Eq. 3
  recurrence carries such an ulp along); `_bucket_steps` exactly;
* whole runs: the port's streams are its own, so sweeps and open-loop
  runs are compared statistically, rtol 0.05 on seed means, as the
  reference compares its own engines;
* within the port: sub-grids equal the one-shot rows exactly, summary
  mode equals the trace reductions, the early-exit mask freezes state.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from repro.core import sim as jsim  # noqa: E402
from repro.core.plant import PROFILES as JPROFILES  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import plane, poisson, sim  # noqa: E402
from repro_torch.core.plant import PROFILES, simulate  # noqa: E402
from repro_torch.core.faults import FaultSchedule, guard_values  # noqa: E402
from repro_torch.core.workloads import (DetectorConfig, Phase,  # noqa: E402
                                        PhaseSchedule, detector_values)
from repro_torch.kernels.closed_loop import ops  # noqa: E402

CPU = dict(device="cpu")
SCAN = dict(backend="scan", **CPU)


# ---- function level: engine_step on the reference's own draws ---------

def _flat(c, prefix=""):
    out = []
    for f, v in zip(c._fields, c):
        out += (_flat(v, prefix + f + ".") if hasattr(v, "_fields")
                else [(prefix + f, v)])
    return out


def _assert_carry_close(mine, ref, tag):
    for (k, a), (k2, b) in zip(_flat(mine), _flat(ref)):
        # scenario state (detector, faults, guard, recorder): None on both
        # sides when its axis is off
        assert k == k2 and (a is None) == (b is None), (tag, k)
        if a is None:
            continue
        assert a.dtype == b.dtype, (tag, k, a.dtype, b.dtype)
        if a.dtype in (torch.bool, torch.int32) or k.endswith("_hist"):
            assert torch.equal(a, b), (tag, k)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{tag} {k}")


def _key_noise(k):
    """The four draws the reference's plant_step makes from ``k``."""
    kn, kp, kd, ke = jax.random.split(k, 4)
    return jnp.stack([jax.random.normal(kn), jax.random.normal(kp),
                      jax.random.uniform(kd), jax.random.uniform(ke)])


def _engine_case(dt, total_work, steps=64, seed=11):
    """gros, dahu, yeti (twice; one yeti with frequent drops) through both
    engines for ``steps`` periods -> the (count bucket, has_anchor)
    pairs the window median saw, and the final done flags."""
    names = ["gros", "dahu", "yeti", "gros", "dahu", "yeti"]
    eps = [0.1, 0.2, 0.1, 0.0, 0.3, 0.15]
    profs = [JPROFILES[n] for n in names]
    profs[5] = dataclasses.replace(profs[5], drop_prob=0.3)
    pv = np.stack([np.asarray(jsim.profile_values(p)) for p in profs])
    gv = np.stack([np.asarray(jsim.gains_values(
        jsim.PIGains.from_model(p, e))) for p, e in zip(profs, eps)])
    f32 = jnp.float32
    tw, mt, dtj, sf = f32(total_work), f32(1e4), f32(dt), f32(3.0)

    def jinit(p, g):
        return jsim._default_init(jsim._unpack_profile(p),
                                  jsim._unpack_gains(g), typed_pi=True)

    def jstep(p, g, c, k):
        return jsim.engine_step(jsim._unpack_profile(p),
                                jsim._unpack_gains(g), c, tw, mt, dtj, k,
                                typed_pi=True, summary_from=sf)

    jstep = jax.jit(jax.vmap(jstep))
    jc = jax.jit(jax.vmap(jinit))(pv, gv)
    prof = sim._unpack_profile(torch.from_numpy(pv))
    gains = plane.unpack_gains(torch.from_numpy(gv))
    c = sim._default_init(prof, gains)
    _assert_carry_close(c, convert.carry_from_reference(jc, **CPU), "init")
    sc = lambda x: torch.tensor(x, dtype=torch.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), steps * len(names))
    keys = keys.reshape(steps, len(names), -1)
    seen = set()
    for i in range(steps):
        split = jax.vmap(jax.random.split)(keys[i])
        kplant, khb = split[:, 0], split[:, 1]
        noise = torch.from_numpy(np.asarray(jax.vmap(_key_noise)(kplant)).T
                                 .copy())

        def sampler(lam):
            n = np.asarray(jax.vmap(jax.random.poisson)(
                khb, jnp.asarray(lam.numpy())))
            seen.update(zip(np.minimum(n, 3).tolist(),
                            c.has_anchor.tolist()))
            return torch.from_numpy(n.astype(np.int32))

        c, out = sim.engine_step(prof, gains, c, sc(total_work), sc(1e4),
                                 sc(dt), noise, sampler,
                                 summary_from=sc(3.0))
        jc, jout = jstep(pv, gv, jc, keys[i])
        _assert_carry_close(c, convert.carry_from_reference(jc, **CPU),
                            f"step {i}")
        for k, v in out.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jout[k]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i} out {k}")
    return seen, c.done.tolist(), c.steps.tolist()


def test_engine_step_matches_reference_typed_pi_on_its_own_draws():
    """64 periods at dt = 1 (every run alive throughout) and at dt = 0.05
    (rates of ~1 beat a period, so the window median's n = 0, 1, 2 and
    >= 3 branches with and without an anchor all run, and every run
    freezes at total_work part-way, at its own step)."""
    seen, done, n_steps = _engine_case(1.0, 1e9)
    assert not any(done) and set(n_steps) == {64}
    seen2, done2, n_steps2 = _engine_case(0.05, 33.0)
    assert all(done2) and max(n_steps2) < 64 and len(set(n_steps2)) > 2
    assert seen | seen2 == {(n, a) for n in range(4) for a in (False, True)}


def _one_run(x):
    """A scenario input of one run, as a batch of one."""
    return type(x)(*(v[None] for v in x)) if isinstance(x, tuple) \
        else x[None]


_SV = _one_run(PhaseSchedule((Phase(10.0),)).resolve("gros", device="cpu"))
_DV = _one_run(detector_values(DetectorConfig(), PROFILES["gros"],
                               device="cpu"))
_FV = _one_run(FaultSchedule().resolve(device="cpu"))
_GV = guard_values(device="cpu")


@pytest.mark.parametrize("kwargs", [
    dict(policy=("pi", "dutycycle"), typed_pi=True),
    dict(faults=_FV, fault_u=torch.zeros(1)),
    dict(guard=_GV)])
def test_engine_step_rejects_what_is_not_ported(kwargs):
    """The typed fast path refuses a branch set other than ("pi",), faults
    and the guard, as the reference does (the fleet's ``cap_limit`` runs:
    `test_engine_step_cap_limit_clips`)."""
    prof = sim._unpack_profile(sim.profile_values(PROFILES["gros"])[None])
    gains = plane.unpack_gains(sim.gains_values(
        sim.PIGains.from_model(PROFILES["gros"], 0.1))[None])
    c = sim._default_init(prof, gains, kwargs.get("policy", ("pi",)),
                          kwargs.get("policy_vals"))
    with pytest.raises(ValueError, match="typed_pi"):
        sim.engine_step(prof, gains, c, 1e9, 64.0, 1.0, torch.zeros(4, 1),
                        lambda lam: lam.to(torch.int32), **kwargs)


_RLS = "rls"  # stands for PIPolicy(adaptive=RLSConfig())'s values


@pytest.mark.parametrize("kwargs", [
    dict(policy=("pi", "dutycycle"), policy_vals=torch.zeros(1, 10),
         detector=_DV, cap_limit=100.0),
    dict(policy=("pi_rls",), policy_vals=_RLS, faults=_FV,
         fault_u=torch.zeros(1), cap_limit=90.0),
    dict(cap_limit=100.0),
    dict(schedule=_SV, cap_limit=100.0),
    dict(policy=("pi",), policy_vals=torch.zeros(1, 10), guard=_GV,
         cap_limit=70.0)],
    ids=["packed-detector", "packed-faults", "typed", "typed-schedule",
         "packed-guard"])
def test_engine_step_cap_limit_clips(kwargs):
    """``cap_limit`` runs on the typed and the packed path, with the
    scenario inputs too, and the command it leaves is min(command,
    limit): two beats a period sit far below the setpoint, so the same
    step without the limit commands more than the limit, and the limited
    one commands the limit (a NaN limit gives NaN, as ``jnp.minimum``
    does)."""
    from repro_torch.core import policies as pol
    from repro_torch.core.adaptive import RLSConfig
    kw = dict(kwargs)
    lim = kw.pop("cap_limit")
    g0 = sim.PIGains.from_model(PROFILES["gros"], 0.1)
    prof = sim._unpack_profile(sim.profile_values(PROFILES["gros"])[None])
    gains = plane.unpack_gains(sim.gains_values(g0)[None])
    if kw.get("policy_vals") is _RLS:
        kw["policy_vals"] = pol.policy_values(pol.PIPolicy(
            adaptive=RLSConfig()), PROFILES["gros"], g0)[None]
    init = {name: kw[arg] for arg, name in (
        ("detector", "det_vals"), ("faults", "faults"), ("guard", "guard"),
        ("schedule", "schedule")) if arg in kw}
    c = sim._default_init(prof, gains, kw.get("policy", ("pi",)),
                          kw.get("policy_vals"), **init)
    noise = torch.tensor([[0.0], [0.0], [0.5], [0.5]])  # no drop
    args = (prof, gains, c, 1e9, 64.0, 1.0, noise,
            lambda lam: torch.full_like(lam, 2).to(torch.int32))
    _, free = sim.engine_step(*args, **kw)
    c2, out = sim.engine_step(*args, cap_limit=lim, **kw)
    assert float(free["pcap"]) > lim
    assert float(out["pcap"]) == pytest.approx(lim)
    assert float(c2.pcap) == pytest.approx(lim)
    nan = sim.engine_step(*args, cap_limit=float("nan"), **kw)[1]
    assert np.isnan(float(nan["pcap"]))


@pytest.mark.parametrize("dt", [1.0, 0.5])
@pytest.mark.parametrize("name", sorted(PROFILES))
def test_replay_model_equals_reference(name, dt):
    rng = np.random.default_rng(0)
    sched = np.repeat(rng.uniform(40, 120, 120), 4).astype(np.float32)
    p = PROFILES[name]
    if name.startswith("v5e"):
        sched = p.pcap_min + (sched - 40) / 80 * (p.pcap_max - p.pcap_min)
    mine = sim.replay_model(name, sched, dt, **CPU)
    assert mine.dtype == torch.float32 and mine.shape == (480,)
    np.testing.assert_allclose(mine.numpy(),
                               np.asarray(jsim.replay_model(name, sched,
                                                            dt)),
                               rtol=1e-5, atol=1e-5 * p.K_L)


def test_replay_model_matches_reference_loop():
    p = PROFILES["dahu"]
    sched = np.concatenate([np.full(20, 60.0), np.full(20, 110.0)])
    pred = sim.replay_model(p, sched, 1.0, **CPU).numpy()
    pl = jsim.pcap_linearize(JPROFILES["dahu"], sched)
    w = 1.0 / (1.0 + p.tau)
    y = float(pl[0]) * p.K_L
    ref = np.zeros(len(sched))
    for i in range(len(sched)):
        y = p.K_L * w * float(pl[i]) + (1 - w) * y
        ref[i] = y + p.K_L
    np.testing.assert_allclose(pred, ref, rtol=1e-5)


def test_bucket_steps_equal_reference():
    for n in (0, 1, 64, 255, 256, 257, 1200, 2000, 2048, 2049, 10**6):
        assert sim._bucket_steps(n) == jsim._bucket_steps(n), n


# ---- open-loop runs ----------------------------------------------------

def test_open_loop_runs_equal_simulate_on_each_seeds_noise():
    p = PROFILES["yeti"]
    seeds = [4, 9, 1000]
    res = sim.open_loop_runs(p, 96, seeds, pcap=90.0, **CPU)
    assert {k: tuple(v.shape) for k, v in res.items()} == {
        "progress": (3, 96), "power": (3, 96), "pcap": (3, 96),
        "progress_clean": (3, 96), "energy": (3,), "work": (3,)}
    prof = sim._unpack_profile(sim.profile_values(p))
    for i, s in enumerate(seeds):
        noise = ops.draw_noise([s], 96, **CPU)[:, :4, 0]
        one = simulate(prof, torch.full((96,), 90.0), torch.tensor(1.0),
                       noise)
        for k, v in one.items():
            assert torch.equal(res[k][i], v.expand_as(res[k][i])), k


@pytest.mark.parametrize("name", ["gros", "dahu", "yeti"])
def test_open_loop_runs_match_reference_statistically(name):
    mine = sim.open_loop_runs(name, 400, range(8), **CPU)
    ref = jsim.open_loop_runs(name, 400, range(8))
    for k in ("progress", "power"):
        np.testing.assert_allclose(mine[k].mean().item(),
                                   float(np.asarray(ref[k]).mean()),
                                   rtol=0.05, err_msg=k)
    np.testing.assert_allclose(mine["energy"].mean().item(),
                               float(np.asarray(ref["energy"]).mean()),
                               rtol=0.05)


# ---- whole runs: sweep(backend="scan") -------------------------------

def test_scan_sweep_matches_reference_scan_statistically():
    kw = dict(total_work=1e9, max_time=192.0, collect_traces=False,
              summary_warmup=30)
    names = ["gros", "dahu", "yeti"]
    mine = sim.sweep(names, [0.1, 0.3], range(16), **kw, **SCAN)
    ref = jsim.sweep(names, [0.1, 0.3], range(16), backend="scan", **kw)
    for k in ("progress_mean", "power_mean"):
        np.testing.assert_allclose(mine.summary[k].mean(-1),
                                   np.asarray(ref.summary[k]).mean(-1),
                                   rtol=0.05, err_msg=k)
    np.testing.assert_allclose(mine.energy.mean(-1),
                               np.asarray(ref.energy).mean(-1), rtol=0.05)
    np.testing.assert_array_equal(mine.n_steps, np.asarray(ref.n_steps))


def test_scan_sweep_shapes_squeeze_and_tradeoff_direction():
    eps = [0.0, 0.1, 0.3]
    res = sim.sweep(["gros", "dahu"], eps, range(2), total_work=800.0,
                    max_time=300.0, **SCAN)
    assert res.exec_time.shape == (2, 3, 2)
    # the reference's scan-path trace length: _bucket_steps(ceil(300/1))
    assert res.traces["progress"].shape == (2, 3, 2, 512)
    assert res.traces["valid"].dtype == bool
    assert res.n_steps.dtype == np.int32
    assert bool(res.completed.all())
    t, e = res.exec_time.mean(-1), res.energy.mean(-1)
    for p in range(2):
        assert e[p, 2] < e[p, 0]     # more degradation -> less energy
        assert t[p, 2] > t[p, 0]     # ... and more time
    one = sim.sweep("gros", eps, range(2), total_work=800.0, max_time=300.0,
                    collect_traces=False, **SCAN)
    assert one.exec_time.shape == (3, 2) and one.traces is None
    assert one.summary["progress_hist"].shape == (3, 2, 64)
    np.testing.assert_array_equal(one.energy, res.energy[0])
    half = sim.sweep("gros", [0.1], [0], total_work=1e9, max_time=100.0,
                     dt=0.5, **SCAN)
    assert half.traces["t"].shape == (1, 1, 256)


def test_scan_sub_grid_equals_one_shot_rows():
    """Each run's plant noise and heartbeat counts ride with its seed, so
    a sub-grid reproduces the one-shot rows exactly."""
    kw = dict(total_work=1500.0, max_time=256.0, **SCAN)
    full = sim.sweep(["gros", "yeti"], [0.1, 0.2], [3, 7, 9, 11], **kw)
    sub = sim.sweep(["yeti"], [0.2], [9, 3], **kw)
    for k in full.traces:
        np.testing.assert_array_equal(sub.traces[k][0, 0],
                                      full.traces[k][1, 1, [2, 0]],
                                      err_msg=k)
    for k in ("progress_hist", "pcap_hist", "progress_mean"):
        np.testing.assert_array_equal(sub.summary[k][0, 0],
                                      full.summary[k][1, 1, [2, 0]])


def test_scan_summary_mode_matches_trace_reductions():
    kw = dict(total_work=900.0, max_time=300.0, **SCAN)
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
    np.testing.assert_allclose(full.summary["pcap_hist"].sum(-1),
                               full.n_steps, rtol=1e-6)


def test_scan_early_exit_mask_freezes_state():
    res = sim.sweep("gros", [0.1], [0], total_work=200.0, max_time=600.0,
                    **SCAN)
    valid = res.traces["valid"][0, 0]
    n = int(res.n_steps[0, 0])
    assert 0 < n < 600
    assert valid[:n].all() and not valid[n:].any()
    for k in ("energy", "work", "t", "pcap"):
        x = res.traces[k][0, 0]
        assert (x[n:] == x[n - 1]).all(), k  # frozen after completion
    assert float(res.exec_time[0, 0]) == pytest.approx(float(n))
    assert (res.traces["progress"][0, 0, n:] == 0).all()
    assert (res.traces["power"][0, 0, n:] == 0).all()


@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_typed_pi_is_accepted_and_changes_nothing(backend):
    kw = dict(total_work=500.0, max_time=200.0, backend=backend, **CPU)
    packed = sim.sweep(["gros", "dahu"], [0.1], range(2), **kw)
    typed = sim.sweep(["gros", "dahu"], [0.1], range(2), typed_pi=True,
                      **kw)
    for k in packed.traces:
        np.testing.assert_array_equal(packed.traces[k], typed.traces[k])


# ---- the Poisson heartbeat sampler -----------------------------------

LAMS = [0.0, 0.3, 3.0, 9.9, 10.0, 40.0, 1800.0, 7000.0]
# 2e5 draws per rate: 20,000 runs x 10 steps of one stream
N_RUNS, N_STEPS = 20000, 10


@pytest.mark.parametrize("lam", LAMS)
def test_poisson_sampler_matches_jax_random_poisson(lam):
    """Mean and variance against lam (5 standard errors), and the binned
    pmf against jax.random.poisson's draws at the same rate (chi-square
    two-sample test, p > 1e-3); no draw left unresolved."""
    stream = poisson.PoissonStream(torch.arange(N_RUNS))
    rate = torch.full((N_RUNS,), lam)
    x = torch.cat([stream(rate, s) for s in range(N_STEPS)]).numpy()
    assert x.dtype == np.int32
    stream.check()
    assert int(stream.unresolved) == 0
    y = np.asarray(jax.random.poisson(jax.random.PRNGKey(0), lam,
                                      (N_RUNS * N_STEPS,)))
    n = x.size
    if lam == 0:
        assert (x == 0).all() and (y == 0).all()
        return
    assert abs(x.mean() - lam) < 5 * np.sqrt(lam / n)
    # the sample variance's standard error for a Poisson: sqrt((lam +
    # 2 lam^2) / n)
    assert abs(x.var() - lam) < 5 * np.sqrt((lam + 2 * lam * lam) / n)
    lo, hi = np.percentile(np.concatenate([x, y]), [0.1, 99.9])
    edges = np.unique(np.round(np.linspace(lo, hi + 1, 40)))
    cx = np.histogram(x, edges)[0]
    cy = np.histogram(y, edges)[0]
    keep = (cx + cy) > 0
    p = stats.chi2_contingency(np.stack([cx[keep], cy[keep]]))[1]
    assert p > 1e-3, (lam, p)


def test_poisson_unresolved_draws_are_flagged_and_raise():
    B = 4
    lam = torch.tensor([5.0, 0.0, 50.0, 3000.0])
    # uniforms near 1 keep every Knuth product above exp(-5); u = 0 puts
    # every PTRS candidate on the rejected edge (u_shifted = 0)
    uk = torch.full((poisson.KNUTH_ROUNDS, B), 1.0 - 2.0 ** -24)
    u = torch.zeros((poisson.PTRS_ROUNDS, B))
    v = torch.full((poisson.PTRS_ROUNDS, B), 0.5)
    counts, open_ = poisson.poisson_from_uniforms(lam, uk, u, v)
    assert open_.tolist() == [True, False, True, True]
    assert int(counts[1]) == 0
    stream = poisson.PoissonStream(torch.arange(3))
    stream(torch.tensor([1.0, 20.0, 700.0]), 0)
    stream.check()
    stream.unresolved += 1
    with pytest.raises(RuntimeError, match="unresolved"):
        stream.check()


def test_poisson_stream_uses_the_counter_generator():
    """A step's uniforms are the counter generator's words for the
    stream's words at that step (`ops._noise_words`), so a run's counts
    depend on its seed and the step alone."""
    seeds = torch.tensor([0, 5, 2**40 + 3])
    stream = poisson.PoissonStream(seeds)
    w = stream.uniforms(17)
    assert w.shape == (poisson.N_WORDS, 3)
    from repro_torch.counter_rng import unit24
    for j in (0, poisson.KNUTH_ROUNDS, poisson.N_WORDS - 1):
        ref = unit24(ops._noise_words(seeds, poisson.FIRST_WORD + j, 17,
                                      18))[0]
        assert torch.equal(w[j], ref)
    lam = torch.tensor([2.0, 30.0, 500.0])
    a = stream(lam, 17)
    b = poisson.PoissonStream(seeds[[2, 0]])(lam[[2, 0]], 17)
    assert torch.equal(a[[2, 0]], b)
