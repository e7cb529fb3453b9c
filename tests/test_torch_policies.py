"""The port's power policies (`repro_torch.core.policies`), the packed
scan engine that carries them (`repro_torch.core.sim.engine_step` with a
packed policy state, `sweep(policies=...)`) and `plane_step`, against the
reference's `repro.core.policies` / `repro.core.sim`.

Inputs come from a seed through numpy into both packages. Tiers:

* function level: `policy_values` of every Policy and `branch_tag`
  exactly; each branch's init, step, on_change and extras on the same
  packed rows with a heterogeneous kind column at rtol 1e-5, atol 1e-5;
  `transitions_from_traces` / `build_dataset` exactly; fitted
  Q-iteration's weights at the tolerance measured on the CPU (below) and
  the greedy actions exactly away from ties; the packed `engine_step`
  for ("pi",), ("pi_rls",) and all four branches at once, fed the
  reference's own plant noise and Poisson counts, step by step at the
  scan engine's bar (rtol 1e-5, atol 1e-5; flags, counts and histograms
  exactly);
* within the port: the packed ("pi",) path equals the typed one bit for
  bit, and a heterogeneous sweep's PI lane equals a pure PI sweep;
* twins of the reference's `tests/test_policies.py` through the port's
  entry points; whole runs against the reference's scan sweep at rtol
  0.05 on seed means (other random streams).

The NRM round trips of policy state are in `tests/test_torch_nrm.py`;
the reference's compile-cache tests (a JAX cache with no PyTorch
counterpart) are not mirrored.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import policies as jpol  # noqa: E402
from repro.core import sim as jsim  # noqa: E402
from repro.core.adaptive import RLSConfig as JRLSConfig  # noqa: E402
from repro.core.plant import PROFILES as JPROFILES  # noqa: E402
from repro.core.policies import offline_rl as JRL  # noqa: E402
from repro.core.policies import pi as JPI  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import plane, sim  # noqa: E402
from repro_torch.core import policies as pol  # noqa: E402
from repro_torch.core.adaptive import RLSConfig  # noqa: E402
from repro_torch.core.controller import PIGains  # noqa: E402
from repro_torch.core.plant import PROFILES  # noqa: E402
from repro_torch.core.policies import (DutyCyclePolicy,  # noqa: E402
                                       OfflineRLPolicy, PIPolicy,
                                       build_dataset, fit_offline_rl)
from repro_torch.core.policies import offline_rl as RL  # noqa: E402
from repro_torch.core.policies import pi as PI  # noqa: E402

from test_torch_scan_engine import (_assert_carry_close,  # noqa: E402
                                    _key_noise)

CPU = dict(device="cpu")
RTOL = ATOL = 1e-5
ALL4 = ("pi", "pi_rls", "dutycycle", "offline_rl")
RL_W = (0.1, 0.8, -0.5, 1.4, -1.0, 0.2)


def _both(branch):
    """A (port, reference) policy pair of ``branch``, with non-default
    hyperparameters."""
    if branch == "pi":
        return PIPolicy(), jpol.PIPolicy()
    if branch == "pi_rls":
        cfg = dict(lam=0.97, dwell=3)
        return (PIPolicy(adaptive=RLSConfig(**cfg)),
                jpol.PIPolicy(adaptive=JRLSConfig(**cfg)))
    if branch == "dutycycle":
        cfg = dict(n_levels=12, deadband=0.05, up_step=3.0)
        return DutyCyclePolicy(**cfg), jpol.DutyCyclePolicy(**cfg)
    return OfflineRLPolicy(weights=RL_W), jpol.OfflineRLPolicy(weights=RL_W)


NAMES = ["gros", "dahu", "yeti", "gros", "dahu", "yeti", "gros", "yeti"]
EPS = [0.1, 0.2, 0.1, 0.0, 0.3, 0.15, 0.05, 0.25]


def _rows(branches):
    """Eight runs over gros / dahu / yeti (one yeti with frequent drops),
    kinds cycling over ``branches``: reference profile, gain and policy
    value rows as numpy."""
    profs = [JPROFILES[n] for n in NAMES]
    profs[5] = dataclasses.replace(profs[5], drop_prob=0.3)
    gl = [jsim.PIGains.from_model(p, e) for p, e in zip(profs, EPS)]
    kinds = [i % len(branches) for i in range(len(NAMES))]
    pv = np.stack([np.asarray(jsim.profile_values(p)) for p in profs])
    gv = np.stack([np.asarray(jsim.gains_values(g)) for g in gl])
    av = np.stack([np.asarray(jpol.policy_values(_both(branches[k])[1], p,
                                                 g, kind=k))
                   for p, g, k in zip(profs, gl, kinds)])
    return pv, gv, av


# ---- the contract's functions ------------------------------------------

def test_constants_and_branch_tags_equal_reference():
    assert (pol.POLICY_STATE_DIM, pol.POLICY_PARAM_DIM,
            pol.BRANCH_TAG_SLOT) == (jpol.POLICY_STATE_DIM,
                                     jpol.POLICY_PARAM_DIM,
                                     jpol.BRANCH_TAG_SLOT)
    assert (PI.PI_RLS_LO, PI.PI_RLS_HI) == (JPI.PI_RLS_LO, JPI.PI_RLS_HI)
    assert (RL.N_FEATURES, RL.N_ACTIONS) == (JRL.N_FEATURES, JRL.N_ACTIONS)
    for name in ALL4:
        assert pol.branch_tag(name) == jpol.branch_tag(name)
        assert pol.tag_branch(pol.branch_tag(name)) == name
    assert pol.tag_branch(0) is None
    assert sorted(set(pol.__all__)) == sorted(set(jpol.__all__))
    assert "harvest_dataset" not in pol.__all__


def test_policy_values_equal_reference_for_every_policy():
    mine = [PIPolicy(), PIPolicy(adaptive=RLSConfig()),
            PIPolicy(adaptive=RLSConfig(lam=0.97, dwell=3, kl_clamp=2.0,
                                        p_trace_max=1e4),
                     design=PROFILES["dahu"]),
            DutyCyclePolicy(), DutyCyclePolicy(n_levels=12, min_level=3,
                                               deadband=0.05),
            OfflineRLPolicy(), OfflineRLPolicy(weights=RL_W)]
    ref = [jpol.PIPolicy(), jpol.PIPolicy(adaptive=JRLSConfig()),
           jpol.PIPolicy(adaptive=JRLSConfig(lam=0.97, dwell=3,
                                             kl_clamp=2.0,
                                             p_trace_max=1e4),
                         design=JPROFILES["dahu"]),
           jpol.DutyCyclePolicy(), jpol.DutyCyclePolicy(
               n_levels=12, min_level=3, deadband=0.05),
           jpol.OfflineRLPolicy(), jpol.OfflineRLPolicy(weights=RL_W)]
    for name in ("gros", "dahu", "yeti"):
        for eps in (0.0, 0.15):
            g = PIGains.from_model(PROFILES[name], eps)
            jg = jsim.PIGains.from_model(JPROFILES[name], eps)
            for kind, (m, r) in enumerate(zip(mine, ref)):
                assert m.branch == r.branch
                v = pol.policy_values(m, PROFILES[name], g, kind=kind % 4)
                assert v.dtype == torch.float32 and v.shape == (10,)
                np.testing.assert_array_equal(
                    v.numpy(), np.asarray(jpol.policy_values(
                        r, JPROFILES[name], jg, kind=kind % 4)))
    with pytest.raises(ValueError, match="weights"):
        OfflineRLPolicy(weights=(1.0, 2.0)).values(PROFILES["gros"], g)
    assert pol.resolve_kinds(mine) == jpol.resolve_kinds(ref)


@pytest.mark.parametrize("branches", [("pi",), ("pi_rls",), ("dutycycle",),
                                      ("offline_rl",), ALL4],
                         ids=lambda b: "+".join(b))
def test_branch_functions_match_reference(branches):
    """init, 40 steps on progress drawn around each run's setpoint, then
    on_change and the trace extras, on the same packed rows."""
    pv, gv, av = _rows(branches)
    jgains = jax.vmap(jsim._unpack_gains)
    f32 = jnp.float32

    def jstep(v, st, p, pw, g):
        obs = jpol.PolicyObs(progress=p, power=pw, dt=f32(1.0),
                             gains=jsim._unpack_gains(g))
        return jpol.policy_step(branches, v, st, obs)

    jinit = jax.jit(jax.vmap(lambda v, g: jpol.policy_init(
        branches, v, jsim._unpack_gains(g))))
    jstep = jax.jit(jax.vmap(jstep))
    jchange = jax.jit(jax.vmap(jpol.branch_on_change(branches)))
    gains = plane.unpack_gains(torch.from_numpy(gv))
    vals = torch.from_numpy(av)
    state = pol.policy_init(branches, vals, gains)
    jstate = jinit(av, gv)
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    assert state.shape == (8, pol.POLICY_STATE_DIM)
    rng = np.random.default_rng(1)
    sp = gv[:, 2]
    for i in range(40):
        prog = (sp * rng.uniform(0.7, 1.3, sp.shape)).astype(np.float32)
        power = rng.uniform(40.0, 120.0, sp.shape).astype(np.float32)
        obs = pol.PolicyObs(progress=torch.from_numpy(prog),
                            power=torch.from_numpy(power),
                            dt=torch.tensor(1.0), gains=gains)
        state, pcap = pol.policy_step(branches, vals, state, obs)
        jstate, jpcap = jstep(av, jstate, prog, power, gv)
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {i} state")
        np.testing.assert_allclose(pcap.numpy(), np.asarray(jpcap),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {i} pcap")
    tags = state[:, pol.BRANCH_TAG_SLOT].numpy()
    assert set(tags.tolist()) == {float(pol.branch_tag(b))
                                  for b in branches}
    changed = pol.branch_on_change(branches)(vals, state)
    np.testing.assert_allclose(changed.numpy(),
                               np.asarray(jchange(av, jstate)),
                               rtol=RTOL, atol=ATOL)
    extras = pol.branch_extras(branches)(state)
    jextras = jax.vmap(jpol.branch_extras(branches))(jstate)
    assert set(extras) == set(jextras)
    for k, v in extras.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jextras[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    if len(branches) > 1:
        assert extras == {}


def test_register_branch_rejects_tag_collisions():
    """Two names whose crc32 lands on the same tag cannot both
    register."""
    taken = {pol.branch_tag(b): b for b in pol.BRANCHES}
    clash = next(f"clash_{i}" for i in range(10**6)
                 if pol.branch_tag(f"clash_{i}") in taken)
    with pytest.raises(ValueError, match="collision"):
        pol.register_branch(clash, lambda v, s, o: (s, 0.0),
                            lambda v, g: v)
    assert clash not in pol.BRANCHES


def test_reexcite_cap_equals_reference():
    rng = np.random.default_rng(4)
    for _ in range(50):
        pcap, frac = rng.uniform(30, 130), rng.uniform(0, 0.5)
        step = int(rng.integers(0, 9))
        assert PI.reexcite_cap(pcap, step, frac, 40.0, 120.0) == \
            JPI.reexcite_cap(pcap, step, frac, 40.0, 120.0)
    assert PI.REEXCITE_K == JPI.REEXCITE_K


def test_plane_step_runs_the_policy_and_rejects_detector_and_guard():
    pv, gv, av = _rows(ALL4)
    gains = plane.unpack_gains(torch.from_numpy(gv))
    vals = torch.from_numpy(av)
    state = pol.policy_init(ALL4, vals, gains)
    prog = gains.setpoint * 0.9
    new, det, pcap, change = plane.plane_step(
        gains, ALL4, vals, state, gains.pcap_max, prog, None,
        torch.tensor(1.0))
    ref, ref_pcap = pol.policy_step(ALL4, vals, state, pol.PolicyObs(
        progress=prog, power=None, dt=torch.tensor(1.0), gains=gains))
    assert torch.equal(new, ref) and torch.equal(pcap, ref_pcap)
    assert det is None and change == 0.0
    # the detector and the guard are ported: a detector still in its
    # arming window (no alarm possible), masked rows, and a guard that
    # sees valid signals each leave the policy step bit for bit as it was
    from repro_torch.core import faults as flt
    from repro_torch.core.workloads import (DetectorConfig, detect_init,
                                            detector_values)
    dv = detector_values(DetectorConfig(), PROFILES["gros"],
                         device="cpu").expand(8, -1)
    ds = detect_init(dv, gains)
    gv, gs = flt.guard_values(device="cpu"), flt.guard_init((8,),
                                                            device="cpu")
    for kw in (dict(det_vals=dv, det_state=ds),
               dict(det_vals=dv, det_state=ds, det_on=torch.zeros(8)),
               dict(guard_vals=gv, guard_state=gs),
               dict(guard_vals=gv, guard_state=gs, guard_on=torch.zeros(8))):
        out = plane.plane_step(gains, ALL4, vals, state, gains.pcap_max,
                               prog, None, torch.tensor(1.0), **kw)
        assert torch.equal(out[0], ref) and torch.equal(out[2], ref_pcap)
        assert not torch.as_tensor(out[3]).any()


def test_harvest_dataset_waits_for_the_executor():
    """The harvest streams through the executor, one chunk per call of
    its consume hook, and keeps no trace beyond a chunk."""
    from repro_torch.obs import metrics as obs_metrics
    chunks = obs_metrics.get_registry().counter("executor_chunks_total",
                                                "grid chunks executed")
    before = chunks.value()
    d = RL.harvest_dataset("gros", [0.1], range(2), total_work=100.0,
                           max_time=64.0, chunk_size=1, device="cpu")
    assert chunks.value() - before == 2
    assert len(d["s"]) > 0 and {len(v) for v in d.values()} == {len(d["s"])}


# ---- offline RL: dataset and fitted Q ----------------------------------

def test_transitions_and_build_dataset_equal_reference():
    rng = np.random.default_rng(2)
    shape = (3, 4, 50)
    prog = rng.uniform(0, 30, shape).astype(np.float32)
    pcap = rng.uniform(40, 120, shape).astype(np.float32)
    power = rng.uniform(30, 110, shape).astype(np.float32)
    valid = rng.uniform(size=shape) < 0.9
    per_run = [rng.uniform(lo, hi, shape[:2]).astype(np.float32)
               for lo, hi in ((15, 25), (35, 45), (100, 110), (40, 45),
                              (70, 80))]
    for rho in (3.0, 0.5):
        a = RL.transitions_from_traces(prog, pcap, power, valid, *per_run,
                                       rho)
        b = JRL.transitions_from_traces(prog, pcap, power, valid, *per_run,
                                        rho)
        assert set(a) == set(b) == {"s", "a", "r", "s2"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tr = {"progress": prog[0], "pcap": pcap[0], "power": power[0],
          "valid": valid[0]}
    for name in ("gros", "yeti"):
        a = build_dataset(tr, PROFILES[name], 0.1)
        b = jpol.build_dataset(tr, JPROFILES[name], 0.1)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    a = build_dataset({k: v[0] for k, v in tr.items() if k != "valid"},
                      PROFILES["dahu"], 0.2)
    b = jpol.build_dataset({k: v[0] for k, v in tr.items()
                            if k != "valid"}, JPROFILES["dahu"], 0.2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ΦᵀΦ + 1e-3 I on [1, s, s², u, u², su] is badly conditioned: float32 LU
# here and in XLA differ, and 50 Bellman iterations at gamma 0.9 carry the
# difference along. `tools/policy_reference.py` measures it on the CPU over
# four datasets of 4,000 transitions like the one below, at gamma 0 and
# 0.9: max |w - w_ref| / max |w_ref| 2.52e-3 (weights reach 67 and cancel
# across s and s²), max |Q - Q_ref| / max |Q_ref| on the state grid
# 1.06e-3. The bars are about 4x those; the greedy actions agreed on every
# grid state.
FQI_W_REL = 1e-2
FQI_Q_REL = 5e-3


def _q(w, s):
    """Q(s, u) on the candidate grid, float64."""
    us = np.linspace(0.0, 1.0, RL.N_ACTIONS)
    S, U = np.meshgrid(s, us, indexing="ij")
    f = np.stack([np.ones_like(S), S, S * S, U, U * U, S * U], -1)
    return f @ np.asarray(w, np.float64)


@pytest.mark.parametrize("gamma", [0.0, 0.9])
def test_fitted_q_matches_reference(gamma):
    """The fitted weights and their Q on a grid of 121 states within the
    measured bars of the reference's, and the greedy actions on that grid
    equal to the reference's except at ties (the reference's top two
    candidates within rtol 1e-5)."""
    rng = np.random.default_rng(11)
    n = 4000
    s = rng.uniform(0.4, 1.4, n).astype(np.float32)
    a = rng.uniform(0.0, 1.0, n).astype(np.float32)
    s2 = np.clip(s + rng.normal(0, 0.1, n), 0.3, 1.5).astype(np.float32)
    r = (-(a - 0.7) ** 2 - 3 * np.maximum(0, 1 - s2)).astype(np.float32)
    ds = {"s": s, "a": a, "r": r, "s2": s2}
    w = np.asarray(fit_offline_rl(ds, gamma=gamma, **CPU).weights)
    w_ref = np.asarray(jpol.fit_offline_rl(ds, gamma=gamma).weights)
    assert np.abs(w - w_ref).max() <= FQI_W_REL * np.abs(w_ref).max(), (
        w, w_ref)
    grid = np.linspace(0.3, 1.5, 121)
    q, q_ref = _q(w, grid), _q(w_ref, grid)
    assert np.abs(q - q_ref).max() <= FQI_Q_REL * np.abs(q_ref).max()
    top2 = np.sort(q_ref, -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-5 * np.abs(top2[:, 1])
    np.testing.assert_array_equal(q.argmax(-1)[clear],
                                  q_ref.argmax(-1)[clear])
    with pytest.raises(ValueError, match="empty"):
        fit_offline_rl({k: v[:0] for k, v in ds.items()}, **CPU)


def test_offline_rl_step_q_values_and_argmax_match_reference():
    """The greedy step over 4,000 rows of random weights and states: its
    features equal the reference's, its Q is the six-term FMA chain in
    feature order (as XLA evaluates the dot), and its cap and state equal
    the reference's wherever the top two candidates are not within rtol
    1e-5 of each other."""
    rng = np.random.default_rng(8)
    B = 4000
    g = PIGains.from_model(PROFILES["gros"], 0.1)
    jg = jsim.PIGains.from_model(JPROFILES["gros"], 0.1)
    prog = (rng.uniform(0.3, 1.5, B) * g.setpoint).astype(np.float32)
    w = rng.normal(size=(B, 6)).astype(np.float32)
    vals = np.concatenate([np.zeros((B, 1), np.float32), w,
                           np.zeros((B, 3), np.float32)], -1)
    state = np.zeros((B, pol.POLICY_STATE_DIM), np.float32)
    s = prog / np.float32(g.setpoint)
    us = jnp.linspace(0.0, 1.0, RL.N_ACTIONS)
    np.testing.assert_array_equal(
        RL.features(torch.from_numpy(s)[:, None],
                    torch.linspace(0, 1, RL.N_ACTIONS)).numpy(),
        np.asarray(jax.vmap(lambda x: JRL.features(x, us))(s)))
    q_ref = np.asarray(jax.jit(jax.vmap(
        lambda x, w: JRL.features(x, us) @ w))(s, w))
    new, pcap = pol.policy_step("offline_rl", torch.from_numpy(vals),
                                torch.from_numpy(state),
                                pol.PolicyObs(progress=torch.from_numpy(prog),
                                              power=None, dt=1.0, gains=g))
    jnew, jpcap = jax.jit(jax.vmap(lambda v, st, p: jpol.policy_step(
        "offline_rl", v, st, jpol.PolicyObs(progress=p, power=0.0, dt=1.0,
                                            gains=jg))))(vals, state, prog)
    top2 = np.sort(q_ref, -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-5 * np.abs(top2[:, 1])
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(pcap.numpy()[clear],
                                  np.asarray(jpcap)[clear])
    np.testing.assert_array_equal(new.numpy()[clear],
                                  np.asarray(jnew)[clear])


# ---- the packed engine step on the reference's own draws ---------------

def _engine_case(branches, dt, total_work, steps=64, seed=11):
    pv, gv, av = _rows(branches)
    f32 = jnp.float32
    tw, mt, dtj, sf = f32(total_work), f32(1e4), f32(dt), f32(3.0)

    def jinit(p, g, a):
        return jsim._default_init(jsim._unpack_profile(p),
                                  jsim._unpack_gains(g), policy=branches,
                                  policy_vals=a)

    def jstep(p, g, a, c, k):
        return jsim.engine_step(jsim._unpack_profile(p),
                                jsim._unpack_gains(g), c, tw, mt, dtj, k,
                                policy=branches, policy_vals=a,
                                summary_from=sf)

    jstep = jax.jit(jax.vmap(jstep))
    jc = jax.jit(jax.vmap(jinit))(pv, gv, av)
    prof = sim._unpack_profile(torch.from_numpy(pv))
    gains = plane.unpack_gains(torch.from_numpy(gv))
    vals = convert.policy_values_from_reference(av, **CPU)
    c = sim._default_init(prof, gains, branches, vals)
    _assert_carry_close(c, convert.carry_from_reference(jc, **CPU), "init")
    sc = lambda x: torch.tensor(x, dtype=torch.float32)
    B = pv.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(seed), steps * B)
    keys = keys.reshape(steps, B, -1)
    for i in range(steps):
        split = jax.vmap(jax.random.split)(keys[i])
        kplant, khb = split[:, 0], split[:, 1]
        noise = torch.from_numpy(np.asarray(jax.vmap(_key_noise)(kplant)).T
                                 .copy())

        def sampler(lam):
            n = np.asarray(jax.vmap(jax.random.poisson)(
                khb, jnp.asarray(lam.numpy())))
            return torch.from_numpy(n.astype(np.int32))

        c, out = sim.engine_step(prof, gains, c, sc(total_work), sc(1e4),
                                 sc(dt), noise, sampler, policy=branches,
                                 policy_vals=vals, summary_from=sc(3.0))
        jc, jout = jstep(pv, gv, av, jc, keys[i])
        _assert_carry_close(c, convert.carry_from_reference(jc, **CPU),
                            f"step {i}")
        assert set(out) == set(jout), (i, set(out) ^ set(jout))
        for k, v in out.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jout[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} out {k}")
    return c


@pytest.mark.parametrize("branches", [("pi",), ("pi_rls",), ALL4],
                         ids=lambda b: "+".join(b))
def test_packed_engine_step_matches_reference_on_its_own_draws(branches):
    """64 periods at dt = 1 (every run alive) and at dt = 0.05 (about one
    beat a period; every run freezes at total_work part-way)."""
    c = _engine_case(branches, 1.0, 1e9)
    assert not c.done.any() and c.pol.shape == (8, pol.POLICY_STATE_DIM)
    c = _engine_case(branches, 0.05, 33.0)
    assert c.done.all() and len(set(c.steps.tolist())) > 2


def test_packed_pi_equals_typed_bit_for_bit():
    prof, gains, seeds = sim.grid_rows(["gros", "dahu", "yeti"],
                                       [0.0, 0.1, 0.3], range(4))
    typed = sim._scan_core(256, True)(prof, gains, seeds, 1500.0, 256.0,
                                      1.0, 30.0)
    packed = sim._scan_core(256, True, ("pi",), False)(
        prof, gains, seeds, 1500.0, 256.0, 1.0, 30.0,
        torch.zeros(seeds.shape[0], pol.POLICY_PARAM_DIM))
    for k, v in typed[0].items():
        assert torch.equal(v, packed[0][k]), k
    assert set(packed[0]) == set(typed[0])
    t, p = typed[1], packed[1]
    assert torch.equal(t.pol.prev_error, p.pol[:, 0])
    assert torch.equal(t.pol.prev_pcap_l, p.pol[:, 1])
    for f in ("pcap", "t", "steps", "done", "anchor_gap"):
        assert torch.equal(getattr(t, f), getattr(p, f)), f
    for a, b in zip(t.summ, p.summ):
        assert torch.equal(a, b)
    kw = dict(total_work=900.0, max_time=256.0, backend="scan", **CPU)
    a = sim.sweep(["gros", "yeti"], [0.1], range(3), **kw)
    b = sim.sweep(["gros", "yeti"], [0.1], range(3), policies=PIPolicy(),
                  **kw)
    for k in a.traces:
        np.testing.assert_array_equal(a.traces[k], b.traces[k], err_msg=k)


@pytest.mark.parametrize("kwargs", [
    dict(typed_pi=True, policy=("pi", "dutycycle")),
    dict(typed_pi=True, policy=("pi_rls",))])
def test_engine_step_typed_pi_takes_the_pi_branch_only(kwargs):
    prof = sim._unpack_profile(sim.profile_values(PROFILES["gros"])[None])
    gains = plane.unpack_gains(sim.gains_values(
        PIGains.from_model(PROFILES["gros"], 0.1))[None])
    c = sim._default_init(prof, gains, kwargs["policy"],
                          torch.zeros(1, 10))
    with pytest.raises(ValueError, match="typed_pi"):
        sim.engine_step(prof, gains, c, 1e9, 64.0, 1.0, torch.zeros(4, 1),
                        lambda lam: lam.to(torch.int32), **kwargs)


# ---- twins of tests/test_policies.py -----------------------------------

def test_sweep_policies_pi_equals_legacy_sweep():
    """sweep(policies=[PIPolicy()]) and the default sweep are the same
    computation (both on the kernel route: the grid is all fixed-gain
    PI), bit for bit; adaptive= is sugar for PIPolicy(adaptive=...)."""
    kw = dict(total_work=500.0, max_time=600.0, **CPU)
    a = sim.sweep("gros", [0.1, 0.2], range(2), **kw)
    b = sim.sweep("gros", [0.1, 0.2], range(2), policies=[PIPolicy()], **kw)
    np.testing.assert_array_equal(a.exec_time, b.exec_time[:, 0])
    np.testing.assert_array_equal(a.traces["pcap"], b.traces["pcap"][:, 0])
    cfgs = [RLSConfig(lam=0.99), RLSConfig(lam=0.999)]
    c = sim.sweep("gros", [0.1], range(2), adaptive=cfgs,
                  collect_traces=False, **kw)
    d = sim.sweep("gros", [0.1], range(2),
                  policies=[PIPolicy(adaptive=cf) for cf in cfgs],
                  collect_traces=False, **kw)
    np.testing.assert_array_equal(c.exec_time, d.exec_time)
    np.testing.assert_array_equal(c.summary["power_mean"],
                                  d.summary["power_mean"])


def test_policy_axis_shapes_squeeze_and_errors():
    pls = [PIPolicy(), OfflineRLPolicy(weights=(0, 0, 0, 1.4, -1.0, 0)),
           DutyCyclePolicy()]
    kw = dict(total_work=400.0, max_time=600.0, **CPU)
    res = sim.sweep(["gros", "dahu"], [0.1, 0.2], range(2), policies=pls,
                    **kw)
    assert res.exec_time.shape == (2, 2, 3, 2)  # (P, E, A, S)
    assert res.traces["progress"].shape[:4] == (2, 2, 3, 2)
    assert bool(np.asarray(res.completed).all())
    res1 = sim.sweep("gros", [0.1], range(2), policies=DutyCyclePolicy(),
                     **kw)
    assert res1.exec_time.shape == (1, 2)
    res2 = sim.sweep("gros", [0.1], range(2), policies=pls,
                     collect_traces=False, **kw)
    assert res2.traces is None
    assert res2.summary["power_mean"].shape == (1, 3, 2)
    with pytest.raises(ValueError):
        sim.sweep("gros", [0.1], range(2), policies=pls,
                  adaptive=RLSConfig(), **kw)
    with pytest.raises(ValueError):
        sim.sweep("gros", [0.1], range(2), policies=[], **kw)


def test_mixed_policy_sweep_pi_lane_matches_pure_pi():
    """Computing every branch on all rows and selecting by kind must not
    disturb a lane: the PI lane of a heterogeneous sweep equals a pure PI
    sweep on the same engine bit for bit (same seeds, same streams)."""
    kw = dict(total_work=400.0, max_time=600.0, **CPU)
    mixed = sim.sweep("gros", [0.1], range(3),
                      policies=[PIPolicy(), DutyCyclePolicy()], **kw)
    pure = sim.sweep("gros", [0.1], range(3), backend="scan", **kw)
    for k in ("progress", "pcap", "energy"):
        np.testing.assert_array_equal(mixed.traces[k][:, 0],
                                      pure.traces[k], err_msg=k)


def test_build_dataset_masks_and_normalization():
    res = sim.sweep("gros", [0.1], range(2), total_work=400.0,
                    max_time=600.0, **CPU)
    ds = build_dataset(res.traces, PROFILES["gros"], 0.1)
    n_live = int(res.n_steps.sum())
    assert len(ds["s"]) == n_live - res.n_steps.size
    assert set(ds) == {"s", "a", "r", "s2"}
    assert (ds["a"] >= 0).all() and (ds["a"] <= 1).all()
    assert (ds["r"] <= 0).all()  # cost-shaped reward
    assert np.isfinite(ds["s"]).all() and np.isfinite(ds["r"]).all()


def test_fitted_q_recovers_known_optimal_action():
    """gamma=0 on a synthetic dataset with reward -(a - 0.7)^2 reduces
    fitted-Q to regression; the greedy policy picks the candidate cap
    nearest u=0.7 everywhere."""
    rng = np.random.default_rng(0)
    n = 4000
    s = rng.uniform(0.4, 1.4, n).astype(np.float32)
    a = rng.uniform(0.0, 1.0, n).astype(np.float32)
    r = -((a - 0.7) ** 2).astype(np.float32)
    ds = {"s": s, "a": a, "r": r, "s2": s}
    policy = fit_offline_rl(ds, gamma=0.0, n_iters=3, **CPU)
    gains = PIGains.from_model(PROFILES["gros"], 0.1)
    us = np.linspace(0.0, 1.0, pol.N_ACTIONS)
    vals = policy.values(PROFILES["gros"], gains)
    state = pol.policy_init(policy, vals, gains)
    for prog in (0.5 * gains.setpoint, gains.setpoint,
                 1.3 * gains.setpoint):
        obs = pol.PolicyObs(progress=torch.tensor(prog, dtype=torch.float32),
                            power=torch.tensor(0.0), dt=torch.tensor(1.0),
                            gains=gains)
        _, pcap = pol.policy_step(policy, vals, state, obs)
        u = (float(pcap) - gains.pcap_min) / (gains.pcap_max
                                              - gains.pcap_min)
        assert abs(u - 0.7) <= (us[1] - us[0])  # nearest grid level


def test_offline_rl_end_to_end_closes_the_loop():
    """Harvest (a sweep's traces) -> train -> deploy: the trained policy
    runs inside the scan engine and finishes the workload."""
    har = sim.sweep("gros", [0.1], range(2), total_work=600.0,
                    max_time=600.0, **CPU)
    ds = build_dataset(har.traces, PROFILES["gros"], 0.1)
    policy = fit_offline_rl(ds, n_iters=20, **CPU)
    res = sim.simulate_closed_loop("gros", 0.1, total_work=600.0,
                                   max_time=3600.0, seed=5, policy=policy,
                                   **CPU)
    assert res.completed
    assert "action" in res.traces
    assert res.pi_state is None and res.rls_state is None
    assert res.policy_state[pol.BRANCH_TAG_SLOT] == pol.branch_tag(
        "offline_rl")


def test_dutycycle_modulates_below_full_power():
    """With slack (large epsilon) the DDCM ladder settles below the top
    level — saving energy — while keeping progress near the setpoint."""
    prof = PROFILES["gros"]
    res = sim.simulate_closed_loop(prof, 0.3, total_work=2000.0, seed=1,
                                   policy=DutyCyclePolicy(), **CPU)
    assert res.completed
    gains = PIGains.from_model(prof, 0.3)
    tail = res.traces["progress"][res.n_steps // 2:]
    assert tail.mean() == pytest.approx(float(gains.setpoint), rel=0.25)
    caps = res.traces["pcap"][res.n_steps // 2:]
    assert caps.mean() < 0.9 * prof.pcap_max   # shed levels
    assert caps.min() >= prof.pcap_min - 1e-6
    assert "dc_level" in res.traces
    lv = res.traces["dc_level"]
    np.testing.assert_allclose(lv, np.round(lv), atol=1e-5)


def test_register_custom_policy_runs_in_sweep():
    name = "bangbang_test"
    if name not in pol.BRANCHES:
        def step(vals, state, obs):
            g = obs.gains
            pcap = torch.where(obs.progress < g.setpoint, g.pcap_max,
                               g.pcap_min)
            return state, pcap

        pol.register_branch(
            name, step,
            lambda vals, gains: torch.zeros(
                vals.shape[:-1] + (pol.POLICY_STATE_DIM,)))

    @dataclasses.dataclass(frozen=True)
    class BangBang(pol.Policy):
        @property
        def branch(self):
            return name

    res = sim.sweep("gros", [0.1], range(2), total_work=300.0,
                    max_time=600.0, policies=[BangBang(), PIPolicy()],
                    **CPU)
    assert res.exec_time.shape == (1, 2, 2)
    assert bool(np.asarray(res.completed).all())
    caps = res.traces["pcap"][0, 0]
    valid = res.traces["valid"][0, 0]
    prof = PROFILES["gros"]
    assert set(np.round(caps[valid]).tolist()) <= {prof.pcap_min,
                                                   prof.pcap_max}


def test_design_with_policy_raises():
    """design= only modifies the adaptive= sugar; silently ignoring it
    next to policy= would change the estimator's linearization model."""
    with pytest.raises(ValueError):
        sim.simulate_closed_loop("gros", 0.1, total_work=100.0,
                                 policy=PIPolicy(adaptive=RLSConfig()),
                                 design=PROFILES["dahu"], **CPU)


# ---- whole runs against the reference ----------------------------------

def test_policy_race_matches_reference_scan_statistically():
    kw = dict(total_work=1e9, max_time=192.0, collect_traces=False,
              summary_warmup=30)
    mine = sim.sweep(["gros", "dahu"], [0.1], range(16),
                     policies=[_both(b)[0] for b in ("pi", "offline_rl",
                                                     "dutycycle")],
                     **kw, **CPU)
    ref = jsim.sweep(["gros", "dahu"], [0.1], range(16),
                     policies=[_both(b)[1] for b in ("pi", "offline_rl",
                                                     "dutycycle")],
                     backend="scan", **kw)
    assert mine.energy.shape == np.asarray(ref.energy).shape == (2, 1, 3,
                                                                 16)
    for k in ("progress_mean", "power_mean"):
        np.testing.assert_allclose(mine.summary[k].mean(-1),
                                   np.asarray(ref.summary[k]).mean(-1),
                                   rtol=0.05, err_msg=k)
    np.testing.assert_allclose(mine.energy.mean(-1),
                               np.asarray(ref.energy).mean(-1), rtol=0.05)
