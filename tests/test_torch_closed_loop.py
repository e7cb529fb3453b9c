"""The port's closed-loop op (`repro_torch.kernels.closed_loop`) against
the JAX reference, on identical inputs.

Both packages get the same packed rows and the same (T, 5, B) noise
tensor, drawn by the reference's ``draw_noise``. The port's plain
version is held against the reference's ``closed_loop_ref`` and its
Pallas kernel in interpret mode.

Tolerance, and why: `repro_torch.kernels.closed_loop.parity` — the two
frameworks' ``exp``/``log`` differ by an ulp now and then, and the
heartbeat count flips by one beat when such an ulp crosses its rounding
edge. So counts and masks must be equal, at least 99.9% of progress
entries equal (rtol 1e-5), caps within 1e-2 W, the integrals within
rtol 1e-5, and each run's histograms hold the same total with at most
2 counts moved.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import sim as jsim  # noqa: E402
from repro.core.controller import PIGains as JPIGains  # noqa: E402
from repro.core.plant import PROFILES as JPROFILES  # noqa: E402
from repro.kernels.closed_loop import ops as jops  # noqa: E402
from repro.kernels.closed_loop import ref as JR  # noqa: E402

from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.kernels.closed_loop import kernel as K  # noqa: E402
from repro_torch.kernels.closed_loop import ops  # noqa: E402
from repro_torch.kernels.closed_loop import ref as R  # noqa: E402
from repro_torch.kernels.closed_loop.parity import check_parity  # noqa: E402

def _rows(profile_names, epsilon=0.1, reps=1):
    """Packed (B, 14)/(B, 9) rows + keys, in the reference's packing."""
    profs = [JPROFILES[n] for n in profile_names] * reps
    prof = jnp.stack([jsim.profile_values(p) for p in profs])
    gains = jnp.stack([jsim.gains_values(JPIGains.from_model(p, epsilon))
                       for p in profs])
    keys = jnp.stack([jax.random.PRNGKey(i) for i in range(len(profs))])
    return prof, gains, keys


# (profiles, reps, max_time, total_work, block_b, chunk_t, collect) — the
# reference kernel test's cases
CASES = [
    (("gros", "dahu"), 4, 96.0, 1e9, 8, 32, True),     # mixed plants
    (("yeti",), 16, 64.0, 1e9, 16, 16, True),          # drop events
    (("v5e-chip",), 4, 64.0, 1e9, 4, 64, False),       # high-rate, summary
    (("gros",), 8, 48.0, 150.0, 8, 16, True),          # early exit
    (("gros", "dahu", "yeti"), 2, 64.0, 1e9, 4, 32, False),  # ragged B=6
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "profiles,reps,max_time,total_work,block_b,chunk_t,collect", CASES)
def test_plain_version_matches_reference_ref(profiles, reps, max_time,
                                             total_work, block_b, chunk_t,
                                             collect, dtype):
    prof, gains, keys = _rows(profiles, reps=reps)
    prof, gains = prof.astype(dtype), gains.astype(dtype)
    T = ops.horizon(max_time, 1.0)
    noise = jops.draw_noise(keys, T)
    tr_r, fin_r = JR.closed_loop_ref(prof, gains, noise, total_work,
                                     max_time, collect=collect)
    p, g, n = from_reference(np.asarray(prof), np.asarray(gains),
                             np.asarray(noise), device="cpu")
    tr_p, fin_p = ops.closed_loop_sim(p, g, n, total_work=total_work,
                                      max_time=max_time, collect=collect)
    check_parity(tr_p, fin_p, tr_r, fin_r)
    assert float(fin_p["done"].min()) == 1.0  # all finished


@pytest.mark.parametrize(
    "profiles,reps,max_time,total_work,block_b,chunk_t,collect", CASES)
def test_plain_version_matches_reference_kernel(profiles, reps, max_time,
                                                total_work, block_b,
                                                chunk_t, collect):
    """Against the Pallas kernel itself, run by the Pallas interpreter;
    its noise is `draw_noise` of the same keys (per-run streams, so the
    kernel's replica padding does not change them)."""
    prof, gains, keys = _rows(profiles, reps=reps)
    tr_r, fin_r = jops.closed_loop_sim(
        prof, gains, keys, total_work=total_work, max_time=max_time,
        collect=collect, block_b=block_b, chunk_t=chunk_t, interpret=True)
    T = -(-int(max_time) // chunk_t) * chunk_t
    p, g, n = from_reference(np.asarray(prof), np.asarray(gains),
                             np.asarray(jops.draw_noise(keys, T)),
                             device="cpu")
    tr_p, fin_p = R.closed_loop_ref(p, g, n, total_work, max_time,
                                    collect=collect)
    check_parity(tr_p, fin_p, tr_r, fin_r)


# (dt, summary_from, total_work) away from the defaults the cases above
# use: other control periods, a summary warm-up, runs that finish at once
# (no work to do) and early
SETTINGS = [(0.25, 0.0, 1e9), (0.5, 0.0, 1e9), (2.0, 0.0, 1e9),
            (1.0, 10.0, 1e9), (1.0, 20.0, 1e9), (1.0, 0.0, 0.0),
            (1.0, 0.0, 150.0)]


@pytest.mark.parametrize("collect", [True, False])
@pytest.mark.parametrize("dt,summary_from,total_work", SETTINGS)
def test_plain_version_matches_reference_off_the_defaults(
        dt, summary_from, total_work, collect):
    """The plain version against the reference's oracle at other control
    periods, summary warm-ups and amounts of work, in trace and summary
    mode, on mixed plants (drop events included)."""
    prof, gains, keys = _rows(("gros", "dahu", "yeti"), reps=2)
    max_time = 64.0
    T = ops.horizon(max_time, dt)
    noise = jops.draw_noise(keys, T)
    tr_r, fin_r = JR.closed_loop_ref(prof, gains, noise, total_work,
                                     max_time, dt=dt,
                                     summary_from=summary_from,
                                     collect=collect)
    p, g, n = from_reference(np.asarray(prof), np.asarray(gains),
                             np.asarray(noise), device="cpu")
    tr_p, fin_p = ops.closed_loop_sim(p, g, n, total_work=total_work,
                                      max_time=max_time, dt=dt,
                                      summary_from=summary_from,
                                      collect=collect)
    assert (tr_p is None) == (not collect)
    check_parity(tr_p, fin_p, tr_r, fin_r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_dtype_buckets(dtype):
    """Rows arriving in bfloat16 are widened once on load, in both
    packages; the port keeps the bucket's dtype on its tensors."""
    prof, gains, keys = _rows(("gros", "dahu"), reps=2)
    prof, gains = prof.astype(dtype), gains.astype(dtype)
    kw = dict(total_work=1e9, max_time=64.0)
    tr_r, fin_r = jops.closed_loop_sim(prof, gains, keys, block_b=4,
                                       chunk_t=32, interpret=True, **kw)
    p, g, n = from_reference(np.asarray(prof), np.asarray(gains),
                             np.asarray(jops.draw_noise(keys, 64)),
                             device="cpu")
    assert p.dtype == getattr(torch, dtype) and g.dtype == p.dtype
    tr_p, fin_p = ops.closed_loop_sim(p, g, n, **kw)
    check_parity(tr_p, fin_p, tr_r, fin_r)


def test_summary_matches_trace_reductions():
    prof, gains, keys = _rows(("gros",), reps=8)
    p, g = from_reference(np.asarray(prof), np.asarray(gains), device="cpu")
    kw = dict(total_work=1e9, max_time=96.0)
    seeds = torch.arange(8)
    tr, fin_t = ops.closed_loop_sim(p, g, seeds, collect=True, **kw)
    _, fin_s = ops.closed_loop_sim(p, g, seeds, collect=False, **kw)
    for k in fin_t:
        torch.testing.assert_close(fin_t[k], fin_s[k], rtol=0, atol=0,
                                   msg=k)
    valid = tr["valid"] > 0
    prog = tr["progress"]
    torch.testing.assert_close(fin_t["progress_sum"],
                               (prog * valid).sum(0), rtol=1e-5, atol=0.0)
    torch.testing.assert_close(fin_t["count"], valid.sum(0).float())
    # per-run histogram mass equals the live-step count
    torch.testing.assert_close(fin_t["progress_hist"].sum(-1),
                               valid.sum(0).float())


def test_summary_warmup_excludes_first_steps():
    prof, gains, _ = _rows(("dahu",), reps=3)
    p, g = from_reference(np.asarray(prof), np.asarray(gains), device="cpu")
    tr, fin = ops.closed_loop_sim(p, g, torch.arange(3), total_work=1e9,
                                  max_time=64.0, summary_from=10.0)
    np.testing.assert_array_equal(fin["count"].numpy(), 54.0)
    torch.testing.assert_close(fin["power_sum"], tr["power"][10:].sum(0),
                               rtol=1e-5, atol=0.0)


def test_step_and_init_match_reference():
    """Function level: init_state and a few steps from identical inputs."""
    prof, gains, keys = _rows(("gros", "yeti", "v5e-host"), reps=2)
    noise = jops.draw_noise(keys, 8)
    p, g, n = from_reference(np.asarray(prof), np.asarray(gains),
                             np.asarray(noise), device="cpu")
    sc = lambda x: torch.tensor(x, dtype=torch.float32)
    cj, cp = JR.init_state(prof, gains), R.init_state(p, g)
    for s in range(8):
        for k in cj:
            np.testing.assert_allclose(cp[k].numpy(), np.asarray(cj[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        cj, oj = JR.step(prof, gains, cj, noise[s], jnp.float32(1e9),
                         jnp.float32(100.0), jnp.float32(1.0),
                         jnp.float32(2.0))
        cp, op = R.step(p, g, cp, n[s], sc(1e9), sc(100.0), sc(1.0),
                        sc(2.0))
        for k in oj:
            np.testing.assert_allclose(op[k].numpy(), np.asarray(oj[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_window_median_and_hist_index_match_reference():
    rng = np.random.default_rng(0)
    n = rng.integers(0, 6, 500).astype(np.float32)
    gap = rng.uniform(0.0, 3.0, 500).astype(np.float32)
    anchor = rng.uniform(size=500) < 0.7
    want = JR.window_median(jnp.asarray(n), jnp.asarray(gap),
                            jnp.asarray(anchor), jnp.float32(1.0))
    got = R.window_median(torch.from_numpy(n), torch.from_numpy(gap),
                          torch.from_numpy(anchor), torch.tensor(1.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    x = rng.uniform(-20.0, 160.0, 500).astype(np.float32)
    for lo, hi, nb in ((0.0, 38.4, 64), (40.0, 120.0, 32)):
        np.testing.assert_array_equal(
            R.hist_index(torch.from_numpy(x), lo, hi, nb).numpy(),
            np.asarray(JR.hist_index(jnp.asarray(x), lo, hi, nb)))


def test_heartbeat_count_moments():
    """The rounded-Gaussian heartbeat stand-in matches the Poisson draw
    it replaces in mean and variance at paper-scale rates, and agrees
    with the reference's on the same normals."""
    lam = 24.0
    z = np.random.default_rng(0).standard_normal(20000).astype(np.float32)
    n = R.heartbeat_count(torch.tensor(lam), torch.from_numpy(z)).numpy()
    assert n.min() >= 0
    assert n.mean() == pytest.approx(lam, rel=0.02)
    assert n.var() == pytest.approx(lam, rel=0.05)
    np.testing.assert_array_equal(
        n, np.asarray(JR.heartbeat_count(jnp.float32(lam), jnp.asarray(z))))


def test_draw_noise_per_run_streams_and_moments():
    """A run's stream depends only on its seed (batch of 1 == batch of
    7, bit for bit); channels have unit-normal / unit-uniform moments."""
    one = ops.draw_noise([11], 200, "cpu")
    many = ops.draw_noise([3, 5, 11, 0, 2**40 + 7, 9, 1], 200, "cpu")
    assert many.shape == (200, 5, 7) and many.dtype == torch.float32
    assert torch.equal(one[:, :, 0], many[:, :, 2])
    assert not torch.equal(many[:, :, 0], many[:, :, 1])
    big = ops.draw_noise(torch.arange(3000), 256, "cpu")
    for ch in (R.NZ_PROG, R.NZ_POW, R.NZ_HB):
        x = big[:, ch].double()
        assert abs(float(x.mean())) < 0.01 and abs(float(x.std()) - 1) < 0.01
    for ch in (R.NU_ENTER, R.NU_EXIT):
        x = big[:, ch].double()
        assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
        assert abs(float(x.mean()) - 0.5) < 0.005
        assert abs(float(x.var()) - 1 / 12) < 0.002
    # channels and neighbouring runs and steps are uncorrelated
    a = big[:, R.NZ_PROG].flatten().double()
    for b in (big[:, R.NZ_HB].flatten(), big[:, R.NZ_POW].flatten(),
              big[1:, R.NZ_PROG].flatten(),
              big[:, R.NZ_PROG].roll(1, dims=1).flatten()):
        m = min(len(a), len(b))
        r = torch.corrcoef(torch.stack([a[:m], b[:m].double()]))[0, 1]
        assert abs(float(r)) < 0.01


def test_closed_loop_sim_checks_noise_shape():
    prof, gains, _ = _rows(("gros",), reps=2)
    p, g = from_reference(np.asarray(prof), np.asarray(gains), device="cpu")
    with pytest.raises(ValueError, match="noise must be"):
        ops.closed_loop_sim(p, g, torch.zeros(63, 5, 2), total_work=1e9,
                            max_time=63.0)
    assert ops.horizon(63.0, 1.0) == 64 and ops.horizon(2048.0, 1.0) == 2048
    assert ops.horizon(96.0, 0.5) == 192


def test_cuda_wrapper_refuses_cpu_tensors():
    """The wrapper launches the kernel or raises; it never computes on
    the CPU."""
    prof, gains, keys = _rows(("gros",), reps=2)
    p, g, n = from_reference(np.asarray(prof), np.asarray(gains),
                             np.asarray(jops.draw_noise(keys, 64)),
                             device="cpu")
    before = K.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        K.closed_loop_cuda(p, g, n, (1e9, 64.0, 1.0, 0.0))
    assert K.LAUNCHES == before


@pytest.mark.parametrize("breach", ["count", "pcap", "energy", "hist",
                                    "progress", "traces"])
def test_parity_bar_rejects_breaches(breach):
    """The bar itself: one run passes against itself, and each kind of
    breach is caught."""
    prof, gains, _ = _rows(("gros", "yeti"), reps=2)
    p, g = from_reference(np.asarray(prof), np.asarray(gains), device="cpu")
    tr, fin = ops.closed_loop_sim(p, g, torch.arange(4), total_work=1e9,
                                  max_time=64.0)
    assert check_parity(tr, fin, tr, fin) == 0.0
    tr2 = {k: v.clone() for k, v in tr.items()}
    fin2 = {k: v.clone() for k, v in fin.items()}
    if breach == "count":
        fin2["count"][1] += 1
    elif breach == "pcap":
        fin2["pcap"][0] += 0.05
    elif breach == "energy":
        fin2["energy"][2] *= 1.001
    elif breach == "hist":
        fin2["progress_hist"][3, :3] -= 1
        fin2["progress_hist"][3, -3:] += 1
    elif breach == "progress":
        tr2["progress"][:2] += 1.0
    else:
        tr2 = None
    with pytest.raises(AssertionError):
        check_parity(tr2, fin2, tr, fin)


# ---------------------------------------------------------------------------
# the kernel's in-kernel noise generator, read from its source
# ---------------------------------------------------------------------------

_CU = K.SOURCE.read_text()
# the kernel's names for the step's noise values, in `ref.NZ_*` order
_CHANNEL_VARS = {"z_prog": R.NZ_PROG, "z_pow": R.NZ_POW,
                 "u_enter": R.NU_ENTER, "u_exit": R.NU_EXIT,
                 "z_hb": R.NZ_HB}


def _cu_const(name):
    m = re.search(rf"constexpr \w+ {name} = ([0-9A-Fa-fx.e+-]+?)[uf]?;", _CU)
    assert m, f"{name} not found in {K.SOURCE.name}"
    text = m.group(1)
    return int(text, 16) if text.lower().startswith("0x") else float(text)


def _cu_words():
    """Channel -> the key indices its line in the kernel's step reads."""
    words = {}
    for var, args in re.findall(
            r"(\w+) = (?:normal|uniform)\(h, ((?:key\[\d\], )*key\[\d\])\);",
            _CU):
        words[_CHANNEL_VARS[var]] = tuple(
            int(i) for i in re.findall(r"key\[(\d)\]", args))
    return words


def test_kernel_channel_words_are_draw_noise_words():
    assert _cu_words() == ops._WORDS
    assert _cu_const("kWords") == 8 == 1 + max(
        w for ws in ops._WORDS.values() for w in ws)


def test_kernel_generator_constants_reproduce_draw_noise():
    """The kernel's generator written out in numpy uint32 arithmetic from
    the constants in its source (word keys from the seed's two halves,
    the step hash, one mix32 per word, unit24, Box-Muller in float32 with
    the kernel's 2 pi) gives `draw_noise`'s streams on the CPU: the
    uniforms bit for bit, the normals as torch rounds them here."""
    c = {n: _cu_const(n) for n in ("kSeedXor", "kWordMul", "kStepMul",
                                   "kStepAdd", "kMix1", "kMix2",
                                   "kUnit24", "kTwoPi")}
    assert np.float32(c["kTwoPi"]) == np.float32(2.0 * np.pi)
    assert c["kUnit24"] == 2.0 ** -24

    def mix32(x):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(c["kMix1"])
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(c["kMix2"])
        return x ^ (x >> np.uint32(16))

    seeds = np.array([0, 1, 7, 2**40 + 7, -3, 2**63 - 1], dtype=np.int64)
    T = 37
    s = seeds.view(np.uint64)
    with np.errstate(over="ignore"):
        k = mix32((s & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                  ^ np.uint32(c["kSeedXor"]))
        k = mix32(k ^ (s >> np.uint64(32)).astype(np.uint32))
        keys = [mix32(k + np.uint32((w + 1) * c["kWordMul"] & 0xFFFFFFFF))
                for w in range(8)]
        t = np.arange(T, dtype=np.uint32)
        h = mix32(t * np.uint32(c["kStepMul"]) + np.uint32(c["kStepAdd"]))
        unif = [((mix32(h[:, None] + key[None, :]) >> np.uint32(8))
                 .astype(np.float32) * np.float32(c["kUnit24"]))
                for key in keys]
    want = ops.draw_noise(torch.from_numpy(seeds), T, "cpu")
    for ch, words in _cu_words().items():
        u = torch.from_numpy(unif[words[0]])
        if len(words) == 2:
            u2 = torch.from_numpy(unif[words[1]])
            u = (torch.sqrt(-2.0 * torch.log(1.0 - u))
                 * torch.cos(c["kTwoPi"] * u2))
        assert torch.equal(u, want[:, ch]), ch


@pytest.mark.parametrize("T,bits", [(1, 16), (2048, 16), (65535, 16),
                                    (65536, 32), (1 << 20, 32)])
def test_histogram_counter_width(T, bits):
    """16-bit counters hold at most 65,535 steps; longer horizons take
    32-bit counters."""
    assert K.bin_bits(T) == bits
    with pytest.raises(ValueError):
        K.bin_bits(0)


@pytest.mark.parametrize("given", ["seeds", "noise"])
def test_closed_loop_sim_on_cpu_runs_the_plain_version(monkeypatch, given):
    """CPU tensors take the plain version, on `draw_noise` of the seeds or
    on the given noise; neither kernel route is reached."""
    calls = {"draw": 0, "plain": 0}
    draw, plain = ops.draw_noise, R.closed_loop_ref

    def counted(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    def refuse(*a, **kw):
        raise AssertionError("a kernel route was reached from the CPU")

    monkeypatch.setattr(ops, "draw_noise", counted("draw", draw))
    monkeypatch.setattr(R, "closed_loop_ref", counted("plain", plain))
    monkeypatch.setattr(ops, "closed_loop_seeds_cuda", refuse)
    monkeypatch.setattr(ops, "closed_loop_cuda", refuse)
    prof, gains, _ = _rows(("gros", "yeti"), reps=2)
    p, g = from_reference(np.asarray(prof), np.asarray(gains), device="cpu")
    seeds = torch.arange(4) + 5
    arg = seeds if given == "seeds" else draw(seeds, 64, "cpu")
    tr, fin = ops.closed_loop_sim(p, g, arg, total_work=1e9, max_time=64.0,
                                  summary_from=3.0)
    assert calls == {"draw": int(given == "seeds"), "plain": 1}
    tr_w, fin_w = plain(p, g, draw(seeds, 64, "cpu"), 1e9, 64.0, 1.0, 3.0,
                        True)
    for k in fin:
        assert torch.equal(fin[k], fin_w[k])
    for k in tr:
        assert torch.equal(tr[k], tr_w[k])
