"""The port's heartbeat signal (`repro_torch.core.signals`) against the
reference's `repro.core.signals`: Eq. 1's median over a window of beat
times exactly in float32 (odd and even windows: the even median averages
the two middle rates, as ``jnp.median`` does), the beat synthesizer's
identical list for the same generator, and the ingestion layer
(`TenantHeartbeatStore`, `HeartbeatAggregator`: host numpy code) fed the
same beats through both packages, its float64 progress bit-equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import signals as jsignals  # noqa: E402

from repro_torch.core.signals import (HeartbeatAggregator,  # noqa: E402
                                      TenantHeartbeatStore, median,
                                      progress_from_times, synth_heartbeats)

CPU = dict(device="cpu")


@pytest.mark.parametrize("n_beats", [2, 3, 4, 9, 10, 33, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_progress_from_times_equals_reference(n_beats, seed):
    """Odd and even numbers of rates (n_beats - 1), repeated gaps, a zero
    gap (a rate of 0) and jittered gaps: bit-equal float32 medians."""
    rng = np.random.default_rng(seed)
    gaps = rng.lognormal(-2.0, 0.5, n_beats).astype(np.float32)
    gaps[n_beats // 2] = 0.0              # two beats at one instant
    if n_beats > 3:
        gaps[1] = gaps[2]                 # a tie in the middle
    times = np.cumsum(gaps).astype(np.float32)
    mine = progress_from_times(times, **CPU)
    ref = jsignals.progress_from_times(jnp.asarray(times))
    assert mine.dtype == torch.float32 and mine.shape == ()
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


def test_even_window_averages_the_middle_rates():
    # rates 1, 2, 4, 8: the median is (2 + 4) / 2, not torch.median's 2
    times = [0.0, 1.0, 1.5, 1.75, 1.875]
    assert float(progress_from_times(times, **CPU)) == 3.0
    assert float(jsignals.progress_from_times(jnp.asarray(times))) == 3.0
    x = torch.tensor([5.0, 1.0, 3.0, 2.0])
    assert float(median(x)) == 2.5 and float(median(x[:3])) == 3.0
    assert torch.isnan(median(torch.tensor([1.0, float("nan"), 2.0])))
    assert torch.isnan(median(torch.tensor([])))


def test_progress_from_times_keeps_the_tensor_device():
    t = torch.tensor([0.0, 0.5, 1.0])
    assert float(progress_from_times(t)) == 2.0


@pytest.mark.parametrize("rate,duration,jitter", [
    (4.0, 10.0, 0.1), (250.0, 2.0, 0.3), (0.7, 30.0, 0.0), (0.0, 5.0, 0.1),
    (-1.0, 5.0, 0.1)])
def test_synth_heartbeats_equals_reference(rate, duration, jitter):
    for seed in (0, 5):
        a = synth_heartbeats(np.random.default_rng(seed), rate, duration,
                             jitter)
        b = jsignals.synth_heartbeats(np.random.default_rng(seed), rate,
                                      duration, jitter)
        assert a == b


# ---- twins of tests/test_signals.py's functional cases ---------------

def test_progress_from_times_matches_numpy():
    times = np.cumsum(np.full(32, 0.25))
    assert float(progress_from_times(times, **CPU)) == pytest.approx(
        4.0, rel=1e-5)


@pytest.mark.parametrize("rate,jitter,seed", [
    (0.5, 0.0, 1), (3.0, 0.1, 2), (40.0, 0.3, 3), (500.0, 0.2, 4)])
def test_progress_tracks_true_rate(rate, jitter, seed):
    """For a jittered beat train the median rate is close to the true
    rate (robustness of Eq. 1's median choice)."""
    rng = np.random.default_rng(seed)
    times = synth_heartbeats(rng, rate, duration=max(20.0 / rate, 2.0),
                             jitter=jitter)
    assert len(times) >= 8
    p = float(progress_from_times(times, **CPU))
    assert p == pytest.approx(rate, rel=0.35 + jitter)


# ---- the ingestion layer: twins of tests/test_signals.py, bit-equal ---

def _both(cls, *args, **kw):
    return cls(*args, **kw), getattr(jsignals, cls.__name__)(*args, **kw)


@pytest.mark.parametrize("seed,rate,jitter", [
    (0, 0.5, 0.0), (1, 7.0, 0.1), (2, 40.0, 0.4), (3, 180.0, 0.2)])
def test_aggregator_equals_reference_on_interleaved_beats(seed, rate,
                                                          jitter):
    """Interleaved weighted beats and emits (the reference's deque-oracle
    property): the port's float64 progress equals the reference's bit for
    bit, and both keep the same buffer and anchor."""
    rng = np.random.default_rng(seed)
    times = synth_heartbeats(rng, rate, duration=6.0, jitter=jitter)
    mine, ref = _both(HeartbeatAggregator)
    emits = np.sort(rng.uniform(0.0, 7.0, size=8))
    ti = 0
    for t in times:
        while ti < len(emits) and emits[ti] <= t:
            assert mine.progress(emits[ti]) == ref.progress(emits[ti])
            ti += 1
        w = float(rng.uniform(0.5, 2.0))
        mine.beat(t, w)
        ref.beat(t, w)
    for e in emits[ti:]:
        assert mine.progress(e) == ref.progress(e)
    assert len(mine) == len(ref) and mine._anchor == ref._anchor
    assert mine.state_dict() == ref.state_dict()


def test_beat_many_equals_beat_loop_and_reference():
    rng = np.random.default_rng(0)
    times = np.sort(rng.uniform(0.0, 4.0, size=256))
    works = rng.uniform(0.5, 3.0, size=256)
    a, ref = _both(HeartbeatAggregator)
    b = HeartbeatAggregator()
    a.beat_many(times, works)
    ref.beat_many(times, works)
    for t, w in zip(times, works):
        b.beat(t, w)
    for e in (1.0, 2.5, 4.1):
        pa = a.progress(e)
        assert pa == b.progress(e) == ref.progress(e)
    c = HeartbeatAggregator()
    c.beat_many([])
    c.beat_many([0.1, 0.2, 0.3])
    assert c.progress(0.4) == pytest.approx(10.0, rel=1e-6)


def test_beats_drop_after_emit_bounded_memory():
    hb = HeartbeatAggregator(max_beats=64)
    t = 0.0
    for _ in range(50):
        hb.beat_many(t + np.arange(1, 11) * 0.1)  # 10 beats per period
        t += 1.0
        assert hb.progress(t) == pytest.approx(10.0, rel=1e-6)
        assert len(hb) <= 1


@pytest.mark.parametrize("ingest", ["many", "loop"])
def test_ring_overflow_keeps_newest_beats(ingest):
    mine, ref = _both(HeartbeatAggregator, max_beats=32)
    times = np.arange(1, 101) * 0.01  # 100 beats at 100 Hz
    for hb in (mine, ref):
        if ingest == "many":
            hb.beat_many(times)
        else:
            for t in times:
                hb.beat(t)
    assert len(mine) == 32 and mine._anchor == pytest.approx(times[-33])
    assert mine._anchor == ref._anchor
    p = mine.progress(1.01)
    assert p == ref.progress(1.01) and p == pytest.approx(100.0, rel=1e-6)


def test_late_beats_fold_into_anchor_not_window():
    for batched in (False, True):
        mine, ref = _both(HeartbeatAggregator)
        for hb in (mine, ref):
            hb.beat(0.5)
            assert hb.progress(1.0) == 0.0
            if batched:
                hb.beat_many([0.8, 1.2])
            else:
                hb.beat(0.8)  # late: window [.., 1.0) already emitted
                hb.beat(1.2)
        p = mine.progress(2.0)
        assert p == ref.progress(2.0) and p == pytest.approx(2.5, rel=1e-6)


@pytest.mark.parametrize("seed,n_tenants,max_beats", [
    (0, 1, 4), (1, 3, 8), (2, 6, 24), (3, 5, 5)])
def test_tenant_store_equals_reference(seed, n_tenants, max_beats):
    """Mixed-tenant batches with late prefixes and ring overflow, and
    staggered emit times, through both packages' stores: every
    `progress_all` bit-equal, and the same counts, anchors and drops."""
    rng = np.random.default_rng(seed)
    mine, ref = _both(TenantHeartbeatStore, n_tenants, max_beats=max_beats)
    clock = np.zeros(n_tenants)
    for _ in range(12):
        ids, times, works = [], [], []
        for tid in rng.permutation(n_tenants):
            n = int(rng.integers(0, 3 * max_beats))
            if n == 0:
                continue
            start = clock[tid]
            if rng.random() < 0.3:  # late prefix
                start = max(0.0, start - rng.uniform(0.0, 1.0))
            ts = start + np.cumsum(rng.uniform(0.0, 0.3, size=n))
            clock[tid] = max(clock[tid], ts[-1])
            ids += [int(tid)] * n
            times += ts.tolist()
            works += rng.uniform(0.5, 2.0, size=n).tolist()
        mine.ingest(ids, times, works)
        ref.ingest(ids, times, works)
        t_i = clock + rng.uniform(-0.2, 0.5, size=n_tenants)
        np.testing.assert_array_equal(mine.progress_all(t_i),
                                      ref.progress_all(t_i))
    np.testing.assert_array_equal(mine.counts(), ref.counts())
    np.testing.assert_array_equal(mine._anchor, ref._anchor)
    np.testing.assert_array_equal(mine.drops(), ref.drops())


def test_tenant_store_state_dict_roundtrip_across_packages():
    """A snapshot survives JSON and restores the same window state, in
    either direction between the packages: the resumed stores emit the
    same Eq. 1 sequence as the originals."""
    import json
    rng = np.random.default_rng(3)
    mine, ref = _both(TenantHeartbeatStore, 3, max_beats=16)
    ids = rng.integers(0, 3, size=40)
    times = np.sort(rng.uniform(0.0, 4.0, size=40))
    works = rng.uniform(0.5, 2.0, size=40)
    for st in (mine, ref):
        st.ingest(ids, times, works)
        st.progress_all(2.0)
    assert mine.state_dict() == ref.state_dict()
    from_ref = TenantHeartbeatStore(3, max_beats=16)
    from_ref.load_state_dict(json.loads(json.dumps(ref.state_dict())))
    to_ref = jsignals.TenantHeartbeatStore(3, max_beats=16)
    to_ref.load_state_dict(json.loads(json.dumps(mine.state_dict())))
    more_ids = rng.integers(0, 3, size=20)
    more_t = 4.0 + np.sort(rng.uniform(0.0, 2.0, size=20))
    outs = []
    for st in (mine, ref, from_ref, to_ref):
        st.ingest(more_ids, more_t)
        outs.append(st.progress_all(6.5))
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)


@pytest.mark.parametrize("seed,rate,n_bad", [(0, 2.0, 1), (1, 30.0, 7),
                                             (2, 100.0, 30)])
def test_corrupt_beats_dropped_counted_and_progress_unchanged(seed, rate,
                                                              n_bad):
    """NaN/inf times and negative or non-finite work are dropped and
    counted, in both packages alike, without moving the progress of the
    clean beats."""
    rng = np.random.default_rng(seed)
    times = synth_heartbeats(rng, rate, duration=4.0, jitter=0.2)
    works = rng.uniform(0.5, 2.0, len(times))
    bad_t, bad_w = [], []
    for k in range(n_bad):
        kind = k % 4
        bad_t.append([np.nan, np.inf if k % 8 < 4 else -np.inf,
                      float(rng.uniform(0.0, 4.0)),
                      float(rng.uniform(0.0, 4.0))][kind])
        bad_w.append([1.0, 1.0, -1.0, np.nan if k % 8 < 4 else np.inf][kind])
    slots = np.sort(rng.integers(0, len(times) + 1, n_bad))
    mixed_t = np.insert(np.asarray(times, float), slots, bad_t)
    mixed_w = np.insert(np.asarray(works, float), slots, bad_w)
    dirty, ref = _both(HeartbeatAggregator)
    clean = HeartbeatAggregator()
    dirty.beat_many(mixed_t, mixed_w)
    ref.beat_many(mixed_t, mixed_w)
    clean.beat_many(times, works)
    assert dirty.drops == ref.drops == n_bad and clean.drops == 0
    for t_i in (1.0, 2.0, 3.0, 4.5):
        p = dirty.progress(t_i)
        assert p == clean.progress(t_i) == ref.progress(t_i)
    redo = HeartbeatAggregator()
    redo.load_state_dict(dirty.state_dict())
    assert redo.drops == n_bad
