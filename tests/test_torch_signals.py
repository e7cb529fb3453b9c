"""The port's heartbeat signal (`repro_torch.core.signals`) against the
reference's functional part of `repro.core.signals`: Eq. 1's median over
a window of beat times exactly in float32 (odd and even windows: the
even median averages the two middle rates, as ``jnp.median`` does), and
the beat synthesizer's identical list for the same generator."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import signals as jsignals  # noqa: E402

from repro_torch.core.signals import (median, progress_from_times,  # noqa: E402
                                      synth_heartbeats)

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
